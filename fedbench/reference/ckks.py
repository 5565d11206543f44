"""Plain CKKS of the secure-FedAvg round: the benchmark's yardstick.

Written from the scheme and the formats alone, in plain torch int64 on
whatever device it is given; it imports nothing of the program and takes
nothing the program made. What it shares with the program is what the
formats fix:

  * RNS residues: int32 in [0, q_l) per limb, the limbs the crypto point's
    moduli (configs/*.json), every q_l below 2**31 and 1 mod 2N;
  * the evaluation domain: the negacyclic NTT with its output in
    bit-reversed order, entry j = a(psi**(2 * brv(j) + 1)) mod q_l, psi the
    first g**((q - 1) / 2N), g = 2, 3, ..., with psi**N = -1;
  * the secret key s ternary, kept in the evaluation domain; a fresh
    ciphertext (c0, c1) decrypts as c0 + c1 * s = m + e;
  * coefficient packing: value i of a client's flat vector is coefficient
    i mod c of chunk i // c (c = N with dense packing, else the batch),
    scaled by 2**scale_bits and rounded half to even.

`RefCKKS` is the reference put in the program's place (the control): the
same methods as the program's helper, computed here; at `bfloat16` the
values, the weights and the result are rounded to bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import wire

_I64 = torch.int64


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    small = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    if n < 2:
        return False
    for p in small:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in small:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def root_2n(q: int, n: int) -> int:
    """psi: the first g**((q - 1) / 2N), g = 2, 3, ..., with psi**N = -1."""
    for g in range(2, 1000):
        psi = pow(g, (q - 1) // (2 * n), q)
        if pow(psi, n, q) == q - 1:
            return psi
    raise ValueError(f"no primitive 2N-th root of unity mod {q}")


def bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(n)],
                    dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class Ring:
    """Z_q[X]/(X^N + 1) over the limbs `moduli`, with its NTT tables."""
    n: int
    moduli: tuple
    q: torch.Tensor        # (L, 1) int64
    tab: torch.Tensor      # (L, N) psi**brv(k)
    itab: torch.Tensor     # (L, N) psi**-brv(k)
    ninv: torch.Tensor     # (L, 1) N**-1 mod q

    def limbs(self, count: int) -> "Ring":
        return Ring(self.n, self.moduli[:count], self.q[:count],
                    self.tab[:count], self.itab[:count], self.ninv[:count])

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """(..., L, N) residues -> evaluation domain (Cooley-Tukey)."""
        lead, L, n = x.shape[:-2], len(self.moduli), self.n
        q = self.q.view(L, 1, 1)
        x = x.to(_I64)
        m, t = 1, n
        while m < n:
            t //= 2
            x = x.reshape(*lead, L, m, 2, t)
            w = self.tab[:, m:2 * m].reshape(L, m, 1)
            u, v = x[..., 0, :], x[..., 1, :] * w % q
            x = torch.stack([(u + v) % q, (u - v) % q], dim=-2)
            m *= 2
        return x.reshape(*lead, L, n)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Evaluation domain -> coefficients (Gentleman-Sande, times 1/N)."""
        lead, L, n = x.shape[:-2], len(self.moduli), self.n
        q = self.q.view(L, 1, 1)
        x = x.to(_I64)
        m, t = n, 1
        while m > 1:
            h = m // 2
            x = x.reshape(*lead, L, h, 2, t)
            w = self.itab[:, h:2 * h].reshape(L, h, 1)
            u, v = x[..., 0, :], x[..., 1, :]
            x = torch.stack([(u + v) % q, (u - v) % q * w % q], dim=-2)
            m, t = h, 2 * t
        return x.reshape(*lead, L, n) * self.ninv % self.q


def make_ring(n: int, moduli, device) -> Ring:
    moduli = tuple(int(q) for q in moduli)
    for q in moduli:
        if not (is_prime(q) and q < 2 ** 31 and (q - 1) % (2 * n) == 0):
            raise ValueError(f"{q} is not a prime below 2**31, 1 mod 2N")
    brv = bitrev(n)
    tab, itab = [], []
    for q in moduli:
        psi = root_2n(q, n)
        ipsi = pow(psi, q - 2, q)
        pw = [1] * n
        ipw = [1] * n
        for k in range(1, n):
            pw[k] = pw[k - 1] * psi % q
            ipw[k] = ipw[k - 1] * ipsi % q
        tab.append(np.array(pw, dtype=np.int64)[brv])
        itab.append(np.array(ipw, dtype=np.int64)[brv])

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return Ring(n, moduli, t(moduli)[:, None], t(tab), t(itab),
                t([pow(n, q - 2, q) for q in moduli])[:, None])


def shoup(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The Shoup word floor(w * 2**32 / q) of each residue (the key files')."""
    return torch.div(w.to(_I64) << 32, q, rounding_mode="floor")


def encode(values: torch.Tensor, scale_bits: int, q: torch.Tensor
           ) -> torch.Tensor:
    """f32 values (..., N) -> round(v * 2**scale_bits) mod q, (..., L, N).
    Exact: a float32 times a power of two is exact in float64, and the
    rounded integer fits int64 for |v| < 2**(62 - scale_bits)."""
    t = torch.round(values.to(torch.float64) * 2.0 ** scale_bits).to(_I64)
    return t[..., None, :] % q


def lift(res: torch.Tensor, moduli) -> torch.Tensor:
    """Residues (..., L, N) -> the centred integer they stand for, as
    float64: balanced mixed-radix digits (Garner), each in (-q/2, q/2], so
    a value below q_0 / 2 in magnitude is exact and a larger one carries
    float64's relative error."""
    moduli = [int(q) for q in moduli]
    dev = res.device
    res = res.to(_I64)
    digits = []
    value = torch.zeros(res.shape[:-2] + res.shape[-1:], dtype=torch.float64,
                        device=dev)
    radix = 1
    for i, qi in enumerate(moduli):
        acc = res[..., i, :]
        r = 1                               # prod_{j < k} q_j mod q_i
        for k, d in enumerate(digits):
            acc = (acc - (d % qi) * r) % qi
            r = r * moduli[k] % qi
        inv = pow(r, qi - 2, qi)
        a = acc * inv % qi
        a = torch.where(a > qi // 2, a - qi, a)
        digits.append(a)
        value = value + a.to(torch.float64) * float(radix)
        radix *= qi
    return value


def popcount(x: torch.Tensor, bits: int) -> torch.Tensor:
    total = torch.zeros_like(x)
    for i in range(bits):
        total += (x >> i) & 1
    return total


def cbd(gen: torch.Generator, shape, eta: int) -> torch.Tensor:
    """Centred binomial error: popcount(a) - popcount(b), a, b uniform
    eta-bit words (variance eta / 2)."""
    a = torch.randint(0, 1 << eta, tuple(shape), generator=gen,
                      device=gen.device)
    b = torch.randint(0, 1 << eta, tuple(shape), generator=gen,
                      device=gen.device)
    return popcount(a, eta) - popcount(b, eta)


def uniform(gen: torch.Generator, shape, ring: Ring) -> torch.Tensor:
    """(..., L, N) residues, limb l uniform in [0, q_l)."""
    *lead, n = shape
    return torch.stack([torch.randint(0, q, (*lead, n), generator=gen,
                                      device=gen.device)
                        for q in ring.moduli], dim=-2)


@dataclasses.dataclass(frozen=True)
class KeyPair:
    s_hat: torch.Tensor     # (L, N) int64, every limb of the crypto point
    p0_hat: torch.Tensor    # -a * s + e
    p1_hat: torch.Tensor    # a


def keygen(ring: Ring, gen: torch.Generator, eta: int) -> KeyPair:
    """A ternary secret and its public key over every limb."""
    n = ring.n
    s = torch.randint(-1, 2, (n,), generator=gen, device=gen.device)
    e = cbd(gen, (n,), eta)
    s_hat, e_hat = ring.ntt(torch.stack([s, e])[:, None, :] % ring.q)
    a = uniform(gen, (n,), ring)
    return KeyPair(s_hat, (e_hat - a * s_hat) % ring.q, a)


def cryptodir_files(crypto: dict, ring: Ring, keys: KeyPair) -> dict:
    """The three files of a cryptodir that the program's loadCryptoParams
    reads: {name: bytes}."""
    q = ring.q
    meta = dict(scheme="ckks", batchSize=crypto["batch"],
                scaleFactorBits=crypto["scale_bits"],
                mult_depth=crypto["mult_depth"], ring_dim=ring.n,
                moduli=list(ring.moduli), num_base=crypto["num_base"])
    sk = [keys.s_hat, shoup(keys.s_hat, q)]
    pk = [keys.p0_hat, shoup(keys.p0_hat, q), keys.p1_hat,
          shoup(keys.p1_hat, q)]
    return {wire.CTX_FILE: wire.context_json(meta),
            wire.SK_FILE: wire.pack_key(0, ring.n, [a.cpu() for a in sk]),
            wire.PK_FILE: wire.pack_key(1, ring.n, [a.cpu() for a in pk])}


def phase(ring: Ring, data: torch.Tensor, s_hat: torch.Tensor
          ) -> torch.Tensor:
    """Ciphertexts (..., 2, L, N) -> c0 + c1 * s in coefficients."""
    c0, c1 = data.to(_I64).unbind(-3)
    return ring.intt((c0 + c1 * s_hat) % ring.q)


@dataclasses.dataclass(frozen=True)
class RefCiphertext:
    data: torch.Tensor      # (..., 2, L, N) int32, evaluation domain
    scale: float
    level: int = 0


class RefCKKS:
    """The reference in the program's place: secret-key encrypt, weighted
    sum and decrypt under the benchmark's key, with the program's helper
    methods. `precision` "float32" is the stated precision; "bfloat16"
    rounds the values, the weights and the result to bfloat16 (the
    control)."""

    WEIGHT_BITS = 30         # weights are integers at scale 2**30

    def __init__(self, crypto: dict, keys: KeyPair, device, seed: int,
                 precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision {precision!r}")
        self.crypto = crypto
        self.device = torch.device(device)
        self.ring = make_ring(crypto["ring_dim"], crypto["moduli"],
                              self.device).limbs(crypto["chain_len"])
        self.s_hat = keys.s_hat[:crypto["chain_len"]].to(self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.low = precision == "bfloat16"
        self.capacity = (crypto["ring_dim"] if crypto["dense_pack"]
                         else crypto["batch"])

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        if self.low:
            return x.to(torch.bfloat16).to(x.dtype)
        return x

    # -- the cohort surface ---------------------------------------------

    def encrypt_cohort(self, values: torch.Tensor) -> RefCiphertext:
        """(K, chunks, N) f32 -> (K, chunks, 2, L, N)."""
        ring, sb = self.ring, self.crypto["scale_bits"]
        values = self._round(values.to(self.device, torch.float32))
        a = uniform(self.gen, values.shape, ring)
        e = cbd(self.gen, values.shape, self.crypto["error_eta"])
        m = (encode(values, sb, ring.q) + e[..., None, :]) % ring.q
        c0 = (a * self.s_hat + ring.ntt(m)) % ring.q
        c1 = (-a) % ring.q
        return RefCiphertext(torch.stack([c0, c1], dim=-3).to(torch.int32),
                             2.0 ** sb)

    def aggregate_cohort(self, ct: RefCiphertext, weights) -> RefCiphertext:
        w = torch.tensor([float(x) for x in weights], dtype=torch.float64)
        if self.low:
            w = w.to(torch.bfloat16).to(torch.float64)
        wi = torch.round(w * 2.0 ** self.WEIGHT_BITS).to(_I64).to(
            self.device)
        q = self.ring.q
        acc = torch.zeros(ct.data.shape[1:], dtype=_I64, device=self.device)
        for k in range(ct.data.shape[0]):
            acc = (acc + ct.data[k].to(_I64) * (wi[k] % q)) % q
        return RefCiphertext(acc.to(torch.int32),
                             ct.scale * 2.0 ** self.WEIGHT_BITS)

    def decrypt_cohort(self, ct: RefCiphertext, data_dimensions=None, *,
                       raw: bool = False) -> torch.Tensor:
        vals = lift(phase(self.ring, ct.data, self.s_hat),
                    self.ring.moduli) / ct.scale
        out = self._round(vals.to(torch.float32))
        if raw:
            return out
        return out[..., :self.capacity].reshape(-1)[
            :int(data_dimensions)].cpu().numpy().astype(np.float64)

    # -- the bytes surface ------------------------------------------------

    def _chunks(self, flat) -> torch.Tensor:
        """Flat values -> (chunks, N), `capacity` values a chunk."""
        flat = torch.as_tensor(np.asarray(flat, dtype=np.float32).reshape(-1))
        cap, n = self.capacity, self.crypto["ring_dim"]
        chunks = max(1, -(-flat.numel() // cap))
        pay = torch.zeros(chunks * cap, dtype=torch.float32)
        pay[:flat.numel()] = flat
        buf = torch.zeros((chunks, n), dtype=torch.float32)
        buf[:, :cap] = pay.view(chunks, cap)
        return buf.to(self.device)

    def _blob(self, ct: RefCiphertext) -> bytes:
        chunks, _, live, n = ct.data.shape
        return wire.pack_ct(self.crypto, chunks, live, ct.level, ct.scale,
                            ct.data.cpu())

    def _parse(self, blob: bytes) -> RefCiphertext:
        hdr, data = wire.parse_ct(blob)
        return RefCiphertext(data.to(self.device), hdr["scale"],
                             hdr["level"])

    def encrypt(self, flat) -> bytes:
        ct = self.encrypt_cohort(self._chunks(flat)[None])
        return self._blob(RefCiphertext(ct.data[0], ct.scale))

    def computeWeightedAverage(self, blobs, weights) -> bytes:
        cts = [self._parse(b) for b in blobs]
        stacked = RefCiphertext(torch.stack([c.data for c in cts]),
                                cts[0].scale)
        return self._blob(self.aggregate_cohort(stacked, weights))

    def decrypt(self, blob: bytes, data_dimensions: int) -> np.ndarray:
        return self.decrypt_cohort(self._parse(blob), data_dimensions)

    # -- the streamed surface ---------------------------------------------

    def fedavg_round(self, client_vectors, scaling_factors,
                     data_dimensions=None, block: int = 1024) -> np.ndarray:
        """The whole round, `block` chunks at a time."""
        dims = (int(data_dimensions) if data_dimensions is not None
                else int(np.asarray(client_vectors[0]).size))
        cap = self.capacity
        chunks = -(-dims // cap)
        out = np.empty(chunks * cap, dtype=np.float64)
        for c0 in range(0, chunks, block):
            c1 = min(chunks, c0 + block)
            part = torch.stack([
                self._chunks(np.asarray(v).reshape(-1)[c0 * cap:c1 * cap])
                for v in client_vectors])
            agg = self.aggregate_cohort(self.encrypt_cohort(part),
                                        scaling_factors)
            out[c0 * cap:c1 * cap] = self.decrypt_cohort(
                agg, raw=True)[:, :cap].reshape(-1).cpu().numpy()
        return out[:dims]


def weighted_mean(values: list, weights) -> torch.Tensor:
    """sum_k w_k x_k in float64, on the values' device."""
    acc = None
    for x, w in zip(values, weights):
        t = x.to(torch.float64) * float(w)
        acc = t if acc is None else acc + t
    return acc
