"""The comparison that decides `correct`.

Each sampled round of the window is held against the reference, on what
the timed path itself produced:

  * format_faults: ciphertext shapes, wire headers and lengths, residues
    outside [0, q_l), output lengths: the count of what is not as the
    format states (an exact comparison: limit 0);
  * enc_noise: each client's ciphertext decrypted under the benchmark's
    secret key, less the encoding of that client's values, as the largest
    |e| in units of the encoding (fresh secret-key RLWE: m + e);
  * enc_var_z: how far the variance of those e lies below the stated
    error variance, in standard errors (the configuration states that
    the error has at least that variance);
  * a_uniform_z: the largest |z| of the mean of c1 = -a over one client's
    limb against the mean of a uniform residue (`a` uniform mod q_l);
  * a_repeats: the count of c1 chunks, of any client in any sampled round,
    equal to a chunk seen before in the run (`a` drawn afresh: a cached
    ciphertext or a reused `a` repeats; an exact comparison: limit 0). The
    run keeps two rounds of one pool entry among those it samples;
  * agg_rel_err: the aggregate decrypted under the secret key and divided
    by its scale, against sum_k w_k x_k in float64, relative to that
    average's largest magnitude;
  * avg_rel_err: the round's decrypted average against the same.

A number is within its limit when value <= limit; NaN never is.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import ckks, wire

_F64 = torch.float64


@dataclasses.dataclass
class Stats:
    """Running readings over the sampled rounds."""
    format_faults: int = 0
    enc_noise: float = 0.0
    err_sq: float = 0.0
    err_count: int = 0
    a_uniform_z: float = 0.0
    a_repeats: int = 0
    agg_rel_err: float = 0.0
    avg_rel_err: float = 0.0
    seen: set = dataclasses.field(default_factory=set)

    def max(self, name: str, value: float) -> None:
        self.seen.add(name)
        old = getattr(self, name)
        # NaN sticks: max() would drop it.
        if not math.isnan(old) and (math.isnan(value) or value > old):
            setattr(self, name, value)


class Checker:
    """Holds the reference's ring and key and accumulates `Stats`."""

    def __init__(self, crypto: dict, keys: ckks.KeyPair, device):
        self.crypto = crypto
        self.device = torch.device(device)
        self.ring = ckks.make_ring(crypto["ring_dim"], crypto["moduli"],
                                   self.device).limbs(crypto["chain_len"])
        self.s_hat = keys.s_hat[:crypto["chain_len"]].to(self.device)
        self.stats = Stats()
        self._prints = set()   # c1 chunks seen, across the sampled rounds
        self._weights = None

    def _fingerprints(self, c1: torch.Tensor) -> list:
        """(chunks, L, N) int64 -> a key per chunk: two dot products with
        fixed random weights under 2**31, wrapping mod 2**64 (exact, so
        equal chunks give equal keys on any device; distinct ones differ
        but with negligible chance)."""
        rows = c1.reshape(c1.shape[0], -1)
        if self._weights is None or self._weights.shape[1] != rows.shape[1]:
            gen = torch.Generator().manual_seed(0x5eed)
            self._weights = torch.randint(
                0, 2 ** 31, (2, rows.shape[1]), generator=gen,
                dtype=torch.int64).to(self.device)
        keys = torch.stack([(rows * w).sum(1) for w in self._weights], 1)
        return [tuple(k) for k in keys.tolist()]

    def _repeats(self, c1: torch.Tensor) -> None:
        st = self.stats
        st.seen.add("a_repeats")
        for key in self._fingerprints(c1):
            st.a_repeats += key in self._prints
            self._prints.add(key)

    # -- pieces ------------------------------------------------------------

    def _fault(self, n: int = 1) -> None:
        self.stats.seen.add("format_faults")
        self.stats.format_faults += int(n)

    def _residues_ok(self, data: torch.Tensor) -> torch.Tensor | None:
        """(..., 2, L, N) residues as int64 if in range, counting faults."""
        L, n = len(self.ring.moduli), self.ring.n
        if tuple(data.shape[-3:]) != (2, L, n):
            self._fault()
            return None
        data = data.to(self.device, torch.int64)
        bad = int(((data < 0) | (data >= self.ring.q)).sum())
        self.stats.seen.add("format_faults")
        self.stats.format_faults += bad
        return data

    def clients(self, data: torch.Tensor, values: torch.Tensor, scale,
                want_scale: float) -> None:
        """Client ciphertexts (K, chunks, 2, L, N) of values (K, chunks, N)
        f32 at `scale`, which has to be the encoding's: enc_noise, the
        error's variance, a_uniform_z."""
        if (tuple(data.shape[:2]) != tuple(values.shape[:2])
                or scale != want_scale):
            self._fault()
            return
        data = self._residues_ok(data)
        if data is None:
            return
        ring, st = self.ring, self.stats
        sb = self.crypto["scale_bits"]
        for k in range(data.shape[0]):
            ph = ckks.phase(ring, data[k], self.s_hat)
            err = ckks.lift((ph - ckks.encode(values[k].to(self.device), sb,
                                              ring.q)) % ring.q,
                            ring.moduli)
            st.max("enc_noise", float(err.abs().max()))
            st.seen.add("enc_var_z")
            st.err_sq += float((err * err).sum())
            st.err_count += err.numel()
            self._repeats(data[k, :, 1])
            c1 = data[k, :, 1].to(_F64)                  # (chunks, L, N)
            count = c1.shape[0] * c1.shape[2]
            for l, q in enumerate(ring.moduli):
                mean = float(c1[:, l].mean())
                sd = math.sqrt((q * q - 1) / 12 / count)
                st.max("a_uniform_z", abs(mean - (q - 1) / 2) / sd)

    def _rel(self, name: str, got: torch.Tensor, want: torch.Tensor) -> None:
        got = got.to(self.device, _F64).reshape(-1)
        want = want.to(self.device, _F64).reshape(-1)
        if got.numel() != want.numel():
            self._fault()
            return
        top = float(want.abs().max())
        self.stats.max(name, float((got - want).abs().max()) / top)

    def aggregate(self, data: torch.Tensor, scale: float,
                  want: torch.Tensor) -> None:
        """The aggregate (chunks, 2, L, N) at `scale` against the float64
        average laid out as (chunks, N)."""
        if data.shape[0] != want.shape[0]:
            self._fault()
            return
        data = self._residues_ok(data)
        if data is None:
            return
        vals = ckks.lift(ckks.phase(self.ring, data, self.s_hat),
                         self.ring.moduli) / float(scale)
        self._rel("agg_rel_err", vals, want)

    def average(self, got, want: torch.Tensor) -> None:
        if not torch.is_tensor(got):
            got = torch.as_tensor(np.asarray(got))
        self._rel("avg_rel_err", got, want)

    def average_blocks(self, got: np.ndarray, values: list, weights,
                       block: int = 1 << 24) -> None:
        """A long flat average against sum_k w_k x_k, `block` values at a
        time (the streamed round)."""
        dims = int(np.asarray(values[0]).size)
        got = np.asarray(got).reshape(-1)
        if got.size != dims:
            self._fault()
            return
        err = top = 0.0
        for s in range(0, dims, block):
            want = ckks.weighted_mean(
                [torch.as_tensor(np.asarray(v).reshape(-1)[s:s + block]).to(
                    self.device) for v in values], weights)
            g = torch.as_tensor(got[s:s + block]).to(self.device, _F64)
            err = max(err, float((g - want).abs().max()))
            top = max(top, float(want.abs().max()))
        self.stats.max("avg_rel_err", err / top)

    def wire_ct(self, blob: bytes, chunks: int, live: int):
        """An FFTC blob -> (residues, scale), counting header faults."""
        if len(blob) < wire.CT_HDR.size:
            self._fault()
            return None, None
        hdr, data = wire.parse_ct(blob)
        c = self.crypto
        want = dict(magic=wire.CT_MAGIC, version=wire.VERSION,
                    ring_dim=c["ring_dim"], batch=c["batch"],
                    scale_bits=c["scale_bits"], chunks=chunks, live=live)
        self._fault(sum(hdr[k] != v for k, v in want.items()))
        if data is None:
            self._fault()
            return None, None
        return data, hdr["scale"]

    # -- result --------------------------------------------------------------

    def numbers(self) -> dict:
        st, out = self.stats, {}
        for name in ("format_faults", "enc_noise", "enc_var_z",
                     "a_uniform_z", "a_repeats", "agg_rel_err",
                     "avg_rel_err"):
            if name not in st.seen:
                continue
            if name == "enc_var_z":
                eta = self.crypto["error_eta"]
                var = eta / 2
                # Var(e^2) of a centred binomial: mu4 - var^2.
                mu4 = eta / 2 + 3 * eta * (eta - 1) / 4
                n = max(st.err_count, 1)
                out[name] = (var - st.err_sq / n) / math.sqrt(
                    (mu4 - var * var) / n)
            else:
                out[name] = float(getattr(st, name))
        return out


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is within its limit (NaN is not)."""
    return bool(numbers) and all(v <= limits[k] for k, v in numbers.items())

