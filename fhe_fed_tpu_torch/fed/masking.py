"""Masking-based secure aggregation (the reference's Paillier scheme), as
fhe_fed_tpu.fed.masking, on one torch device.

  offline (per round, per learner, on the host):
    genPaillierRandOffline(n_params, iteration): draw one-time-pad
        randomness r in [0, 2**num_bits), persist it, bit-pack many values
        per Paillier plaintext and encrypt them;
    addPaillierRandOffline([blobs]): homomorphic sum of every learner's
        encrypted randomness;
    decryptRandomnessSum(blob, n_params, iteration): decrypt and persist
        the mask sum; recoverRandomnessSubset re-sums the retained blobs of
        a survivor subset when learners drop out.

  online (on the helper's device):
    encrypt(x, iteration) = (fix(x) - r) mod 2**num_bits;
    computeWeightedAverage(...) = the sum of the masked values mod
        2**num_bits (scaling factors are checked for count only: like the
        reference, the protocol averages by the learner count);
    decrypt(blob, dims, iteration) = + mask sum, two's-complement decode,
        / 2**precision / learners.

Ring values live in int64 tensors (torch's uint32 is a storage-only dtype
on the CPU); every step equals the JAX package's uint32 arithmetic because
the ring mask is below 2**32. The files (<randomnessdir>/<iteration>/
learner_rand*.npy, the Paillier key hex files) and the wire bytes (raw
little-endian uint32 for masked values, uint64 limbs for Paillier
ciphertexts) are the JAX package's, so learners of either package share a
round. The offline Paillier runs in the native kernels (native/paillier.py).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import cuda_lib
from ..native import paillier as paillier_mod
from .scheme import Scheme, register_scheme

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Fixed-point ring codec and the online helpers, on tensors
# ---------------------------------------------------------------------------

def fixed_point_encode(x: torch.Tensor, num_bits: int,
                       precision_bits: int) -> torch.Tensor:
    """f32 -> int64 ring values in [0, 2**num_bits), two's complement.

    round half to even of x * 2**precision, clipped to
    +-(2**(num_bits-1) - 1), with the JAX package's f32 -> int32 convert:
    NaN gives 0 and out-of-range values saturate (torch's .to(int32) gives
    -2**31 for all of them), so clip in f64 after mapping NaN to 0."""
    limit = (1 << (num_bits - 1)) - 1
    scaled = torch.round(x.to(_F32) * float(1 << precision_bits))
    scaled = torch.nan_to_num(scaled.double(), nan=0.0).clamp(-limit, limit)
    return scaled.to(torch.int64) & ((1 << num_bits) - 1)


def fixed_point_decode(v: torch.Tensor, num_bits: int, precision_bits: int,
                       divide_by: int = 1) -> torch.Tensor:
    """Ring values -> f32: two's complement, then two f32 divisions, by
    2**precision and by `divide_by`, in that order. The divisors are
    tensors on v's device: a CUDA division by a Python scalar multiplies by
    its reciprocal, which is not the JAX package's division."""
    threshold = 1 << (num_bits - 1)
    v = v.to(torch.int64)
    signed = torch.where(v >= threshold, v - (1 << num_bits), v).to(_F32)

    def div(d):
        return torch.tensor(float(d), dtype=_F32, device=v.device)
    return signed / div(1 << precision_bits) / div(divide_by)


def mask_values(fixed: torch.Tensor, r: torch.Tensor,
                mask: int) -> torch.Tensor:
    """(fix(x) - r) mod 2**num_bits."""
    return (fixed - r) & mask


def sum_masked(stacked: torch.Tensor, mask: int) -> torch.Tensor:
    """(K, n) ring values -> (n,) sum mod 2**num_bits: the client axis."""
    return stacked.sum(dim=0) & mask


def _to_wire(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().astype("<u4").tobytes()


def _from_wire(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype="<u4").astype(np.int64)


# ---------------------------------------------------------------------------
# Paillier bit-packing (host big-int code)
# ---------------------------------------------------------------------------

def _packing_geometry(learners: int, num_bits: int, modulus_bits: int):
    """(bytes per slot, slots per plaintext): a slot holds one value plus
    the carry bits of `learners` additions."""
    bytes_per_num = (num_bits + 7) // 8
    extra_bits = (learners - 1) - (bytes_per_num * 8 - num_bits)
    extra_bytes = (extra_bits + 7) // 8 if extra_bits > 0 else 0
    total_bytes = bytes_per_num + extra_bytes
    nums_per_pt = (modulus_bits // 8) // total_bytes
    return total_bytes, nums_per_pt


def pack_values(vals: np.ndarray, learners: int, num_bits: int,
                modulus_bits: int) -> list[int]:
    """Values below 2**num_bits -> big-int plaintexts, `nums_per_pt` per
    plaintext, each value in a total_bytes-wide big-endian slot, the first
    value in the most significant one."""
    total_bytes, nums_per_pt = _packing_geometry(learners, num_bits,
                                                 modulus_bits)
    vals = np.asarray(vals)
    if vals.size and int(vals.max()) >> min(64, 8 * total_bytes):
        raise ValueError(f"values exceed the {total_bytes}-byte slot")
    n_blocks = math.ceil(vals.size / nums_per_pt)
    padded = np.zeros(n_blocks * nums_per_pt, dtype=">u8")
    padded[:vals.size] = vals
    w = min(8, total_bytes)
    slots = np.zeros((padded.size, total_bytes), dtype=np.uint8)
    slots[:, total_bytes - w:] = padded.view(np.uint8).reshape(-1, 8)[:, 8 - w:]
    return [int.from_bytes(row.tobytes(), "big")
            for row in slots.reshape(n_blocks, -1)]


def unpack_values(blocks: list[int], n: int, learners: int, num_bits: int,
                  modulus_bits: int) -> np.ndarray:
    """Inverse of pack_values for sums of up to `learners` packings: the
    first n slot values, uint64; bits above the slots are dropped. A slot
    value of 64 bits or more raises OverflowError, as the JAX package's
    uint64 store does."""
    total_bytes, nums_per_pt = _packing_geometry(learners, num_bits,
                                                 modulus_bits)
    width = total_bytes * nums_per_pt
    raw = b"".join((acc & ((1 << (8 * width)) - 1)).to_bytes(width, "big")
                   for acc in blocks)
    slots = np.frombuffer(raw, dtype=np.uint8).reshape(-1, total_bytes)[:n]
    w = min(8, total_bytes)
    if slots[:, :total_bytes - w].any():
        raise OverflowError("a slot value does not fit in uint64")
    out = np.zeros((slots.shape[0], 8), dtype=np.uint8)
    out[:, 8 - w:] = slots[:, total_bytes - w:]
    return out.view(">u8").reshape(-1).astype(np.uint64)


# ---------------------------------------------------------------------------
# Scheme
# ---------------------------------------------------------------------------

class Masking(Scheme):
    """The reference's `Paillier : Scheme` surface (its constructor's
    arguments), plus `device` (default "cuda", the card; "cpu" on request):
    the online phase runs on tensors there."""

    def __init__(self, scheme: str = "paillier", learners: int = 4,
                 modulus_bits: int = 2048, num_bits: int = 17,
                 precision_bits: int = 13,
                 cryptodir: str = "../resources/cryptoparams/",
                 randomnessdir: str = "../resources/random_params/",
                 device: torch.device | str = "cuda"):
        super().__init__(scheme)
        self.learners = learners
        self.modulus_bits = modulus_bits
        self.num_bits = num_bits
        self.precision_bits = precision_bits
        self.cryptodir = cryptodir
        self.randomnessdir = randomnessdir
        self.device = cuda_lib.device(device)
        self._ring_mask = (1 << num_bits) - 1
        self._ctx: paillier_mod.PaillierContext | None = None

    # -- keys: hex files -----------------------------------------------------

    def _key_paths(self):
        return (os.path.join(self.cryptodir, "paillier-key-public.txt"),
                os.path.join(self.cryptodir, "paillier-key-private.txt"))

    def genCryptoContextAndKeyGen(self) -> int:
        os.makedirs(self.cryptodir, exist_ok=True)
        pk, sk = paillier_mod.keygen(self.modulus_bits)
        pub_p, prv_p = self._key_paths()
        with open(pub_p, "w") as f:
            f.write(pk.to_hex())
        with open(prv_p, "w") as f:
            f.write(sk.to_hex())
        self._ctx = paillier_mod.PaillierContext(pk, sk)
        return 1

    def loadCryptoParams(self) -> None:
        pub_p, prv_p = self._key_paths()
        with open(pub_p) as f:
            pk = paillier_mod.PaillierPublicKey.from_hex(
                f.read().strip(), bits=self.modulus_bits)
        sk = None
        if os.path.exists(prv_p):
            with open(prv_p) as f:
                sk = paillier_mod.PaillierSecretKey.from_hex(f.read().strip())
        self._ctx = paillier_mod.PaillierContext(pk, sk)

    def _paillier(self, secret: bool = False) -> paillier_mod.PaillierContext:
        if self._ctx is None:
            raise RuntimeError("call loadCryptoParams() or "
                               "genCryptoContextAndKeyGen() first")
        if secret and self._ctx.sk is None:
            raise RuntimeError("this helper holds no Paillier secret key")
        return self._ctx

    # -- offline phase (host) ------------------------------------------------

    def _rand_path(self, iteration: int, name: str) -> str:
        d = os.path.join(self.randomnessdir, str(iteration))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    @staticmethod
    def _sum_name(subset: list[int] | None) -> str:
        if subset is None:
            return "learner_rand_sum.npy"
        tag = "_".join(str(i) for i in sorted(subset))
        return f"learner_rand_sum_s{tag}.npy"

    def genPaillierRandOffline(self, params: int, iteration: int) -> bytes:
        """Draw and persist one-time-pad randomness; return it packed and
        Paillier-encrypted."""
        ctx = self._paillier()
        raw = np.frombuffer(os.urandom(4 * params), dtype="<u4")
        r = (raw & self._ring_mask).astype(np.uint32)
        np.save(self._rand_path(iteration, "learner_rand.npy"), r)
        blocks = pack_values(r, self.learners, self.num_bits,
                             self.modulus_bits)
        return ctx.ct_to_bytes(ctx.encrypt(blocks))

    def addPaillierRandOffline(self, blobs: list[bytes]) -> bytes:
        """Aggregator: homomorphic sum of the encrypted randomness."""
        ctx = self._paillier()
        acc = ctx.ct_from_bytes(blobs[0])
        for b in blobs[1:]:
            acc = ctx.add(acc, ctx.ct_from_bytes(b))
        return ctx.ct_to_bytes(acc)

    def decryptRandomnessSum(self, blob: bytes, params: int,
                             iteration: int,
                             subset: list[int] | None = None) -> None:
        """Key holder: decrypt the mask sum and persist it for unmasking
        (suffixed by the survivors when `subset` names them)."""
        ctx = self._paillier(secret=True)
        vals = unpack_values(ctx.decrypt(ctx.ct_from_bytes(blob)), params,
                             self.learners, self.num_bits, self.modulus_bits)
        r_sum = (vals & self._ring_mask).astype(np.uint32)
        np.save(self._rand_path(iteration, self._sum_name(subset)), r_sum)

    def recoverRandomnessSubset(self, blobs: list[bytes], params: int,
                                iteration: int, subset: list[int]) -> None:
        """Learner dropout: re-sum the retained encrypted blobs of the
        survivors `subset` and decrypt that sum; decrypt(..., subset=...)
        then unmasks with it. No survivor has to act again."""
        sub_blob = self.addPaillierRandOffline([blobs[i] for i in subset])
        self.decryptRandomnessSum(sub_blob, params, iteration, subset=subset)

    # -- online phase (device) -----------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def encrypt(self, data: np.ndarray, iteration: int = 0) -> bytes:
        """Mask: (fix(x) - r) mod 2**num_bits."""
        r = np.load(self._rand_path(iteration, "learner_rand.npy"))
        x = np.asarray(data, dtype=np.float32).reshape(-1)
        fixed = fixed_point_encode(self._tensor(x), self.num_bits,
                                   self.precision_bits)
        return _to_wire(mask_values(
            fixed, self._tensor(r[:x.size].astype(np.int64)),
            self._ring_mask))

    def computeWeightedAverage(self, learner_data: list[bytes],
                               scaling_factors: list[float] | None = None,
                               params: int | None = None) -> bytes:
        """Sum of the masked values mod 2**num_bits. Uniform average only:
        scaling_factors are checked for count, as the reference does."""
        if scaling_factors is not None and \
                len(scaling_factors) != len(learner_data):
            raise ValueError(
                "Error: learner_data and scaling_factors size mismatch")
        stacked = self._tensor(np.stack([_from_wire(b)
                                         for b in learner_data]))
        return _to_wire(sum_masked(stacked, self._ring_mask))

    def decrypt(self, data: bytes, data_dimensions: int,
                iteration: int = 0,
                subset: list[int] | None = None) -> np.ndarray:
        """Unmask and decode, averaged over the learners (or over the
        survivors `subset`, with the sum recoverRandomnessSubset wrote)."""
        r_sum = np.load(self._rand_path(iteration, self._sum_name(subset)))
        v = self._tensor(_from_wire(data)[:data_dimensions])
        r = self._tensor(r_sum[:data_dimensions].astype(np.int64))
        out = fixed_point_decode(
            (v + r) & self._ring_mask, self.num_bits, self.precision_bits,
            divide_by=self.learners if subset is None else len(subset))
        return out.cpu().numpy().astype(np.float64)


register_scheme("paillier")(Masking)
register_scheme("masking")(Masking)
