"""User-facing CKKS scheme: the drop-in surface of the reference binding,
as fhe_fed_tpu.fed.api.CKKS, on one torch device.

    from fhe_fed_tpu_torch import CKKS
    helper = CKKS(cryptodir=d, device="cuda:0")   # "ckks", 4096, 52
    helper.genCryptoContextAndKeyGen()
    helper.loadCryptoParams()
    ct = helper.encrypt(flat_np_array)
    agg = helper.computeWeightedAverage([ct1, ct2, ct3], [0.5, 0.2, 0.3])
    out = helper.decrypt(agg, dims)

The constructor takes the JAX class's arguments and refuses the same
combinations, plus `device` (default "cuda", the card; pass "cpu" to run
on the CPU): the context, the keys and every tensor of the helper live
there; it is never chosen by what the machine has. `prng` ("rbg",
"threefry", or None for the device's default) takes the place of the JAX
class's FHE_FED_TPU_PRNG environment override. The cryptodir
(cryptocontext.txt JSON, FFTK key files) and every blob (FFTC, FFTS,
FFTP) are the JAX package's formats, so either package reads what the
other writes.

The helper's PRNG stream is the key key(seed) of its implementation
(utils/prng.py), advanced by split, as the JAX class uses it. The JAX
class picks the implementation by backend: rbg on its accelerator,
threefry elsewhere; so does this one by device (prng.default_impl): rbg
on the card, threefry on the CPU. Under either, with the same seed, both
classes write the same key files and the same ciphertext bytes (the JAX
class under FHE_FED_TPU_PRNG=rbg for rbg), on the CPU and on the card
alike: rbg's draws are XLA's Philox stream, drawn on the card by the
Philox kernel (utils/philox_rbg.py). An FFTS blob's `a` comes from
threefry whatever the session key, so any server expands it.

Chunking follows the reference: ceil(size / capacity) chunks, the decrypt
tail rule, `dense_pack` packing the full ring per chunk, `packing="slots"`
the canonical embedding (N/2 slots per chunk, host-side encode/decode).

`fedavg_round` stages by what it is given: host vectors are packed on the
host, sent up, and their average comes back as a float64 ndarray; a
(K, E) tensor (fhe_fedavg's gathered buffer) is packed on the helper's
device where it lies, and its average stays there as an (E,) float32
tensor. `staging` counts the rounds by where their pack ran.
"""

from __future__ import annotations

import collections
import json
import os
import secrets

import numpy as np
import torch

from .. import cuda_lib
from ..ckks import params as ckks_params
from ..ckks import keys as ckks_keys
from ..ckks import ops as ckks_ops
from ..ckks import serial as ckks_serial
from ..ckks import slots as ckks_slots
from ..utils import prng as prng_mod
from ..utils.spans import span, traced
from .scheme import Scheme, register_scheme

_CTX_FILE = "cryptocontext.txt"
_PK_FILE = "key-public.txt"
_SK_FILE = "key-private.txt"

# fedavg_round's rounds by where their pack ran: "device" for a (K, E)
# tensor packed on the helper's device, "host" for host vectors.
staging: collections.Counter = collections.Counter()


def _slicing(chunks: int, max_chunks: int | None) -> tuple[int, int]:
    """fedavg_round's (padded chunks, slice length): one slice of every
    chunk, or slices of max_chunks over the chunk axis padded to a
    multiple of it."""
    if max_chunks is None or chunks <= max_chunks:
        return chunks, chunks
    return -(-chunks // max_chunks) * max_chunks, max_chunks


@register_scheme("ckks")
class CKKS(Scheme):
    # fedavg_round takes a (K, E) tensor and returns its average on the
    # helper's device (fed/fedavg.py hands over its gathered buffer).
    fedavg_round_takes_tensor = True

    def __init__(self, scheme: str = "ckks", batchSize: int = 4096,
                 scaleFactorBits: int = 52,
                 cryptodir: str = "../resources/cryptoparams/",
                 mult_depth: int = 1, dense_pack: bool = False,
                 symmetric: bool = False, seeded_fresh: bool = False,
                 seed: int | None = None, packing: str = "coeff",
                 device: torch.device | str = "cuda",
                 prng: str | None = None):
        super().__init__(scheme)
        self.batchSize = int(batchSize)
        self.scaleFactorBits = int(scaleFactorBits)
        self.cryptodir = cryptodir
        self.mult_depth = int(mult_depth)
        self.dense_pack = bool(dense_pack)
        if packing not in ("coeff", "slots"):
            raise ValueError(f"unknown packing {packing!r}")
        if packing == "slots" and dense_pack:
            raise ValueError("dense_pack packs coefficients; a slot-packed "
                             "ciphertext has exactly N/2 slots")
        if packing == "slots" and (symmetric or seeded_fresh):
            raise ValueError(
                "symmetric/seeded_fresh are coefficient-mode encrypt "
                "optimizations; slot packing always takes the "
                "reference-shaped public-key path")
        self.packing = packing
        # symmetric=True: secret-key RLWE encryption (one NTT batch instead
        # of four); every learner holds sk in this protocol.
        self.symmetric = bool(symmetric)
        # seeded_fresh=True (implies symmetric): uploads carry (c0, 128-bit
        # seed) instead of (c0, c1), half the bytes; the server expands
        # c1 = -PRG(seed) on arrival. computeWeightedAverage takes both.
        self.seeded_fresh = bool(seeded_fresh)
        if self.seeded_fresh:
            self.symmetric = True
        self.device = cuda_lib.device(device)
        self._params = ckks_params.make_params(
            batch=self.batchSize, scale_bits=self.scaleFactorBits,
            mult_depth=self.mult_depth)
        self._ctx = None
        self._sk = None
        self._pk = None
        # The sampling PRNG: rbg on the card, threefry on the CPU, unless
        # the caller names one.
        self.prng = (prng_mod.default_impl(self.device) if prng is None
                     else prng)
        self._rng = prng_mod.key(
            secrets.randbits(63) if seed is None else seed, self.prng,
            self.device)

    # -- context / key lifecycle ------------------------------------------

    @property
    def ctx(self) -> ckks_params.CkksContext:
        if self._ctx is None:
            self._ctx = ckks_params.make_context(self._params, self.device)
        return self._ctx

    @property
    def capacity(self) -> int:
        """Values packed per ciphertext chunk."""
        if self.packing == "slots":
            return self._params.ring_dim // 2
        return self._params.ring_dim if self.dense_pack else self.batchSize

    def genCryptoContextAndKeyGen(self) -> int:
        """Generate context + keys and persist them (ckks.cpp:25-59)."""
        ctx = self.ctx
        sk, pk = ckks_keys.keygen(
            ctx, int(prng_mod.bits(self._next_key(), ())))
        self._sk, self._pk = sk, pk
        os.makedirs(self.cryptodir, exist_ok=True)
        meta = dict(scheme="ckks", batchSize=self.batchSize,
                    scaleFactorBits=self.scaleFactorBits,
                    mult_depth=self.mult_depth,
                    ring_dim=self._params.ring_dim,
                    moduli=list(self._params.moduli),
                    num_base=self._params.num_base)
        with open(os.path.join(self.cryptodir, _CTX_FILE), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(self.cryptodir, _PK_FILE), "wb") as f:
            f.write(ckks_serial.serialize_public_key(ctx, pk))
        with open(os.path.join(self.cryptodir, _SK_FILE), "wb") as f:
            f.write(ckks_serial.serialize_secret_key(ctx, sk))
        return 1

    def loadCryptoParams(self) -> None:
        """Load persisted context + keys (ckks.cpp:11-23)."""
        with open(os.path.join(self.cryptodir, _CTX_FILE)) as f:
            meta = json.load(f)
        if (meta["batchSize"] != self.batchSize
                or meta["scaleFactorBits"] != self.scaleFactorBits):
            raise ValueError("persisted crypto context does not match "
                             "constructor parameters")
        with open(os.path.join(self.cryptodir, _PK_FILE), "rb") as f:
            self._pk = ckks_serial.deserialize_public_key(f.read(),
                                                          self.device)
        with open(os.path.join(self.cryptodir, _SK_FILE), "rb") as f:
            self._sk = ckks_serial.deserialize_secret_key(f.read(),
                                                          self.device)

    def load_or_gen(self) -> None:
        try:
            self.loadCryptoParams()
        except (FileNotFoundError, ValueError):
            self.genCryptoContextAndKeyGen()

    def _next_key(self) -> torch.Tensor:
        self._rng, k = prng_mod.split(self._rng).unbind(0)
        return k

    # -- data path ---------------------------------------------------------

    def _pack(self, flat: np.ndarray):
        """flat (size,) -> (chunks, N) f32 on the device, zeros in unused
        positions. In slot mode: (chunks, N/2) f64 host slots."""
        return self._pack_cohort([flat])[0]

    @traced("fhe.unpack")
    def _unpack(self, vals, dims: int) -> np.ndarray:
        if torch.is_tensor(vals):
            vals = vals.cpu().numpy()
        cap = self.capacity
        return vals[:, :cap].reshape(-1)[:dims].astype(np.float64)

    def encrypt(self, data_array) -> bytes:
        """Flat float vector -> ciphertext bytes (ckks.cpp:61-104)."""
        if self._pk is None:
            raise RuntimeError("call loadCryptoParams() or "
                               "genCryptoContextAndKeyGen() first")
        flat = np.asarray(data_array).reshape(-1)
        if self.packing == "slots":
            pt = ckks_slots.encode_slots(self.ctx, self._pack(flat))
            ct = ckks_ops.encrypt_encoded(self.ctx, self._pk, pt,
                                          self._next_key(),
                                          self._params.scale)
            return ckks_serial.serialize_ct(self.ctx, ct, packing="slots")
        if self.seeded_fresh and self._sk is not None:
            sct = ckks_ops.encrypt_symmetric_seeded(
                self.ctx, self._sk, self._pack(flat), self._next_key())
            return ckks_serial.serialize_seeded_ct(self.ctx, sct)
        if self.symmetric and self._sk is not None:
            ct = ckks_ops.encrypt_symmetric(self.ctx, self._sk,
                                            self._pack(flat), self._next_key())
        else:
            ct = ckks_ops.encrypt(self.ctx, self._pk, self._pack(flat),
                                  self._next_key())
        return ckks_serial.serialize_ct(self.ctx, ct)

    def computeWeightedAverage(self, learner_data: list[bytes],
                               scaling_factors: list[float]) -> bytes:
        """Fused encrypted weighted average (ckks.cpp:264-320)."""
        if len(learner_data) != len(scaling_factors):
            raise ValueError(
                "Error: learner_data and scaling_factors size mismatch")
        cts = [ckks_serial.deserialize_any_ct(self.ctx, b,
                                              packing=self.packing)
               for b in learner_data]
        agg = ckks_ops.weighted_sum(self.ctx, cts,
                                    [float(s) for s in scaling_factors])
        return ckks_serial.serialize_ct(self.ctx, agg,
                                        packing=self.packing)

    def decrypt(self, learner_data: bytes, data_dimensions: int) -> np.ndarray:
        """Decrypt ciphertext bytes -> float64 vector of `data_dimensions`
        (ckks.cpp:170-213 incl. tail-length rule)."""
        if self._sk is None:
            raise RuntimeError("call loadCryptoParams() first")
        ct = ckks_serial.deserialize_ct(self.ctx, learner_data,
                                        packing=self.packing)
        if self.packing == "slots":
            res = ckks_ops.decrypt_residues(self.ctx, self._sk, ct)
            z = ckks_slots.decode_slots(self.ctx, res, ct.scale)
            return z.real.reshape(-1)[:int(data_dimensions)]
        return self._unpack(ckks_ops.decrypt(self.ctx, self._sk, ct),
                            int(data_dimensions))

    # -- cohort fast path ----------------------------------------------------
    #
    # The bytes methods above are the wire-parity surface (one blob per
    # client). The cohort path keeps the round on the device: one call
    # encrypts all K clients, one weighted sum (kernel K3), one decrypt.

    @traced("fhe.pack")
    def _pack_cohort(self, client_vectors):
        """K flat vectors (same size) -> (K, chunks, N) f32 on the device
        (slot mode: (K, chunks, N/2) f64 on the host)."""
        cap = self.capacity
        flats = [np.asarray(v).reshape(-1) for v in client_vectors]
        size = flats[0].size
        if any(f.size != size for f in flats):
            raise ValueError("cohort sizes differ")
        chunks = max(1, -(-size // cap))
        if self.packing == "slots":
            buf = np.zeros((len(flats), chunks, cap), dtype=np.float64)
            for i, f in enumerate(flats):
                buf[i].reshape(-1)[:size] = f
            return buf
        n = self._params.ring_dim
        buf = np.zeros((len(flats), chunks, n), dtype=np.float32)
        pay = np.zeros((len(flats), chunks * cap), dtype=np.float32)
        for i, f in enumerate(flats):
            pay[i, :size] = f
        buf[:, :, :cap] = pay.reshape(len(flats), chunks, cap)
        return torch.as_tensor(buf, device=self.device)

    def pack_cohort(self, client_vectors) -> torch.Tensor:
        """Stage K clients' flat vectors on the device as (K, chunks, N)
        f32."""
        return self._pack_cohort(client_vectors)

    @staticmethod
    def _is_packed(client_vectors) -> bool:
        return torch.is_tensor(client_vectors) and client_vectors.dim() == 3

    def encrypt_cohort(self, client_vectors) -> ckks_ops.Ciphertext:
        """Encrypt all K clients' flat vectors in one call. Takes a list of
        host vectors or a pack_cohort() tensor; returns a stacked
        Ciphertext (K, chunks, 2, L, N) on the device."""
        if self._pk is None and self._sk is None:
            raise RuntimeError("call loadCryptoParams() or "
                               "genCryptoContextAndKeyGen() first")
        if self.packing == "slots":
            raise ValueError(
                "the cohort fast path is coefficient-packed; slot packing "
                "serves the reference-parity bytes surface "
                "(encrypt/computeWeightedAverage/decrypt)")
        stacked = (client_vectors if self._is_packed(client_vectors)
                   else self._pack_cohort(client_vectors))
        if self.symmetric and self._sk is not None:
            return ckks_ops.encrypt_symmetric_stacked(
                self.ctx, self._sk, stacked, self._next_key())
        return ckks_ops.encrypt_stacked(self.ctx, self._pk, stacked,
                                        self._next_key())

    def aggregate_cohort(self, cohort_ct: ckks_ops.Ciphertext,
                         scaling_factors: list[float]) -> ckks_ops.Ciphertext:
        """Encrypted weighted average of a stacked cohort ciphertext."""
        return ckks_ops.weighted_sum(self.ctx, cohort_ct,
                                     [float(s) for s in scaling_factors])

    def decrypt_cohort(self, ct: ckks_ops.Ciphertext,
                       data_dimensions: int | None = None, *,
                       raw: bool = False):
        """Decrypt a ciphertext on the device. raw=True returns the decoded
        (chunks, N) f32 tensor still on the device; otherwise the unpacked
        flat f64 np.ndarray of length data_dimensions."""
        if self._sk is None:
            raise RuntimeError("call loadCryptoParams() first")
        dev = ckks_ops.decrypt(self.ctx, self._sk, ct)
        if raw:
            return dev
        return self._unpack(dev, int(data_dimensions))

    def unpack_values(self, dev_values, data_dimensions: int) -> np.ndarray:
        """Host fetch + payload unpack of a raw decrypt_cohort result."""
        return self._unpack(dev_values, int(data_dimensions))

    def ct_wire_bytes(self, ct: ckks_ops.Ciphertext,
                      per_client: bool = False) -> int:
        """Serialized size of `ct` without building the bytes. For a stacked
        cohort ct, per_client=True reports one client's upload."""
        data = ct.data
        nbytes = data.numel() * data.element_size()
        if data.dim() == 5:
            k = data.shape[0]
            one = nbytes // k + ckks_serial.CT_HEADER_BYTES
            return one if per_client else k * one
        return nbytes + ckks_serial.CT_HEADER_BYTES

    def _round_slice(self, packed: torch.Tensor, scaling_factors,
                     fused: bool) -> torch.Tensor:
        """encrypt -> aggregate -> decrypt of one (K, chunks, N) slice;
        fused=True runs ops.fedavg_round_fused (secret-key mode only; the
        public-key mode always stages)."""
        if fused and self.symmetric and self._sk is not None:
            return ckks_ops.fedavg_round_fused(
                self.ctx, self._sk, packed, self._next_key(),
                [float(s) for s in scaling_factors])
        ct = self.encrypt_cohort(packed)
        agg = self.aggregate_cohort(ct, scaling_factors)
        return self.decrypt_cohort(agg, raw=True)

    def _pack_tensor(self, x: torch.Tensor, chunks: int) -> torch.Tensor:
        """(K, E) values -> (K, chunks, N) f32 on the helper's device, as
        _pack_cohort packs them: each row's payload in the first `capacity`
        positions of its chunks, zeros elsewhere (`chunks` may exceed
        ceil(E / capacity): the padding to whole slices)."""
        x = x.to(self.device, torch.float32)
        k, size = x.shape
        n, cap = self._params.ring_dim, self.capacity
        buf = torch.zeros((k, chunks, n), dtype=torch.float32,
                          device=self.device)
        if cap == n:
            buf.view(k, -1)[:, :size] = x
            return buf
        full, tail = divmod(size, cap)
        buf[:, :full, :cap] = x[:, :full * cap].reshape(k, full, cap)
        if tail:
            buf[:, full, :tail] = x[:, full * cap:]
        return buf

    def fedavg_round(self, client_vectors, scaling_factors,
                     data_dimensions: int | None = None,
                     max_chunks: int | None = 1024,
                     fused: bool = True):
        """One full secure-FedAvg round on the device.

        client_vectors: K host vectors (or a pack_cohort() tensor), whose
        average comes back as a float64 ndarray; or a (K, E) tensor, packed
        on the helper's device where it lies, whose average comes back as
        an (E,) float32 tensor on that device (the same values: the host
        path's widening to float64 is exact). data_dimensions defaults to
        a vector's size.

        max_chunks bounds device memory for large models: the chunk axis
        is padded to a multiple of max_chunks and streamed slice by slice
        through encrypt -> aggregate -> decrypt. Pass None for one slice."""
        if self.packing == "slots":
            raise ValueError(
                "fedavg_round is coefficient-packed; slot packing serves "
                "the reference-parity bytes surface")
        if torch.is_tensor(client_vectors) and client_vectors.dim() == 2:
            return self._fedavg_round_tensor(client_vectors, scaling_factors,
                                             data_dimensions, max_chunks,
                                             fused)
        staging["host"] += 1
        with span("fhe.pack"):
            packed = (client_vectors if self._is_packed(client_vectors)
                      else self._pack_cohort(client_vectors))
            dims = (int(data_dimensions) if data_dimensions is not None
                    else packed[0].numel() if packed is client_vectors
                    else int(np.asarray(client_vectors[0]).size))
            chunks = packed.shape[1]
            padded, step = _slicing(chunks, max_chunks)
            if padded > chunks:
                packed = torch.cat([packed, packed.new_zeros(
                    (packed.shape[0], padded - chunks, packed.shape[2]))],
                    dim=1)
        if padded == step:
            with span("fhe.slice"):
                out = self._round_slice(packed, scaling_factors, fused)
            return self._unpack(out, dims)
        outs = []
        for s in range(0, padded, step):
            with span("fhe.slice"):
                outs.append(self._round_slice(packed[:, s:s + step],
                                              scaling_factors, fused).cpu())
        with span("fhe.unpack"):
            return self._unpack(torch.cat(outs), dims)

    def _fedavg_round_tensor(self, x: torch.Tensor, scaling_factors,
                             data_dimensions, max_chunks, fused):
        """fedavg_round of a (K, E) tensor, packed, streamed and unpacked
        on the helper's device: the host path's slices and key draws, with
        no copy to the host."""
        staging["device"] += 1
        with span("fhe.pack"):
            dims = (int(data_dimensions) if data_dimensions is not None
                    else x.shape[1])
            padded, step = _slicing(max(1, -(-x.shape[1] // self.capacity)),
                                    max_chunks)
            packed = self._pack_tensor(x, padded)
        if padded == step:
            with span("fhe.slice"):
                out = self._round_slice(packed, scaling_factors, fused)
        else:
            out = torch.empty(packed.shape[1:], dtype=torch.float32,
                              device=self.device)
            for s in range(0, padded, step):
                with span("fhe.slice"):
                    out[s:s + step] = self._round_slice(
                        packed[:, s:s + step], scaling_factors, fused)
        with span("fhe.unpack"):
            return out[:, :self.capacity].reshape(-1)[:dims]
