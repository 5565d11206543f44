"""Wire formats, byte-identical to fhe_fed_tpu.ckks.serial.

Ciphertext (FFTC coefficient-packed, FFTP slot-packed):
  magic | ver u16 | ring_dim u32 | batch u32 | scale_bits u16 |
  chunks u32 | live u32 | level u16 | scale f64 | payload u32[chunks*2*live*N]
Seed-compressed fresh ciphertext (FFTS): the same header, then the seed
  u32[4] and c0 u32[chunks*live*N] (c1 is expanded from the seed).
Keys (FFTK): magic | ver u16 | kind u8 (0 secret, 1 public) | ring_dim u32 |
  L u32 | count u32 | count arrays of u32[L*N].

Residues are non-negative int32 and Shoup words int64 in memory; on the
wire both are little-endian u32.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import cuda_lib
from ..utils.spans import traced
from .params import CkksContext
from .keys import SecretKey, PublicKey
from .ops import Ciphertext, SeededCiphertext, expand_seeded

_CT_MAGIC = b"FFTC"       # coefficient-packed ciphertext
_CTP_MAGIC = b"FFTP"      # slot-packed (canonical embedding) ciphertext
_SCT_MAGIC = b"FFTS"      # seed-compressed fresh ciphertext
_KEY_MAGIC = b"FFTK"
_VER = 1
_CT_HDR = struct.Struct("<4sHIIHIIHd")
_KEY_HDR = struct.Struct("<4sHBIII")

CT_HEADER_BYTES = _CT_HDR.size


def _u32_bytes(t: torch.Tensor) -> bytes:
    return np.ascontiguousarray(t.cpu().numpy(), dtype="<u4").tobytes()


def _ct_header(ctx: CkksContext, magic: bytes, chunks: int, live: int,
               level: int, scale: float) -> bytes:
    return _CT_HDR.pack(magic, _VER, ctx.ring_dim, ctx.params.batch,
                        ctx.params.scale_bits, chunks, live, level,
                        float(scale))


def _check_params(ctx: CkksContext, ring_dim: int, scale_bits: int) -> None:
    if ring_dim != ctx.ring_dim or scale_bits != ctx.params.scale_bits:
        raise ValueError(
            f"ciphertext params (N={ring_dim}, sb={scale_bits}) do not match "
            f"context (N={ctx.ring_dim}, sb={ctx.params.scale_bits})")


def _residues(blob: bytes, offset: int, shape, device) -> torch.Tensor:
    arr = np.frombuffer(blob, dtype="<u4", offset=offset,
                        count=int(np.prod(shape)))
    return torch.as_tensor(arr.astype(np.int32).reshape(shape), device=device)


@traced("fhe.serialize")
def serialize_ct(ctx: CkksContext, ct: Ciphertext,
                 packing: str = "coeff") -> bytes:
    """(chunks, 2, live, N) ciphertext -> FFTC bytes, or FFTP bytes with
    packing="slots", so a consumer of the other packing cannot silently
    mis-decode the blob."""
    chunks, two, live, _ = ct.data.shape
    if two != 2:
        raise ValueError("serialize_ct expects (chunks, 2, live, N) data")
    magic = _CTP_MAGIC if packing == "slots" else _CT_MAGIC
    return (_ct_header(ctx, magic, chunks, live, ct.level, ct.scale)
            + _u32_bytes(ct.data))


@traced("fhe.deserialize")
def deserialize_ct(ctx: CkksContext, blob: bytes,
                   packing: str = "coeff") -> Ciphertext:
    magic, ver, ring_dim, _batch, scale_bits, chunks, live, level, scale = \
        _CT_HDR.unpack_from(blob, 0)
    want = _CTP_MAGIC if packing == "slots" else _CT_MAGIC
    if magic in (_CT_MAGIC, _CTP_MAGIC) and magic != want:
        raise ValueError(
            "ciphertext packing mismatch: blob is "
            f"{'slot' if magic == _CTP_MAGIC else 'coefficient'}-packed "
            f"but this helper decodes {packing!r}")
    if magic != want or ver != _VER:
        raise ValueError("not a fhe_fed_tpu ciphertext blob")
    _check_params(ctx, ring_dim, scale_bits)
    data = _residues(blob, _CT_HDR.size, (chunks, 2, live, ring_dim),
                     ctx.device)
    return Ciphertext(data=data, scale=scale, level=level)


@traced("fhe.serialize")
def serialize_seeded_ct(ctx: CkksContext, sct: SeededCiphertext) -> bytes:
    """header | seed u32[4] | c0 payload: about half of serialize_ct."""
    chunks, live, _ = sct.c0.shape
    return (_ct_header(ctx, _SCT_MAGIC, chunks, live, sct.level, sct.scale)
            + _u32_bytes(sct.seed) + _u32_bytes(sct.c0))


@traced("fhe.deserialize")
def deserialize_seeded_ct(ctx: CkksContext, blob: bytes) -> SeededCiphertext:
    magic, ver, ring_dim, _batch, scale_bits, chunks, live, level, scale = \
        _CT_HDR.unpack_from(blob, 0)
    if magic != _SCT_MAGIC or ver != _VER:
        raise ValueError("not a fhe_fed_tpu seeded-ciphertext blob")
    _check_params(ctx, ring_dim, scale_bits)
    seed = np.frombuffer(blob, dtype="<u4", offset=_CT_HDR.size, count=4)
    c0 = _residues(blob, _CT_HDR.size + 16, (chunks, live, ring_dim),
                   ctx.device)
    return SeededCiphertext(
        c0=c0, seed=torch.as_tensor(seed.astype(np.int64), device=ctx.device),
        scale=scale, level=level)


def deserialize_any_ct(ctx: CkksContext, blob: bytes,
                       packing: str = "coeff") -> Ciphertext:
    """Dispatch on magic: full ciphertexts pass through, seed-compressed
    fresh ciphertexts are expanded to (c0, c1) here. A seeded blob is
    always coefficient-packed, so a slot-mode consumer refuses it before
    expanding (the JAX package's deserialize_any_ct expands first and lets
    a slot-mode server mis-aggregate it)."""
    if blob[:4] == _SCT_MAGIC:
        if packing != "coeff":
            raise ValueError(
                "ciphertext packing mismatch: a seed-compressed blob is "
                f"coefficient-packed but this helper decodes {packing!r}")
        return expand_seeded(ctx, deserialize_seeded_ct(ctx, blob))
    return deserialize_ct(ctx, blob, packing=packing)


def _pack_key_arrays(kind: int, ring_dim: int, arrays) -> bytes:
    hdr = _KEY_HDR.pack(_KEY_MAGIC, _VER, kind, ring_dim,
                        arrays[0].shape[0], len(arrays))
    return hdr + b"".join(_u32_bytes(a) for a in arrays)


def _unpack_key_arrays(blob: bytes, want_kind: int):
    magic, ver, kind, _ring_dim, L, count = _KEY_HDR.unpack_from(blob, 0)
    if magic != _KEY_MAGIC or ver != _VER or kind != want_kind:
        raise ValueError("not a matching fhe_fed_tpu key blob")
    flat = np.frombuffer(blob, dtype="<u4", offset=_KEY_HDR.size)
    n = flat.size // (count * L)
    return [a.reshape(L, n) for a in np.split(flat, count)]


def _res(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int32), device=device)


def _shoup(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64), device=device)


def serialize_secret_key(ctx: CkksContext, sk: SecretKey) -> bytes:
    return _pack_key_arrays(0, ctx.ring_dim, [sk.s, sk.s_shoup])


def deserialize_secret_key(blob: bytes,
                           device: torch.device | str = "cuda") -> SecretKey:
    device = cuda_lib.device(device)
    s, s_shoup = _unpack_key_arrays(blob, 0)
    return SecretKey(s=_res(s, device), s_shoup=_shoup(s_shoup, device))


def serialize_public_key(ctx: CkksContext, pk: PublicKey) -> bytes:
    return _pack_key_arrays(
        1, ctx.ring_dim, [pk.p0, pk.p0_shoup, pk.p1, pk.p1_shoup])


def deserialize_public_key(blob: bytes,
                           device: torch.device | str = "cuda") -> PublicKey:
    device = cuda_lib.device(device)
    p0, p0s, p1, p1s = _unpack_key_arrays(blob, 1)
    return PublicKey(p0=_res(p0, device), p0_shoup=_shoup(p0s, device),
                     p1=_res(p1, device), p1_shoup=_shoup(p1s, device))
