"""Wire formats, byte-identical to fhe_fed_tpu.ckks.serial.

Ciphertext (FFTC):
  magic 'FFTC' | ver u16 | ring_dim u32 | batch u32 | scale_bits u16 |
  chunks u32 | live u32 | level u16 | scale f64 | payload u32[chunks*2*live*N]
Keys (FFTK): magic | ver u16 | kind u8 (0 secret, 1 public) | ring_dim u32 |
  L u32 | count u32 | count arrays of u32[L*N].

Residues are non-negative int32 and Shoup words int64 in memory; on the
wire both are little-endian u32. The slot-packed (FFTP) and seed-compressed
(FFTS) ciphertexts are not ported yet.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .params import CkksContext
from .keys import SecretKey, PublicKey
from .ops import Ciphertext

_CT_MAGIC = b"FFTC"
_CTP_MAGIC = b"FFTP"
_SCT_MAGIC = b"FFTS"
_KEY_MAGIC = b"FFTK"
_VER = 1
_CT_HDR = struct.Struct("<4sHIIHIIHd")
_KEY_HDR = struct.Struct("<4sHBIII")

CT_HEADER_BYTES = _CT_HDR.size


def _u32_bytes(t: torch.Tensor) -> bytes:
    return np.ascontiguousarray(t.cpu().numpy(), dtype="<u4").tobytes()


def _not_ported(magic: bytes):
    if magic in (_CTP_MAGIC, _SCT_MAGIC):
        raise NotImplementedError(
            f"{magic.decode()} ciphertexts (slot-packed / seed-compressed) "
            "are not ported yet")


def serialize_ct(ctx: CkksContext, ct: Ciphertext) -> bytes:
    """Coefficient-packed ciphertext (chunks, 2, live, N) -> FFTC bytes."""
    chunks, two, live, _ = ct.data.shape
    if two != 2:
        raise ValueError("serialize_ct expects (chunks, 2, live, N) data")
    hdr = _CT_HDR.pack(_CT_MAGIC, _VER, ctx.ring_dim, ctx.params.batch,
                       ctx.params.scale_bits, chunks, live, ct.level,
                       float(ct.scale))
    return hdr + _u32_bytes(ct.data)


def deserialize_ct(ctx: CkksContext, blob: bytes) -> Ciphertext:
    magic, ver, ring_dim, _batch, scale_bits, chunks, live, level, scale = \
        _CT_HDR.unpack_from(blob, 0)
    _not_ported(magic)
    if magic != _CT_MAGIC or ver != _VER:
        raise ValueError("not a fhe_fed_tpu ciphertext blob")
    if ring_dim != ctx.ring_dim or scale_bits != ctx.params.scale_bits:
        raise ValueError(
            f"ciphertext params (N={ring_dim}, sb={scale_bits}) do not match "
            f"context (N={ctx.ring_dim}, sb={ctx.params.scale_bits})")
    arr = np.frombuffer(blob, dtype="<u4", offset=_CT_HDR.size,
                        count=chunks * 2 * live * ring_dim)
    data = torch.as_tensor(arr.astype(np.int32).reshape(chunks, 2, live,
                                                        ring_dim),
                           device=ctx.device)
    return Ciphertext(data=data, scale=scale, level=level)


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
                           device: torch.device | str = "cpu") -> SecretKey:
    s, s_shoup = _unpack_key_arrays(blob, 0)
    return SecretKey(s=_res(s, device), s_shoup=_shoup(s_shoup, device))


def serialize_public_key(ctx: CkksContext, pk: PublicKey) -> bytes:
    return _pack_key_arrays(
        1, ctx.ring_dim, [pk.p0, pk.p0_shoup, pk.p1, pk.p1_shoup])


def deserialize_public_key(blob: bytes,
                           device: torch.device | str = "cpu") -> PublicKey:
    p0, p0s, p1, p1s = _unpack_key_arrays(blob, 1)
    return PublicKey(p0=_res(p0, device), p0_shoup=_shoup(p0s, device),
                     p1=_res(p1, device), p1_shoup=_shoup(p1s, device))
