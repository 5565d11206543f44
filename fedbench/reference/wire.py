"""A frozen copy of the wire formats the benchmark reads and writes.

Ciphertext (FFTC, coefficient-packed):
  magic | ver u16 | ring_dim u32 | batch u32 | scale_bits u16 |
  chunks u32 | live u32 | level u16 | scale f64 | payload u32[chunks*2*live*N]
Keys (FFTK): magic | ver u16 | kind u8 (0 secret, 1 public) | ring_dim u32 |
  L u32 | count u32 | count arrays of u32[L*N].
A cryptodir holds cryptocontext.txt (JSON), key-public.txt, key-private.txt.
All little-endian. Kept here so that a change to the program's formats
cannot change what the benchmark checks.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

CT_MAGIC = b"FFTC"
KEY_MAGIC = b"FFTK"
VERSION = 1
CT_HDR = struct.Struct("<4sHIIHIIHd")
KEY_HDR = struct.Struct("<4sHBIII")
CTX_FILE = "cryptocontext.txt"
PK_FILE = "key-public.txt"
SK_FILE = "key-private.txt"


def _u32(t: torch.Tensor) -> bytes:
    return np.ascontiguousarray(t.numpy(), dtype="<u4").tobytes()


def context_json(meta: dict) -> bytes:
    return json.dumps(meta).encode()


def pack_key(kind: int, ring_dim: int, arrays) -> bytes:
    """FFTK bytes of `arrays`, each (L, N) residues or Shoup words."""
    hdr = KEY_HDR.pack(KEY_MAGIC, VERSION, kind, ring_dim,
                       arrays[0].shape[0], len(arrays))
    return hdr + b"".join(_u32(a) for a in arrays)


def pack_ct(crypto: dict, chunks: int, live: int, level: int, scale: float,
            data: torch.Tensor) -> bytes:
    """FFTC bytes of (chunks, 2, live, N) int32 residues."""
    return CT_HDR.pack(CT_MAGIC, VERSION, crypto["ring_dim"], crypto["batch"],
                       crypto["scale_bits"], chunks, live, level,
                       float(scale)) + _u32(data)


def parse_ct(blob: bytes):
    """FFTC bytes -> (header dict, (chunks, 2, live, N) int32 residues, or
    None where the payload's length does not match the header)."""
    magic, ver, ring_dim, batch, scale_bits, chunks, live, level, scale = \
        CT_HDR.unpack_from(blob, 0)
    hdr = dict(magic=magic, version=ver, ring_dim=ring_dim, batch=batch,
               scale_bits=scale_bits, chunks=chunks, live=live, level=level,
               scale=scale, length=len(blob))
    count = chunks * 2 * live * ring_dim
    if len(blob) != CT_HDR.size + 4 * count:
        return hdr, None
    arr = np.frombuffer(blob, dtype="<u4", offset=CT_HDR.size, count=count)
    return hdr, torch.as_tensor(arr.astype(np.int64).reshape(
        chunks, 2, live, ring_dim))
