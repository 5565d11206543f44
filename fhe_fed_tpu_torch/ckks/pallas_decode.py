"""Wrapper of kernel K4 (csrc/decode_crt.cu): the exact-CRT decode, one
thread per coefficient, bit-identical to encoding.decode_core (its plain
version). The counterpart of fhe_fed_tpu/ckks/pallas_decode.py.

CUDA tensors only: encoding.decode_coeff sends CPU tensors to decode_core.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import cuda_lib
from ..utils import dfloat
from .params import CkksContext, DecodeConsts, DIGIT_BITS

_MAX_LIVE = 8
_MAX_DIG = 20


def _kernel_consts(ctx: CkksContext, dc: DecodeConsts,
                   scale: float) -> np.ndarray:
    """The kernel's DecConsts struct as 256 host uint32 words."""
    live, nd = dc.live, dc.ndig
    if not (1 <= live <= _MAX_LIVE and nd <= _MAX_DIG):
        raise ValueError(f"decode_fused: live={live}, ndig={nd} unsupported")
    e = math.floor(math.log2(scale))
    ex = DIGIT_BITS * np.arange(_MAX_DIG) - e
    use = ex <= 127
    tw = np.array([np.float32(2.0 ** int(v)) if u else 0.0
                   for v, u in zip(ex, use)], dtype=np.float32)
    mdig = np.zeros((_MAX_LIVE, _MAX_DIG), dtype=np.uint32)
    mdig[:live, :nd] = dc.m_digits
    qdig = np.zeros(_MAX_DIG, dtype=np.uint32)
    qdig[:nd] = dc.q_digits

    def pad(a, dtype=np.uint32):
        out = np.zeros(_MAX_LIVE, dtype=dtype)
        out[:live] = a
        return out.view(np.uint32)

    words = np.concatenate([
        np.array([live, nd], dtype=np.uint32),
        pad(ctx.params.moduli[:live]), pad(dc.punc_inv),
        pad(dc.punc_inv_shoup), pad(dc.inv_q_f32, np.float32),
        mdig.ravel(), qdig, tw.view(np.uint32), use.astype(np.uint32),
        np.array(dfloat.df_from_f64((2.0 ** e) / scale),
                 dtype=np.float32).view(np.uint32)])
    assert words.size == 256
    return words


def decode_fused(ctx: CkksContext, dc: DecodeConsts, residues: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """residues: (chunks, live, N) int32 on the GPU -> (chunks, N) f32."""
    cuda_lib.require_cuda(residues, "decode_fused", torch.int32)
    if residues.dim() != 3 or residues.shape[1] != dc.live:
        raise ValueError(f"decode_fused: expected (chunks, {dc.live}, N), "
                         f"got {tuple(residues.shape)}")
    chunks, _, n = residues.shape
    consts = _kernel_consts(ctx, dc, scale)
    out = torch.empty((chunks, n), dtype=torch.float32, device=residues.device)
    if out.numel() == 0:
        return out
    err = cuda_lib.lib().fhe_decode_crt(
        out.data_ptr(), residues.data_ptr(),
        consts.ctypes.data_as(ctypes.c_void_p), chunks, n,
        cuda_lib.stream_ptr(residues))
    cuda_lib.check(err, "decode_fused")
    cuda_lib.launches["decode_fused"] += 1
    return out
