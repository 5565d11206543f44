"""Wrapper of kernel K1 (csrc/ntt_mxu.cu): the fused four-step digit-plane
NTT on the GPU's int8 tensor cores.

The counterpart of fhe_fed_tpu/ntt/mxu_pallas.py: the same drop-in
semantics as the butterfly ntt / intt (bit-reversed evaluation order) and
the same tables, bit-identical to mxu.ntt_mxu / mxu.intt_mxu, its plain
version. CUDA tensors only: the dispatch in ntt/ntt.py sends CPU tensors
to the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib
from .mxu import MxuNttTables

_MAX_LIMBS = 16


def _call(x: torch.Tensor, mt: MxuNttTables, forward: bool) -> torch.Tensor:
    name = "ntt_mxu_fused" if forward else "intt_mxu_fused"
    cuda_lib.require_cuda(x, name, torch.int32)
    L, n = x.shape[-2], x.shape[-1]
    n1, n2 = mt.n1, mt.n2
    if n != mt.ring_dim or L != mt.num_limbs:
        raise ValueError(f"{name}: input {tuple(x.shape)} does not match "
                         f"tables (L={mt.num_limbs}, N={mt.ring_dim})")
    if not (L <= _MAX_LIMBS and n1 % 16 == 0 and n2 % 16 == 0
            and max(n1, n2) <= 128):
        raise ValueError(f"{name}: unsupported split N={n} = {n1} x {n2} "
                         f"or L={L} > {_MAX_LIMBS}")
    w1 = mt.r1f_nk if forward else mt.r1i_nk
    w2 = mt.r2f_nk if forward else mt.r2i_nk
    mid = mt.midf if forward else mt.midi
    mids = mt.midf_shoup if forward else mt.midi_shoup
    for t, dt in ((w1, torch.int8), (w2, torch.int8), (mid, torch.int32),
                  (mids, torch.int64)):
        cuda_lib.require_cuda(t, name, dt)
        if t.device != x.device:
            raise ValueError(f"{name}: tables on {t.device}, input on "
                             f"{x.device}")
    consts = np.zeros((4, _MAX_LIMBS), dtype=np.uint32)
    for row, v in enumerate((mt.q, mt.c32, mt.c32_shoup, mt.offm)):
        consts[row, :L] = v
    B = x.numel() // (L * n)
    out = torch.empty_like(x)
    if B == 0:
        return out
    err = cuda_lib.lib().fhe_ntt_mxu(
        out.data_ptr(), x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        mid.data_ptr(), mids.data_ptr(),
        consts.ctypes.data_as(ctypes.c_void_p),
        B, L, n1, n2, int(forward), cuda_lib.stream_ptr(x))
    cuda_lib.check(err, name)
    cuda_lib.launches[name] += 1
    return out


def ntt_mxu_fused(x: torch.Tensor, mt: MxuNttTables) -> torch.Tensor:
    """Forward NTT of int32 residues (..., L, N) on the GPU."""
    return _call(x, mt, True)


def intt_mxu_fused(x: torch.Tensor, mt: MxuNttTables) -> torch.Tensor:
    """Inverse NTT of int32 residues (..., L, N) on the GPU, exactly scaled."""
    return _call(x, mt, False)
