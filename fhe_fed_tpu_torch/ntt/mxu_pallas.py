"""Wrapper of kernel K1 (csrc/ntt_mxu.cu): the fused four-step digit-plane
NTT on the GPU's int8 tensor cores.

The counterpart of fhe_fed_tpu/ntt/mxu_pallas.py: the same drop-in
semantics as the butterfly ntt / intt (bit-reversed evaluation order) and
the same tables, bit-identical to mxu.ntt_mxu / mxu.intt_mxu, its plain
version. CUDA tensors only: the dispatch in ntt/ntt.py sends CPU tensors
to the plain version.

The kernel has two bodies, chosen by shape alone (mxu.body_for, which also
fixes the layout of the tables K1 reads): the wgmma body where both local
DFT sizes are at least 64 (one warpgroup's 64-row tile; N = 4096, 8192,
16384), the mma.sync body for the smaller rings. Both are exact for every
modulus q < 2**31.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib
from .mxu import MxuNttTables

_MAX_LIMBS = 32          # kMaxLimbs: make_params reaches 28 moduli


def operands(mt: MxuNttTables, forward: bool):
    """What K1's body for this ring reads, in its C entry's order: the
    device tables, their dtypes, and the per-limb constants (host uint32
    (4, 32): q, 2^32 mod q, its Shoup word, the plane offset mod q)."""
    if mt.body == "wgmma":
        tabs = ((mt.w1f, mt.w2f, mt.midf_pair) if forward
                else (mt.w1i, mt.w2i, mt.midi_pair))
        dts = (torch.int8, torch.int8, torch.int32)
    else:
        tabs = ((mt.w1f, mt.w2f, mt.midf, mt.midf_shoup) if forward
                else (mt.w1i, mt.w2i, mt.midi, mt.midi_shoup))
        dts = (torch.int8, torch.int8, torch.int32, torch.int64)
    consts = np.zeros((4, _MAX_LIMBS), dtype=np.uint32)
    for row, v in enumerate((mt.q, mt.c32, mt.c32_shoup, mt.offm)):
        consts[row, :mt.num_limbs] = v
    return tabs, dts, consts


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
    tabs, dts, consts = operands(mt, forward)
    for t, dt in zip(tabs, dts):
        cuda_lib.require_cuda(t, name, dt)
        if t.device != x.device:
            raise ValueError(f"{name}: tables on {t.device}, input on "
                             f"{x.device}")
    B = x.numel() // (L * n)
    out = torch.empty_like(x)
    if B == 0:
        return out
    entry = (cuda_lib.lib().fhe_ntt_mxu_wg if mt.body == "wgmma"
             else cuda_lib.lib().fhe_ntt_mxu_sync)
    err = entry(out.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in tabs),
                consts.ctypes.data_as(ctypes.c_void_p),
                B, L, n1, n2, int(forward), cuda_lib.stream_ptr(x))
    cuda_lib.check(err, name)
    cuda_lib.launches[name] += 1
    cuda_lib.launches[f"{name}.{mt.body}"] += 1
    return out


def ntt_mxu_fused(x: torch.Tensor, mt: MxuNttTables) -> torch.Tensor:
    """Forward NTT of int32 residues (..., L, N) on the GPU."""
    return _call(x, mt, True)


def intt_mxu_fused(x: torch.Tensor, mt: MxuNttTables) -> torch.Tensor:
    """Inverse NTT of int32 residues (..., L, N) on the GPU, exactly
    scaled."""
    return _call(x, mt, False)
