"""Wrapper of kernel K2 (csrc/ntt_butterfly.cu): the whole radix-2
butterfly NTT / iNTT in one pass, the polynomial held in shared memory.

The counterpart of fhe_fed_tpu/ntt/pallas_ntt.py (ntt_fused, intt_fused),
bit-identical to ntt.ntt_butterfly / ntt.intt_butterfly, its plain
version. It takes every power-of-two ring from 256 to 65536: up to 32768
a polynomial sits in one block's shared memory, at 65536 in two blocks of
one half each (a two-block cluster for the inverse); a larger ring raises.
CUDA tensors only: the dispatch in ntt/ntt.py sends CPU tensors to the
plain version. Host work per call is the checks and the ctypes call: the
launch constants are cached on the tables (NttTables.k2_consts, built
on a table's first call, and their address k2_consts_ptr) and the
kernel's shared-memory opt-in is made once per device.
"""

from __future__ import annotations

import torch

from .. import cuda_lib
from .tables import K2_MAX_LIMBS, NttTables

MIN_RING = 256
MAX_RING = 65536          # two blocks of 128 KB of int32 residues


def _call(x: torch.Tensor, tb: NttTables, forward: bool) -> torch.Tensor:
    name = "ntt_fused" if forward else "intt_fused"
    cuda_lib.require_cuda(x, name, torch.int32)
    L, n = x.shape[-2], x.shape[-1]
    if n != tb.ring_dim or L != tb.num_limbs:
        raise ValueError(f"{name}: input {tuple(x.shape)} does not match "
                         f"tables (L={tb.num_limbs}, N={tb.ring_dim})")
    if not MIN_RING <= n <= MAX_RING:
        raise ValueError(f"{name}: N={n} outside [{MIN_RING}, {MAX_RING}]: "
                         f"the kernel keeps the whole polynomial in the "
                         f"shared memory of at most two blocks, which hold "
                         f"N={MAX_RING}")
    if L > K2_MAX_LIMBS:
        raise ValueError(f"{name}: L={L} > {K2_MAX_LIMBS} limbs")
    tw = tb.tw_fwd if forward else tb.tw_inv
    cuda_lib.require_cuda(tw, name, torch.int32)
    if tw.device != x.device:
        raise ValueError(f"{name}: tables on {tw.device}, input on "
                         f"{x.device}")
    B = x.numel() // (L * n)
    out = torch.empty_like(x)
    if B == 0:
        return out
    err = cuda_lib.lib().fhe_ntt_butterfly(
        out.data_ptr(), x.data_ptr(), tw.data_ptr(),
        tb.k2_consts_ptr, B, L, n, int(forward),
        cuda_lib.stream_ptr(x))
    cuda_lib.check(err, name)
    cuda_lib.launches[name] += 1
    return out


def ntt_fused(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Forward NTT of int32 residues (..., L, N) on the GPU."""
    return _call(x, tb, True)


def intt_fused(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Inverse NTT of int32 residues (..., L, N) on the GPU, times N**-1."""
    return _call(x, tb, False)
