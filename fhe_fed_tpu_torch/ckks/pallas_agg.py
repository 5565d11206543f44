"""Wrapper of kernel K3 (csrc/weighted_sum.cu): the encrypted FedAvg
weighted sum, reading each client's ciphertext once. The counterpart of
fhe_fed_tpu/ckks/pallas_agg.py; bit-identical to both lowerings of
ops._weighted_sum_impl, its plain version.

CUDA tensors only: ops.weighted_sum sends CPU tensors to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib

MAX_CLIENTS = 65536       # as ops.modsum_clients, the plain version
MAX_LIVE = 32             # kMaxLive: make_params reaches 27 live limbs
PARAM_PAIRS = 384         # kParamPairs: K * live pairs passed by value


def weight_block(w_res: np.ndarray, w_shoup: np.ndarray,
                 moduli) -> np.ndarray:
    """The host block K3 reads, built once per set of weights: uint32
    [the live moduli | (K, live, 2) pairs of the weight and the low 32 bits
    of its Shoup word]."""
    w_res = np.asarray(w_res)
    w_shoup = np.asarray(w_shoup)
    if w_res.ndim != 2 or w_shoup.shape != w_res.shape:
        raise ValueError("weight_block: weights must be (K, live)")
    K, live = w_res.shape
    if len(moduli) != live:
        raise ValueError(f"weight_block: {len(moduli)} moduli for "
                         f"live={live}")
    block = np.empty(live + 2 * K * live, dtype=np.uint32)
    block[:live] = moduli
    pairs = block[live:].reshape(K, live, 2)
    pairs[..., 0] = w_res
    pairs[..., 1] = w_shoup
    return block


def weighted_sum_fused(stacked: torch.Tensor,
                       block: np.ndarray) -> torch.Tensor:
    """stacked: (K, chunks, 2, live, N) int32 on the GPU; block: its
    weight_block. Returns (chunks, 2, live, N) int32, the weighted sum mod
    q."""
    cuda_lib.require_cuda(stacked, "weighted_sum_fused", torch.int32)
    if stacked.dim() != 5 or stacked.shape[2] != 2:
        raise ValueError("weighted_sum_fused: expected (K, chunks, 2, live, "
                         f"N), got {tuple(stacked.shape)}")
    K, chunks, _, live, n = stacked.shape
    if not 1 <= K <= MAX_CLIENTS:
        raise ValueError(f"weighted_sum_fused: K={K} clients, the kernel "
                         f"takes 1..{MAX_CLIENTS}")
    if live > MAX_LIVE or n % 4:
        raise ValueError(f"weighted_sum_fused: live={live}, N={n} unsupported"
                         f" (live <= {MAX_LIVE}, N % 4 == 0)")
    if block.dtype != np.uint32 or block.shape != (live + 2 * K * live,):
        raise ValueError("weighted_sum_fused: block is not the weight_block "
                         f"of K={K}, live={live}")
    out = torch.empty(stacked.shape[1:], dtype=torch.int32,
                      device=stacked.device)
    if out.numel() == 0:
        return out
    wdev = None
    if K * live > PARAM_PAIRS:
        # Too many pairs for the parameter block: a device copy, staged
        # from pinned memory on the launch stream.
        wdev = torch.from_numpy(block[live:].view(np.int32)).pin_memory().to(
            stacked.device, non_blocking=True)
    err = cuda_lib.lib().fhe_weighted_sum(
        out.data_ptr(), stacked.data_ptr(),
        None if wdev is None else wdev.data_ptr(),
        block.ctypes.data, K, live, n,
        chunks * 2 * live, cuda_lib.stream_ptr(stacked))
    cuda_lib.check(err, "weighted_sum_fused")
    cuda_lib.launches["weighted_sum_fused"] += 1
    return out
