"""Wrapper of kernel K3 (csrc/weighted_sum.cu): the encrypted FedAvg
weighted sum, reading each client's ciphertext once. The counterpart of
fhe_fed_tpu/ckks/pallas_agg.py; bit-identical to both lowerings of
ops._weighted_sum_impl, its plain version.

CUDA tensors only: ops.weighted_sum sends CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib

MAX_CLIENTS = 16
_MAX_LIMBS = 16


def weighted_sum_fused(stacked: torch.Tensor, w_res: np.ndarray,
                       w_shoup: np.ndarray, moduli) -> torch.Tensor:
    """stacked: (K, chunks, 2, live, N) int32 on the GPU; w_res, w_shoup:
    host (K, live) integer arrays; moduli: the live q_l. Returns
    (chunks, 2, live, N) int32, the weighted sum mod q."""
    cuda_lib.require_cuda(stacked, "weighted_sum_fused", torch.int32)
    if stacked.dim() != 5 or stacked.shape[2] != 2:
        raise ValueError("weighted_sum_fused: expected (K, chunks, 2, live, "
                         f"N), got {tuple(stacked.shape)}")
    K, chunks, _, live, n = stacked.shape
    w_res = np.asarray(w_res)
    w_shoup = np.asarray(w_shoup)
    if not 1 <= K <= MAX_CLIENTS:
        raise ValueError(f"weighted_sum_fused: K={K} clients, the kernel "
                         f"takes 1..{MAX_CLIENTS}")
    if live > _MAX_LIMBS or n % 4 or len(moduli) != live:
        raise ValueError(f"weighted_sum_fused: live={live}, N={n} unsupported")
    if w_res.shape != (K, live) or w_shoup.shape != (K, live):
        raise ValueError("weighted_sum_fused: weights must be (K, live)")
    consts = np.zeros((1 + 2 * MAX_CLIENTS, _MAX_LIMBS), dtype=np.uint32)
    consts[0, :live] = moduli
    consts[1:1 + K, :live] = w_res
    consts[1 + MAX_CLIENTS:1 + MAX_CLIENTS + K, :live] = w_shoup
    out = torch.empty(stacked.shape[1:], dtype=torch.int32,
                      device=stacked.device)
    per_client = out.numel()
    if per_client == 0:
        return out
    err = cuda_lib.lib().fhe_weighted_sum(
        out.data_ptr(), stacked.data_ptr(),
        consts.ctypes.data_as(ctypes.c_void_p), K, live, n, per_client,
        cuda_lib.stream_ptr(stacked))
    cuda_lib.check(err, "weighted_sum_fused")
    cuda_lib.launches["weighted_sum_fused"] += 1
    return out
