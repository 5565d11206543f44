"""Wrapper of kernel K4 (csrc/decode_crt.cu): the exact-CRT decode with
the digit-plane sum on the tensor cores, bit-identical to
encoding.decode_core (its plain version). The counterpart of
fhe_fed_tpu/ckks/pallas_decode.py.

The kernel reads one device block of constants per (limb count, scale),
built by `kernel_consts` once and kept in the context (decode_blocks), so
a call does no host work beyond its checks. CUDA tensors only:
encoding.decode_coeff sends CPU tensors to decode_core.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import cuda_lib
from ..utils import dfloat
from .params import CkksContext, DecodeConsts, DIGIT_BITS

MAX_LIVE = 27             # kMaxLive: the longest chain make_params accepts
HEADER = 8                # kHeader: live, ks, nt, du, c_hi, c_lo, words, 0


def dims(live: int) -> tuple[int, int, int]:
    """The kernel's Dims<live>: k-steps of 32 bytes, 8-column tiles, and
    the planes it computes (the most a chain of 31-bit primes needs,
    rounded up to a multiple of 4)."""
    ks = (4 * live + 31) // 32
    nt = ((31 * live + 15) // 16 + 2 + 3) // 4
    return ks, nt, 4 * nt


def fragments(m_bytes: np.ndarray, ks: int, nt: int) -> np.ndarray:
    """m_bytes zero-padded to (32 ks, 8 nt) and laid out as mma.sync
    m16n8k32 B fragments: (ks, nt, 32 lanes, 2) uint32, lane 4g + t holding
    rows 32s + 16r + 4t + (0..3) of column 8j + g in register r, byte i of
    the word from row ... + i."""
    b = np.zeros((32 * ks, 8 * nt), dtype=np.uint8)
    b[:m_bytes.shape[0], :m_bytes.shape[1]] = m_bytes
    f = b.reshape(ks, 2, 4, 4, nt, 8).transpose(0, 4, 5, 2, 1, 3)
    return np.ascontiguousarray(f).reshape(ks, nt, 32, 2, 4).view(
        "<u4")[..., 0]


def kernel_consts(dc: DecodeConsts, moduli, scale: float) -> np.ndarray:
    """K4's constant block for dc and scale, host uint32 words: the header,
    per limb q, (Q/q)^-1, its Shoup word and f32(1/q), per plane Q's digit
    and f32(2^(16d - e)) (0 past the digits that count), and m_bytes in
    fragment order (csrc/decode_crt.cu Dims)."""
    live, nd = dc.live, dc.ndig
    ks, nt, npl = dims(live)
    if not (1 <= live <= MAX_LIVE and nd <= npl):
        raise ValueError(f"decode_fused: live={live}, ndig={nd} unsupported")
    e = math.floor(math.log2(scale))
    ex = DIGIT_BITS * np.arange(npl) - e
    du = int(np.sum(ex <= 127))        # digits of weight up to 2^127
    tw = np.zeros(npl, dtype=np.float32)
    tw[:du] = [np.float32(2.0 ** int(v)) for v in ex[:du]]
    qdig = np.zeros(npl, dtype=np.uint32)
    qdig[:nd] = dc.q_digits
    c = np.array(dfloat.df_from_f64((2.0 ** e) / scale), dtype=np.float32)
    per_plane = np.concatenate([qdig, tw.view(np.uint32)])
    body = np.concatenate([
        np.asarray(moduli[:live], dtype=np.uint32),
        dc.punc_inv.astype(np.uint32), dc.punc_inv_shoup.astype(np.uint32),
        dc.inv_q_f32.view(np.uint32), per_plane])
    b_off = (HEADER + body.size + 1) & ~1
    frag = fragments(dc.m_bytes, ks, nt).ravel()
    words = np.zeros(b_off + frag.size, dtype=np.uint32)
    words[:HEADER] = [live, ks, nt, du, 0, 0, words.size, 0]
    words[4:6] = c.view(np.uint32)
    words[HEADER:HEADER + body.size] = body
    words[b_off:] = frag
    return words


def decode_fused(ctx: CkksContext, dc: DecodeConsts, residues: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """residues: (chunks, live, N) int32 on the GPU -> (chunks, N) f32; dc
    is ctx.dec_consts[live - 1]."""
    cuda_lib.require_cuda(residues, "decode_fused", torch.int32)
    if residues.dim() != 3 or residues.shape[1] != dc.live:
        raise ValueError(f"decode_fused: expected (chunks, {dc.live}, N), "
                         f"got {tuple(residues.shape)}")
    chunks, live, n = residues.shape
    if n < 32 or n & (n - 1):
        raise ValueError(f"decode_fused: N={n} is not a power of two >= 32")
    key = (live, float(scale), residues.device)
    if key not in ctx.decode_blocks:
        words = kernel_consts(dc, ctx.params.moduli, float(scale))
        ctx.decode_blocks[key] = torch.from_numpy(words.view(np.int32)).to(
            residues.device)
    block = ctx.decode_blocks[key]
    out = torch.empty((chunks, n), dtype=torch.float32, device=residues.device)
    if out.numel() == 0:
        return out
    err = cuda_lib.lib().fhe_decode_crt(
        out.data_ptr(), residues.data_ptr(), block.data_ptr(), block.numel(),
        live, chunks, n, cuda_lib.stream_ptr(residues))
    cuda_lib.check(err, "decode_fused")
    cuda_lib.launches["decode_fused"] += 1
    return out
