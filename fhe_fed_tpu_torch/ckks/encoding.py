"""Coefficient-packed CKKS encode / exact-CRT decode.

encode: round(m * 2**scale_bits) in f32 (exact: power-of-two scaling),
split into 16-bit digits by exact f32 ops, reduced mod each q_l with Shoup
multiplies. decode: exact CRT in 16-bit digit planes, then the centred
value divided by the scale in two-float arithmetic. Both follow
fhe_fed_tpu.ckks.encoding operation for operation.

`decode_core` is the plain PyTorch version of kernel K4
(ckks/pallas_decode.py); `decode_coeff` sends a CUDA tensor to the kernel
and a CPU tensor to decode_core. `encode_plain` is the plain version of
the encode pass (csrc/rlwe_passes.cu), which `encode_coeff` runs on the
card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..rns import modops
from ..utils import dfloat
from ..utils.spans import traced
from . import keys, pallas_decode, rlwe_passes
from .params import CkksContext, DecodeConsts, ENCODE_DIGITS, DIGIT_BITS

_F32 = torch.float32
_I64 = torch.int64


@traced("fhe.encode")
def encode_coeff(ctx: CkksContext, values: torch.Tensor, scale: float,
                 num_limbs: int | None = None,
                 error: torch.Tensor | None = None) -> torch.Tensor:
    """f32 values (..., N) -> int32 residues (..., L, N), coefficient order.
    `scale` must be a power of two. With `error`, small signed int32
    coefficients (..., N), their lift is added mod q_l (the secret-key
    encrypt's m + e). A CUDA tensor runs the encode pass of
    csrc/rlwe_passes.cu (ckks/rlwe_passes.py), a CPU tensor encode_plain."""
    sb = math.log2(scale)
    if sb != int(sb):
        raise ValueError("vector encode requires a power-of-two scale")
    L = num_limbs if num_limbs is not None else ctx.params.chain_len
    if values.is_cuda:
        return rlwe_passes.encode(ctx, values.to(_F32), scale, L, error)
    if values.device.type != "cpu":
        raise ValueError(f"no encode backend for device {values.device}")
    return encode_plain(ctx, values, scale, L, error)


def encode_plain(ctx: CkksContext, values: torch.Tensor, scale: float,
                 L: int, error: torch.Tensor | None = None) -> torch.Tensor:
    """The encode on plain tensors: round(m * scale) in f32 (exact: a
    power-of-two scale), split into 16-bit digits by exact f32 ops, reduced
    mod each q_l by Shoup multiplies in int64; then the error's lift added
    mod q_l. The plain version of the encode pass."""
    t = torch.round(values.to(_F32) * float(np.float32(scale)))  # half-even
    sign = t < 0
    r = torch.abs(t)
    digs = []
    for j in reversed(range(ENCODE_DIGITS)):
        p = float(2.0 ** (DIGIT_BITS * j))
        d = torch.floor(r / p)
        r = r - d * p
        digs.append((j, d))
    qb = ctx.q[:L, None]
    acc = torch.zeros(values.shape[:-1] + (L, values.shape[-1]), dtype=_I64,
                      device=values.device)
    for j, d in digs:
        term = modops.mul_mod_shoup(
            d.to(_I64)[..., None, :], ctx.enc_pow[j, :L, None],
            ctx.enc_pow_shoup[j, :L, None], qb)
        acc = modops.add_mod(acc, term, qb)
    pt = torch.where(sign[..., None, :], modops.neg_mod(acc, qb),
                     acc).to(torch.int32)
    if error is None:
        return pt
    return modops.add_mod(pt, keys.lift_signed(error, ctx.q[:L]),
                          qb).to(torch.int32)


def encode_scalar(moduli: tuple[int, ...], w: float, scale: float):
    """Host side: round(w * scale) mod q_l and its Shoup words, as numpy
    int64 (L,) arrays."""
    t = int(round(float(w) * scale))
    res = np.array([t % q for q in moduli], dtype=np.int64)
    return res, modops.shoup_precompute(res, np.array(moduli, dtype=np.int64))


def decode_coeff(ctx: CkksContext, residues: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """int32 residues (chunks, live, N) in coefficient order -> f32
    (chunks, N)."""
    live = residues.shape[-2]
    dc = ctx.dec_consts[live - 1]
    if residues.is_cuda:
        return pallas_decode.decode_fused(ctx, dc, residues, float(scale))
    if residues.device.type != "cpu":
        raise ValueError(f"no decode backend for device {residues.device}")
    return decode_core(dc, ctx.q[:live], residues, scale)


def decode_core(dc: DecodeConsts, qs: torch.Tensor, residues: torch.Tensor,
                scale: float) -> torch.Tensor:
    """The decode arithmetic on plain tensors (int64 integer steps, f32
    tail); the plain version of kernel K4."""
    dev = residues.device
    live = residues.shape[-2]
    nd = dc.ndig

    def t(a):
        return torch.as_tensor(a, device=dev)

    y = modops.mul_mod_shoup(residues, t(dc.punc_inv)[:, None],
                             t(dc.punc_inv_shoup)[:, None],
                             qs[:, None])                 # (..., live, N)

    # k = round(sum_l y_l / q_l), summed in limb order.
    yq = y.to(torch.int32).to(_F32) * t(dc.inv_q_f32)[:, None]
    fsum = torch.zeros(yq.shape[:-2] + yq.shape[-1:], dtype=_F32, device=dev)
    for l in range(live):
        fsum = fsum + yq[..., l, :]
    k = torch.round(fsum).to(_I64)

    # sum_l y_l * M_l in 16-bit digit planes; every partial < 2**16.
    y_lo = y & 0xFFFF
    y_hi = y >> 16
    planes = [torch.zeros_like(k) for _ in range(nd)]
    for l in range(live):
        for d in range(nd):
            m = int(dc.m_digits[l, d])
            p1 = y_lo[..., l, :] * m
            planes[d] = planes[d] + (p1 & 0xFFFF)
            if d + 1 < nd:
                planes[d + 1] = planes[d + 1] + (p1 >> 16)
                p2 = y_hi[..., l, :] * m
                planes[d + 1] = planes[d + 1] + (p2 & 0xFFFF)
            if d + 2 < nd:
                planes[d + 2] = planes[d + 2] + (p2 >> 16)
    return _planes_to_f32(dc, planes, k, scale)


def _planes_to_f32(dc: DecodeConsts, planes: list, k: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Digit planes of sum_l y_l * M_l (base 2**16, each < 2**30) and k ->
    centred value / scale as f32, as the JAX package's _planes_to_f32."""
    nd = dc.ndig
    qd = [int(v) for v in dc.q_digits]

    # w = acc + Q - k*Q >= 0; k*Q's digits are left non-normalised and the
    # carry chain renormalises them.
    out_digits = []
    carry = torch.zeros_like(k)
    for d in range(nd):
        r = planes[d] + qd[d] - k * qd[d] + carry
        out_digits.append(r & 0xFFFF)
        carry = r >> 16

    # v = w - Q with borrow; the final borrow is the sign of v.
    vdigs = []
    borrow = torch.zeros_like(k)
    for d in range(nd):
        r = out_digits[d] - qd[d] + borrow
        vdigs.append(r & 0xFFFF)
        borrow = r >> 16
    neg = borrow < 0

    # Two's complement -> magnitude digits.
    mag = []
    carry = neg.to(_I64)
    for d in range(nd):
        tt = torch.where(neg, 0xFFFF - vdigs[d], vdigs[d]) + carry
        mag.append(tt & 0xFFFF)
        carry = tt >> 16

    # Two-float sum of digit * 2**(16d - e); digits whose weight exceeds the
    # f32 exponent range only flag an overflow.
    e = math.floor(math.log2(scale))
    hi = torch.zeros(k.shape, dtype=_F32, device=k.device)
    lo = torch.zeros_like(hi)
    overflow = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
    for d in range(nd):
        ex = DIGIT_BITS * d - e
        if ex > 127:
            overflow = overflow | (mag[d] > 0)
            continue
        term = mag[d].to(_F32) * float(np.float32(2.0 ** ex))
        hi, lo = dfloat.df_add_f32(hi, lo, term)
    hi = torch.where(overflow, torch.full_like(hi, math.inf), hi)
    # f32 tensors, not Python floats: the Dekker split must run in f32.
    c = torch.tensor(dfloat.df_from_f64((2.0 ** e) / scale), dtype=_F32,
                     device=k.device)
    hi, lo = dfloat.df_mul(hi, lo, c[0], c[1])
    return (hi + lo) * torch.where(neg, -1.0, 1.0).to(_F32)
