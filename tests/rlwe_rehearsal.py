"""A rehearsal of the encode pass of csrc/rlwe_passes.cu on the CPU, and
the values its tests use: tests/test_torch_rlwe_passes.py holds the
rehearsal against the plain version, tests/test_torch_cuda.py the kernel
against both."""

import math

import numpy as np
import torch


def rehearse_encode(ctx, values, scale, L, error=None):
    """The encode pass's arithmetic, step for step, in int64 on the CPU:
    t = rint(v * scale) in f32, |t| = m * 2**k (m < 2**24), one u32 Shoup
    multiply by the table's 2**k mod q_l, the negation, the error's lift
    and add; 0 for a non-finite t."""
    t = torch.round(values.to(torch.float32) * float(np.float32(scale)))
    r = t.abs()
    finite = r < math.inf
    r = torch.where(finite, r, torch.zeros_like(r))
    bits = r.view(torch.int32).to(torch.int64)
    small = r < 2.0 ** 24
    m = torch.where(small, r.to(torch.int64), (bits & 0x7FFFFF) | 0x800000)
    k = torch.where(small, torch.zeros_like(bits), (bits >> 23) - 150)
    table = ctx.enc_table[:L].to(torch.int64) & 0xFFFFFFFF   # (L, 105, 2)
    p = table[:, k, 0].movedim(0, -2)                        # (..., L, N)
    ps = table[:, k, 1].movedim(0, -2)
    q = ctx.q[:L, None]
    m = m[..., None, :]
    qhat = (m * ps) >> 32
    x = (m * p - qhat * q) & 0xFFFFFFFF
    x = torch.where(x >= q, x - q, x)
    neg = (t < 0)[..., None, :] & (x != 0)
    x = torch.where(neg, q - x, x)
    if error is not None:
        e = error.to(torch.int64)[..., None, :]
        s = x + torch.where(e < 0, e + q, e)
        x = torch.where(s >= q, s - q, s)
    return x.to(torch.int32)


def exact_residues(t_values, moduli):
    """Python integers: t mod q for each integer t and modulus (L, len)."""
    return np.array([[int(t) % q for t in t_values] for q in moduli],
                    dtype=np.int64)


def edge_values(scale_bits):
    """Edge values of the plain version's exact range |t| < 2**96 at
    2**scale_bits: +-0, rounding ties, |t| about 2**24, just under
    2**96, subnormal inputs."""
    d = 2.0 ** scale_bits
    ts = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5,
          2 ** 24 - 1, 2 ** 24, 2 ** 24 + 2, -(2 ** 24 - 1), -(2 ** 24),
          (2 ** 24 - 1) * 2.0 ** 72, -(2 ** 24 - 1) * 2.0 ** 72,
          2.0 ** 95, -(2.0 ** 95), 12345.0, -12345.0, 1.0, -1.0]
    v = [t / d for t in ts] + [0.0, -0.0, 1e-45, -1e-45, 1e-40]
    return np.array(v, dtype=np.float32)
