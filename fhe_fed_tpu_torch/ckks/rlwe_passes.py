"""Wrapper of the three passes of csrc/rlwe_passes.cu: the secret-key
encrypt's and the decrypt's elementwise steps around the NTT on the card,
in place of PyTorch's int64 glue. Each equals its plain version bit for bit
(the source states the one place where they differ: an encode outside the
plain version's exact range):

  * `encode`  values (..., N) f32 [+ error (..., N) int32] -> (..., L, N)
    int32, the forward NTT's input; plain: encoding.encode_plain;
  * `encrypt` a_hat, w_hat (..., L, N) -> (..., 2, L, N) (c0 = a*s + w_hat,
    c1 = -a), or c0 alone (..., L, N); plain: ops._encrypt_plain;
  * `decrypt` data (..., 2, live, N) -> c0 + c1*s (..., live, N), the
    inverse NTT's input; plain: ops._phase_plain.

None replaces a Pallas kernel. CUDA tensors only: encoding.encode_coeff,
ops.encrypt_symmetric_core and ops.decrypt_residues send CPU tensors to
the plain versions. Each call launches one kernel, counted under its
name.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import cuda_lib

NAMES = ("encode_pass", "encrypt_pass", "decrypt_pass")
MAX_LIMBS = 32            # kMaxLimbs: make_params reaches 28 limbs


@functools.lru_cache(maxsize=None)
def _moduli(moduli: tuple) -> np.ndarray:
    """The by-value block of a call: the live moduli as uint32."""
    return np.asarray(moduli, dtype=np.uint32)


def _ready(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """t made contiguous, checked as every kernel wrapper checks it."""
    t = t.contiguous()
    cuda_lib.require_cuda(t, name, dtype)
    return t


def _shape(limbs: int, n: int, name: str) -> None:
    if not 1 <= limbs <= MAX_LIMBS or n < 4 or n % 4:
        raise ValueError(f"{name}: {limbs} limbs, N={n} unsupported "
                         f"(1..{MAX_LIMBS} limbs, N % 4 == 0)")


def _key(sk, limbs: int, n: int, device, name: str):
    s, s_shoup = sk.s, sk.s_shoup
    if s.device != device or s.shape[0] < limbs or s.shape[1] != n:
        raise ValueError(f"{name}: the secret key {tuple(s.shape)} on "
                         f"{s.device} does not cover {limbs} limbs of N={n}"
                         f" on {device}")
    cuda_lib.require_cuda(s, name, torch.int32)
    cuda_lib.require_cuda(s_shoup, name, torch.int64)
    return s, s_shoup


def _launch(name: str, fn, *args) -> None:
    cuda_lib.check(fn(*args), name)
    cuda_lib.launches[name] += 1


def encode(ctx, values: torch.Tensor, scale: float, limbs: int,
           error: torch.Tensor | None = None) -> torch.Tensor:
    """values (..., N) float32 on the card -> int32 (..., limbs, N):
    round(values * scale) mod q_l, plus lift(error) mod q_l where `error`
    (..., N) int32 is given. `scale` is a power of two."""
    name = NAMES[0]
    values = _ready(values, torch.float32, name)
    if error is not None:
        if error.shape != values.shape:
            raise ValueError(f"{name}: error {tuple(error.shape)} for values "
                             f"{tuple(values.shape)}")
        error = _ready(error, torch.int32, name)
        if error.device != values.device:
            raise ValueError(f"{name}: error on {error.device}, values on "
                             f"{values.device}")
    n = values.shape[-1]
    _shape(limbs, n, name)
    table = ctx.enc_table
    if table.device != values.device or table.shape[0] < limbs:
        raise ValueError(f"{name}: the context's table on {table.device} "
                         f"does not cover {limbs} limbs on {values.device}")
    out = torch.empty(values.shape[:-1] + (limbs, n), dtype=torch.int32,
                      device=values.device)
    if out.numel() == 0:
        return out
    _launch(name, cuda_lib.lib().fhe_encode_pass, out.data_ptr(),
            values.data_ptr(), None if error is None else error.data_ptr(),
            table.data_ptr(), _moduli(ctx.params.moduli[:limbs]).ctypes.data,
            limbs, values.numel() // n, n, float(np.float32(scale)),
            cuda_lib.stream_ptr(values))
    return out


def encrypt(ctx, sk, a_hat: torch.Tensor, w_hat: torch.Tensor,
            c1: bool = True) -> torch.Tensor:
    """a_hat, w_hat (..., L, N) int32 on the card -> (..., 2, L, N) int32
    (c0 = a_hat*s + w_hat, c1 = -a_hat mod q_l), or c0 alone (..., L, N)
    where `c1` is False."""
    name = NAMES[1]
    if a_hat.shape != w_hat.shape or a_hat.dim() < 2:
        raise ValueError(f"{name}: a_hat {tuple(a_hat.shape)} and w_hat "
                         f"{tuple(w_hat.shape)} differ")
    a_hat = _ready(a_hat, torch.int32, name)
    w_hat = _ready(w_hat, torch.int32, name)
    *lead, limbs, n = a_hat.shape
    _shape(limbs, n, name)
    s, s_shoup = _key(sk, limbs, n, a_hat.device, name)
    out = torch.empty((*lead, *((2,) if c1 else ()), limbs, n),
                      dtype=torch.int32, device=a_hat.device)
    if out.numel() == 0:
        return out
    _launch(name, cuda_lib.lib().fhe_encrypt_pass, out.data_ptr(),
            a_hat.data_ptr(), w_hat.data_ptr(), s.data_ptr(),
            s_shoup.data_ptr(),
            _moduli(ctx.params.moduli[:limbs]).ctypes.data, limbs,
            a_hat.numel() // (limbs * n), n, int(c1),
            cuda_lib.stream_ptr(a_hat))
    return out


def decrypt(ctx, sk, data: torch.Tensor) -> torch.Tensor:
    """data (..., 2, live, N) int32 on the card -> c0 + c1*s mod q_l,
    (..., live, N) int32."""
    name = NAMES[2]
    if data.dim() < 3 or data.shape[-3] != 2:
        raise ValueError(f"{name}: expected (..., 2, live, N), got "
                         f"{tuple(data.shape)}")
    data = _ready(data, torch.int32, name)
    *lead, _, live, n = data.shape
    _shape(live, n, name)
    s, s_shoup = _key(sk, live, n, data.device, name)
    out = torch.empty((*lead, live, n), dtype=torch.int32, device=data.device)
    if out.numel() == 0:
        return out
    _launch(name, cuda_lib.lib().fhe_decrypt_pass, out.data_ptr(),
            data.data_ptr(), s.data_ptr(), s_shoup.data_ptr(),
            _moduli(ctx.params.moduli[:live]).ctypes.data, live,
            data.numel() // (2 * live * n), n, cuda_lib.stream_ptr(data))
    return out
