"""The threefry2x32 PRNG of `jax.random`, bit for bit, in PyTorch.

Reproduces `jax.random` with its default `threefry2x32` implementation and
`jax_threefry_partitionable` on (the default since jax 0.5), so the port
draws the JAX package's samples: the same keys, ciphertexts and seeded
wire blobs from the same seed (jax/_src/prng.py: `threefry_seed`,
`iota_2x32_shape`, `_threefry_split_foldlike`, `_threefry_fold_in`,
`_threefry_random_bits_partitionable`).

A key is a tensor (..., 2) of uint32 words held in int64, on an explicit
device; leading dimensions are a batch of keys, and every function here
maps over them in one pass. The hash computes in int64 with
`& 0xFFFFFFFF` after every add and rotate (torch's uint32 is a
storage-only dtype on the CPU).

  * counter i of a (...)-shaped draw is the flat index split into the
    words (i >> 32, i & 0xFFFFFFFF);
  * split(k, num)[i] = threefry2x32(k, counter i), both output words;
  * bits(k, shape) = out0 ^ out1 of the counters of `shape`;
  * fold_in(k, d) = threefry2x32(k, (0, d)).

A split on the card is one launch of the kernel csrc/threefry_split.cu,
which reads the key words from device memory; `split_plain` is the same
split in int64 torch ops, which CPU keys take. Nothing falls back: a CUDA
key launches the kernel or raises.

On those words, `uniform` is jax.random.uniform bit for bit and `normal`
jax.random.normal within 4 ulp (see `_erfinv`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib
from .spans import traced

_M = 0xFFFFFFFF
_I64 = torch.int64
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if not torch.is_tensor(key) or key.shape[-1:] != (2,):
        raise TypeError(f"a threefry key is a tensor (..., 2), got "
                        f"{getattr(key, 'shape', type(key).__name__)}")
    return key[..., 0], key[..., 1]


def _rotl_(x: torch.Tensor, r: int) -> torch.Tensor:
    """In-place 32-bit rotate left of words held in int64."""
    low = x >> (32 - r)
    return x.bitwise_left_shift_(r).bitwise_and_(_M).bitwise_or_(low)


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds), elementwise over the
    broadcast of key words (k0, k1) and counter words (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M
    x1 = (x1 + k1) & _M
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M)
            _rotl_(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M)
    return x0, x1


def _counters(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=_I64,
                       device=device).reshape(tuple(shape))
    return idx >> 32, idx & _M


def _hash_counters(key: torch.Tensor, shape):
    """Both output words for every counter of `shape`, under each key:
    (*key.shape[:-1], *shape) each."""
    shape = tuple(shape)
    k0, k1 = _words(key)
    if key.is_meta:     # shapes only: nothing to hash
        out = torch.empty(k0.shape + shape, dtype=_I64, device=key.device)
        return out, out.clone()
    expand = (...,) + (None,) * len(shape)
    c_hi, c_lo = _counters(shape, key.device)
    return threefry2x32(k0[expand], k1[expand], c_hi, c_lo)


def key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """jax.random.key(seed) with 64-bit mode off, as key data (2,): the seed
    is taken as an int64 and keeps its low 32 bits, so key(s) is
    (0, s mod 2**32) (jax.random.key(2**62 + 12345) is (0, 12345))."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in int64")
    return torch.tensor([0, seed & _M], dtype=_I64, device=device)


def wrap_key_data(words, device: torch.device | str | None = None
                  ) -> torch.Tensor:
    """uint32 key words (..., 2) (numpy, tensor or sequence) -> a key."""
    if torch.is_tensor(words):
        t = words.to(_I64) & _M
        return t if device is None else t.to(device)
    a = np.asarray(words, dtype=np.uint32).astype(np.int64)
    return torch.as_tensor(a, device="cpu" if device is None else device)


@traced("fhe.key_split")
def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): (..., 2) -> (..., num, 2). A CUDA key
    splits in one launch of the kernel, any other in torch ops."""
    if torch.is_tensor(key) and key.is_cuda:
        return _split_kernel(key, num)
    return split_plain(key, num)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """The plain version of `split`: int64 torch ops on the key's device;
    a meta key gives the shape alone."""
    y0, y1 = _hash_counters(key, (num,))
    return torch.stack([y0, y1], dim=-1)


def _split_kernel(key: torch.Tensor, num: int) -> torch.Tensor:
    _words(key)
    if key.dtype != _I64:
        raise TypeError(f"threefry_split: expected {_I64}, got {key.dtype}")
    key, num = key.contiguous(), int(num)
    out = torch.empty((*key.shape[:-1], num, 2), dtype=_I64,
                      device=key.device)
    if out.numel() == 0:
        return out
    err = cuda_lib.lib().fhe_threefry_split(
        out.data_ptr(), key.data_ptr(), key.numel() // 2, num,
        cuda_lib.stream_ptr(key))
    cuda_lib.check(err, "threefry_split")
    cuda_lib.launches["threefry_split"] += 1
    return out


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data) for a 32-bit `data`: (..., 2)."""
    k0, k1 = _words(key)
    zero = torch.zeros((), dtype=_I64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, zero, zero + (int(data) & _M))
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits(key, shape, uint32): uniform 32-bit words, as int64
    values in [0, 2**32), shape (*key.shape[:-1], *shape)."""
    y0, y1 = _hash_counters(key, shape)
    return y0.bitwise_xor_(y1)


def _meta_draw(key: torch.Tensor, shape) -> torch.Tensor:
    return torch.empty(tuple(key.shape[:-1]) + tuple(shape),
                       dtype=torch.float32, device=key.device)


def uniform(key: torch.Tensor, shape, minval: float, maxval: float
            ) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval), bit for bit.

    The 23 mantissa bits of each word make f in [0, 1); JAX returns
    max(lo, f * (hi - lo) + lo) in float32, and XLA fuses that multiply-add
    into one rounding. Here the product is exact in float64 and so is the
    sum (at most 47 significant bits), so rounding it once to float32 gives
    the fused result."""
    if key.is_meta:     # shapes only: nothing to draw
        return _meta_draw(key, shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(hi - lo)                       # float32 subtraction, as JAX
    words = bits(key, shape)
    f = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min((f.double() * span + float(lo)).float(), float(lo))


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function", 2010):
# a degree-8 polynomial in w - 2.5 for w = -log1p(-x^2) < 5, else in
# sqrt(w) - 3.
_ERFINV_SMALL = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_LARGE = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_SQRT2 = float(np.float32(np.sqrt(2)))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv on x in (-1, 1). Each Horner step rounds once
    (XLA emits fused multiply-adds); log1p is torch's, which differs from
    XLA's by an ulp now and then, so the result is within a few ulp of
    JAX's rather than equal to it (tests/test_torch_models.py)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = (torch.where(small, a, b).double() + p.double() * w).float()
    return p * x


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.normal(key, shape, float32): sqrt(2) erf_inv(u) with u
    uniform on (-1, 1), u bit for bit and the result within a few ulp."""
    if key.is_meta:
        return _meta_draw(key, shape)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    return _SQRT2 * _erfinv(uniform(key, shape, float(lo), 1.0))
