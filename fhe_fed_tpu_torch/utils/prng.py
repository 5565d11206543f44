"""Keys of either PRNG implementation the JAX package draws with: the
counterpart of `jax.random`'s dispatch on the implementation, for
`threefry2x32` and `rbg`.

A key is an int64 tensor of uint32 words on an explicit device. Its last
dimension says which implementation it is, and leading dimensions are a
batch of keys:

  * (..., 2): threefry2x32 (utils/threefry.py), `jax.random.key`'s default
    on any device, bit for bit;
  * (..., 4): rbg, two threefry half-keys, as jax 0.9.0 builds it
    (jax/_src/prng.py `_rbg_seed`, `_rbg_split`, `_rbg_fold_in`).

A batch of threefry keys keeps 2 as its last dimension whatever its
shape, so the rule never takes one for an rbg key, and utils/threefry.py
refuses an rbg key.

rbg's key tree is threefry on each half, bit for bit with jax. Its draws
are XLA's RngBitGenerator, which `jax.random.bits` reaches through
`lax.rng_bit_generator` (`_rbg_random_bits`) and which XLA expands to
Philox4x32-10; `bits` gives the same words. For key words
(w0, w1, w2, w3), with s0 = w0 | w1 << 32 and s1 = w2 | w3 << 32:

  * Philox block i runs on the 128-bit counter C_i = (s0 << 64) + s1 + i,
    as the words (lo32, hi32) of its low 64 bits and then of its high 64
    bits (the low half carries into the high one), under the Philox key
    (w0, w1);
  * word j of the row-major draw is word j mod 4 of block j // 4.

`philox_bits` is that stream in int64 torch ops, the plain version; an
rbg key on the card draws through the kernel csrc/philox_rbg.cu
(utils/philox_rbg.py), which reads the key words from device memory.
Nothing falls back: a CUDA key launches the kernel or raises.

A batch of rbg keys (..., 4) draws one of two ways, as the JAX function
the caller mirrors draws:

  * each key its own stream (`vmap=False`): a Python loop over keys in
    JAX, or a single key;
  * under `jax.vmap` (`vmap=True`): JAX's batching rule for
    rng_bit_generator (jax/_src/lax/control_flow/loops.py,
    `_rng_bit_generator_batching_rule`) draws the whole batch from its
    FIRST key, with shape (*batch, *shape). Nested vmaps reduce to the
    first key of the flattened batch (`batch_rule`).

threefry's batching draws each key's own stream either way.
"""

from __future__ import annotations

import math

import torch

from . import philox_rbg, threefry

IMPLS = ("threefry", "rbg")

_M = 0xFFFFFFFF
# Philox4x32-10's multipliers and Weyl key increments.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def default_impl(device: torch.device | str) -> str:
    """The implementation a helper on `device` samples with when the
    caller names none: rbg on the card (as the JAX package picks rbg on
    its accelerator), threefry elsewhere."""
    return "rbg" if torch.device(device).type == "cuda" else "threefry"


def impl_of(key: torch.Tensor) -> str:
    """'threefry' for a key (..., 2), 'rbg' for a key (..., 4)."""
    if torch.is_tensor(key) and key.dim() and key.shape[-1] in (2, 4):
        return "threefry" if key.shape[-1] == 2 else "rbg"
    raise TypeError(f"a key is a tensor (..., 2) (threefry) or (..., 4) "
                    f"(rbg), got {getattr(key, 'shape', type(key).__name__)}")


def _halves(key: torch.Tensor) -> torch.Tensor:
    return key.unflatten(-1, (2, 2))


def key(seed: int, impl: str, device: torch.device | str) -> torch.Tensor:
    """jax.random.key(seed, impl=...) as key data: threefry (2,), or rbg
    (4,), the threefry key twice (`_rbg_seed`)."""
    if impl not in IMPLS:
        raise ValueError(f"PRNG {impl!r}: expected one of {IMPLS}")
    half = threefry.key(seed, device)
    return half if impl == "threefry" else torch.cat([half, half])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): (..., W) -> (..., num, W). rbg splits
    each half with threefry (`_rbg_split`)."""
    if impl_of(key) == "threefry":
        return threefry.split(key, num)
    halves = threefry.split(_halves(key), num)      # (..., 2, num, 2)
    return halves.transpose(-3, -2).flatten(-2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data) for a 32-bit `data`: (..., W). rbg
    folds each half with threefry (`_rbg_fold_in`)."""
    if impl_of(key) == "threefry":
        return threefry.fold_in(key, data)
    return threefry.fold_in(_halves(key), data).flatten(-2)


def batch_rule(key: torch.Tensor, shape, vmap: bool
               ) -> tuple[torch.Tensor, tuple]:
    """The (key, shape) a draw of `shape` under a key batch (..., W) runs:
    unchanged, unless `vmap` and the keys are rbg, where JAX's batching
    rule takes the batch's first key and the shape (*batch, *shape)."""
    shape = tuple(shape)
    if vmap and impl_of(key) == "rbg" and key.dim() > 1:
        return key.reshape(-1, 4)[0], (*key.shape[:-1], *shape)
    return key, shape


def _mulhilo(x: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of x * m for words x < 2**32 held in int64 and
    a 32-bit constant m. The product reaches 2**64, beyond int64: m is
    split into 16-bit halves, each partial product below 2**48."""
    lo_part = x * (m & 0xFFFF)
    hi_part = x * (m >> 16)
    t = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (t >> 32), t & _M


def philox_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """The plain version of rbg's draw: the words XLA's RngBitGenerator
    (Philox4x32-10, the layout in the module docstring) gives each rbg key
    of the batch (..., 4), as int64 in [0, 2**32), shape
    (*key.shape[:-1], *shape). Int64 torch ops on the key's device; no
    host read."""
    if impl_of(key) != "rbg":
        raise TypeError("philox_bits draws under an rbg key (..., 4)")
    shape = tuple(shape)
    n = math.prod(shape)
    w = key.reshape(-1, 4).to(torch.int64)
    blocks = -(-n // 4)
    i = torch.arange(blocks, dtype=torch.int64, device=key.device)
    # The 128-bit counter (s0 << 64) + s1 + i, word by word with carries.
    t = w[:, 2:3] + i
    c0 = t & _M
    t = w[:, 3:4] + (t >> 32)
    c1 = t & _M
    t = w[:, 0:1] + (t >> 32)
    c2 = t & _M
    c3 = (w[:, 1:2] + (t >> 32)) & _M
    k0, k1 = w[:, 0:1], w[:, 1:2]
    for r in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M
        k1 = (k1 + _PHILOX_W[1]) & _M
    out = torch.stack([c0, c1, c2, c3], dim=-1).reshape(w.shape[0], -1)
    return out[:, :n].reshape((*key.shape[:-1], *shape))


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits(key, shape, uint32): uniform 32-bit words as int64
    in [0, 2**32), bit for bit; a key batch (..., W) draws each key's
    stream, shape (*batch, *shape) (`batch_rule` gives a vmapped draw's
    key and shape). rbg keys on the card draw through the Philox kernel,
    on the CPU through `philox_bits`."""
    if impl_of(key) == "threefry":
        return threefry.bits(key, shape)
    if key.is_cuda:
        return philox_rbg.words(key.contiguous(), shape)
    if key.device.type != "cpu":
        raise ValueError(f"no rbg generator for {key.device}")
    return philox_bits(key, shape)
