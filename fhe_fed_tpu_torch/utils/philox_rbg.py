"""Wrapper of the Philox kernel (csrc/philox_rbg.cu): rbg's draws on the
card, the words XLA's RngBitGenerator gives under a key (utils/prng.py
states the stream), with the JAX package's three samplers fused after
them (fhe_fed_tpu/ckks/keys.py: `uniform_mod_q`, `ternary_coeffs`,
`cbd_coeffs`). It replaces XLA's expansion of `lax.rng_bit_generator`,
reached from jax/_src/prng.py `_rbg_random_bits`: a generator of the
device, not a Pallas kernel.

Each entry draws under a key batch (..., 4) of int64 words on the card,
every key its own stream of `shape`, and reads the keys from device
memory: nothing goes to the host. The plain versions are
`prng.philox_bits` and the epilogues in ckks/keys.py; keys.py and
prng.py send CPU keys there. All four entries launch one kernel, counted
as `philox_rbg`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import cuda_lib

NAME = "philox_rbg"
MAX_LIMBS = 28            # kMaxLimbs: make_params reaches 28 moduli
# Epilogue codes of fhe_philox_rbg (the Epilogue enum in the source).
WORDS, UNIFORM, TERNARY, CBD = 0, 1, 2, 3


def limb_block(moduli) -> np.ndarray:
    """The uint32 block the uniform epilogue reads by value, per limb:
    [q | 2**32 mod q | its Shoup word floor((2**32 mod q) * 2**32 / q)]."""
    qs = np.asarray(moduli, dtype=np.uint64)
    if not 1 <= qs.size <= MAX_LIMBS:
        raise ValueError(f"philox_rbg: {qs.size} limbs, the kernel takes "
                         f"1..{MAX_LIMBS}")
    if np.any(qs <= 1 << 30) or np.any(qs >= 1 << 31):
        raise ValueError("philox_rbg: every modulus must lie in "
                         "(2**30, 2**31)")
    p32 = (np.uint64(1) << np.uint64(32)) % qs
    return np.concatenate([qs, p32, (p32 << np.uint64(32)) // qs]).astype(
        np.uint32)


def _launch(epilogue: int, out: torch.Tensor, k1: torch.Tensor,
            k2: torch.Tensor | None, per: int, block: np.ndarray | None,
            limbs: int = 0, n: int = 0) -> torch.Tensor:
    nkeys = k1.numel() // 4
    if out.numel() == 0:
        return out
    err = cuda_lib.lib().fhe_philox_rbg(
        out.data_ptr(), k1.data_ptr(),
        None if k2 is None else k2.data_ptr(),
        None if block is None else block.ctypes.data, limbs, n, epilogue,
        nkeys, per, cuda_lib.stream_ptr(k1))
    cuda_lib.check(err, NAME)
    cuda_lib.launches[NAME] += 1
    return out


def _keys(name: str, *keys: torch.Tensor) -> None:
    for k in keys:
        cuda_lib.require_cuda(k, name, torch.int64)
        if k.dim() == 0 or k.shape[-1] != 4:
            raise ValueError(f"{name}: expected rbg keys (..., 4), got "
                             f"{tuple(k.shape)}")
        if k.shape != keys[0].shape or k.device != keys[0].device:
            raise ValueError(f"{name}: key batches differ in shape or "
                             f"device")


def _out(key: torch.Tensor, shape, dtype) -> tuple[torch.Tensor, int]:
    shape = tuple(shape)
    return (torch.empty((*key.shape[:-1], *shape), dtype=dtype,
                        device=key.device), math.prod(shape))


def words(key: torch.Tensor, shape) -> torch.Tensor:
    """prng.philox_bits on the card: (*batch, *shape) int64 words."""
    _keys("philox_rbg.words", key)
    out, per = _out(key, shape, torch.int64)
    return _launch(WORDS, out, key, None, per, None)


def uniform_mod_q(k1: torch.Tensor, k2: torch.Tensor, shape,
                  moduli) -> torch.Tensor:
    """(hi * 2**32 + lo) mod q_l with hi drawn under k1 and lo under k2,
    shape (..., L, n): (*batch, *shape) int32, limb l's modulus
    moduli[l]."""
    _keys("philox_rbg.uniform_mod_q", k1, k2)
    shape = tuple(shape)
    if len(shape) < 2:
        raise ValueError("philox_rbg.uniform_mod_q: shape must be "
                         f"(..., L, n), got {shape}")
    limbs, n = shape[-2], shape[-1]
    block = limb_block(list(moduli)[:limbs])
    if block.size != 3 * limbs:
        raise ValueError(f"philox_rbg.uniform_mod_q: {len(moduli)} moduli "
                         f"for {limbs} limbs")
    out, per = _out(k1, shape, torch.int32)
    return _launch(UNIFORM, out, k1, k2, per, block, limbs, n)


def ternary(key: torch.Tensor, shape) -> torch.Tensor:
    """bits % 3 - 1: (*batch, *shape) int32 in {-1, 0, 1}."""
    _keys("philox_rbg.ternary", key)
    out, per = _out(key, shape, torch.int32)
    return _launch(TERNARY, out, key, None, per, None)


def cbd(k1: torch.Tensor, k2: torch.Tensor, shape) -> torch.Tensor:
    """popcount(a & (2**20 - 1)) - popcount(b & (2**20 - 1)) with a drawn
    under k1 and b under k2: (*batch, *shape) int32."""
    _keys("philox_rbg.cbd", k1, k2)
    out, per = _out(k1, shape, torch.int32)
    return _launch(CBD, out, k1, k2, per, None)
