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
are the device's own generator (in JAX, XLA's RngBitGenerator): here a
torch.Generator on the key's device, seeded from the key's four words
(w0, w1, w2, w3) as

    seed = y0 * 2**32 + y1,   (y0, y1) = threefry2x32(key (w0, w1),
                                                      counter (w2, w3)),

so every bit of the key reaches the 64-bit seed. The words are read to
the host for that, one read per call of `generators` (on the card a
stream synchronise), and hashed there (threefry.threefry2x32_words). On the card the
Generator is Philox4x32-10 at offset 0. On the CPU torch's Generator is
MT19937, which keeps only the seed's low 32 bits (y1): rbg draws on the
CPU are the port's own reproducible stream, not the card's, and neither
is JAX's. A batch of keys draws one Generator per key and stacks the
results, as JAX vmaps `_rbg_random_bits`. An rbg key on a CUDA device
draws on the card; nothing falls back to the CPU or to threefry.
"""

from __future__ import annotations

import torch

from . import threefry

IMPLS = ("threefry", "rbg")


def default_impl(device: torch.device | str) -> str:
    """The implementation a helper on `device` samples with when the
    caller names none: rbg on the card (the device's own generator, as the
    JAX package picks rbg on its accelerator), threefry elsewhere."""
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


def seeds(key: torch.Tensor) -> list[int]:
    """The 64-bit Generator seed of each rbg key of the batch, in
    row-major order (the rule in the module docstring)."""
    if impl_of(key) != "rbg":
        raise TypeError("only an rbg key seeds a Generator")
    seeds = []
    for w in key.reshape(-1, 4).tolist():
        y0, y1 = threefry.threefry2x32_words(*w)
        seeds.append((y0 << 32) | y1)
    return seeds


def generators(key: torch.Tensor) -> list[torch.Generator]:
    """One torch.Generator on the key's device per rbg key of the batch,
    in row-major order, each seeded from its key."""
    gens = []
    for s in seeds(key):
        g = torch.Generator(device=key.device)
        g.manual_seed(s)
        gens.append(g)
    return gens


def draw(key: torch.Tensor, shape, fn) -> torch.Tensor:
    """fn(generator, shape) under each rbg key of the batch, stacked:
    (*key.shape[:-1], *result shape)."""
    outs = [fn(g, tuple(shape)) for g in generators(key)]
    return torch.stack(outs).reshape(key.shape[:-1] + outs[0].shape)


def _words(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 1 << 32, shape, generator=gen, device=gen.device,
                         dtype=torch.int64)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits(key, shape, uint32): uniform 32-bit words as int64
    in [0, 2**32), shape (*key.shape[:-1], *shape). Threefry's words are
    JAX's; rbg's come from the key's Generator."""
    if impl_of(key) == "threefry":
        return threefry.bits(key, shape)
    return draw(key, shape, _words)
