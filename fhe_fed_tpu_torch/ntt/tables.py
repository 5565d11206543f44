"""Twiddle tables for the negacyclic NTT over a modulus chain.

The same tables as fhe_fed_tpu.ntt.tables, built the same way (vectorised
bit reversal, log-doubling power tables):

  tab[l, k]  = psi_l ** bitrev(k)     (mod q_l)   forward (Cooley-Tukey)
  itab[l, k] = psi_l ** -bitrev(k)    (mod q_l)   inverse (Gentleman-Sande)

in tree order: stage m of the forward transform reads tab[m : 2m], stage h
of the inverse itab[h : 2h]. Residues are int32 tensors and Shoup words
int64 tensors on the context's device; the per-limb scalars (q, N^-1) stay
on the host as numpy int64, because kernel K2 takes them as launch
arguments.

Kernel K2 (csrc/ntt_butterfly.cu) reads its twiddles from `tw_fwd` /
`tw_inv`: the same values with the LOW 32 bits of each Shoup word beside
them, (L, N, 2) int32, so a twiddle and its Shoup word come in one 8-byte
load. The 32-bit Shoup word is exact because w < q < 2**31 gives
w_shoup < 2**32. The per-stage expanded twiddles of the TPU kernel
(pallas_ntt.make_stage_tables) exist for its (8, 128) lane layout and are
not built: K2 reads tab[m + i] directly.

`mxu` holds the four-step tables of kernel K1 (ntt/mxu.py) where the ring
has such a split (mxu.mxu_viable), else None.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..rns import primes as primes_mod
from ..rns import modops
from . import mxu as mxu_mod

_HOST_FIELDS = ("q", "ninv", "ninv_shoup")
K2_MAX_LIMBS = 64        # kMaxLimbs of csrc/ntt_butterfly.cu


@dataclasses.dataclass(frozen=True)
class NttTables:
    """Twiddle tables for L limbs of one ring."""
    ring_dim: int
    q: np.ndarray                   # (L,) int64 moduli
    ninv: np.ndarray                # (L,) N^-1 mod q, int64
    ninv_shoup: np.ndarray          # (L,) int64
    tab: torch.Tensor               # (L, N) int32, tree order
    tab_shoup: torch.Tensor         # (L, N) int64
    itab: torch.Tensor              # (L, N) int32, tree order
    itab_shoup: torch.Tensor        # (L, N) int64
    tw_fwd: torch.Tensor            # (L, N, 2) int32: (tab, low 32 of shoup)
    tw_inv: torch.Tensor            # (L, N, 2) int32: (itab, ...)
    mxu: mxu_mod.MxuNttTables | None = None

    @property
    def num_limbs(self) -> int:
        return int(self.q.shape[0])

    @functools.cached_property
    def k2_consts(self) -> np.ndarray:
        """Kernel K2's launch constants, its C struct NttConsts: rows q,
        N^-1 and N^-1's Shoup word, (3, K2_MAX_LIMBS) uint32, zero-padded.
        Built on first use and kept (the tables are frozen; a slice is a
        table of its own)."""
        block = np.zeros((3, K2_MAX_LIMBS), dtype=np.uint32)
        for row, v in enumerate((self.q, self.ninv, self.ninv_shoup)):
            block[row, :v.shape[0]] = v
        return block

    @functools.cached_property
    def k2_consts_ptr(self) -> int:
        """The host address of k2_consts, which the table keeps alive."""
        return self.k2_consts.ctypes.data

    def _map(self, host_fn, dev_fn, mxu_fn) -> "NttTables":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "ring_dim":
                continue
            if f.name == "mxu":
                kw[f.name] = None if v is None else mxu_fn(v)
            elif f.name in _HOST_FIELDS:
                kw[f.name] = host_fn(v)
            else:
                kw[f.name] = dev_fn(v)
        return dataclasses.replace(self, **kw)

    def _derived(self, key, make) -> "NttTables":
        """The table `make()` builds, made once per key and kept: the paths
        ask for the same slices on every call, and a kept slice keeps its
        k2_consts too."""
        cache = self.__dict__.setdefault("_derived_tables", {})
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def slice_limbs(self, lo: int, hi: int) -> "NttTables":
        """Tables restricted to limbs [lo, hi)."""
        return self._derived(("slice", lo, hi), lambda: self._map(
            lambda a: a[lo:hi], lambda t: t[lo:hi],
            lambda m: m.slice_limbs(lo, hi)))

    def take(self, idx) -> "NttTables":
        """Tables of the limbs `idx` in that order, e.g. the key switch's
        extended basis {q_0 .. q_{live-1}, P} (fhe_fed_tpu keyswitch.
        _take_tables), four-step tables included."""
        idx = np.asarray(idx, dtype=np.int64)
        ti = torch.as_tensor(idx)
        return self._derived(("take", *idx.tolist()), lambda: self._map(
            lambda a: a[idx], lambda t: t.index_select(0, ti.to(t.device)),
            lambda m: m.take(idx)))


def _pow_table(base: int, q: int, n: int) -> np.ndarray:
    """base**k mod q for k in [0, n) as uint64, by log-doubling (every
    product of two values < 2**31 fits uint64 exactly)."""
    pw = np.ones(1, dtype=np.uint64)
    b = np.uint64(base % q)
    qq = np.uint64(q)
    while pw.size < n:
        pw = np.concatenate([pw, (pw * b) % qq])
        b = (b * b) % qq
    return pw[:n]


def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    brv = np.zeros(n, dtype=np.int64)
    x = np.arange(n, dtype=np.int64)
    for _ in range(bits):
        brv = (brv << 1) | (x & 1)
        x >>= 1
    return brv


def make_tables(ring_dim: int, moduli, device: torch.device | str = "cpu"
                ) -> NttTables:
    """Tables for `moduli` at ring `ring_dim` (a power of two)."""
    n = ring_dim
    if n < 2 or n & (n - 1):
        raise ValueError(f"ring_dim {n} must be a power of two")
    moduli = tuple(int(q) for q in moduli)
    L = len(moduli)
    brv = _bitrev_perm(n)
    tab = np.zeros((L, n), dtype=np.int64)
    itab = np.zeros((L, n), dtype=np.int64)
    ninv = np.zeros(L, dtype=np.int64)
    for l, q in enumerate(moduli):
        psi = primes_mod.primitive_root_2n(q, n)
        tab[l] = _pow_table(psi, q, n)[brv]
        itab[l] = _pow_table(pow(psi, q - 2, q), q, n)[brv]
        ninv[l] = pow(n, q - 2, q)
    qs = np.asarray(moduli, dtype=np.int64)
    tab_sh = modops.shoup_precompute(tab, qs[:, None])
    itab_sh = modops.shoup_precompute(itab, qs[:, None])

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a).astype(dtype),
                               device=device)

    def pairs(w, w_sh):
        return t(np.stack([w, w_sh], axis=-1).astype(np.uint32).view(
            np.int32), np.int32)

    return NttTables(
        ring_dim=n, q=qs, ninv=ninv,
        ninv_shoup=modops.shoup_precompute(ninv, qs),
        tab=t(tab, np.int32), tab_shoup=t(tab_sh, np.int64),
        itab=t(itab, np.int32), itab_shoup=t(itab_sh, np.int64),
        tw_fwd=pairs(tab, tab_sh), tw_inv=pairs(itab, itab_sh),
        mxu=(mxu_mod.make_mxu_tables(n, moduli, device=device)
             if mxu_mod.mxu_viable(n) else None))
