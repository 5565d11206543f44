"""Coefficient- and limb-sharded negacyclic NTT over a device mesh: the
counterpart of fhe_fed_tpu/ntt/dist.py on torch.distributed.

Four-step (Bailey) decomposition, N = N1 * N2, coefficient n = N2*n1 + n2:

    X[k1 + N1*k2] = F_{N2}[n2 -> k2]( W_N^{n2*k1} * F_{N1}[n1 -> k1](x) )

so a polynomial lives as a (..., L, N1, N2) matrix:

  1. negacyclic pre-twist  x[n] *= psi^n                 (local)
  2. column DFTs: size-N1 cyclic DFT along n1            (local, n2 sharded)
  3. mid twiddle           *= W_N^{rev(r) * n2}          (local)
  4. RESHARD n2-sharded -> k1-sharded                    (ONE all_to_all)
  5. row DFTs: size-N2 cyclic DFT along n2               (local, k1 sharded)

The inverse runs the mirror image (one all_to_all back) and folds N^-1
into the post-twist. The local DFTs are Gentleman-Sande forward (natural
-> bit-reversed) and Cooley-Tukey inverse on the Shoup modmul of
rns/modops.py, in int64 torch ops: the JAX package runs them as plain jnp
ops too (no Pallas kernel sits here). The exchange is int32.

Eval-domain order: position (r, c) holds the evaluation at psi^(2k+1) with
k = rev_{N1}(r) + N1 * rev_{N2}(c): a fixed permutation of the on-chip
order (`eval_perm`).

Layout. JAX shards one global array under GSPMD; here each rank holds its
block and `DistSpec` names the mesh axes:

  * coefficient layout (..., L, N1, N2): n2 sharded over `coeff_axis`;
  * evaluation layout: the r (N1) axis sharded over `coeff_axis`;
  * the limb axis (-3) sharded over `limb_axis` as well, or whole on
    every rank (limb_axis None); every transform here is limb-local.

The tables are whole on every rank; the transforms take the rank's block
of each. `col_block` / `row_block` cut a global array to a rank's block,
`gather_axis` puts one axis back together. With no mesh (DistSpec()) the
rank holds everything and no collective runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import cuda_lib
from ..rns import modops, primes as primes_mod
from ..parallel.multihost import axis_coord, block
from .tables import _bitrev_perm, _pow_table

_I32 = torch.int32


# ---------------------------------------------------------------------------
# Tables (host-built, exact integer arithmetic)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistNttTables:
    """Twiddle tables for the four-step sharded NTT (L limbs, N = N1*N2):
    residues int32, Shoup words int64, on one device."""
    ring_dim: int
    n1: int
    n2: int
    q: torch.Tensor                 # (L,) int64
    twist: torch.Tensor             # (L, N1, N2)  psi^n
    twist_shoup: torch.Tensor
    untwist: torch.Tensor           # (L, N1, N2)  psi^-n * N^-1
    untwist_shoup: torch.Tensor
    mid: torch.Tensor               # (L, N1, N2)  W_N^(rev1(r) * n2)
    mid_shoup: torch.Tensor
    imid: torch.Tensor              # (L, N1, N2)  W_N^(-rev1(r) * n2)
    imid_shoup: torch.Tensor
    # Per-stage cyclic DFT twiddles. Forward (GS) spans t = S/2 .. 1,
    # inverse (CT) spans t = 1 .. S/2; stage s has a (L, t) table.
    f1: tuple
    f1_shoup: tuple
    i1: tuple
    i1_shoup: tuple
    f2: tuple
    f2_shoup: tuple
    i2: tuple
    i2_shoup: tuple

    @property
    def num_limbs(self) -> int:
        return int(self.q.shape[0])

    def slice_limbs(self, lo: int, hi: int) -> "DistNttTables":
        """Tables restricted to limbs [lo, hi): every table leads with L."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = tuple(t[lo:hi] for t in v)
            elif torch.is_tensor(v):
                v = v[lo:hi]
            kw[f.name] = v
        return DistNttTables(**kw)


def _cyclic_stage_tables(size: int, omega: int, q: int):
    """GS-forward and CT-inverse stage twiddles of a size-`size` cyclic DFT:
    the forward stage of span t holds omega^((size/2t) * i), i < t, the
    inverse omega^-(...). Returns (fwd, inv) lists of int64 arrays."""
    fp = _pow_table(omega, q, size).astype(np.int64)
    ip = _pow_table(pow(omega, q - 2, q), q, size).astype(np.int64)
    spans = [size >> (s + 1) for s in range(size.bit_length() - 1)]
    fwd = [fp[(size // (2 * t)) * np.arange(t)] for t in spans]
    inv = [ip[(size // (2 * t)) * np.arange(t)] for t in reversed(spans)]
    return fwd, inv


def _host_tables(ring_dim: int, moduli: tuple, n1: int) -> dict:
    """The tables as numpy int64 arrays (host side)."""
    n = ring_dim
    n2 = n // n1
    if n1 * n2 != n or n1 < 2 or n2 < 2 or n & (n - 1):
        raise ValueError(f"N = {n} does not split as {n1} x {n2}")
    L = len(moduli)
    rev1 = _bitrev_perm(n1)
    twist, untwist, mid, imid = (np.zeros((L, n1, n2), dtype=np.int64)
                                 for _ in range(4))
    f1s, i1s, f2s, i2s = [], [], [], []
    expo = (rev1[:, None] * np.arange(n2)[None, :]) % n
    for l, q in enumerate(moduli):
        psi = primes_mod.primitive_root_2n(q, n)
        ipsi = pow(psi, q - 2, q)
        w = psi * psi % q                     # omega_N, order N
        ninv = pow(n, q - 2, q)
        qq = np.uint64(q)
        twist[l] = _pow_table(psi, q, n).reshape(n1, n2)
        untwist[l] = (_pow_table(ipsi, q, n) * np.uint64(ninv) % qq
                      ).reshape(n1, n2)
        # mid[r, c] = w^(rev1(r) * c): rows are in the bit-reversed order
        # the size-N1 GS stage leaves them in.
        mid[l] = _pow_table(w, q, n)[expo]
        imid[l] = _pow_table(pow(w, q - 2, q), q, n)[expo]
        f1, i1 = _cyclic_stage_tables(n1, pow(w, n2, q), q)
        f2, i2 = _cyclic_stage_tables(n2, pow(w, n1, q), q)
        f1s.append(f1)
        i1s.append(i1)
        f2s.append(f2)
        i2s.append(i2)

    def stack(per_limb):
        # [limb][stage] -> (t,)  =>  [stage] -> (L, t)
        return tuple(np.stack([per_limb[l][s] for l in range(L)])
                     for s in range(len(per_limb[0])))

    return dict(twist=twist, untwist=untwist, mid=mid, imid=imid,
                f1=stack(f1s), i1=stack(i1s), f2=stack(f2s), i2=stack(i2s),
                q=np.asarray(moduli, dtype=np.int64))


def make_dist_tables(ring_dim: int, moduli, n1: int | None = None,
                     device: torch.device | str = "cuda") -> DistNttTables:
    """Tables for N = ring_dim split as (n1, N/n1) on `device` (default
    the card). The default n1 is the near-square split with N2 >= N1."""
    device = cuda_lib.device(device)
    if n1 is None:
        n1 = 1 << ((ring_dim.bit_length() - 1) // 2)
    h = _host_tables(ring_dim, tuple(int(q) for q in moduli), n1)
    qs = h["q"]

    def res(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    def sh(a, qb):
        return torch.as_tensor(modops.shoup_precompute(a, qb), device=device)

    def stages(name):
        return (tuple(res(s) for s in h[name]),
                tuple(sh(s, qs[:, None]) for s in h[name]))

    kw = {}
    for name in ("twist", "untwist", "mid", "imid"):
        kw[name] = res(h[name])
        kw[name + "_shoup"] = sh(h[name], qs[:, None, None])
    for name in ("f1", "i1", "f2", "i2"):
        kw[name], kw[name + "_shoup"] = stages(name)
    return DistNttTables(ring_dim=ring_dim, n1=n1, n2=ring_dim // n1,
                         q=torch.as_tensor(qs, device=device), **kw)


# ---------------------------------------------------------------------------
# Layout: mesh axes and rank blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Mesh axis names of the distributed layout. `limb_axis` None: every
    rank holds all limbs. `mesh` None: one rank holds everything."""
    mesh: DeviceMesh | None = None
    coeff_axis: str = "coeff"
    limb_axis: str | None = None

    def coeff(self) -> tuple[int, int]:
        return axis_coord(self.mesh, self.coeff_axis)

    def limbs(self, n_limbs: int) -> slice:
        """This rank's block of `n_limbs` global limbs."""
        return block(*axis_coord(self.mesh, self.limb_axis), n_limbs)

    def without_limbs(self) -> "DistSpec":
        return dataclasses.replace(self, limb_axis=None)


def _global_limbs(ds: DistSpec, local: int) -> int:
    return local * axis_coord(ds.mesh, ds.limb_axis)[1]


def col_block(x, ds: DistSpec, limbs: bool = True):
    """The rank's coefficient-layout block of a global (..., [L,] N1, N2)
    array (numpy or tensor): its n2 columns, and its limbs if `limbs`."""
    idx = [slice(None)] * x.ndim
    idx[-1] = block(*ds.coeff(), x.shape[-1])
    if limbs:
        idx[-3] = ds.limbs(x.shape[-3])
    return x[tuple(idx)]


def row_block(x, ds: DistSpec, limbs: bool = True):
    """The rank's evaluation-layout block of a global (..., [L,] N1, N2)
    array: its N1 rows, and its limbs if `limbs`."""
    idx = [slice(None)] * x.ndim
    idx[-2] = block(*ds.coeff(), x.shape[-2])
    if limbs:
        idx[-3] = ds.limbs(x.shape[-3])
    return x[tuple(idx)]


def gather_axis(x: torch.Tensor, mesh: DeviceMesh | None, axis: str | None,
                dim: int) -> torch.Tensor:
    """Concatenate every rank's block along `dim` over mesh axis `axis`, in
    coordinate order: one all_gather (nothing without a mesh or axis)."""
    if mesh is None or axis is None:
        return x
    parts = [torch.empty_like(x) for _ in range(axis_coord(mesh, axis)[1])]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# Local cyclic DFT networks
# ---------------------------------------------------------------------------

def _gs_last(x, tws, tws_sh, q):
    """Forward GS DFT along the LAST axis (size S), natural in, bit-reversed
    out. x (..., L, R, S) int64; stage tables tws[s] (L, t)."""
    S = x.shape[-1]
    t = S // 2
    qb = q.reshape(-1, 1, 1, 1)
    for tw, tw_sh in zip(tws, tws_sh):
        xs = x.reshape(*x.shape[:-1], S // (2 * t), 2, t)
        u, v = xs[..., 0, :], xs[..., 1, :]
        w = tw.reshape(tw.shape[0], 1, 1, t)      # (L, R=1, nb=1, t)
        w_sh = tw_sh.reshape(tw.shape[0], 1, 1, t)
        a = modops.add_mod(u, v, qb)
        b = modops.mul_mod_shoup(modops.sub_mod(u, v, qb), w, w_sh, qb)
        x = torch.stack([a, b], dim=-2).reshape(x.shape)
        t //= 2
    return x


def _ct_last(x, tws, tws_sh, q):
    """Inverse CT DFT along the LAST axis: bit-reversed in, natural out,
    scaled by S (folded into untwist)."""
    S = x.shape[-1]
    t = 1
    qb = q.reshape(-1, 1, 1, 1)
    for tw, tw_sh in zip(tws, tws_sh):
        xs = x.reshape(*x.shape[:-1], S // (2 * t), 2, t)
        u, v = xs[..., 0, :], xs[..., 1, :]
        w = tw.reshape(tw.shape[0], 1, 1, t)
        w_sh = tw_sh.reshape(tw.shape[0], 1, 1, t)
        wv = modops.mul_mod_shoup(v, w, w_sh, qb)
        x = torch.stack([modops.add_mod(u, wv, qb),
                         modops.sub_mod(u, wv, qb)], dim=-2).reshape(x.shape)
        t *= 2
    return x


def _dft(x, tws, tws_sh, q, inverse: bool, along_rows: bool):
    """The size-N1 (along_rows: over the -2 axis) or size-N2 DFT."""
    f = _ct_last if inverse else _gs_last
    if along_rows:
        return f(x.transpose(-1, -2), tws, tws_sh, q).transpose(-1, -2)
    return f(x, tws, tws_sh, q)


def _reshard(x: torch.Tensor, ds: DistSpec, to_row: bool) -> torch.Tensor:
    """The one exchange between the n2-sharded (col) and N1-sharded (row)
    layouts: lax.all_to_all(tiled) as ONE all_to_all_single on the coeff
    group. to_row: the rank's rows are cut into P blocks, block j goes to
    rank j, and the blocks received from ranks 0..P-1 are its columns in
    that order; the inverse is the mirror image."""
    if ds.mesh is None:
        return x
    P = ds.coeff()[1]
    x = x.to(_I32)
    *lead, r, c = x.shape
    if to_row:
        send = x.reshape(*lead, P, r // P, c).movedim(-3, 0)
    else:
        send = x.reshape(*lead, r, P, c // P).movedim(-2, 0)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send,
                           group=ds.mesh.get_group(ds.coeff_axis))
    if to_row:
        return recv.movedim(0, -2).reshape(*lead, r // P, c * P)
    return recv.movedim(0, -3).reshape(*lead, r * P, c // P)


# ---------------------------------------------------------------------------
# Sharded transforms
# ---------------------------------------------------------------------------

def _local(dt: DistNttTables, ds: DistSpec, x: torch.Tensor):
    """(the rank's global limb slice, its n2 column slice) for x's block."""
    lim = ds.limbs(_global_limbs(ds, x.shape[-3]))
    if lim.stop - lim.start != x.shape[-3] or \
            _global_limbs(ds, x.shape[-3]) != dt.num_limbs:
        raise ValueError(f"{x.shape[-3]} local limbs do not match "
                         f"{dt.num_limbs} table limbs under {ds.limb_axis}")
    return lim, block(*ds.coeff(), dt.n2)


def _stage(tabs: tuple, lim: slice) -> tuple:
    return tuple(t[lim] for t in tabs)


def dist_ntt(x: torch.Tensor, dt: DistNttTables, ds: DistSpec
             ) -> torch.Tensor:
    """Forward negacyclic NTT of the rank's coefficient-layout block
    (..., L_loc, N1, N2_loc) -> its eval-layout block (..., L_loc,
    N1_loc, N2), int32. ONE all_to_all."""
    lim, cols = _local(dt, ds, x)
    q = dt.q[lim]
    q3 = q.reshape(-1, 1, 1)
    x = modops.mul_mod_shoup(x, dt.twist[lim][..., cols],
                             dt.twist_shoup[lim][..., cols], q3)
    x = _dft(x, _stage(dt.f1, lim), _stage(dt.f1_shoup, lim), q,
             inverse=False, along_rows=True)
    x = modops.mul_mod_shoup(x, dt.mid[lim][..., cols],
                             dt.mid_shoup[lim][..., cols], q3)
    x = _reshard(x, ds, to_row=True)
    return _dft(x, _stage(dt.f2, lim), _stage(dt.f2_shoup, lim), q,
                inverse=False, along_rows=False).to(_I32)


def dist_intt(x: torch.Tensor, dt: DistNttTables, ds: DistSpec
              ) -> torch.Tensor:
    """Inverse of dist_ntt: the rank's eval-layout block -> its coefficient
    layout block, scaled exactly (N^-1 folded into the post-twist)."""
    lim, cols = _local(dt, ds, x)
    q = dt.q[lim]
    q3 = q.reshape(-1, 1, 1)
    x = _dft(x, _stage(dt.i2, lim), _stage(dt.i2_shoup, lim), q,
             inverse=True, along_rows=False)
    x = _reshard(x, ds, to_row=False)
    x = modops.mul_mod_shoup(x, dt.imid[lim][..., cols],
                             dt.imid_shoup[lim][..., cols], q3)
    x = _dft(x, _stage(dt.i1, lim), _stage(dt.i1_shoup, lim), q,
             inverse=True, along_rows=True)
    return modops.mul_mod_shoup(x, dt.untwist[lim][..., cols],
                                dt.untwist_shoup[lim][..., cols],
                                q3).to(_I32)


# ---------------------------------------------------------------------------
# Layout conversion
# ---------------------------------------------------------------------------

def eval_perm(ring_dim: int, n1: int) -> np.ndarray:
    """perm[p] = j such that flat dist-eval position p = r*N2 + c holds the
    evaluation the ON-CHIP ntt() places at position j: (r, c) holds
    X(psi^(2k+1)), k = rev1(r) + N1*rev2(c), and on-chip position j holds
    X(psi^(2*rev_N(j)+1)), so j = rev_N(k)."""
    n2 = ring_dim // n1
    k = _bitrev_perm(n1)[:, None] + n1 * _bitrev_perm(n2)[None, :]
    return _bitrev_perm(ring_dim)[k].reshape(-1)


def _take_last(x, idx: np.ndarray):
    if torch.is_tensor(x):
        return x.index_select(-1, torch.as_tensor(idx, device=x.device))
    return np.asarray(x)[..., idx]


def to_dist_coeff(x, n1: int):
    """Coefficient order (..., L, N) -> dist coefficient layout
    (..., L, N1, N2): a row-major reshape."""
    n = x.shape[-1]
    return x.reshape(*x.shape[:-1], n1, n // n1)


def from_dist_coeff(x):
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def eval_to_dist(x_eval, n1: int):
    """On-chip eval order (..., L, N) -> dist eval layout (..., L, N1, N2),
    numpy or tensor (ciphertexts, NTT-domain keys)."""
    n = x_eval.shape[-1]
    return to_dist_coeff(_take_last(x_eval, eval_perm(n, n1)), n1)


def dist_to_eval(x_dist):
    """Inverse of eval_to_dist."""
    n1, n2 = x_dist.shape[-2:]
    inv = np.argsort(eval_perm(n1 * n2, n1))
    return _take_last(from_dist_coeff(x_dist), inv)


# ---------------------------------------------------------------------------
# Demo composite: sharded negacyclic polynomial multiply
# ---------------------------------------------------------------------------

def dist_poly_mul(a: torch.Tensor, b: torch.Tensor, dt: DistNttTables,
                  ds: DistSpec) -> torch.Tensor:
    """Negacyclic product of two coefficient-layout blocks, fully sharded:
    2 forward transforms + pointwise product + 1 inverse = 3 all_to_alls.
    The eval-domain product is variable x variable: modops.mul_mod (the
    value of the JAX package's Barrett mul_mod)."""
    ah = dist_ntt(a, dt, ds)
    bh = dist_ntt(b, dt, ds)
    lim, _ = _local(dt, ds, a)
    ph = modops.mul_mod(ah, bh, dt.q[lim].reshape(-1, 1, 1))
    return dist_intt(ph, dt, ds)
