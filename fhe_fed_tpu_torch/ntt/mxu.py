"""Four-step negacyclic NTT in signed base-256 digit planes.

Same method and the same tables as fhe_fed_tpu.ntt.mxu: N = n1 * n2, two
dense DFT stages (contract n1, then n2) around one elementwise twiddle
pass. Each stage is one (rows x 4S) @ (4S x 4S) integer product of the
input's four signed int8 digits against the DFT matrix premultiplied by
2**(8i) and re-split into four int8 output planes, so

    x @ M = sum_j 2**(8j) * P_j,   |P_j| <= 4 * S * 128 * 128 <= 2**23

for S <= 128. The negacyclic twists, N**-1 and both bit reversals are folded
into the tables, so the output order is exactly the butterfly ntt()'s
bit-reversed order.

The host tables are built here with the JAX package's own construction.
`ntt_mxu` / `intt_mxu` below are the plain PyTorch version of kernel K1
(csrc/ntt_mxu.cu): the digit-plane product runs as an f32 matmul, exact
because every partial sum stays below 2**24. int8 @ int8 is not used:
torch returns int8 for it and wraps.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..rns import primes as primes_mod
from ..rns import modops

_OFF_BITS = 24                     # plane offset: |P_j| <= 2^23 < 2^24
_OFF = 1 << _OFF_BITS


def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _pow_table_np(base: int, q: int, n: int) -> np.ndarray:
    """base**k mod q for k in [0, n) as uint64, via log-doubling."""
    pw = np.ones(1, dtype=np.uint64)
    b = np.uint64(base % q)
    qq = np.uint64(q)
    k = 1
    while k < n:
        pw = np.concatenate([pw, (pw * b) % qq])
        b = (b * b) % qq
        k *= 2
    return pw[:n]


def _digit_planes_rhs(M: np.ndarray, q: int) -> np.ndarray:
    """M: (Sout, S) uint64 residues mod q -> int8 rhs (4, S, 4*Sout):
    rhs[i, s, j*Sout + t] = digit_j( center( (2^(8i) * M[t, s]) mod q ) )."""
    s_out, s_in = M.shape
    out = np.empty((4, s_in, 4 * s_out), dtype=np.int8)
    for i in range(4):
        mi = (M.astype(object) * (1 << (8 * i))) % q   # exact
        mi = np.array(mi, dtype=np.int64)
        mi = np.where(mi > q // 2, mi - q, mi)         # |mi| < 2^30
        for j in range(4):
            d = ((mi + 128) & 255) - 128
            out[i, :, j * s_out:(j + 1) * s_out] = d.T.astype(np.int8)
            mi = (mi - d) >> 8
        assert np.all(mi == 0)
    return out


@functools.lru_cache(maxsize=None)
def _host_build(ring_dim: int, moduli: tuple, n1: int):
    n = ring_dim
    n2 = n // n1
    if not (n1 * n2 == n and n1 >= 2 and n2 >= 2 and max(n1, n2) <= 128):
        raise ValueError(f"no four-step digit-plane split for N={n}, n1={n1}")
    b1 = n1.bit_length() - 1
    b2 = n2.bit_length() - 1
    L = len(moduli)
    rev1 = np.array([_bitrev(r, b1) for r in range(n1)], dtype=np.int64)
    rev2 = np.array([_bitrev(c, b2) for c in range(n2)], dtype=np.int64)
    i1 = np.arange(n1, dtype=np.int64)
    i2 = np.arange(n2, dtype=np.int64)

    r1f = np.empty((L, 4, n1, 4 * n1), dtype=np.int8)
    r2f = np.empty((L, 4, n2, 4 * n2), dtype=np.int8)
    r1i = np.empty((L, 4, n1, 4 * n1), dtype=np.int8)
    r2i = np.empty((L, 4, n2, 4 * n2), dtype=np.int8)
    midf = np.empty((L, n1, n2), dtype=np.uint32)
    midi = np.empty((L, n1, n2), dtype=np.uint32)
    c32 = np.empty(L, dtype=np.uint32)
    offm = np.empty(L, dtype=np.uint32)
    for l, q in enumerate(moduli):
        psi = primes_mod.primitive_root_2n(q, n)
        ipsi = pow(psi, q - 2, q)
        om = psi * psi % q
        iom = pow(om, q - 2, q)
        ninv = pow(n, q - 2, q)
        pw_psi = _pow_table_np(psi, q, 2 * n)
        pw_ipsi = _pow_table_np(ipsi, q, 2 * n)
        pw_om = _pow_table_np(om, q, n)
        pw_iom = _pow_table_np(iom, q, n)
        w1 = pow(om, n2, q)
        w2 = pow(om, n1, q)
        pw_w1 = _pow_table_np(w1, q, n1)
        pw_w2 = _pow_table_np(w2, q, n2)
        pw_iw1 = _pow_table_np(pow(w1, q - 2, q), q, n1)
        pw_iw2 = _pow_table_np(pow(w2, q - 2, q), q, n2)
        qq = np.uint64(q)

        # Forward: M1f[r, n1] = W1^(rev1(r)*n1) * psi^(N2*n1)
        m1f = (pw_w1[(rev1[:, None] * i1[None, :]) % n1]
               * pw_psi[(n2 * i1[None, :]) % (2 * n)]) % qq
        # midf[r, c] = om^(rev1(r)*c) * psi^c
        midf[l] = ((pw_om[(rev1[:, None] * i2[None, :]) % n]
                    * pw_psi[i2[None, :]]) % qq).astype(np.uint32)
        # M2f[c, n2] = W2^(rev2(c)*n2)
        m2f = pw_w2[(rev2[:, None] * i2[None, :]) % n2]

        # Inverse: M2i[n2, c] = W2^(-rev2(c)*n2)
        m2i = pw_iw2[(rev2[None, :] * i2[:, None]) % n2]
        # midi[r, c] = om^(-rev1(r)*c) * psi^-c
        midi[l] = ((pw_iom[(rev1[:, None] * i2[None, :]) % n]
                    * pw_ipsi[i2[None, :]]) % qq).astype(np.uint32)
        # M1i[n1, r] = W1^(-rev1(r)*n1) * psi^(-N2*n1) * N^-1
        m1i = (pw_iw1[(rev1[None, :] * i1[:, None]) % n1]
               * pw_ipsi[(n2 * i1[:, None]) % (2 * n)]) % qq
        m1i = (m1i * np.uint64(ninv)) % qq

        r1f[l] = _digit_planes_rhs(m1f, q)
        r2f[l] = _digit_planes_rhs(m2f, q)
        r2i[l] = _digit_planes_rhs(m2i, q)
        r1i[l] = _digit_planes_rhs(m1i, q)
        c32[l] = (1 << 32) % q
        offm[l] = (_OFF * (1 + (1 << 8) + (1 << 16) + (1 << 24))) % q

    qs = np.asarray(moduli, dtype=np.uint32)
    return dict(r1f=r1f, r2f=r2f, r1i=r1i, r2i=r2i, midf=midf, midi=midi,
                c32=c32, offm=offm, q=qs)


@dataclasses.dataclass(frozen=True)
class MxuNttTables:
    """Digit-plane matrices and twiddles for the four-step NTT.

    The per-limb scalars (q, c32, c32_shoup, offm) stay on the host as numpy
    int64: the kernel takes them as launch arguments. The rest are tensors
    on the context's device. `*_nk` hold the same matrices as r1f .. r2i,
    reshaped to (L, 4*Sout, 4*S) and transposed so that the contraction
    index is contiguous: the layout of K1's tensor-core B operand."""
    ring_dim: int
    n1: int
    n2: int
    q: np.ndarray                   # (L,) int64
    c32: np.ndarray                 # (L,) 2^32 mod q
    c32_shoup: np.ndarray
    offm: np.ndarray                # (L,) reassembly offset mod q
    r1f: torch.Tensor               # (L, 4, N1, 4*N1) int8
    r2f: torch.Tensor               # (L, 4, N2, 4*N2) int8
    r1i: torch.Tensor
    r2i: torch.Tensor
    midf: torch.Tensor              # (L, N1, N2) int32
    midf_shoup: torch.Tensor        # (L, N1, N2) int64
    midi: torch.Tensor
    midi_shoup: torch.Tensor
    r1f_nk: torch.Tensor            # (L, 4*N1, 4*N1) int8, [n, k]
    r2f_nk: torch.Tensor
    r1i_nk: torch.Tensor
    r2i_nk: torch.Tensor

    @property
    def num_limbs(self) -> int:
        return int(self.q.shape[0])

    def slice_limbs(self, lo: int, hi: int) -> "MxuNttTables":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[lo:hi]
            for f in dataclasses.fields(self)
            if f.name not in ("ring_dim", "n1", "n2")})


def _default_n1(ring_dim: int) -> int:
    return 1 << ((ring_dim.bit_length() - 1) // 2)


def make_mxu_tables(ring_dim: int, moduli: tuple[int, ...],
                    n1: int | None = None,
                    device: torch.device | str = "cpu") -> MxuNttTables:
    """Default split: near-square with N2 >= N1, both <= 128."""
    if n1 is None:
        n1 = _default_n1(ring_dim)
    h = _host_build(ring_dim, tuple(int(m) for m in moduli), n1)
    qs = h["q"].astype(np.int64)
    sh = modops.shoup_precompute

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a).astype(dtype),
                               device=device)

    def nk(r):
        L, _, s, s4 = r.shape
        return t(np.swapaxes(r.reshape(L, 4 * s, s4), 1, 2), np.int8)

    return MxuNttTables(
        ring_dim=ring_dim, n1=n1, n2=ring_dim // n1,
        q=qs, c32=h["c32"].astype(np.int64), c32_shoup=sh(h["c32"], qs),
        offm=h["offm"].astype(np.int64),
        r1f=t(h["r1f"], np.int8), r2f=t(h["r2f"], np.int8),
        r1i=t(h["r1i"], np.int8), r2i=t(h["r2i"], np.int8),
        midf=t(h["midf"], np.int32),
        midf_shoup=t(sh(h["midf"], qs[:, None, None]), np.int64),
        midi=t(h["midi"], np.int32),
        midi_shoup=t(sh(h["midi"], qs[:, None, None]), np.int64),
        r1f_nk=nk(h["r1f"]), r2f_nk=nk(h["r2f"]),
        r1i_nk=nk(h["r1i"]), r2i_nk=nk(h["r2i"]))


def mxu_viable(ring_dim: int, n1: int | None = None) -> bool:
    """True when both local DFT sizes of the four-step split are <= 128."""
    if n1 is None:
        n1 = _default_n1(ring_dim)
    n2 = ring_dim // n1
    return (n1 * n2 == ring_dim and n1 >= 2 and n2 >= 2
            and max(n1, n2) <= 128)


# ---------------------------------------------------------------------------
# Plain PyTorch version of kernel K1
# ---------------------------------------------------------------------------

def _stage(x: torch.Tensor, rhs: torch.Tensor,
           q: torch.Tensor) -> torch.Tensor:
    """One DFT stage along the LAST axis.

    x: (L, B, F, S) int64 residues; rhs: (L, 4, S, 4*S) int8; q: (L,) int64.
    Returns (L, B, F, S) int64 residues."""
    L, B, F, S = x.shape
    qb = q.view(L, 1, 1, 1)
    xs = x - torch.where(x > (qb >> 1), qb, 0)         # centred, |xs| < 2^30
    ds = []
    for _ in range(4):
        d = ((xs + 128) & 255) - 128
        ds.append(d)
        xs = (xs - d) >> 8
    lhs = torch.stack(ds, dim=-2).reshape(L, B * F, 4 * S)
    planes = torch.bmm(lhs.to(torch.float32),
                       rhs.reshape(L, 4 * S, 4 * S).to(torch.float32))
    p = planes.to(torch.int64).view(L, B, F, 4, S)
    v = p[..., 0, :] + (p[..., 1, :] << 8) + (p[..., 2, :] << 16) \
        + (p[..., 3, :] << 24)                          # |v| < 2^48, exact
    return torch.remainder(v, qb)


def _twiddle(y, mid, mid_shoup, q):
    L = q.shape[0]
    return modops.mul_mod_shoup(y, mid[:, None], mid_shoup[:, None],
                                q.view(L, 1, 1, 1))


def _to_lbrc(x: torch.Tensor, n1: int, n2: int):
    L = x.shape[-2]
    return x.reshape(-1, L, n1, n2).transpose(0, 1).to(torch.int64)


def _from_lbrc(x: torch.Tensor, shape) -> torch.Tensor:
    return x.transpose(0, 1).reshape(shape).to(torch.int32)


def _check(x: torch.Tensor, mt: MxuNttTables):
    if x.shape[-1] != mt.ring_dim or x.shape[-2] != mt.num_limbs:
        raise ValueError(f"NTT input {tuple(x.shape)} does not match tables "
                         f"(L={mt.num_limbs}, N={mt.ring_dim})")


def ntt_mxu(x: torch.Tensor, mt: MxuNttTables) -> torch.Tensor:
    """Forward negacyclic NTT of int32 residues (..., L, N): coefficient
    order -> the butterfly ntt()'s bit-reversed evaluation order."""
    _check(x, mt)
    q = torch.as_tensor(mt.q, device=x.device)
    xm = _to_lbrc(x, mt.n1, mt.n2)                     # (L, B, n1, n2)
    y = _stage(xm.transpose(-1, -2), mt.r1f, q)        # contract n1
    y = _twiddle(y.transpose(-1, -2), mt.midf, mt.midf_shoup, q)
    z = _stage(y, mt.r2f, q)                           # contract n2
    return _from_lbrc(z, x.shape)


def intt_mxu(x: torch.Tensor, mt: MxuNttTables) -> torch.Tensor:
    """Inverse: bit-reversed evaluation order -> coefficient order, scaled
    by N**-1 (folded into the tables)."""
    _check(x, mt)
    q = torch.as_tensor(mt.q, device=x.device)
    xm = _to_lbrc(x, mt.n1, mt.n2)                     # (L, B, r, c)
    u = _stage(xm, mt.r2i, q)                          # contract n2
    u = _twiddle(u, mt.midi, mt.midi_shoup, q)
    v = _stage(u.transpose(-1, -2), mt.r1i, q)         # contract n1
    return _from_lbrc(v.transpose(-1, -2), x.shape)
