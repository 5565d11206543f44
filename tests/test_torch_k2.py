"""CPU rehearsal of kernel K2's register-resident stage groups
(fhe_fed_tpu_torch/csrc/ntt_butterfly.cu), against the port's plain
butterfly (ntt.ntt_butterfly / intt_butterfly).

`_k2` runs the kernel's schedule on one polynomial: the same split of the
in-block stages into groups (`rest_groups`, `rest_size`: five-stage
contiguous group at the span-1 end), each thread's unit of 2^K residues
(base + r * 2^LS), the twiddle index of every stage in a group (forward
(twk * m0 + b) << j + sb, inverse twk * m_j + (b << (K-1-j)) + sb, twk =
H + h), the two halves of N = 65536 (the forward's cross-half stage on
load, the inverse's from the partner's half), the swizzled shared-memory
addresses, and the unsigned-min arithmetic on u32 words with the source's
bounds asserted on every intermediate, and the coalesced copy-out. The
layout tests check that each
group covers the block once, that the swizzle of 16-byte chunks is the
word swizzle, that no warp access has a bank conflict, and that a 16-byte
twiddle load is 16-byte aligned.
"""

import numpy as np
import pytest
import torch

from fhe_fed_tpu_torch.ntt import tables as T_tables, ntt as T_ntt
from fhe_fed_tpu_torch.rns import primes

torch.set_num_threads(1)

GROUP = 5                 # kGroup: stages of the contiguous group
WORD = 2 ** 32
MASK = WORD - 1


def rest_groups(S):
    return (S - 1) // GROUP


def rest_size(S, g):
    rest, ng = S - GROUP, rest_groups(S)
    return rest // ng + (1 if g < rest % ng else 0)


def threads(S):
    return 512 if S >= 14 else 1 << (S - GROUP)


def groups(S, forward):
    """(K, LS) of each group in the order the kernel runs them."""
    rest, done = [], 0
    for g in range(rest_groups(S)):
        K = rest_size(S, g)
        rest.append((K, S - done - K if forward else GROUP + done))
        done += K
    return rest + [(GROUP, 0)] if forward else [(GROUP, 0)] + rest


def swz(a):
    return a ^ (((a >> 5) & 7) << 2)


def swz4(c):
    return c ^ ((c >> 3) & 7)


# -- the kernel's arithmetic on u32 words, bounds asserted --------------------

def _reduce(r, q):
    assert bool((r >= 0).all()) and bool((r < 2 * q).all())
    return torch.minimum(r, (r - q) & MASK)


def _canon(*xs, q):
    for x in map(torch.as_tensor, xs):
        assert bool((x >= 0).all()) and bool((x < q).all())


def addq(a, b, q):
    _canon(a, b, q=q)
    return _reduce(a + b, q)             # a + b < 2q < 2^32


def subq(a, b, q):
    _canon(a, b, q=q)
    d = (a - b) & MASK
    return torch.minimum(d, (d + q) & MASK)


def mulq(x, w, ws, q):
    """Shoup: x*w - umulhi(x, ws)*q, exact in [0, 2q) (asserted before the
    low 32 bits are taken), then reduced."""
    x, w, ws = map(torch.as_tensor, (x, w, ws))
    _canon(w, q=q)
    assert bool((x >= 0).all()) and bool((x < WORD).all())
    assert bool((ws >= 0).all()) and bool((ws < WORD).all())
    return _reduce(x * w - ((x * ws) >> 32) * q, q)


def _units(S, K, LS):
    u = torch.arange(1 << (S - K))
    b = u >> LS
    base = (b << (LS + K)) | (u & ((1 << LS) - 1))
    return u, b, base[:, None] + (torch.arange(1 << K) << LS)[None]


def _group(st, S, K, LS, forward, load_g):
    """One group over every unit at once, written back to shared memory;
    `st` holds the block's swizzled shared memory `s`, its input `gin`,
    twiddles, twk."""
    q = st["q"]
    R = 1 << K
    _, b, idx = _units(S, K, LS)
    v = (st["gin"][idx] if load_g else st["s"][swz(idx)]).clone()
    tw, tws, twk = st["tw"], st["tws"], st["twk"]
    for j in range(K):
        if forward:
            half, nb = R >> (j + 1), 1 << j
            first = (twk * (1 << (S - K - LS)) + b) << j
        else:
            half, nb = 1 << j, R >> (j + 1)
            first = twk * (1 << (S - 1 - j - LS)) + (b << (K - 1 - j))
        if nb >= 2:             # 16-byte loads: even first pair index
            assert bool((first % 2 == 0).all())
        for sb in range(nb):
            w, ws = tw[first + sb], tws[first + sb]
            for r0 in range(half):
                r = sb * 2 * half + r0
                x, y = v[:, r], v[:, r + half]
                if forward:
                    y = mulq(y, w, ws, q)
                    v[:, r], v[:, r + half] = addq(x, y, q), subq(x, y, q)
                else:
                    v[:, r], v[:, r + half] = (
                        addq(x, y, q), mulq(subq(x, y, q), w, ws, q))
    st["s"][swz(idx)] = v


def _run_groups(st, S, forward, H):
    """The groups, the first reading device memory (not the two-block
    forward's: its load stage filled shared memory), then the coalesced
    copy-out of the block (times N^-1 for the one-block inverse)."""
    for i, (K, LS) in enumerate(groups(S, forward)):
        _group(st, S, K, LS, forward,
               load_g=i == 0 and (H == 1 or not forward))
    words = torch.arange(1 << S)
    if forward:
        st["gout"][words] = st["s"][swz(words)]
    elif H == 1:
        st["gout"][words] = mulq(st["s"][swz(words)], st["ni"], st["nis"],
                                 st["q"])


def _k2(x, tb, forward):
    """The kernel on one polynomial of limb 0: x (N,) int32 -> (N,)."""
    n = tb.ring_dim
    H = 2 if n == 65536 else 1
    nl = n // H
    S = nl.bit_length() - 1
    q = int(tb.q[0])
    tw = (tb.tab if forward else tb.itab)[0].to(torch.int64)
    tws = (tb.tab_shoup if forward else tb.itab_shoup)[0].to(torch.int64)
    x = x.to(torch.int64)
    out = torch.full((n,), -1, dtype=torch.int64)
    blocks = []
    for h in range(H):
        st = dict(q=q, tw=tw, tws=tws, twk=H + h, ni=int(tb.ninv[0]),
                  nis=int(tb.ninv_shoup[0]), gin=x[h * nl:(h + 1) * nl],
                  gout=out[h * nl:(h + 1) * nl],
                  s=torch.full((nl,), -1, dtype=torch.int64))
        if forward and H == 2:
            # tab[1] pairs i with i + N/2 on load: block 0 the sums.
            u, v = x[:nl], mulq(x[nl:], tw[1], tws[1], q)
            words = torch.arange(nl)
            st["s"][swz(words)] = addq(u, v, q) if h == 0 else subq(u, v, q)
        _run_groups(st, S, forward, H)
        blocks.append(st)
    if not forward and H == 2:
        words = torch.arange(nl)
        x0, x1 = (blk["s"][swz(words)] for blk in blocks)
        halves = (addq(x0, x1, q), mulq(subq(x0, x1, q), tw[1], tws[1], q))
        for h in range(2):
            out[h * nl:(h + 1) * nl] = mulq(halves[h], blocks[h]["ni"],
                                            blocks[h]["nis"], q)
    assert bool((out >= 0).all())
    return out.to(torch.int32)


def _modulus(n, kind):
    if kind == "near_2_31":
        q = primes.ntt_primes(n, 1)[0]
        assert (2 ** 31 - q) < 2 ** 31 * 2 ** -13
        return q
    rng = np.random.default_rng(n)
    bits = int(rng.integers(25, 31))
    return primes.ntt_primes(n, 4, target_bits=bits)[int(rng.integers(4))]


@pytest.mark.parametrize("kind", ["near_2_31", "random"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [256, 2048, 32768, 65536])
def test_k2_groups_match_butterfly(n, forward, kind):
    tb = T_tables.make_tables(n, (_modulus(n, kind),))
    rng = np.random.default_rng(n + forward)
    x = torch.as_tensor(rng.integers(0, int(tb.q[0]), size=(1, 1, n))
                        .astype(np.int32))
    plain = T_ntt.ntt_butterfly if forward else T_ntt.intt_butterfly
    assert torch.equal(_k2(x[0, 0], tb, forward), plain(x, tb)[0, 0])


@pytest.mark.parametrize("S,split", [
    (8, [3, 5]), (9, [4, 5]), (10, [5, 5]), (11, [3, 3, 5]),
    (12, [4, 3, 5]), (13, [4, 4, 5]), (14, [5, 4, 5]), (15, [5, 5, 5])])
def test_k2_group_split(S, split):
    """The stage split for every ring 256 .. 32768 (and each half of
    65536): the contiguous group last in the forward, first in the inverse,
    every other group of stride >= 32, all stages covered."""
    fwd, inv = groups(S, True), groups(S, False)
    assert [k for k, _ in fwd] == split
    assert [k for k, _ in inv] == split[-1:] + split[:-1]
    for gs in (fwd, inv):
        assert sum(k for k, _ in gs) == S
        assert all(ls >= 5 for k, ls in gs if ls) and \
            [ls for _, ls in gs].count(0) == 1
    assert (1 << (S - GROUP)) % threads(S) == 0


@pytest.mark.parametrize("S", range(8, 16))
def test_k2_layout_covers_and_is_conflict_free(S):
    """Each group's units cover the block's words once; 16-byte chunk
    swizzle == word swizzle; per warp and thread-loop step, a strided
    access of the r-th residue hits each bank at most once, a contiguous
    16-byte access (quarter warps of 8 threads) 8 distinct chunks of a
    row."""
    nl = 1 << S
    words = torch.arange(nl)
    assert torch.equal(torch.sort(swz(words)).values, words)
    chunk = words[: nl // 4, None]
    assert torch.equal(4 * swz4(chunk) + torch.arange(4),
                       swz(4 * chunk + torch.arange(4)))
    T = threads(S)
    for K, LS in set(groups(S, True) + groups(S, False)):
        _, _, idx = _units(S, K, LS)
        assert torch.equal(torch.sort(idx.flatten()).values, words)
        W = min(T, 32)                           # a block below 32: one warp
        warps = idx.view(-1, T // W, W, 1 << K)  # loop step, warp, lane, r
        if LS:
            banks = torch.sort(swz(warps) % 32, dim=2).values
            assert bool((banks.diff(dim=2) > 0).all())
        else:
            chunks = swz4(warps[..., ::4] // 4)   # 16-byte accesses
            quarter = chunks.view(*chunks.shape[:2], W // 8, 8, -1) % 8
            assert bool((torch.sort(quarter, dim=3).values
                         == torch.arange(8)[:, None]).all())


def test_k2_launch_constants_cached_per_table():
    """The wrapper's (3, 64) launch constants: built once per table,
    the right rows, zero-padded; a table's slice gets its own, and asking
    for the same slice again gives the same table (and constants)."""
    tb = T_tables.make_tables(512, primes.ntt_primes(512, 3))
    block = tb.k2_consts
    assert block is tb.k2_consts and tb.k2_consts_ptr == block.ctypes.data
    assert block.shape == (3, 64) and block.dtype == np.uint32
    for row, v in enumerate((tb.q, tb.ninv, tb.ninv_shoup)):
        assert np.array_equal(block[row, :3], v)
    assert not block[:, 3:].any()
    part = tb.slice_limbs(1, 3)
    assert np.array_equal(part.k2_consts[0, :2], tb.q[1:3])
    assert tb.slice_limbs(1, 3) is part
    assert tb.take([2, 0]) is tb.take(np.array([2, 0]))
    assert np.array_equal(tb.take([2, 0]).k2_consts[0, :2], tb.q[[2, 0]])
