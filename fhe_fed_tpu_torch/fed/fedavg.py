"""Federated averaging under encryption over nested containers of tensors,
as fhe_fed_tpu.fed.fedavg.

Selective encryption (by layer, or the first `rate` fraction of every
tensor) is a per-leaf policy, planned once by `tree_average.leaf_plan`:
the encrypted prefixes of all leaves are concatenated into one vector a
client and run as one ciphertext batch, the plain remainder is averaged
directly.

Leaves are ordered as `jax.tree_util.tree_flatten` orders them, so a
`layer_mask` picks the same leaves in both packages: a plain dict by
sorted key, an OrderedDict (every torch `state_dict`) by insertion, lists
and tuples by position. Anything else is a leaf. A leaf's path is its
keys and positions joined by "." (a state_dict's leaf: its key, as
"model.layers.3.self_attn.q_proj.weight"); a callable `layer_mask` is
given (index, path).

`fhe_fedavg` runs one flow for every tree, on the leaves' device when
every leaf of every client is a tensor on one device (a model's state
dicts where training left them) and on the CPU otherwise (numpy arrays,
JAX arrays, scalars, devices mixed): tree_average gathers the encrypted
prefixes into one (K, E) buffer and averages the plain remainder in
float64 into one float32 output in layout order, reading the leaves in
place (contiguous float32 leaves, and on the card contiguous bfloat16
ones, as they lie; any other leaf is first copied to float32, counted in
`tree_average.casts`); the (K, E) buffer goes to the scheme's
`fedavg_round` as it lies where the scheme declares that it takes a
tensor (`fedavg_round_takes_tensor`: the port's CKKS, which packs it on
its device and returns the average there), else as K host vectors; the
decrypted average is scattered into the same output, whose leaves come
back as float32 CPU views of one buffer in the input's containers. On the
card the entries launch the kernel csrc/tree_average.cu, on the CPU they
run their plain versions; either gives the JAX package's result bit for
bit.

Each stage of `fhe_fedavg` is a span (utils/spans.py): `fhe.tree_flatten`
(the leaves, their plan and the cohort's table), `fhe.tree_split` (the
gather, with its copy to the host for a scheme that takes host vectors,
and the scatter), `fhe.plain_average` (the average), `fhe.encrypted_part`
(the scheme's calls) and `fhe.tree_unflatten` (the output's copy to the
host and its views).
`flatten_params`, `split_by_policy`, `merge_by_policy` and
`unflatten_params` keep the JAX package's numpy API, for `plain_fedavg`
and the benchmarks.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import weakref

import numpy as np
import torch

from ..utils.spans import span, traced
from . import tree_average


@dataclasses.dataclass(frozen=True)
class SelectivePolicy:
    """Which parts of the model get encrypted.

    layer_mask: optional list/set of leaf indices (or a predicate on
        (index, path)) selecting leaves to encrypt entirely.
    rate: optional fraction p in [0, 1]: encrypt the first ceil(p * size)
        elements of every (selected) leaf.
    """
    layer_mask: object = None
    rate: float | None = None

    def leaf_selected(self, idx: int, path=None) -> bool:
        if self.layer_mask is None:
            return True
        if callable(self.layer_mask):
            return bool(self.layer_mask(idx, path))
        return idx in self.layer_mask

    def enc_count(self, size: int) -> int:
        if self.rate is None:
            return size
        return min(size, math.ceil(self.rate * size))


FULL = SelectivePolicy()


def _children(node):
    """(keys, children, rebuild) of a container node, or None for a
    leaf."""
    kind = type(node)
    if kind is collections.OrderedDict:
        keys = list(node)
        return (keys, [node[k] for k in keys],
                lambda ch: collections.OrderedDict(zip(keys, ch)))
    if kind is dict:
        keys = sorted(node)
        return keys, [node[k] for k in keys], lambda ch: dict(zip(keys, ch))
    if kind in (list, tuple):
        return range(len(node)), list(node), kind
    return None


def _flatten(node, leaves: list, paths: list | None = None,
             prefix: str = ""):
    """Append node's leaves in order (and their paths to `paths`); return
    its structure."""
    ch = _children(node)
    if ch is None:
        leaves.append(node)
        if paths is not None:
            paths.append(prefix)
        return None
    keys, children, rebuild = ch
    return rebuild, [_flatten(c, leaves, paths,
                              f"{prefix}.{k}" if prefix else str(k))
                     for k, c in zip(keys, children)]


def _unflatten(struct, it):
    if struct is None:
        return next(it)
    rebuild, subs = struct
    return rebuild([_unflatten(s, it) for s in subs])


def tree_leaves(tree) -> list:
    """The leaves of nested containers, in flatten_params' order."""
    leaves: list = []
    _flatten(tree, leaves)
    return leaves


def tree_map(fn, tree):
    """The same containers with fn applied to every leaf."""
    leaves: list = []
    struct = _flatten(tree, leaves)
    return _unflatten(struct, iter([fn(x) for x in leaves]))


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        # numpy has no bfloat16; float32 holds each of its values exactly.
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


@traced("fhe.tree_flatten")
def flatten_params(tree):
    """Nested containers of tensors or arrays -> (flat float32 vector,
    spec); spec is (structure, shapes, sizes, paths)."""
    leaves: list = []
    paths: list = []
    struct = _flatten(tree, leaves, paths)
    arrays = [_numpy(x) for x in leaves]
    flats = [a.reshape(-1).astype(np.float32) for a in arrays]
    flat = np.concatenate(flats) if flats else np.zeros(0, np.float32)
    return flat, (struct, [a.shape for a in arrays], [f.size for f in flats],
                  paths)


@traced("fhe.tree_unflatten")
def unflatten_params(flat, spec):
    """Inverse of flatten_params: float32 CPU tensors in the input's
    containers (a state_dict comes back as an OrderedDict that
    `load_state_dict` takes)."""
    struct, shapes, sizes, _ = spec
    out = []
    off = 0
    for shp, sz in zip(shapes, sizes):
        out.append(torch.from_numpy(np.array(
            flat[off:off + sz], dtype=np.float32).reshape(shp)))
        off += sz
    return _unflatten(struct, iter(out))


@traced("fhe.tree_split")
def split_by_policy(flat, spec, policy: SelectivePolicy):
    """Split a flat model vector into (encrypted_part, plain_part, plan);
    plan records per-leaf (enc_len, plain_len) so the split is invertible.
    The plan is tree_average.leaf_plan's: the policy sees each leaf's index
    and path."""
    p = tree_average.leaf_plan(spec[2], spec[3], policy)
    segs = list(zip(p.out.tolist(), p.k.tolist(), p.sizes.tolist()))
    return (_cat([flat[o:o + k] for o, k, _ in segs]),
            _cat([flat[o + k:o + n] for o, k, n in segs]), p.plan)


@traced("fhe.tree_split")
def merge_by_policy(enc, plain, plan):
    out = []
    eo = po = 0
    for k, r in plan:
        out.append(enc[eo:eo + k])
        out.append(plain[po:po + r])
        eo += k
        po += r
    return _cat(out)


def _cat(segs: list) -> np.ndarray:
    return np.concatenate(segs) if segs else np.zeros(0, np.float32)


def fhe_fedavg(scheme, client_params: list, weights: list[float],
               policy: SelectivePolicy = FULL, use_bytes: bool = False):
    """End-to-end secure FedAvg over nested containers of tensors.

    scheme: a fed.api.CKKS (or any Scheme) with keys loaded.
    client_params: one container per client, all of the same structure.
    weights: scaling factors, typically summing to 1.
    use_bytes: force the per-client bytes path (encrypt /
        computeWeightedAverage / decrypt) on host vectors; by default the
        cohort goes through scheme.fedavg_round where the scheme has one:
        the gathered (K, E) buffer as it lies where the scheme declares
        `fedavg_round_takes_tensor`, else K host vectors.

    Returns the aggregated container of float32 CPU tensors, views of one
    fresh host buffer (a state_dict comes back as an OrderedDict that
    `load_state_dict` takes). The plain remainder of a selective policy is
    averaged directly in f64, on the leaves' device (the module docstring
    has the flow).
    """
    if len(client_params) != len(weights):
        raise ValueError("one weight per client")
    with span("fhe.tree_flatten"):
        paths: list = []
        struct = _flatten(client_params[0], [], paths)
        if not paths:
            return _unflatten(struct, iter([]))
        leaves = [[_tensor(x) for x in tree_leaves(p)] for p in client_params]
        _count_aliases(leaves, paths)
        devices = {x.device for lv in leaves for x in lv}
        dev = devices.pop() if len(devices) == 1 else torch.device("cpu")
        shapes = [tuple(x.shape) for x in leaves[0]]
        cohort = tree_average.Cohort(
            tree_average.leaf_plan([x.numel() for x in leaves[0]], paths,
                                   policy),
            _cohort_leaves(leaves, dev), weights)
        out = cohort.empty_output()
    plan = cohort.plan
    if plan.enc[-1]:
        with span("fhe.tree_split"):
            encs = tree_average.gather(cohort)
            if use_bytes or not getattr(scheme, "fedavg_round_takes_tensor",
                                        False):
                encs = list(_to_host(encs).numpy())
    if plan.plain[-1]:
        with span("fhe.plain_average"):
            tree_average.average(cohort, out)
    if plan.enc[-1]:
        enc_out = _encrypted_part(scheme, encs, weights, use_bytes)
        with span("fhe.tree_split"):
            tree_average.scatter(cohort, torch.as_tensor(enc_out).to(
                cohort.device), out)
    with span("fhe.tree_unflatten"):
        host = _to_host(out)
        views = [host[o:o + n].view(shp) for o, n, shp in
                 zip(plan.out.tolist(), plan.sizes.tolist(), shapes)]
        return _unflatten(struct, iter(views))


def _encrypted_part(scheme, encs, weights, use_bytes: bool):
    """The decrypted weighted average of the K encrypted vectors, float32:
    of a (K, E) tensor, an (E,) tensor on the scheme's device; of K host
    vectors, an ndarray."""
    with span("fhe.encrypted_part"):
        if torch.is_tensor(encs):
            return scheme.fedavg_round(encs, list(weights), encs.shape[1])
        if not use_bytes and hasattr(scheme, "fedavg_round"):
            return scheme.fedavg_round(
                encs, list(weights), encs[0].size).astype(np.float32)
        blobs = [scheme.encrypt(e) for e in encs]
        agg_blob = scheme.computeWeightedAverage(blobs, list(weights))
        return scheme.decrypt(agg_blob, encs[0].size).astype(np.float32)


class HostBlocks:
    """Page-locked host blocks of exact sizes, each reused once every
    tensor on it is freed, and never given back. Torch's host caching
    allocator rounds a block up to a power of two, so a 12.2 GB tree (3.06
    billion float32 values) would take 16 GiB, and the few such trees a
    caller holds at once more than the host has; above EXACT_BYTES
    `_to_host` takes its blocks from here. `register(address, bytes)`
    page-locks a block (cudaHostRegister), after which the card copies
    into it as into torch's pinned memory."""

    def __init__(self, register=None):
        self.free = collections.defaultdict(list)
        self.register = register or _cuda_host_register

    def empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An uninitialised tensor on a free block of its exact size."""
        nbytes = math.prod(shape) * dtype.itemsize
        free = self.free[nbytes]
        if free:
            block = free.pop()
        else:
            block = np.empty(nbytes, np.uint8)
            # Fault the pages in on every core at once: page-locking does
            # it page by page on one.
            torch.from_numpy(block).zero_()
            self.register(block.ctypes.data, nbytes)
        lease = block.view()
        weakref.finalize(lease, free.append, block)
        return torch.from_numpy(lease).view(dtype).view(shape)

    def reserve(self, shape, dtype: torch.dtype, count: int) -> None:
        """Make `count` blocks for tensors of `shape` and `dtype` free ahead
        of use, so that no call page-locks a new one."""
        held = [self.empty(shape, dtype) for _ in range(count)]
        del held


def _cuda_host_register(address: int, nbytes: int) -> None:
    err = int(torch.cuda.cudart().cudaHostRegister(address, nbytes, 0))
    if err:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes: error {err}")


host_blocks = HostBlocks()
EXACT_BYTES = 1 << 33


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host: a CPU tensor as it is; from the card a new copy in
    pinned memory, from torch's host caching allocator up to EXACT_BYTES
    (8 GiB) and from `host_blocks` above it. A pinned copy takes 2.14 GB
    in ~39 ms on an H100 where a pageable copy took 150-900 ms; a block is
    reused only once the tensors on it are freed."""
    if not t.is_cuda:
        return t
    if t.numel() * t.element_size() > EXACT_BYTES:
        return host_blocks.empty(t.shape, t.dtype).copy_(t)
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _count_aliases(leaves: list, paths: list) -> None:
    """One count in `tree_average.aliases`, under its path, for each leaf
    of a client that is an earlier leaf's memory (a tied embedding's two
    keys): the cohort reads it, and the policy encrypts its prefix, under
    each key."""
    for lv in leaves:
        seen = set()
        for x, path in zip(lv, paths):
            if x.numel():
                at = (x.device, x.data_ptr(), x.dtype, x.numel())
                if at in seen:
                    tree_average.aliases[path] += 1
                seen.add(at)


def _cohort_leaves(leaves: list, dev: torch.device) -> list:
    """The clients' leaves as a Cohort reads them on `dev`: leaf i as it
    lies where every client's is contiguous on `dev` and of one dtype the
    cohort reads there (float32; on the card bfloat16 too); else each
    client's copied to contiguous float32 on `dev` (a float32 leaf already
    so stays), rounded as numpy's astype(np.float32) rounds (float16,
    bfloat16 and small integers exactly), one count a copy in
    `tree_average.casts`."""
    keep = tree_average.DTYPES if dev.type == "cuda" else (torch.float32,)
    out = [[] for _ in leaves]
    for column in zip(*leaves):
        dtype = column[0].dtype
        as_is = dtype in keep and all(
            x.dtype == dtype and x.device == dev and x.is_contiguous()
            for x in column)
        for lv, x in zip(out, column):
            if not as_is and not (x.dtype == torch.float32
                                  and x.device == dev and x.is_contiguous()):
                tree_average.casts[str(x.dtype).removeprefix("torch.")] += 1
                x = x.to(dev, torch.float32).contiguous()
            lv.append(x.detach())
    return out


def _tensor(x) -> torch.Tensor:
    """A leaf as a tensor: a tensor as it is; anything else (numpy and JAX
    arrays, scalars) as a float32 CPU tensor, converted as the JAX package
    converts it."""
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.asarray(x).astype(np.float32))


def plain_fedavg(client_params: list, weights: list[float]):
    """Plaintext FedAvg baseline: the f64 weighted sum, as float32."""
    flats, specs = zip(*(flatten_params(p) for p in client_params))
    agg = sum(w * f.astype(np.float64) for w, f in zip(weights, flats))
    return unflatten_params(agg.astype(np.float32), specs[0])
