"""Federated averaging under encryption over nested containers of tensors,
as fhe_fed_tpu.fed.fedavg.

The whole model is flattened once into one vector, encrypted in one cohort
call, aggregated in one weighted sum and unflattened. Selective encryption
(by layer, or the first `rate` fraction of every tensor) is a per-leaf
policy: the encrypted segments of all leaves are concatenated and run as
one ciphertext batch, the plain remainder is averaged directly.

Leaves are ordered as `jax.tree_util.tree_flatten` orders them, so a
`layer_mask` picks the same leaves in both packages: a plain dict by
sorted key, an OrderedDict (every torch `state_dict`) by insertion, lists
and tuples by position. Anything else is a leaf.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch


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
    """(children, rebuild) of a container node, or None for a leaf."""
    kind = type(node)
    if kind is collections.OrderedDict:
        keys = list(node)
        return ([node[k] for k in keys],
                lambda ch: collections.OrderedDict(zip(keys, ch)))
    if kind is dict:
        keys = sorted(node)
        return [node[k] for k in keys], lambda ch: dict(zip(keys, ch))
    if kind in (list, tuple):
        return list(node), kind
    return None


def _flatten(node, leaves: list):
    """Append node's leaves in order; return its structure."""
    ch = _children(node)
    if ch is None:
        leaves.append(node)
        return None
    children, rebuild = ch
    return rebuild, [_flatten(c, leaves) for c in children]


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
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten_params(tree):
    """Nested containers of tensors or arrays -> (flat float32 vector,
    spec)."""
    leaves: list = []
    struct = _flatten(tree, leaves)
    arrays = [_numpy(x) for x in leaves]
    flats = [a.reshape(-1).astype(np.float32) for a in arrays]
    flat = np.concatenate(flats) if flats else np.zeros(0, np.float32)
    return flat, (struct, [a.shape for a in arrays], [f.size for f in flats])


def unflatten_params(flat, spec):
    """Inverse of flatten_params: float32 CPU tensors in the input's
    containers (a state_dict comes back as an OrderedDict that
    `load_state_dict` takes)."""
    struct, shapes, sizes = spec
    out = []
    off = 0
    for shp, sz in zip(shapes, sizes):
        out.append(torch.from_numpy(np.array(
            flat[off:off + sz], dtype=np.float32).reshape(shp)))
        off += sz
    return _unflatten(struct, iter(out))


def split_by_policy(flat, spec, policy: SelectivePolicy):
    """Split a flat model vector into (encrypted_part, plain_part, plan);
    plan records per-leaf (enc_len, plain_len) so the split is invertible."""
    _, _, sizes = spec
    enc_segs, plain_segs, plan = [], [], []
    off = 0
    for idx, sz in enumerate(sizes):
        leaf = flat[off:off + sz]
        off += sz
        k = policy.enc_count(sz) if policy.leaf_selected(idx) else 0
        enc_segs.append(leaf[:k])
        plain_segs.append(leaf[k:])
        plan.append((k, sz - k))
    enc = (np.concatenate(enc_segs) if enc_segs
           else np.zeros(0, np.float32))
    plain = (np.concatenate(plain_segs) if plain_segs
             else np.zeros(0, np.float32))
    return enc, plain, plan


def merge_by_policy(enc, plain, plan):
    out = []
    eo = po = 0
    for k, r in plan:
        out.append(enc[eo:eo + k])
        out.append(plain[po:po + r])
        eo += k
        po += r
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def fhe_fedavg(scheme, client_params: list, weights: list[float],
               policy: SelectivePolicy = FULL, use_bytes: bool = False):
    """End-to-end secure FedAvg over nested containers of tensors.

    scheme: a fed.api.CKKS (or any Scheme) with keys loaded.
    client_params: one container per client, all of the same structure.
    weights: scaling factors, typically summing to 1.
    use_bytes: force the per-client bytes path (encrypt /
        computeWeightedAverage / decrypt); by default the cohort goes
        through scheme.fedavg_round where the scheme has one.

    Returns the aggregated container (unflatten_params). The plain
    remainder of a selective policy is averaged directly in f64.
    """
    if len(client_params) != len(weights):
        raise ValueError("one weight per client")
    flats, specs = zip(*(flatten_params(p) for p in client_params))
    spec = specs[0]

    encs, plains = [], []
    plan = None
    for f in flats:
        e, pl, plan = split_by_policy(f, spec, policy)
        encs.append(e)
        plains.append(pl)

    if encs[0].size:
        if not use_bytes and hasattr(scheme, "fedavg_round"):
            enc_out = scheme.fedavg_round(
                encs, list(weights), encs[0].size).astype(np.float32)
        else:
            blobs = [scheme.encrypt(e) for e in encs]
            agg_blob = scheme.computeWeightedAverage(blobs, list(weights))
            enc_out = scheme.decrypt(agg_blob, encs[0].size).astype(np.float32)
    else:
        enc_out = np.zeros(0, np.float32)

    if plains[0].size:
        plain_out = sum(w * p.astype(np.float64)
                        for w, p in zip(weights, plains)).astype(np.float32)
    else:
        plain_out = np.zeros(0, np.float32)

    return unflatten_params(merge_by_policy(enc_out, plain_out, plan), spec)


def plain_fedavg(client_params: list, weights: list[float]):
    """Plaintext FedAvg baseline: the f64 weighted sum, as float32."""
    flats, specs = zip(*(flatten_params(p) for p in client_params))
    agg = sum(w * f.astype(np.float64) for w, f in zip(weights, flats))
    return unflatten_params(agg.astype(np.float32), specs[0])
