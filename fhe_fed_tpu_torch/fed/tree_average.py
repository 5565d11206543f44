"""Selective FedAvg's tree where its leaves lie: the leaf plan, the table
the kernel csrc/tree_average.cu reads, and its three entries.

A policy gives each leaf i of n_i values an encrypted prefix of k_i
(`leaf_plan`, the one plan of fhe_fedavg and split_by_policy). Over K
clients' leaves:

- `gather`: the (K, E) float32 encrypted vectors, each client's prefixes
  concatenated in leaf order (split_by_policy's `enc`);
- `average`: the plain remainder of every leaf averaged in float64 in the
  order of the JAX package's `sum(w * p.astype(np.float64) ...)`, as
  float32, in its positions of the (N,) output in layout order;
- `scatter`: the (E,) decrypted average in the encrypted positions of the
  same output (merge_by_policy's result, once both ran).

A leaf is float32 or bfloat16 (the same in every client), read as it
lies and widened exactly; the outputs are float32. A cohort of CUDA leaves
launches the kernel, one launch an entry, counted in `cuda_lib.launches`
as `tree_gather`, `tree_average` and `tree_scatter`; a cohort of CPU
leaves runs the plain versions here, which the tests hold to the JAX
package and chip_smoke.py holds the kernel to on the card. The leaves are
read in place: no flattened copy of a client. `casts` counts, by the
source dtype, the leaves fhe_fedavg copied to float32 first because a
cohort could not read them as they were; `aliases`, by path, the leaves
that are another leaf's memory (a tied embedding), which the cohort reads
under each key. Offsets, counts and addresses are int64 throughout, in
the plan, the table and the kernel: a tree may hold more than 2^31
positions.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .. import cuda_lib

NAMES = ("tree_gather", "tree_average", "tree_scatter")

# Leaves copied to float32 before a cohort read them, by source dtype
# ("float16", "bfloat16", ...): fed/fedavg.py adds one a leaf and client.
casts: collections.Counter = collections.Counter()

# Leaves that are an earlier leaf's memory in the same client (a tied
# embedding under two keys), by path: fed/fedavg.py adds one a leaf and
# client. Each is read, and its prefix encrypted, under every key.
aliases: collections.Counter = collections.Counter()

# The leaf dtypes a cohort reads, by the kernel's dtype code.
DTYPES = (torch.float32, torch.bfloat16)


def _offsets(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Per leaf (L of them, in layout order): its size, its encrypted
    prefix, and the offsets (L + 1 each, the last the total) of its
    prefix in the encrypted vector, of its remainder among the plain
    positions and of the leaf in the output."""
    sizes: np.ndarray
    k: np.ndarray
    enc: np.ndarray
    plain: np.ndarray
    out: np.ndarray

    @property
    def plan(self) -> list[tuple[int, int]]:
        """split_by_policy's plan: (encrypted, plain) values a leaf."""
        return [(int(k), int(n - k)) for k, n in zip(self.k, self.sizes)]


def leaf_plan(sizes, paths, policy) -> LeafPlan:
    """The plan of `policy` (a SelectivePolicy) over leaves of `sizes`
    with their `paths`: leaf i's prefix is policy.enc_count(n_i) values if
    policy.leaf_selected(i, path_i), else none."""
    sizes = np.asarray(sizes, dtype=np.int64).reshape(-1)
    k = np.array([policy.enc_count(int(n))
                  if policy.leaf_selected(i, path) else 0
                  for i, (n, path) in enumerate(zip(sizes, paths))],
                 dtype=np.int64)
    return LeafPlan(sizes, k, _offsets(k), _offsets(sizes - k),
                    _offsets(sizes))


class Cohort:
    """K clients' leaves under one plan, with their weights: contiguous
    float32 or bfloat16 tensors, every one on one device, leaf i of every
    client of plan.sizes[i] values and of one dtype. On the card it holds
    the kernel's table and the launch's mode (0: every leaf float32, 1:
    every leaf bfloat16, 2: mixed)."""

    def __init__(self, plan: LeafPlan, leaves: list, weights):
        self.plan, self.leaves = plan, leaves
        self.weights = [float(w) for w in weights]
        if not leaves or len(leaves) != len(self.weights):
            raise ValueError("one weight per client, and a client at least")
        if not plan.sizes.size:
            raise ValueError("a cohort's trees hold a leaf at least")
        self.device = leaves[0][0].device
        self.codes = [DTYPES.index(x.dtype) if x.dtype in DTYPES else -1
                      for x in leaves[0]]
        for lv in leaves:
            if [x.numel() for x in lv] != plan.sizes.tolist():
                raise ValueError("the clients' trees differ in their leaves")
            for x, code in zip(lv, self.codes):
                if (code < 0 or x.dtype != DTYPES[code]
                        or not x.is_contiguous() or x.device != self.device):
                    raise ValueError("a cohort's leaves are contiguous "
                                     "float32 or bfloat16 on one device, "
                                     "each leaf of one dtype")
        self.mode = self.codes[0] if len(set(self.codes)) == 1 else 2
        self.table = self._table() if self.device.type == "cuda" else None

    def _table(self) -> torch.Tensor:
        p = self.plan
        ptrs = np.array([[x.data_ptr() for x in lv] for lv in self.leaves],
                        dtype=np.int64)
        w = np.array(self.weights, dtype=np.float64).view(np.int64)
        host = np.concatenate([p.enc, p.plain, p.k, p.out[:-1],
                               np.array(self.codes, dtype=np.int64),
                               ptrs.reshape(-1), w])
        return torch.from_numpy(host).to(self.device)

    def _launch(self, name: str, out: torch.Tensor, count, *args,
                mode=()) -> None:
        """One launch of entry `name` over `count` positions (`args`: the
        pointers between `out` and the table; `mode`: (self.mode,) for the
        entries that read the leaves)."""
        cuda_lib.require_cuda(out, name, torch.float32)
        err = getattr(cuda_lib.lib(), f"fhe_{name}")(
            out.data_ptr(), *args, self.table.data_ptr(), len(self.plan.k),
            len(self.leaves), int(count), *mode, cuda_lib.stream_ptr(out))
        cuda_lib.check(err, name)
        cuda_lib.launches[name] += 1

    def empty_output(self) -> torch.Tensor:
        """The (N,) float32 output in layout order, on the leaves' device."""
        return torch.empty(int(self.plan.out[-1]), dtype=torch.float32,
                           device=self.device)


def gather(cohort: Cohort) -> torch.Tensor:
    """The (K, E) float32 encrypted vectors, on the leaves' device."""
    if cohort.table is None:
        return gather_plain(cohort)
    enc = torch.empty((len(cohort.leaves), int(cohort.plan.enc[-1])),
                      dtype=torch.float32, device=cohort.device)
    if enc.numel():
        cohort._launch("tree_gather", enc, cohort.plan.enc[-1],
                       mode=(cohort.mode,))
    return enc


def average(cohort: Cohort, out: torch.Tensor) -> None:
    """The plain positions of `out` (cohort.empty_output()) averaged."""
    if cohort.plan.plain[-1] == 0:
        return
    if cohort.table is None:
        return average_plain(cohort, out)
    _check_out(cohort, out)
    cohort._launch("tree_average", out, cohort.plan.plain[-1],
                   mode=(cohort.mode,))


def scatter(cohort: Cohort, dec: torch.Tensor, out: torch.Tensor) -> None:
    """The (E,) float32 `dec` written into the encrypted positions of
    `out`."""
    if tuple(dec.shape) != (int(cohort.plan.enc[-1]),):
        raise ValueError(f"tree_scatter: {tuple(dec.shape)} values for "
                         f"{int(cohort.plan.enc[-1])} encrypted positions")
    if dec.numel() == 0:
        return
    if cohort.table is None:
        return scatter_plain(cohort, dec, out)
    _check_out(cohort, out)
    cuda_lib.require_cuda(dec, "tree_scatter", torch.float32)
    if dec.device != cohort.device:
        raise ValueError("tree_scatter: dec on another device")
    cohort._launch("tree_scatter", out, dec.numel(), dec.data_ptr())


def _check_out(cohort: Cohort, out: torch.Tensor) -> None:
    if tuple(out.shape) != (int(cohort.plan.out[-1]),) or (
            out.device != cohort.device):
        raise ValueError(f"tree output: {tuple(out.shape)} on {out.device}, "
                         f"want ({int(cohort.plan.out[-1])},) on "
                         f"{cohort.device}")


def _segments(cohort: Cohort):
    """(leaf index, k, n, output offset) of every leaf."""
    p = cohort.plan
    return zip(range(len(p.k)), p.k.tolist(), p.sizes.tolist(),
               p.out.tolist())


def gather_plain(cohort: Cohort) -> torch.Tensor:
    """gather in torch ops on the leaves' device, widened to float32."""
    enc = [torch.cat([lv[i].reshape(-1)[:k].float() for i, k, _, _ in
                      _segments(cohort)]) for lv in cohort.leaves]
    return torch.stack(enc)


def average_plain(cohort: Cohort, out: torch.Tensor) -> None:
    """average in torch ops on the leaves' device: float64 products and
    sums, one op each, from +0.0, client by client."""
    for i, k, n, o in _segments(cohort):
        acc = torch.zeros(n - k, dtype=torch.float64, device=out.device)
        for w, lv in zip(cohort.weights, cohort.leaves):
            acc = acc + w * lv[i].reshape(-1)[k:].double()
        out[o + k:o + n] = acc.float()


def scatter_plain(cohort: Cohort, dec: torch.Tensor,
                  out: torch.Tensor) -> None:
    """scatter in torch ops on the leaves' device."""
    e = cohort.plan.enc.tolist()
    for i, k, _, o in _segments(cohort):
        out[o:o + k] = dec[e[i]:e[i] + k]
