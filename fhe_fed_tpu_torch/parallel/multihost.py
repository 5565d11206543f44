"""The multi-process runtime: process-group start, named meshes, rank
shards and the host feed. The counterpart of fhe_fed_tpu/parallel/
multihost.py on torch.distributed.

JAX runs one process over a global device list and lets GSPMD insert the
collectives. torch.distributed runs ONE process per device: each rank holds
plain local shards of every sharded array, and the collectives are explicit
calls on the groups of a named `DeviceMesh`. This module is the thin layer
under both meshes of the port (parallel/mesh.py, ntt/dist.py):

  * init_distributed() - bring up (or no-op) the process group from
    arguments or torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, LOCAL_RANK);
  * pod_mesh(...)      - a named mesh over the ranks with one axis
    inferred, the first axis the major one (ranks are host-major, so the
    first axis spans hosts and the later ones stay within a host);
  * local_slices(...)  - this rank's slice of each axis of a global array
    under a partition spec (an axis name or None per dimension, as
    jax.sharding.PartitionSpec);
  * host_client_array() - this rank's payloads on its device, tagged with
    their global offsets; no rank materialises the global array.

The entry points default to the card: NCCL on CUDA. `device="cpu"` runs
gloo ranks on the host (the tests).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import cuda_lib


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     device: torch.device | str = "cuda",
                     backend: str | None = None) -> bool:
    """Start the default process group from the arguments or torchrun's
    environment. Returns True if it came up, False for the single-process
    no-op (no address given or set, and a world of at most one). On CUDA
    the rank's card (LOCAL_RANK, else the rank, modulo the cards) becomes
    the current device and the backend is NCCL; on the CPU it is gloo.
    A group that cannot form raises; nothing falls back to the CPU."""
    addr = init_method or os.environ.get("MASTER_ADDR")
    world = (world_size if world_size is not None
             else int(os.environ.get("WORLD_SIZE", "0") or 0))
    if addr is None and world <= 1:
        return False                        # single process: nothing to do
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        cuda_lib.device(dev)                # raises without a card
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://",
        world_size=max(world, 1), rank=rank)
    return True


def mesh_shape(axis_sizes: dict[str, int], n_ranks: int) -> list[int]:
    """The sizes of `axis_sizes` (name -> size, major to minor) with the one
    -1 entry inferred from n_ranks."""
    sizes = list(axis_sizes.values())
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError(f"at most one axis may be -1: {axis_sizes}")
    if unknown:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n_ranks % known:
            raise ValueError(f"{n_ranks} ranks do not split into {axis_sizes}")
        sizes[unknown[0]] = n_ranks // known
    if int(np.prod(sizes)) > n_ranks:
        raise ValueError(f"mesh {sizes} needs more than {n_ranks} ranks")
    return sizes


def named_mesh(device_type: str, sizes, names) -> DeviceMesh:
    """A DeviceMesh over the first prod(sizes) ranks in row-major order.
    Every rank of the world calls it; a rank outside the mesh gets no
    coordinate and may not use it."""
    need = int(np.prod(sizes))
    grid = torch.arange(need, dtype=torch.int64).reshape(tuple(sizes))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))


def pod_mesh(axis_sizes: dict[str, int], device_type: str = "cuda"
             ) -> DeviceMesh:
    """Named mesh over the world's ranks. axis_sizes maps axis name ->
    size in MAJOR-to-minor order; one axis may be -1 (inferred). FedAvg
    convention: ('clients', 'chunks') or ('clients', 'limb', 'coeff')
    with clients first, so the fan-in crosses hosts once."""
    sizes = mesh_shape(axis_sizes, dist.get_world_size())
    return named_mesh(device_type, sizes, axis_sizes)


def axis_coord(mesh: DeviceMesh | None, name: str | None
               ) -> tuple[int, int]:
    """(this rank's coordinate, the axis size) on mesh axis `name`; (0, 1)
    for no mesh or no axis."""
    if mesh is None or name is None:
        return 0, 1
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh "
                           f"{mesh.mesh.tolist()}")
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_local_rank(dim), mesh.mesh.shape[dim]


def block(coord: int, size: int, n: int) -> slice:
    """Block `coord` of `size` equal blocks of a length-n axis."""
    if n % size:
        raise ValueError(f"an axis of {n} does not split over {size} ranks")
    step = n // size
    return slice(coord * step, (coord + 1) * step)


def local_slices(mesh: DeviceMesh | None, spec, shape) -> tuple[slice, ...]:
    """This rank's slice of each dimension of a global `shape` under
    `spec` (a mesh axis name or None per dimension)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match shape {shape}")
    return tuple(slice(None) if name is None
                 else block(*axis_coord(mesh, name), n)
                 for name, n in zip(spec, shape))


@dataclasses.dataclass(frozen=True)
class HostShard:
    """This rank's block of a global array: its data on the rank's device
    and where it sits in the global array."""
    data: torch.Tensor
    index: tuple[slice, ...]
    global_shape: tuple[int, ...]

    @property
    def offsets(self) -> tuple[int, ...]:
        return tuple(s.start or 0 for s in self.index)


def host_client_array(mesh: DeviceMesh, global_shape: tuple[int, ...],
                      spec, local_data, device: torch.device | str = "cuda"
                      ) -> HostShard:
    """Place THIS rank's block of a global array on its device. local_data
    must be the rank's slice under `spec` (for the FedAvg feed: its clients'
    packed payloads (K_local, chunks_local, ...)); it is checked against the
    slice's shape. Nothing is gathered."""
    index = local_slices(mesh, spec, global_shape)
    want = tuple(len(range(*s.indices(n))) for s, n in zip(index,
                                                           global_shape))
    data = torch.as_tensor(np.asarray(local_data),
                           device=cuda_lib.device(device))
    if tuple(data.shape) != want:
        raise ValueError(f"local data {tuple(data.shape)} is not this rank's "
                         f"block {want} of {tuple(global_shape)}")
    return HostShard(data, index, tuple(global_shape))
