"""Mesh-sharded encrypted aggregation: the counterpart of
fhe_fed_tpu/parallel/mesh.py on torch.distributed.

Two logical parallel axes are mesh axes:

  * clients - the FedAvg fan-in. Each rank of a clients group holds some
    clients' ciphertexts, computes their weighted modular sum (K3 on a
    CUDA tensor, ckks/ops._aggregate) and ONE int64 all_reduce over the
    group adds the partial sums; a reduction mod q follows. This is the
    JAX package's psum of modsum_clients: a modular sum is exact in any
    order, so the result is its bit for bit. Partials are < 2**31 and a
    group has at most a few thousand ranks, so int64 cannot overflow.
  * chunks  - ciphertext chunks of the model, pure data parallelism: the
    rescale and the decrypt's NTTs stay local, because each chunk's
    coefficient axis is unsharded.

Arrays are the rank's local blocks (parallel/multihost.local_slices): the
stacked ciphertexts (K, chunks, 2, L, N) under ('clients', 'chunks'),
weights (K, L) under ('clients',), results (chunks, ...) under
('chunks',), replicated over clients. `gather_chunks` assembles a result
for a caller that wants the whole array.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ckks import ops as ckks_ops
from ..ckks.keys import PublicKey, SecretKey
from ..ckks.params import CkksContext
from ..utils import prng
from .multihost import axis_coord, block, named_mesh

# Chunk-rows (clients x chunks) a full_fed_step encrypts at once: the
# public-key encrypt's int64 glue holds ~11 tensors of rows x L x N.
ENCRYPT_ROWS = 1024


def make_fed_mesh(n_clients_axis: int, n_chunks_axis: int,
                  device_type: str = "cuda") -> DeviceMesh:
    """('clients', 'chunks') mesh over the first n_clients_axis x
    n_chunks_axis ranks of the world (every rank calls it)."""
    need = n_clients_axis * n_chunks_axis
    if need > dist.get_world_size():
        raise ValueError(f"mesh ({n_clients_axis}, {n_chunks_axis}) needs "
                         f"{need} ranks, the world has "
                         f"{dist.get_world_size()}")
    return named_mesh(device_type, (n_clients_axis, n_chunks_axis),
                      ("clients", "chunks"))


def modsum_over(ctx: CkksContext, mesh: DeviceMesh, axis: str,
                partial: torch.Tensor) -> torch.Tensor:
    """The modular sum over mesh axis `axis` of each rank's partial
    (..., live, N) residues mod q: one int64 all_reduce, then mod q."""
    live = partial.shape[-2]
    acc = partial.to(torch.int64)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return torch.remainder(acc, ctx.q[:live, None]).to(torch.int32)


def sharded_weighted_sum(ctx: CkksContext, mesh: DeviceMesh):
    """(stacked, w_res, w_shoup) -> this rank's block of the aggregated
    ciphertext data, with the client reduction over the 'clients' group.

    stacked: the rank's (K_local, chunks_local, 2, live, N) int32 block;
    w_*: its clients' (K_local, live) weights and Shoup words (numpy or
    tensors). Returns (chunks_local, 2, live, N) int32."""
    def agg(stacked: torch.Tensor, w_res, w_shoup) -> torch.Tensor:
        partial = ckks_ops._aggregate(ctx, stacked, _host(w_res),
                                      _host(w_shoup))
        return modsum_over(ctx, mesh, "clients", partial)
    return agg


def _host(w) -> np.ndarray:
    return (w.cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
            ).astype(np.int64)


def _encrypt_clients(ctx: CkksContext, mesh: DeviceMesh, pk: PublicKey,
                     values: torch.Tensor, rng_keys: torch.Tensor
                     ) -> torch.Tensor:
    """The rank's clients' public-key ciphertexts (K_local, chunks_local,
    2, L, N) int32: client k draws (u, e0, e1) from split(key_k, 3) at the
    GLOBAL (chunks, N) shape, as the JAX step's vmapped encrypt_one, and
    the rank keeps its chunk rows; clients go in groups of about
    ENCRYPT_ROWS chunk-rows."""
    if prng.impl_of(rng_keys) != "threefry":
        # JAX's vmap draws every client's rbg samples from the GLOBAL
        # batch's first key, which the ranks holding other clients lack.
        raise ValueError("full_fed_step takes threefry client keys")
    k_loc, c_loc, n = values.shape
    coord, size = axis_coord(mesh, "chunks")
    chunks = c_loc * size
    rows = block(coord, size, chunks)
    stacked = torch.empty((k_loc, c_loc, 2, ctx.params.chain_len, n),
                          dtype=torch.int32, device=values.device)
    group = max(1, ENCRYPT_ROWS // chunks)
    for g0 in range(0, k_loc, group):
        g1 = min(g0 + group, k_loc)
        u, e0, e1 = ckks_ops._pk_samples(rng_keys[g0:g1],
                                         (g1 - g0, chunks, n))
        stacked[g0:g1] = ckks_ops.encrypt_core(
            ctx, pk, values[g0:g1], u[:, rows], e0[:, rows], e1[:, rows],
            float(ctx.params.scale))
    return stacked


def _rescale_decrypt(ctx: CkksContext, agg: torch.Tensor, sk: SecretKey
                     ) -> torch.Tensor:
    """Rescale the aggregate by the top prime, decrypt and decode. The
    weights are encoded at that prime, so the scale is Delta again."""
    scale = float(ctx.params.scale)
    res = ckks_ops.rescale(ctx, ckks_ops.Ciphertext(agg, scale, 0))
    return ckks_ops.decrypt(ctx, sk, ckks_ops.Ciphertext(res.data, scale,
                                                         res.level))


def full_fed_step(ctx: CkksContext, mesh: DeviceMesh):
    """One complete secure-FedAvg round over the mesh: per-client
    public-key encrypt -> weighted sum (all_reduce over 'clients') ->
    rescale -> decrypt -> decode.

    Returns step(pk, values, rng_keys, w_res, w_shoup, sk), where values
    is the rank's (K_local, chunks_local, N) f32 block, rng_keys its
    clients' threefry keys (K_local, 2), w_* their (K_local, L) weights
    encoded at the top prime; the result is the rank's (chunks_local, N)
    f32 block of the average. The ciphertexts are the JAX step's bit for
    bit (_encrypt_clients), written into one stacked int32 tensor that K3
    reads once."""
    agg_fn = sharded_weighted_sum(ctx, mesh)

    def step(pk: PublicKey, values: torch.Tensor, rng_keys: torch.Tensor,
             w_res, w_shoup, sk: SecretKey) -> torch.Tensor:
        stacked = _encrypt_clients(ctx, mesh, pk, values, rng_keys)
        agg = agg_fn(stacked, w_res, w_shoup)
        del stacked
        return _rescale_decrypt(ctx, agg, sk)

    return step


def gather_chunks(mesh: DeviceMesh, local: torch.Tensor) -> torch.Tensor:
    """The whole (chunks, ...) array from each rank's chunk block: one
    all_gather over the 'chunks' group."""
    parts = [torch.empty_like(local)
             for _ in range(axis_coord(mesh, "chunks")[1])]
    dist.all_gather(parts, local.contiguous(),
                    group=mesh.get_group("chunks"))
    return torch.cat(parts)
