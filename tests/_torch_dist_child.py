"""Rank bodies of the port's multi-rank tests (tests/test_torch_parallel.py
and tests/test_torch_dist.py), run in gloo ranks on the CPU by
fhe_fed_tpu_torch.parallel.launch.spawn.

This module imports only the port, torch and numpy: a spawned interpreter
imports it by name, and it must not pull in the JAX package. The seeded
inputs are made here, and the tests call the same functions for the JAX
side. Each suite returns, per rank, its mesh coordinates and the local
blocks it computed, as numpy arrays; the tests put the blocks together.
"""

from __future__ import annotations

import numpy as np
import torch

from fhe_fed_tpu_torch.ckks import params as P, keys as K, ops as O
from fhe_fed_tpu_torch.ckks import dist_ckks as DC, keyswitch as KS
from fhe_fed_tpu_torch.ntt import dist as D
from fhe_fed_tpu_torch.parallel import mesh as M, multihost as MH
from fhe_fed_tpu_torch.rns import primes
from fhe_fed_tpu_torch.utils import threefry

CPU = torch.device("cpu")

# --- parallel/mesh.py, parallel/multihost.py (world 8) ---------------------

FED_MESHES = ((2, 4), (2, 2), (1, 2))
FED_CLIENTS, FED_CHUNKS = 4, 8
MANY_CLIENTS = 64


def fed_params():
    return P.make_params(batch=128, scale_bits=40, mult_depth=1,
                         ring_dim=256)


def fed_weights(k: int) -> list[float]:
    return [1.0 / k] * k


def fed_residues(params, seed=0) -> np.ndarray:
    """Seeded ciphertext-shaped residues (K, chunks, 2, L, N) below each q."""
    rng = np.random.default_rng(seed)
    L = params.chain_len
    q = np.array(params.moduli[:L], dtype=np.int64)[:, None]
    x = rng.integers(0, 1 << 62, size=(FED_CLIENTS, FED_CHUNKS, 2, L,
                                       params.ring_dim))
    return (x % q).astype(np.int32)


def fed_values(params, n_clients=FED_CLIENTS, chunks=FED_CHUNKS, seed=1
               ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((n_clients, chunks, params.ring_dim)).astype(
        np.float32)


def _encoded_weights(ctx, k):
    w_res, w_shoup, _ = O._encode_weights(ctx, fed_weights(k),
                                          ctx.params.chain_len, 0)
    return w_res, w_shoup


def _fed_mesh_jobs(ctx, sk, pk, ca, cha) -> dict:
    mesh = M.make_fed_mesh(ca, cha, "cpu")
    if mesh.get_coordinate() is None:
        return {}
    out = {"coord": np.array(mesh.get_coordinate())}
    params = ctx.params
    w_res, w_shoup = _encoded_weights(ctx, FED_CLIENTS)
    spec = ("clients", "chunks")
    ci, cc = MH.local_slices(mesh, spec, (FED_CLIENTS, FED_CHUNKS))
    stacked = torch.as_tensor(fed_residues(params)[ci, cc])
    out["wsum"] = M.sharded_weighted_sum(ctx, mesh)(
        stacked, w_res[ci], w_shoup[ci]).numpy()
    vals = torch.as_tensor(fed_values(params)[ci, cc])
    keys = threefry.split(threefry.key(7), FED_CLIENTS)[ci]
    step = M.full_fed_step(ctx, mesh)
    local = step(pk, vals, keys, w_res[ci], w_shoup[ci], sk)
    out["step"] = local.numpy()
    out["step_gathered"] = M.gather_chunks(mesh, local).numpy()
    return out


def _many_clients(ctx, pk) -> dict:
    """MANY_CLIENTS clients through the 16-bit split reduction on each
    rank (32 a rank on the clients axis), then the all_reduce."""
    mesh = M.make_fed_mesh(2, 4, "cpu")
    data = fed_values(ctx.params, MANY_CLIENTS, 1, seed=3)
    ci = MH.local_slices(mesh, ("clients",), (MANY_CLIENTS,))[0]
    cts = torch.stack([O.encrypt(ctx, pk, torch.as_tensor(data[i]),
                                 threefry.key(i)).data
                       for i in range(MANY_CLIENTS)[ci]])
    w_res, w_shoup = _encoded_weights(ctx, MANY_CLIENTS)
    agg = M.sharded_weighted_sum(ctx, mesh)(cts, w_res[ci], w_shoup[ci])
    return {"many": agg.numpy()}


def _host_feed(ctx, sk) -> dict:
    """A pod mesh (clients 4, chunks 2), each rank's block of a stacked
    secret-key cohort fed through host_client_array, then aggregated."""
    mesh = MH.pod_mesh({"clients": 4, "chunks": 2}, "cpu")
    vals = np.random.default_rng(0).standard_normal(
        (4, 2, ctx.ring_dim)).astype(np.float32)
    ct = O.encrypt_symmetric_stacked(ctx, sk, torch.as_tensor(vals),
                                     threefry.key(1))
    spec = ("clients", "chunks", None, None, None)
    idx = MH.local_slices(mesh, spec, tuple(ct.data.shape))
    shard = MH.host_client_array(mesh, tuple(ct.data.shape), spec,
                                 ct.data[idx].numpy(), "cpu")
    w_res, w_shoup = _encoded_weights(ctx, 4)
    agg = M.sharded_weighted_sum(ctx, mesh)(
        shard.data, w_res[idx[0]], w_shoup[idx[0]])
    return {"feed": agg.numpy(), "feed_offsets": np.array(shard.offsets),
            "feed_coord": np.array(mesh.get_coordinate())}


def _pod_meshes() -> dict:
    m2 = MH.pod_mesh({"clients": 2, "chunks": -1}, "cpu")
    m3 = MH.pod_mesh({"clients": 2, "limb": 2, "coeff": 2}, "cpu")
    return {"pod2": m2.mesh.numpy(), "pod2_names": list(m2.mesh_dim_names),
            "pod3": m3.mesh.numpy()}


def parallel_suite(rank: int, world: int) -> dict:
    params = fed_params()
    ctx = P.make_context(params, CPU)
    sk, pk = K.keygen(ctx, 11)
    out = {"rank": rank}
    for ca, cha in FED_MESHES:
        out[(ca, cha)] = _fed_mesh_jobs(ctx, sk, pk, ca, cha)
    out.update(_many_clients(ctx, pk))
    out.update(_host_feed(ctx, K.keygen(ctx, 0)[0]))
    out.update(_pod_meshes())
    return out


# --- ntt/dist.py, ckks/dist_ckks.py (world 8) -------------------------------

NTT_RING = 1024
NTT_LIMBS = 4
ROUND_WEIGHTS = (0.5, 0.2, 0.3)
ROUND_CHUNKS = 2
STEP_WEIGHTS = (0.25, 0.25, 0.25, 0.25)


def ntt_moduli() -> tuple[int, ...]:
    return tuple(primes.ntt_primes(NTT_RING, NTT_LIMBS))


def ntt_input(seed=42) -> np.ndarray:
    """(2, L, N) residues below the smallest modulus."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, min(ntt_moduli()),
                        size=(2, NTT_LIMBS, NTT_RING)).astype(np.int32)


def round_params():
    return P.make_params(batch=128, scale_bits=40, mult_depth=1,
                         ring_dim=NTT_RING)


def round_values(n_clients, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_clients, ROUND_CHUNKS, NTT_RING))
            * 0.1).astype(np.float32)


def galois_elements(n: int) -> tuple[int, ...]:
    return (KS.galois_element(1, n), KS.galois_element(5, n),
            KS.conj_element(n))


def _ntt_jobs(spec: D.DistSpec, dt) -> dict:
    x = D.to_dist_coeff(torch.as_tensor(ntt_input()), dt.n1)
    fwd = D.dist_ntt(D.col_block(x, spec), dt, spec)
    rt = D.dist_intt(fwd, dt, spec)
    y = D.to_dist_coeff(torch.as_tensor(ntt_input(9)), dt.n1)
    inv = D.dist_intt(D.row_block(y, spec), dt, spec)
    b = D.to_dist_coeff(torch.as_tensor(ntt_input(7)), dt.n1)
    prod = D.dist_poly_mul(D.col_block(x, spec), D.col_block(b, spec), dt,
                           spec)
    return {"fwd": fwd.numpy(), "rt": rt.numpy(), "inv": inv.numpy(),
            "prod": prod.numpy(),
            "cols_gathered": D.gather_axis(rt, spec.mesh, spec.coeff_axis,
                                           -1).numpy()}


def _round_jobs(spec: D.DistSpec) -> dict:
    params = round_params()
    ctx = P.make_context(params, CPU)
    sk, _ = K.keygen(ctx, 0)
    dt = D.make_dist_tables(params.ring_dim,
                            params.moduli[:params.chain_len], device=CPU)
    sk_d = DC.sk_to_dist(sk, dt.n1)
    scale = float(params.scale)
    vals = round_values(len(ROUND_WEIGHTS), 0)
    flat = D.to_dist_coeff(torch.as_tensor(vals.reshape(-1, NTT_RING)),
                           dt.n1)
    cts = DC.encrypt_symmetric_dist(ctx, dt, spec, sk_d,
                                    D.col_block(flat, spec, limbs=False),
                                    threefry.key(7), scale)
    stacked = cts.reshape(len(ROUND_WEIGHTS), ROUND_CHUNKS, *cts.shape[1:])
    w_res, w_shoup, _ = O._encode_weights(ctx, ROUND_WEIGHTS,
                                          params.chain_len, 0)
    agg = DC.weighted_sum_dist(ctx, stacked, w_res, w_shoup, spec)
    res = DC.rescale_dist(ctx, dt, spec, agg)
    dec = DC.decrypt_dist(ctx, dt, spec.without_limbs(), sk_d, res, scale)
    step = DC.make_dist_fed_step(ctx, dt, spec, list(STEP_WEIGHTS))
    svals = round_values(len(STEP_WEIGHTS), 1)
    sv = D.col_block(D.to_dist_coeff(torch.as_tensor(svals), dt.n1), spec,
                     limbs=False)
    out = {"cts": cts.numpy(), "agg": agg.numpy(), "res": res.numpy(),
           "dec": dec.numpy(), "step": step(sk_d, sv, threefry.key(3))
           .numpy()}
    rng = np.random.default_rng(2)
    x = rng.integers(0, min(params.moduli[:params.chain_len]),
                     size=(2, params.chain_len, NTT_RING)).astype(np.int32)
    x_d = D.row_block(D.eval_to_dist(torch.as_tensor(x), dt.n1), spec)
    for g in galois_elements(NTT_RING):
        out[f"auto_{g}"] = DC.dist_automorphism(x_d, g, dt, spec).numpy()
    return out


def dist_suite(rank: int, world: int) -> dict:
    dt = D.make_dist_tables(NTT_RING, ntt_moduli(), device=CPU)
    coeff8 = MH.named_mesh("cpu", (8,), ("coeff",))
    lc = MH.named_mesh("cpu", (2, 4), ("limb", "coeff"))
    spec8 = D.DistSpec(mesh=coeff8)
    spec_lc = D.DistSpec(mesh=lc, limb_axis="limb")
    return {"rank": rank,
            "coeff8": {"coord": np.array(coeff8.get_coordinate()),
                       **_ntt_jobs(spec8, dt)},
            "limb_coeff": {"coord": np.array(lc.get_coordinate()),
                           **_ntt_jobs(spec_lc, dt)},
            "round": {"coord": np.array(lc.get_coordinate()),
                      **_round_jobs(spec_lc)}}


# --- the tests' side --------------------------------------------------------

def assemble(parts, dims: dict) -> np.ndarray:
    """The global array from rank blocks. parts: (mesh coordinate, block)
    pairs; dims maps a mesh dimension to the array dimension it shards.
    Blocks that land on the same place (replicas over the other mesh
    dimensions) must be equal."""
    parts = list(parts)
    sizes = {md: max(int(c[md]) for c, _ in parts) + 1 for md in dims}
    first = parts[0][1]
    shape = list(first.shape)
    for md, ad in dims.items():
        shape[ad] *= sizes[md]
    out = np.empty(shape, dtype=first.dtype)
    seen = {}
    for c, b in parts:
        idx = [slice(None)] * len(shape)
        for md, ad in dims.items():
            n = b.shape[ad]
            idx[ad] = slice(int(c[md]) * n, (int(c[md]) + 1) * n)
        key = tuple(idx[ad].start for ad in dims.values())
        if key in seen:
            if not np.array_equal(seen[key], b):
                raise AssertionError(f"replicas at {key} differ")
        else:
            seen[key] = b
            out[tuple(idx)] = b
    if len(seen) != int(np.prod(list(sizes.values()))):
        raise AssertionError("blocks missing")
    return out


# --- benchmarks/baseline_configs.py config 5 in ranks -----------------------

POD_SHAPE_SMALL = (20_000, 4)


def baseline_config5(rank: int, world: int, out: str) -> dict:
    """Config 5 thinned to POD_SHAPE_SMALL in the world's ranks."""
    from fhe_fed_tpu_torch.benchmarks import baseline_configs as BC
    BC.POD_SHAPE_CPU = POD_SHAPE_SMALL
    return BC.cfg5_pod_fedavg(True, CPU, out)
