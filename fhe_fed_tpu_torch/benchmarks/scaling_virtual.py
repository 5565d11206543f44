"""Weak scaling over ranks that share one device, with the
oversubscription confound separated out: the counterpart of
benchmarks/scaling_virtual.py.

The JAX driver measures a virtual mesh: N virtual XLA devices on one CPU
socket. Here the mesh is N torch.distributed ranks (processes) that share
one device: gloo ranks on the host under --device cpu, or gloo ranks on
the one card under --device cuda (NCCL takes one rank a card; gloo takes
CUDA tensors and stages them through the host). Doubling the ranks on a
shared device doubles the total work without adding compute, so raw weak
scaling measures oversubscription, by construction.

What transfers is the PARTITION + COLLECTIVE OVERHEAD: the same total
work run (a) by ONE rank and (b) sharded over nd ranks, each its block of
the chunks, through parallel/mesh.sharded_weighted_sum (the psum-shaped
client reduction of the clients x chunks round; the reference's serial
learner loop, ckks.cpp:273-298). Per rank count:

  wall_mesh    - nd ranks, chunks sharded, the fused weighted sum; the
                 wall between two barriers on rank 0
  wall_serial  - the SAME total chunks on ONE rank, same function; on the
                 CPU it gets nd intra-op threads, the cores the nd ranks
                 have (one thread each)
  overhead     - wall_mesh / wall_serial (the transferable number: ~1.0
                 means the sharded aggregation adds no partition or
                 collective cost on the same compute)
  weak_scaling_efficiency_raw - wall_mesh at one rank over wall_mesh at
                 nd, kept for continuity

Run: python -m fhe_fed_tpu_torch.benchmarks.scaling_virtual
         [--chunks-per-device 16] [--clients 16] [--reps 20]
         [--device cuda] [--out DIR]

Writes scaling_virtual.jsonl in build/results_torch/ or --out (rewritten:
measured rows only). Nothing falls back to the CPU: --device cuda without
a card raises.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from .. import cuda_lib
from ..ckks import ops as O, params as P
from ..ckks.keys import uniform_mod_q
from ..parallel import launch, mesh as M
from .common import backend, rewrite_jsonl

SIZES = (1, 2, 4, 8)             # ranks, as the JAX driver's device counts
NOTE = ("ranks share one device (gloo), so raw weak scaling measures "
        "oversubscription (total work grows, compute does not). The "
        "transferable number is partition_collective_overhead = sharded "
        "run / one rank on the same total work (on the CPU with as many "
        "threads as the ranks have cores); ~1.0 means the psum-shaped "
        "aggregation adds no partition or collective cost. The fabric "
        "between devices is not measured.")


def _rank(rank: int, world: int, cfg: dict) -> float:
    """The rank's block of cfg['chunks'] through the sharded weighted sum
    on a ('clients', 'chunks') mesh (1, world); the best over the reps of
    the wall between two barriers."""
    device = cuda_lib.device(cfg["device"])
    if device.type == "cpu":
        torch.set_num_threads(cfg["threads"])
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params, device)
    K = cfg["clients"]
    w_res, w_shoup, _ = O._encode_weights(ctx, [1.0 / K] * K,
                                          params.chain_len, 0)
    mesh = M.make_fed_mesh(1, world, device.type)
    gen = torch.Generator(device=device)
    gen.manual_seed(1000 + rank)
    x = uniform_mod_q(gen, (K, cfg["chunks"] // world, 2, params.chain_len,
                            params.ring_dim), params.moduli)
    agg = M.sharded_weighted_sum(ctx, mesh)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    agg(x, w_res, w_shoup)                       # warm-up
    sync()
    ts = []
    for _ in range(cfg["reps"]):
        t0 = time.perf_counter()
        agg(x, w_res, w_shoup)
        sync()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _wall(world: int, cfg: dict) -> float:
    return launch.spawn(_rank, world, (cfg,), device=cfg["device"],
                        backend="gloo")[0]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks-per-device", type=int, default=16)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)
    device = cuda_lib.device(args.device)
    ncpu = os.cpu_count()
    rows = []
    base = None
    for nd in SIZES:
        chunks = args.chunks_per_device * nd       # weak scaling: fixed a rank
        cfg = dict(device=str(device), clients=args.clients, chunks=chunks,
                   reps=args.reps, threads=1)
        t_mesh = _wall(nd, cfg)
        t_serial = _wall(1, dict(cfg, threads=nd))  # same total work
        if base is None:
            base = t_mesh
        eff_raw = base / t_mesh
        overhead = t_mesh / t_serial
        rows.append({"devices": nd, "chunks": chunks,
                     "chunks_per_device": args.chunks_per_device,
                     "clients": args.clients,
                     "wall_mesh_s": round(t_mesh, 5),
                     "wall_serial_same_work_s": round(t_serial, 5),
                     "partition_collective_overhead": round(overhead, 3),
                     "weak_scaling_efficiency_raw": round(eff_raw, 3),
                     "host_physical_cpus": ncpu,
                     "backend": backend(device),
                     "note": NOTE})
        print(f"{nd} ranks: mesh {t_mesh * 1e3:8.2f} ms vs serial "
              f"{t_serial * 1e3:8.2f} ms for {chunks} chunks -> overhead "
              f"x{overhead:.2f} (raw weak-eff {eff_raw:.2f}, {ncpu} cpus, "
              f"{rows[-1]['backend']})", flush=True)
    rewrite_jsonl("scaling_virtual.jsonl", rows, args.out)
    return rows


if __name__ == "__main__":
    main()
