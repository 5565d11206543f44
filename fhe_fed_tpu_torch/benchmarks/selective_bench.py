"""Selective-encryption sweep, the port's counterpart of
benchmarks/selective_bench.py (reference benchmark_selection.py /
benchmark_selection_rate.py): encrypt only the first `rate` fraction of
each tensor (benchmark_selection_rate.py:134-139), aggregate the
remainder in plaintext (benchmark_selection.py:152-158), and measure the
round time and upload bytes per rate.

Client payloads are staged on the device before the timers; the
encrypted part runs the fused round (ops.fedavg_round_fused), streamed
over max_chunks slices; the plain remainder is a weighted sum on the
device. One labelled `path: "bytes_wire"` row, on request, times the
per-client bytes surface.

Writes selective.jsonl (rewritten each run unless --append) in
build/results_torch/ or --out.

Usage: python -m fhe_fed_tpu_torch.benchmarks.selective_bench
       [--models cnn_fedavg resnet50] [--rates 0.1 0.5 1.0] [--clients 3]
       [--reps 3] [--bytes-row]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import CKKS, flatten_params, SelectivePolicy
from ..fed.fedavg import split_by_policy, merge_by_policy
from .. import models
from .common import (PhaseTimer, append_jsonl, backend, results_dir,
                     rewrite_jsonl)
from .model_bench import _pad_chunks


def _plain_weighted_sum(w: torch.Tensor, stacked: torch.Tensor
                        ) -> torch.Tensor:
    # elementwise multiply-add in f32, as the JAX driver (no matmul)
    return torch.sum(w[:, None] * stacked, dim=0)


def bench_rate(helper: CKKS, model: str, rate: float, clients_flat,
               spec, weights, max_chunks: int, reps: int) -> dict:
    n = clients_flat[0].size
    policy = SelectivePolicy(rate=rate)
    encs, plains, plan = [], [], None
    for f in clients_flat:
        e, pl, plan = split_by_policy(f, spec, policy)
        encs.append(e)
        plains.append(pl)
    enc_n, plain_n = encs[0].size, plains[0].size
    dev = helper.device
    sync = PhaseTimer(dev).sync
    w_dev = torch.as_tensor(np.asarray(weights, np.float32), device=dev)

    # stage on the device (host prep, untimed)
    packed = helper.pack_cohort(encs) if enc_n else None
    plains_dev = (torch.as_tensor(np.stack(plains), device=dev)
                  if plain_n else None)
    chunks = packed.shape[1] if enc_n else 0
    mc = min(max_chunks, chunks) if chunks else 0
    if chunks:
        packed = _pad_chunks(packed, mc)

    def one_round():
        outs = [helper._round_slice(packed[:, s:s + mc], weights, fused=True)
                for s in range(0, packed.shape[1], mc)] if chunks else []
        plain = (_plain_weighted_sum(w_dev, plains_dev)
                 if plain_n else None)
        return outs, plain

    one_round()                       # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = one_round()
    sync()
    round_s = (time.perf_counter() - t0) / reps

    # host fetch + merge (the server->client leg, reported apart)
    t0 = time.perf_counter()
    outs, plain = res
    enc_out = (helper._unpack(torch.cat(outs), enc_n).astype(np.float32)
               if chunks else np.zeros(0, np.float32))
    plain_out = (plain.cpu().numpy() if plain_n
                 else np.zeros(0, np.float32))
    fetch_s = time.perf_counter() - t0
    got = merge_by_policy(enc_out, plain_out, plan)
    want = np.mean(np.stack(clients_flat), axis=0)
    err = float(np.max(np.abs(got - want)))

    p = helper.ctx.params
    k = len(clients_flat)
    # All byte fields are per client upload (processing_comm.py:81-107
    # plots one client's upload), as in model_bench.
    ct_bytes = chunks * 2 * p.chain_len * p.ring_dim * 4 + 64
    # seeded uploads (ops.encrypt_symmetric_seeded): header | 16-byte seed
    # | c0 only; the c1 half is expanded server-side from the seed
    ct_bytes_seeded = chunks * p.chain_len * p.ring_dim * 4 + 64 + 16
    return {"model": model, "rate": rate, "params": n, "clients": k,
            "enc_params": enc_n, "chunks": chunks,
            "ct_bytes": ct_bytes, "ct_bytes_seeded": ct_bytes_seeded,
            "plain_bytes": plain_n * 4,
            "round_s": round_s, "fetch_s": fetch_s, "reps": reps,
            "path": "fused_cohort", "max_err": err,
            "backend": backend(dev)}


def bench_bytes_row(helper: CKKS, model: str, rate: float, clients_flat,
                    spec, weights) -> dict:
    """The reference's client<->server wire path, one blob per client
    (ckks.cpp:98-101), host copies included."""
    policy = SelectivePolicy(rate=rate)
    encs = [split_by_policy(f, spec, policy)[0] for f in clients_flat]
    helper.encrypt(encs[0])          # warm-up
    t0 = time.perf_counter()
    blobs = [helper.encrypt(e) for e in encs]
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    agg = helper.computeWeightedAverage(blobs, list(weights))
    out = helper.decrypt(agg, encs[0].size)
    rest_s = time.perf_counter() - t0
    err = float(np.max(np.abs(out - np.mean(np.stack(encs), axis=0))))
    return {"model": model, "rate": rate, "params": clients_flat[0].size,
            "clients": len(clients_flat),
            "enc_params": encs[0].size,
            "ct_bytes": sum(map(len, blobs)) // len(blobs),
            "encrypt_s": enc_s, "agg_dec_s": rest_s,
            "path": "bytes_wire",
            "note": "serialized per-client blobs; includes host<->device "
                    "copies",
            "max_err": err, "backend": backend(helper.device)}


def _clients(model: str, n_clients: int, device):
    """The model's flat vector from build(model) (seed 0) plus each
    client's noise, and its flatten spec."""
    flat, spec = flatten_params(models.build(model, device=device).params)
    rng = np.random.default_rng(0)
    return [(flat + rng.standard_normal(flat.size).astype(np.float32)
             * 0.01) for _ in range(n_clients)], spec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="*",
                    default=["cnn_fedavg", "resnet50", "bert"])
    ap.add_argument("--rates", nargs="*", type=float,
                    default=[0.1, 0.5, 1.0])
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--bits", type=int, default=52)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-chunks", type=int, default=512)
    ap.add_argument("--bytes-row", action="store_true",
                    help="add one labeled bytes-wire row (first model, "
                         "first rate)")
    ap.add_argument("--wire-rates", nargs="*", type=float, default=None,
                    help="emit ONLY labeled bytes-wire rows at these "
                         "rates for the first model (no fused rows); "
                         "use with --append to extend the wire column")
    ap.add_argument("--append", action="store_true",
                    help="append to selective.jsonl instead of rewriting")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the keys and the rounds")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)

    keydir = results_dir(args.out) / "bench_keys"
    keydir.mkdir(parents=True, exist_ok=True)
    helper = CKKS("ckks", args.batch, args.bits, cryptodir=str(keydir),
                  symmetric=True, device=args.device)
    helper.load_or_gen()

    weights = [1.0 / args.clients] * args.clients
    out = []
    if args.wire_rates is not None:
        model = args.models[0]
        clients_flat, spec = _clients(model, args.clients, helper.device)
        for rate in args.wire_rates:
            r = bench_bytes_row(helper, model, rate, clients_flat, spec,
                                weights)
            out.append(r)
            print(f"{model} rate={rate} [bytes wire]: ct "
                  f"{r['ct_bytes']:,} B, enc {r['encrypt_s']:.2f}s, "
                  f"agg+dec {r['agg_dec_s']:.2f}s")
    else:
        for model in args.models:
            clients_flat, spec = _clients(model, args.clients, helper.device)
            for rate in args.rates:
                big = clients_flat[0].size * args.clients > 200_000_000
                r = bench_rate(helper, model, rate, clients_flat, spec,
                               weights, args.max_chunks,
                               1 if big else args.reps)
                out.append(r)
                print(f"{model} rate={rate}: enc {r['enc_params']:,}/"
                      f"{r['params']:,} params, ct {r['ct_bytes']:,} B "
                      f"(seeded {r['ct_bytes_seeded']:,} B, "
                      f"+{r['plain_bytes']:,} plain B), "
                      f"round {r['round_s'] * 1e3:.1f} ms, "
                      f"err {r['max_err']:.1e}", flush=True)
            if args.bytes_row and model == args.models[0]:
                r = bench_bytes_row(helper, model, args.rates[0],
                                    clients_flat, spec, weights)
                out.append(r)
                print(f"{model} rate={args.rates[0]} [bytes wire]: "
                      f"enc {r['encrypt_s']:.2f}s "
                      f"agg+dec {r['agg_dec_s']:.2f}s")
            del clients_flat
    if args.append:
        for r in out:
            append_jsonl("selective.jsonl", r, args.out)
    else:
        rewrite_jsonl("selective.jsonl", out, args.out)

    for model in args.models:
        rows = [r for r in out if r["model"] == model
                and r["path"] == "fused_cohort"]
        full = next((r for r in rows if r["rate"] == 1.0), None)
        if full:
            for r in rows:
                if r["rate"] < 1.0:
                    up = r["ct_bytes"] + r["plain_bytes"]
                    up_seed = r["ct_bytes_seeded"] + r["plain_bytes"]
                    print(f"  {model} rate {r['rate']}: x"
                          f"{full['ct_bytes'] / up:.1f} smaller "
                          f"upload than full encryption "
                          f"(x{full['ct_bytes'] / up_seed:.1f}"
                          f" with seeded uploads)")
    return out


if __name__ == "__main__":
    main()
