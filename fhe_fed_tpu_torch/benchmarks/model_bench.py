"""Per-model secure-aggregation benchmark over the zoo ladder, the port's
counterpart of benchmarks/model_bench.py (reference benchmark.py:418-567 /
benchmark_nvidia.py:401-504).

For each model: Init / Encryption / Secure Agg / Decryption wall-clock
(each phase synchronised with the card), ciphertext bytes, plaintext
bytes, expansion ratio and max_err against the plaintext mean. Writes
model_results<suffix>.txt in the reference's nvidia_results.txt format
and appends to model_bench.jsonl, in build/results_torch/ or --out.

Usage:
  python -m fhe_fed_tpu_torch.benchmarks.model_bench                # ladder up to CNN
  python -m fhe_fed_tpu_torch.benchmarks.model_bench --models bert  # any zoo subset
  python -m fhe_fed_tpu_torch.benchmarks.model_bench --clients 8
  python -m fhe_fed_tpu_torch.benchmarks.model_bench --scheme ckks-threshold --fused
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import CKKS, ThresholdCKKS, flatten_params
from .. import models
from .common import PhaseTimer, append_jsonl, backend, results_dir

DEFAULT_MODELS = ["linear", "tst", "mlp", "rnn_lstm", "cnn_fedavg"]


def _pad_chunks(packed: torch.Tensor, mc: int) -> torch.Tensor:
    """(K, chunks, N) -> the chunk axis zero-padded to a multiple of mc."""
    pad = (-packed.shape[1]) % mc
    if not pad:
        return packed
    return torch.cat([packed, packed.new_zeros(
        (packed.shape[0], pad, packed.shape[2]))], dim=1)


def run_model(name: str, n_clients: int, helper: CKKS, seed: int = 0,
              use_bytes: bool = False, reps: int = 1, max_chunks: int = 512,
              use_fused: bool = False):
    """One model's timed round. Returns (record, spec, averaged, want): the
    zoo model built on the helper's device, the decrypted average (n,) f32
    and the plaintext mean of the clients' vectors (n,) f32."""
    spec = models.build(name, seed=seed, device=helper.device)
    flat, _ = flatten_params(spec.params)
    n = flat.size
    rng = np.random.default_rng(seed)
    clients = [flat + rng.standard_normal(n).astype(np.float32) * 0.01
               for _ in range(n_clients)]
    weights = [1.0 / n_clients] * n_clients

    t = PhaseTimer(helper.device)
    if use_fused:
        # Fused rounds (ops.fedavg_round_fused): encrypt -> weighted sum ->
        # decrypt per slice, all slices enqueued back to back, one sync per
        # round; phases cannot be split ('round'). ct_bytes comes from the
        # shapes: one 64-byte header per client blob, as ct_wire_bytes
        # counts on the cohort path.
        packed = helper.pack_cohort(clients)
        chunks = packed.shape[1]
        p = helper.ctx.params
        ct_bytes = n_clients * (
            chunks * 2 * p.chain_len * p.ring_dim * 4 + 64)
        mc = min(max_chunks, chunks)
        packed = _pad_chunks(packed, mc)
        round_outs = []
        with t.phase("round"):
            for _ in range(reps):
                round_outs.append([
                    helper._round_slice(packed[:, s:s + mc], weights,
                                        fused=True)
                    for s in range(0, packed.shape[1], mc)])
        with t.phase("fetch"):
            out = helper._unpack(torch.cat(round_outs[-1]),
                                 n).astype(np.float32)
    elif use_bytes:
        # Reference-parity wire path: one blob per client (ckks.cpp:98-101).
        reps = 1
        with t.phase("encrypt"):
            blobs = [helper.encrypt(c) for c in clients]
        ct_bytes = sum(len(b) for b in blobs)
        with t.phase("aggregate"):
            agg = helper.computeWeightedAverage(blobs, weights)
        with t.phase("decrypt"):
            out = helper.decrypt(agg, n).astype(np.float32)
    else:
        # Device-resident cohort path. Client vectors are staged on the
        # device before the timers (the reference's flatten/tensor prep is
        # likewise outside its encrypt timer, benchmark_crypto.py:159 vs
        # :183); each phase averages over `reps` rounds; the host fetch and
        # unpack is reported apart as 'fetch'.
        packed = helper.pack_cohort(clients)
        chunks = packed.shape[1]
        if chunks <= max_chunks:
            with t.phase("encrypt"):
                cohorts = [helper.encrypt_cohort(packed)
                           for _ in range(reps)]
            ct_bytes = helper.ct_wire_bytes(cohorts[-1])
            with t.phase("aggregate"):
                aggs = [helper.aggregate_cohort(c, weights)
                        for c in cohorts]
            with t.phase("decrypt"):
                devs = [helper.decrypt_cohort(a, raw=True) for a in aggs]
            with t.phase("fetch"):
                out = helper.unpack_values(devs[-1], n).astype(np.float32)
        else:
            # Streaming: the chunk axis is padded to a multiple of
            # max_chunks and run slice by slice, so peak device memory stays
            # a few slices' ciphertexts and every slice has one shape.
            reps = 1
            packed = _pad_chunks(packed, max_chunks)
            outs = []
            bytes_per_chunk = None
            for s in range(0, packed.shape[1], max_chunks):
                with t.phase("encrypt"):
                    ct = helper.encrypt_cohort(packed[:, s:s + max_chunks])
                if bytes_per_chunk is None:
                    bytes_per_chunk = helper.ct_wire_bytes(ct) / max_chunks
                with t.phase("aggregate"):
                    agg = helper.aggregate_cohort(ct, weights)
                with t.phase("decrypt"):
                    dev = helper.decrypt_cohort(agg, raw=True)
                with t.phase("fetch"):
                    outs.append(dev.cpu())
            ct_bytes = int(bytes_per_chunk * chunks)
            with t.phase("fetch"):
                out = helper._unpack(torch.cat(outs), n).astype(np.float32)
    want = np.mean(np.stack(clients), axis=0)
    err = float(np.max(np.abs(out - want)))

    phases = {k: (v / reps if k != "fetch" else v)
              for k, v in t.phases.items()}
    total = sum(v for k, v in phases.items() if k != "fetch")
    plain_bytes = n * 4 * n_clients
    record = {
        "model": name, "params": n, "clients": n_clients,
        "phases": phases, "total": total, "reps": reps,
        "path": ("fused" if use_fused else "bytes" if use_bytes
                 else "cohort"),
        # which encryption op the 'encrypt' phase timed
        "scheme": helper.scheme,
        "encrypt_op": (("threshold_round_fused"
                        if helper.scheme == "ckks-threshold"
                        else "fused_round") if use_fused else
                       "encrypt_bytes" if use_bytes else
                       ("encrypt_symmetric_stacked" if helper.symmetric
                        else "encrypt_stacked")),
        "ct_bytes": ct_bytes, "plain_bytes": plain_bytes,
        "comm_expansion": ct_bytes / plain_bytes, "max_err": err,
        "backend": backend(helper.device)}
    return record, spec, out, want


def bench_model(name: str, n_clients: int, helper: CKKS, seed: int = 0,
                use_bytes: bool = False, reps: int = 1,
                max_chunks: int = 512, use_fused: bool = False) -> dict:
    return run_model(name, n_clients, helper, seed, use_bytes, reps,
                     max_chunks, use_fused)[0]


def main(argv=None, on_model=None):
    """Run the benchmark; returns the records. on_model(record, spec,
    averaged, want), where given, is called after each model's timed
    round with run_model's results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="*", default=DEFAULT_MODELS)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--bits", type=int, default=52)
    ap.add_argument("--bytes", action="store_true",
                    help="per-client bytes wire path instead of the cohort "
                         "fast path")
    ap.add_argument("--pk", action="store_true",
                    help="public-key encryption (default: secret-key, the "
                         "reference trust model: every learner holds sk)")
    ap.add_argument("--warmup", action="store_true",
                    help="run each model once untimed first")
    ap.add_argument("--reps", type=int, default=1,
                    help="rounds averaged per phase (cohort path only); "
                         "capped to 1 for models whose ciphertexts exceed "
                         "~1 GB to bound device memory")
    ap.add_argument("--max-chunks", type=int, default=512,
                    help="chunk-axis slice size for streaming large models "
                         "(bounds peak device memory)")
    ap.add_argument("--fused", action="store_true",
                    help="fused rounds (enc->agg->dec per slice, one sync "
                         "per round); phases report as 'round'")
    ap.add_argument("--scheme", default="ckks",
                    choices=["ckks", "ckks-threshold"],
                    help="ckks-threshold runs the same ladder with the "
                         "threshold scheme: joint-pk encrypt, fused sum, "
                         "all-party decrypt ceremony (no single sk)")
    ap.add_argument("--parties", type=int, default=3,
                    help="key-share parties for --scheme ckks-threshold")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the keys and the rounds")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)
    if args.fused and (args.bytes or
                       (args.pk and args.scheme == "ckks")):
        ap.error("--fused requires the secret-key cohort path (or the "
                 "threshold scheme, whose rounds fuse their ceremony)")

    out_dir = results_dir(args.out)
    if args.scheme == "ckks-threshold":
        keydir = out_dir / "bench_keys_threshold"

        def make_helper():
            return ThresholdCKKS("ckks-threshold", args.batch, args.bits,
                                 cryptodir=str(keydir), parties=args.parties,
                                 device=args.device)
    else:
        keydir = out_dir / "bench_keys"

        def make_helper():
            return CKKS("ckks", args.batch, args.bits, cryptodir=str(keydir),
                        symmetric=not args.pk, device=args.device)

    keydir.mkdir(parents=True, exist_ok=True)
    helper = make_helper()
    sync = PhaseTimer(helper.device).sync
    # Generate keys only if no persisted set exists (cold, reported apart),
    # then time the reference's measured Init op: loadCryptoParams from
    # files (ckks.cpp:11-23) plus the context, on a fresh helper, twice
    # (the first pass also builds the tables' device state).
    t0 = time.perf_counter()
    try:
        helper.loadCryptoParams()
        keygen_s = 0.0
    except (FileNotFoundError, ValueError):
        helper.genCryptoContextAndKeyGen()
        sync()
        keygen_s = time.perf_counter() - t0

    def time_init():
        h = make_helper()
        sync()
        t0 = time.perf_counter()
        _ = h.ctx
        h.loadCryptoParams()
        sync()
        return time.perf_counter() - t0, h
    init_first_s, _ = time_init()
    init_s, helper = time_init()
    if keygen_s:
        print(f"cold keygen+persist: {keygen_s:.2f}s (one-time; warm init "
              f"{init_s:.3f}s)")

    suffix = ("_fused" if args.fused
              else "_bytes" if args.bytes else "")
    if args.scheme == "ckks-threshold":
        suffix = "_threshold" + suffix
    txt_path = out_dir / f"model_results{suffix}.txt"
    results = []
    with open(txt_path, "w") as f:
        for i, name in enumerate(args.models):
            reps = args.reps
            chunks = -(-models.build(name, device="meta").count
                       // helper.capacity)
            ct_gb = (args.clients * chunks * 2
                     * helper.ctx.params.chain_len
                     * helper.ctx.params.ring_dim * 4) / 2**30
            if ct_gb * max(1, reps) > 1.0:
                reps = 1
            if args.warmup:
                if not args.bytes and chunks > args.max_chunks:
                    # streamed models run one slice shape: warm one slice
                    # of the path the timed run takes
                    dummy = [np.zeros(args.max_chunks * helper.capacity,
                                      np.float32)] * args.clients
                    helper.fedavg_round(
                        dummy, [1.0 / args.clients] * args.clients,
                        max_chunks=args.max_chunks, fused=args.fused)
                else:
                    bench_model(name, args.clients, helper,
                                use_bytes=args.bytes, use_fused=args.fused,
                                max_chunks=args.max_chunks)
            r, spec, avg, want = run_model(
                name, args.clients, helper, use_bytes=args.bytes, reps=reps,
                use_fused=args.fused, max_chunks=args.max_chunks)
            r["init"] = init_s
            r["init_first_incl_compile"] = init_first_s
            results.append(r)
            append_jsonl("model_bench.jsonl", r, out_dir)
            if on_model is not None:
                on_model(r, spec, avg, want)
            del spec, avg, want
            f.write(f"Model #{i} ({name}, {r['params']} params)\n")
            f.write(f"Init Time: {init_s}\n")
            if args.fused:
                f.write(f"Fused Round Time: {r['phases']['round']}\n")
                f.write(f" Total time: {init_s + r['total']}\n")
                print(f"{name:12s} {r['params']:>11,} params: "
                      f"round {r['phases']['round']:.3f}s "
                      f"err {r['max_err']:.1e}", flush=True)
            else:
                f.write(f"Encryption Time: {r['phases']['encrypt']}\n")
                f.write(f"Secure Agg Time: {r['phases']['aggregate']}\n")
                f.write(f"Decryption Time: {r['phases']['decrypt']}\n")
                f.write(f" Total time: {init_s + r['total']}\n")
                print(f"{name:12s} {r['params']:>11,} params: "
                      f"enc {r['phases']['encrypt']:.3f}s "
                      f"agg {r['phases']['aggregate']:.3f}s "
                      f"dec {r['phases']['decrypt']:.3f}s "
                      f"comm x{r['comm_expansion']:.1f} "
                      f"err {r['max_err']:.1e}", flush=True)
    print("wrote", txt_path)
    return results


if __name__ == "__main__":
    main()
