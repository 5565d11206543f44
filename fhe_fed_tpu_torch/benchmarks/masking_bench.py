"""Masking-scheme (Paillier one-time-pad) benchmark, offline + online
phases at model scale: the port's counterpart of
benchmarks/masking_bench.py.

  offline (host, one-time per round schedule): per-learner randomness
      draw + bit-pack + Paillier encrypt (native OpenMP kernel,
      native/paillier.py over fhe_fed_tpu/native/paillier.cpp),
      homomorphic sum across learners, key-holder decrypt of the mask sum
      (PaillierUtils.cpp:705-808 parity).
  online (per round, on the helpers' device): mask = (fix(x) - r) mod 2^b
      per learner, server sum mod 2^b, unmask + fixed-point decode
      (PaillierUtils.cpp:499-701 parity).

Each learner is a separate Masking instance with its own randomness
directory (shared Paillier keys: 2048-bit, 17-bit ring, 13-bit
precision, the cpp defaults), so the measured flow is the real
multi-party protocol. Every phase is timed with PhaseTimer (synchronised
with the card); the offline phases are host work. The protocol's files
live in a temporary directory under the results directory, removed after
each run.

Usage: python -m fhe_fed_tpu_torch.benchmarks.masking_bench
       [--params 100000 1663370] [--learners 4] [--thread-sweep]
       [--append] [--device cuda] [--out DIR]
--thread-sweep measures the offline phase at 1 vs all OpenMP threads.
Writes masking_bench.jsonl in build/results_torch/ or --out (rewritten,
measured rows only, unless --append).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from .. import Masking, cuda_lib
from ..native import paillier as native
from .common import PhaseTimer, append_jsonl, backend, results_dir, \
    rewrite_jsonl


def bench(params: int, learners: int, out=None, device="cuda") -> dict:
    dev = cuda_lib.device(device)
    with tempfile.TemporaryDirectory(dir=results_dir(out)) as d:
        return _protocol(params, learners, d, dev)


def _protocol(params: int, learners: int, d: str, dev) -> dict:
    """One run of the protocol with its files under `d`."""
    # learner 0 doubles as key-holder and server, as in the reference's
    # simulation
    ms = [Masking("paillier", learners=learners,
                  cryptodir=os.path.join(d, "keys"),
                  randomnessdir=os.path.join(d, f"rand_l{i}"), device=dev)
          for i in range(learners)]
    t = PhaseTimer(dev)
    with t.phase("keygen"):
        ms[0].genCryptoContextAndKeyGen()
    for m in ms[1:]:
        m.loadCryptoParams()

    # offline phase: each learner generates + encrypts its pad
    with t.phase("gen_one"):
        blob0 = ms[0].genPaillierRandOffline(params, iteration=0)
    blobs = [blob0] + [m.genPaillierRandOffline(params, iteration=0)
                       for m in ms[1:]]
    with t.phase("add"):
        agg_blob = ms[0].addPaillierRandOffline(blobs)
    with t.phase("dec_sum"):
        ms[0].decryptRandomnessSum(agg_blob, params, iteration=0)

    # online phase, after one untimed round
    rng = np.random.default_rng(0)
    data = [rng.standard_normal(params).astype(np.float32) * 0.1
            for _ in range(learners)]
    weights = [1.0 / learners] * learners
    warm = [m.encrypt(x, iteration=0) for m, x in zip(ms, data)]
    ms[0].decrypt(ms[0].computeWeightedAverage(warm, weights), params,
                  iteration=0)
    with t.phase("mask"):
        uploads = [m.encrypt(x, iteration=0) for m, x in zip(ms, data)]
    with t.phase("sum"):
        summed = ms[0].computeWeightedAverage(uploads, weights)
    with t.phase("unmask"):
        got = ms[0].decrypt(summed, params, iteration=0)
    err = float(np.max(np.abs(got - np.mean(np.stack(data), axis=0))))

    p = t.phases
    offline = p["gen_one"] + p["add"] + p["dec_sum"]
    mask_s = p["mask"] / learners
    return {"params": params, "learners": learners,
            "threads": native.num_threads(),
            "keygen_s": p["keygen"],
            "offline_gen_per_learner_s": p["gen_one"],
            "offline_add_s": p["add"], "offline_decrypt_sum_s": p["dec_sum"],
            "offline_total_s": offline,
            "online_mask_per_learner_s": mask_s,
            "online_sum_s": p["sum"], "online_unmask_s": p["unmask"],
            "online_total_s": mask_s + p["sum"] + p["unmask"],
            "upload_bytes": len(uploads[0]),
            "plain_bytes": params * 4,
            "comm_expansion": len(uploads[0]) / (params * 4),
            "max_err": err, "backend": backend(dev)}


def _report(r):
    print(f"{r['params']:,} params x {r['learners']} learners "
          f"[{r['threads']} thr]: offline {r['offline_total_s']:.4f}s "
          f"(gen {r['offline_gen_per_learner_s']:.4f} + add "
          f"{r['offline_add_s']:.4f} + dec "
          f"{r['offline_decrypt_sum_s']:.4f}), online "
          f"{r['online_total_s'] * 1e3:.4f} ms, comm "
          f"x{r['comm_expansion']:.2f}, err {r['max_err']:.1e} "
          f"({r['backend']})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", nargs="*", type=int,
                    default=[100_000, 1_663_370])
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--thread-sweep", action="store_true",
                    help="rerun the first size at 1 thread vs all "
                         "threads (offline-phase core scaling)")
    ap.add_argument("--append", action="store_true",
                    help="append rows instead of rewriting the jsonl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)
    rows = []
    for p in args.params:
        r = bench(p, args.learners, args.out, args.device)
        rows.append(r)
        _report(r)
    if args.thread_sweep:
        full = native.num_threads()
        try:
            for t in sorted({1, full}):
                native.set_threads(t)
                r = bench(args.params[0], args.learners, args.out,
                          args.device)
                r["sweep"] = "threads"
                rows.append(r)
                _report(r)
        finally:
            native.set_threads(full)
    if args.append:
        for r in rows:
            append_jsonl("masking_bench.jsonl", r, args.out)
    else:
        rewrite_jsonl("masking_bench.jsonl", rows, args.out)
    return rows


if __name__ == "__main__":
    main()
