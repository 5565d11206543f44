"""Crypto-parameter sweep (reference benchmark_crypto.py:116-265), the
port's counterpart of benchmarks/param_sweep.py.

Grid {batch} x {scale bits} -> per-phase time, ciphertext bytes, and an
accuracy-delta check on the CNN_OriginalFedAvg model; writes
params_results.csv with the reference's exact columns ('Batch Size',
'Scaling Factor Bits', 'Computation', 'Communication', 'Acc Delta').

Acc Delta (the reference retests FashionMNIST accuracy after FHE vs plain
aggregation, benchmark_crypto.py:246-250): the model is first trained on
the synthetic task (train_synth.py, cached), the three clients are
perturbed copies of the trained weights (standard normal x 0.02 from
np.random.default_rng(0), drawn leaf by leaf in tree order, client by
client, as the JAX driver draws them), and Acc Delta = test accuracy of
the plain-aggregated model minus that of the FHE-aggregated model on the
held-out synthetic test set (delta 0.0 at >= 33 scale bits in the
reference, params_results.csv:2-16).

Each point times the cohort path (device-resident, one synchronised phase
each: init, encrypt, aggregate, decrypt) after an untimed warm-up round;
the whole model is packed into one cohort, as the JAX driver packs it
(1625 chunks per client at batch 1024). Records add the chunk count, the
card's peak memory over the point (torch.cuda.max_memory_allocated; None
off the card) and the backend.

Usage: python -m fhe_fed_tpu_torch.benchmarks.param_sweep [--small]
       [--model cnn_fedavg] [--scheme ckks-threshold] [--device cuda]
       [--out DIR]
Results and per-point key directories go to build/results_torch/ or --out.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np
import torch

from .. import CKKS, ThresholdCKKS, cuda_lib
from ..data.synth import make_synth_images
from ..fed.fedavg import tree_leaves
from .common import PhaseTimer, append_jsonl, backend, results_dir
from .train_synth import evaluate, params_from_flat, trained_model

N_CLIENTS = 3
GRID_BATCHES = (1024, 2048, 4096)
GRID_BITS = (14, 20, 33, 40, 52)


def client_vectors(params, n_clients: int = N_CLIENTS, seed: int = 0
                   ) -> list[np.ndarray]:
    """The clients' flat vectors: each leaf of `params` plus standard
    normal noise x 0.02 in float32, drawn leaf by leaf, client by client,
    from np.random.default_rng(seed) (benchmarks/param_sweep.py:48-55)."""
    rng = np.random.default_rng(seed)
    leaves = [t.detach().cpu().numpy().reshape(-1)
              for t in tree_leaves(params)]
    return [np.concatenate([
        x + rng.standard_normal(x.shape).astype(np.float32) * np.float32(0.02)
        for x in leaves]) for _ in range(n_clients)]


def run_config(batch_size: int, scaling_bits: int, model_name: str,
               workdir, n_eval: int = 4096, scheme: str = "ckks",
               out=None, device="cuda") -> dict:
    """One grid point: keys in `workdir` (generated on its first use,
    untimed), the trained model from results_dir(out), the timed round,
    max_err and the accuracies of the plain and the FHE average."""
    dev = cuda_lib.device(device)
    spec, base_params, _ = trained_model(model_name, out=out, device=dev)
    flats = client_vectors(base_params)
    weights = [1.0 / N_CLIENTS] * N_CLIENTS

    if scheme == "ckks-threshold":
        helper = ThresholdCKKS("ckks-threshold", batch_size, scaling_bits,
                               cryptodir=str(workdir), device=dev)
    else:
        helper = CKKS("ckks", batch_size, scaling_bits,
                      cryptodir=str(workdir), device=dev)
    helper.load_or_gen()
    t = PhaseTimer(dev)
    # The reference's measured init: loadCryptoParams from files
    # (ckks.cpp:11-23).
    with t.phase("init"):
        _ = helper.ctx
        helper.loadCryptoParams()
    size = flats[0].size
    packed = helper.pack_cohort(flats)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # Untimed warm-up round (the reference's PALISADE is AOT C++).
    helper.decrypt_cohort(helper.aggregate_cohort(
        helper.encrypt_cohort(packed), weights), size)
    with t.phase("encrypt"):
        ct = helper.encrypt_cohort(packed)
    ct_bytes = helper.ct_wire_bytes(ct)
    with t.phase("aggregate"):
        agg = helper.aggregate_cohort(ct, weights)
    with t.phase("decrypt"):
        out_vec = np.asarray(helper.decrypt_cohort(agg, size),
                             dtype=np.float32)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    chunks = ct.data.shape[1]
    del ct, agg, packed

    plain = np.mean(np.stack(flats), axis=0)
    max_err = float(np.max(np.abs(out_vec - plain)))
    x_te, y_te = make_synth_images(n_eval, seed=99)
    acc_fhe = evaluate(spec.apply, params_from_flat(spec.params, out_vec,
                                                    dev), x_te, y_te)
    acc_plain = evaluate(spec.apply, params_from_flat(spec.params, plain,
                                                      dev), x_te, y_te)
    return {"batch": batch_size, "scale_bits": scaling_bits,
            "scheme": scheme,
            "computation": t.total - t.phases["init"],
            "phases": dict(t.phases), "communication": ct_bytes,
            "acc_delta": float(acc_plain - acc_fhe), "acc_plain": acc_plain,
            "acc_fhe": acc_fhe, "max_err": max_err, "chunks": chunks,
            "peak_mem_bytes": peak, "backend": backend(dev)}


def _report(r: dict) -> None:
    ms = {k: round(v * 1e3, 4) for k, v in r["phases"].items()}
    print(f"[{r['scheme']}] batch={r['batch']} bits={r['scale_bits']}: "
          f"chunks={r['chunks']} comp={r['computation']:.4f}s phases_ms="
          f"{ms} comm={r['communication']}B acc_delta={r['acc_delta']} "
          f"acc_plain={r['acc_plain']} max_err={r['max_err']:.3e} "
          f"peak_mem_bytes={r['peak_mem_bytes']} ({r['backend']})",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="reduced grid + small model (CI/CPU)")
    ap.add_argument("--model", default="cnn_fedavg")
    ap.add_argument("--scheme", default="ckks",
                    choices=["ckks", "ckks-threshold"],
                    help="ckks-threshold runs the production point only "
                         "(4096/52): trust-model cost on the trained "
                         "acc-delta criterion; appends a jsonl row "
                         "instead of rewriting the CSV")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)
    out_dir = results_dir(args.out)

    if args.scheme == "ckks-threshold":
        r = run_config(4096, 52, args.model,
                       out_dir / "keys_threshold_4096_52",
                       scheme="ckks-threshold", out=out_dir,
                       device=args.device)
        _report(r)
        append_jsonl("params_threshold.jsonl", r, out_dir)
        return [r]

    if args.small:
        batch_list, bits_list, model = [1024], [20, 40], "mlp"
    else:
        batch_list, bits_list, model = GRID_BATCHES, GRID_BITS, args.model
    rows = []
    for b in batch_list:
        for s in bits_list:
            r = run_config(b, s, model, out_dir / f"keys_{b}_{s}",
                           out=out_dir, device=args.device)
            rows.append(r)
            _report(r)
    out_csv = out_dir / "params_results.csv"
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Batch Size", "Scaling Factor Bits", "Computation",
                    "Communication", "Acc Delta"])
        for r in rows:
            w.writerow([r["batch"], r["scale_bits"], r["computation"],
                        r["communication"], r["acc_delta"]])
    print("wrote", out_csv)
    return rows


if __name__ == "__main__":
    main()
