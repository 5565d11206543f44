#!/usr/bin/env python3
"""Drive the PyTorch port's encrypted FedAvg round once on one CUDA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the kernel library from csrc/ (nvcc, into build/fhe_fed_tpu_torch/);
  3. hold every kernel against its plain PyTorch version, bit-exactly, at
     the main path's shapes, and time both with CUDA events;
  4. run the main path at the bench configuration (CNN_OriginalFedAvg,
     1,663,370 parameters x 3 clients, batch 4096 / scale 2^52 / N 8192,
     204 dense chunks) with the committed keys: secret-key encrypt ->
     weighted sum -> decrypt, the public-key encrypt path, and the fused
     round; check max_err <= 1e-6 against the plaintext weighted average
     and that every kernel was launched;
  5. time each phase after a warm-up.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from fhe_fed_tpu_torch import cuda_lib
from fhe_fed_tpu_torch.ntt import mxu, mxu_pallas
from fhe_fed_tpu_torch.ckks import params as P, serial as S, ops, encoding
from fhe_fed_tpu_torch.ckks import pallas_agg, pallas_decode
from fhe_fed_tpu_torch.ckks.keys import uniform_mod_q

ROOT = pathlib.Path(__file__).resolve().parent
KEY_DIR = ROOT / "results" / "bench_keys_headline"
CNN_PARAMS = 1_663_370
N_CLIENTS = 3
MAX_ERR = 1e-6
TIMED_ROUNDS = 10

KERNELS = {   # wrapper name -> (source, TPU kernel it replaces)
    "ntt_mxu_fused": ("fhe_fed_tpu_torch/csrc/ntt_mxu.cu",
                      "fhe_fed_tpu/ntt/mxu_pallas.py:95"),
    "intt_mxu_fused": ("fhe_fed_tpu_torch/csrc/ntt_mxu.cu",
                       "fhe_fed_tpu/ntt/mxu_pallas.py:95"),
    "weighted_sum_fused": ("fhe_fed_tpu_torch/csrc/weighted_sum.cu",
                           "fhe_fed_tpu/ckks/pallas_agg.py:30"),
    "decode_fused": ("fhe_fed_tpu_torch/csrc/decode_crt.cu",
                     "fhe_fed_tpu/ckks/pallas_decode.py:39"),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over `reps` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check_kernels(ctx, sk, values, weights, gen, reps=10) -> list[dict]:
    """Each kernel against its plain version at the shapes `values`
    (K, chunks, N) gives the main path; raises on any bit difference."""
    K, chunks, n = values.shape
    L = ctx.params.chain_len
    moduli = ctx.params.moduli
    mt = ctx.mxu.slice_limbs(0, L)
    recs = []

    def record(name, got, want, fn, plain_fn):
        torch.cuda.synchronize()
        if got.dtype == torch.float32:
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            same = torch.equal(got, want)
        err = _max_abs_err(got, want)
        if not same:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max_abs_err {err})")
        src, rep = KERNELS[name]
        recs.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         shape=list(got.shape), max_abs_err=err,
                         ms=cuda_ms(fn, reps), plain_ms=cuda_ms(plain_fn, 3)))

    x = uniform_mod_q(gen, (K * chunks, L, n), moduli)
    record("ntt_mxu_fused", mxu_pallas.ntt_mxu_fused(x, mt),
           mxu.ntt_mxu(x, mt), lambda: mxu_pallas.ntt_mxu_fused(x, mt),
           lambda: mxu.ntt_mxu(x, mt))
    xe = uniform_mod_q(gen, (chunks, L, n), moduli)
    record("intt_mxu_fused", mxu_pallas.intt_mxu_fused(xe, mt),
           mxu.intt_mxu(xe, mt), lambda: mxu_pallas.intt_mxu_fused(xe, mt),
           lambda: mxu.intt_mxu(xe, mt))

    stacked = uniform_mod_q(gen, (K, chunks, 2, L, n), moduli)
    w_res, w_shoup, _ = ops._encode_weights(ctx, weights, L, 0)
    wr = torch.as_tensor(w_res, device=stacked.device)
    ws = torch.as_tensor(w_shoup, device=stacked.device)
    record("weighted_sum_fused",
           pallas_agg.weighted_sum_fused(stacked, w_res, w_shoup, moduli[:L]),
           ops._weighted_sum_impl(ctx, stacked, wr, ws),
           lambda: pallas_agg.weighted_sum_fused(stacked, w_res, w_shoup,
                                                 moduli[:L]),
           lambda: ops._weighted_sum_impl(ctx, stacked, wr, ws))

    # Real decrypt residues of an aggregated round.
    agg = ops.weighted_sum(
        ctx, ops.encrypt_symmetric_stacked(ctx, sk, values, gen), weights)
    res = ops.decrypt_residues(ctx, sk, agg)
    dc = ctx.dec_consts[L - 1]
    qs = ctx.q[:L]
    record("decode_fused", pallas_decode.decode_fused(ctx, dc, res, agg.scale),
           encoding.decode_core(dc, qs, res, agg.scale),
           lambda: pallas_decode.decode_fused(ctx, dc, res, agg.scale),
           lambda: encoding.decode_core(dc, qs, res, agg.scale))
    return recs


def run_main_path(ctx, sk, pk, values, weights, gen) -> dict:
    """One pass of every entry point of the round; returns the outputs."""
    ct = ops.encrypt_symmetric_stacked(ctx, sk, values, gen)
    out = ops.decrypt(ctx, sk, ops.weighted_sum(ctx, ct, weights))
    ct_pk = ops.encrypt_stacked(ctx, pk, values, gen)
    out_pk = ops.decrypt(ctx, sk, ops.weighted_sum(ctx, ct_pk, weights))
    fused = ops.fedavg_round_fused(ctx, sk, values, gen, weights)
    torch.cuda.synchronize()
    return {"secret_key": out, "public_key": out_pk, "fused": fused}


def check_outputs(outs: dict, want: np.ndarray, n_values: int) -> float:
    """Finite, right shape, and within MAX_ERR of the plaintext average."""
    errs = []
    for name, o in outs.items():
        if tuple(o.shape) != want.shape or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{name}: bad output {tuple(o.shape)}")
        flat = o.cpu().numpy().reshape(-1)[:n_values].astype(np.float64)
        errs.append(float(np.max(np.abs(flat - want.reshape(-1)[:n_values]))))
    err = max(errs)
    if not err <= MAX_ERR:
        raise AssertionError(f"max_err {err} > {MAX_ERR} ({errs})")
    return err


def make_values(n_clients, n_values, chunks, n, seed=0):
    """Seeded client payloads, dense-packed into (K, chunks, N) f32, and the
    f64 plaintext weighted average (equal weights)."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((n_clients, chunks * n), dtype=np.float32)
    for k in range(n_clients):
        buf[k, :n_values] = rng.standard_normal(n_values).astype(
            np.float32) * 0.1
    weights = [1.0 / n_clients] * n_clients
    want = np.tensordot(np.array(weights), buf.astype(np.float64), axes=1)
    return buf.reshape(n_clients, chunks, n), weights, want.reshape(chunks, n)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # The plain NTT's f32 digit-plane matmul is exact only in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    gpu = card()
    print(f"card: {gpu}", flush=True)

    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"build_s: {time.perf_counter() - t0:.3f} ({gpu})", flush=True)

    t0 = time.perf_counter()
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params, dev)
    sk = S.deserialize_secret_key((KEY_DIR / "key-private.txt").read_bytes(),
                                  dev)
    pk = S.deserialize_public_key((KEY_DIR / "key-public.txt").read_bytes(),
                                  dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = params.ring_dim
    chunks = -(-CNN_PARAMS // n)
    vals_np, weights, want = make_values(N_CLIENTS, CNN_PARAMS, chunks, n)
    values = torch.as_tensor(vals_np, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(f"config: N={n} limbs={params.num_limbs} chain={params.chain_len} "
          f"chunks={chunks} clients={N_CLIENTS} init_s={init_s:.3f}",
          flush=True)

    recs = check_kernels(ctx, sk, values, weights, gen)
    for r in recs:
        print(f"kernel {r['name']} {r['shape']}: bit-exact, "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms ({gpu})",
              flush=True)

    cuda_lib.launches.clear()
    outs = run_main_path(ctx, sk, pk, values, weights, gen)
    counts = dict(cuda_lib.launches)
    missing = [k for k in KERNELS if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}: {counts}")
    max_err = check_outputs(outs, want, CNN_PARAMS)
    print(f"main path: max_err {max_err!r} launches {counts}", flush=True)

    ct = ops.encrypt_symmetric_stacked(ctx, sk, values, gen)
    agg = ops.weighted_sum(ctx, ct, weights)
    torch.cuda.reset_peak_memory_stats(dev)
    phases = {
        "encrypt_cohort": lambda: ops.encrypt_symmetric_stacked(
            ctx, sk, values, gen),
        "aggregate": lambda: ops.weighted_sum(ctx, ct, weights),
        "decrypt": lambda: ops.decrypt(ctx, sk, agg),
        "encrypt_publickey_cohort": lambda: ops.encrypt_stacked(
            ctx, pk, values, gen),
        "round_fused": lambda: ops.fedavg_round_fused(
            ctx, sk, values, gen, weights),
    }
    times = {k: cuda_ms(fn, TIMED_ROUNDS) for k, fn in phases.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for k, ms in times.items():
        print(f"phase {k}_ms: {ms:.4f} ({gpu})", flush=True)
    round_ms = sum(times[k] for k in ("encrypt_cohort", "aggregate",
                                      "decrypt"))
    print(f"phase enc+agg+dec_ms: {round_ms:.4f} peak_mem_bytes: {peak} "
          f"({gpu})", flush=True)

    for r in recs:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
