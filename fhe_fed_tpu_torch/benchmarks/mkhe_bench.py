"""Single-key vs threshold CKKS timing, the port's counterpart of
benchmarks/mkhe_bench.py: `mk-test` CLI parity (reference
code/mkhe/mkhe.cpp:52-94: `mk-test <model_size> <client_size>` times
RunSingleKeyCKKS then RunCKKS with N-party threshold keys).

The point is mkhe.cpp:204-215's genCryptoContextCKKS: batch 4096, scale
2^51, multiplicative depth 2 (N 8192, chain 5 + 1 special prime). A
warm-up pass precedes each measured pass (the reference is AOT C++, its
chrono runs around already-compiled calls; here the warm-up builds the
context's device state and the kernels' first launches). Each phase is
timed with PhaseTimer (synchronised with the card). Only measured rows
are written: mkhe_bench.jsonl in build/results_torch/ or --out is
rewritten, never appended.

Usage: python -m fhe_fed_tpu_torch.benchmarks.mkhe_bench [model_size]
       [client_size ...] [--device cuda] [--out DIR]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import cuda_lib
from ..ckks import keys as K
from ..ckks import keyswitch as KS
from ..ckks import ops as O
from ..ckks import params as P
from ..ckks import threshold as T
from ..utils import threefry as tf
from .common import PhaseTimer, backend, rewrite_jsonl


def chunk(vals: np.ndarray, cap: int, n: int, device) -> torch.Tensor:
    """vals -> (chunks, n) f32 on `device`, `cap` values a chunk."""
    chunks = -(-vals.size // cap)
    buf = np.zeros((chunks, n), dtype=np.float32)
    pay = np.zeros(chunks * cap, dtype=np.float32)
    pay[:vals.size] = vals
    buf[:, :cap] = pay.reshape(chunks, cap)
    return torch.as_tensor(buf, device=device)


def _errors(out: torch.Tensor, v: np.ndarray, batch: int) -> dict:
    got = out.cpu().numpy()[:, :batch].reshape(-1)[:v.size]
    return {"max_err": float(np.abs(got - v).max()),
            "log2_precision": round(O.log2_precision(got, v), 2)}


def run_single_key(model_size: int, ctx, batch: int) -> dict:
    """RunSingleKeyCKKS (mkhe.cpp:96-185): keygen, encrypt, x0.5, +, dec."""
    dev = ctx.q.device
    t = PhaseTimer(dev)
    with t.phase("keygen"):
        sk, pk = K.keygen(ctx, 0)
    v = np.random.default_rng(0).standard_normal(model_size).astype(
        np.float32)
    vals = chunk(v, batch, ctx.ring_dim, dev)
    with t.phase("encrypt"):
        ct = O.encrypt(ctx, pk, vals, tf.key(1, dev))
    with t.phase("eval"):
        h = O.mul_scalar(ctx, ct, 0.5)
        h = O.add(ctx, h, h)
    with t.phase("decrypt"):
        out = O.decrypt(ctx, sk, h).cpu()
    return {"mode": "single", **t.phases, **_errors(out, v, batch)}


def run_threshold(model_size: int, client_size: int, ctx,
                  batch: int) -> dict:
    """RunCKKS (mkhe.cpp:188-465): chained keygen, the joint eval-mult key,
    joint encrypt, eval, ct x ct + relinearise under the joint key, and
    the per-party partial decrypts + fusion, each ceremony stacked over
    the parties (threshold.py's *_batched, residue-identical to the
    per-party functions)."""
    dev = ctx.q.device
    t = PhaseTimer(dev)
    with t.phase("keygen"):
        sec, pk = T.multiparty_keygen_batched(ctx, client_size, seed=1)
    # the two-round MultiKeySwitchGen / MultiMultEvalKey /
    # MultiAddEvalMultKeys ceremony (mkhe.cpp:281-317)
    with t.phase("joint_evalkey"):
        rlk = T.multiparty_relin_key_batched(ctx, sec, common_seed=2, seed=1)
    v = np.random.default_rng(1).standard_normal(model_size).astype(
        np.float32)
    vals = chunk(v, batch, ctx.ring_dim, dev)
    with t.phase("encrypt"):
        ct = O.encrypt(ctx, pk, vals, tf.key(2, dev))
    with t.phase("eval"):
        h = O.mul_scalar(ctx, ct, 0.5)
        h = O.add(ctx, h, h)
    # ct x ct + relinearise under the JOINT key (beyond the reference's
    # scalar-only circuit; proves the joint relin key at these params)
    with t.phase("mul_relin_joint"):
        O.rescale(ctx, KS.mul_ct(ctx, ct, ct, rlk))
    # MultipartyDecryptLead/Main + Fusion (mkhe.cpp:392-402): lead key 10,
    # mains 11 + i, as the JAX driver.
    dec_keys = T.stack_keys([tf.key(10, dev)] + [
        tf.key(11 + i, dev) for i in range(client_size - 1)])
    with t.phase("decrypt"):
        out = T.threshold_decrypt(ctx, sec, h, dec_keys).cpu()
    return {"mode": "threshold", "parties": client_size, **t.phases,
            **_errors(out, v, batch)}


def main(argv=None):
    """mk-test parity: one single-key pass plus a threshold pass per
    requested party count, each after a warm-up pass."""
    ap = argparse.ArgumentParser()
    ap.add_argument("model_size", nargs="?", type=int, default=100_000)
    ap.add_argument("client_sizes", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)
    client_sizes = args.client_sizes or [3]
    batch = 4096
    dev = cuda_lib.device(args.device)
    params = P.make_params(batch=batch, scale_bits=51, mult_depth=2)
    ctx = P.make_context(params, dev)

    run_single_key(args.model_size, ctx, batch)
    rows = [run_single_key(args.model_size, ctx, batch)]
    for client_size in client_sizes:
        run_threshold(args.model_size, client_size, ctx, batch)
        rows.append(run_threshold(args.model_size, client_size, ctx, batch))
    for r in rows:
        r.update(model_size=args.model_size, ring_dim=params.ring_dim,
                 pass_="measured", backend=backend(dev))
        print(r, flush=True)
    rewrite_jsonl("mkhe_bench.jsonl", rows, args.out)
    return rows


if __name__ == "__main__":
    main()
