"""3-learner weighted-average smoke demo, the port's counterpart of
benchmarks/fedavg_demo.py: `SHELFI_FHE_MAIN` parity (reference
src/main.cpp:26-83: learners with weights 0.5 / 0.3 / 0.5 over random
100-dim data; prints decrypted vs expected values).

--scheme ckks-threshold runs the same round with 3-party threshold keys:
no single secret key exists; decryption is the multiparty ceremony.
Keys are generated anew into <out>/fedavg_demo_<scheme>/ (default
build/results_torch/).

Usage: python -m fhe_fed_tpu_torch.benchmarks.fedavg_demo [n_dims]
       [--scheme ckks|ckks-threshold] [--device cuda] [--out DIR]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import CKKS, ThresholdCKKS
from .common import backend, results_dir

WEIGHTS = [0.5, 0.3, 0.5]                 # main.cpp:55
MAX_ERR = 1e-4


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_dims", nargs="?", type=int, default=100)
    ap.add_argument("--scheme", default="ckks",
                    choices=["ckks", "ckks-threshold"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)
    n = args.n_dims
    rng = np.random.default_rng(42)
    data = [rng.random(n).astype(np.float32) for _ in WEIGHTS]

    keydir = str(results_dir(args.out) / f"fedavg_demo_{args.scheme}")
    if args.scheme == "ckks-threshold":
        helper = ThresholdCKKS("ckks-threshold", 4096, 52, cryptodir=keydir,
                               parties=3, device=args.device)
    else:
        helper = CKKS("ckks", 4096, 52, cryptodir=keydir,
                      device=args.device)
    helper.genCryptoContextAndKeyGen()
    helper.loadCryptoParams()

    blobs = [helper.encrypt(d) for d in data]
    agg = helper.computeWeightedAverage(blobs, WEIGHTS)
    out = helper.decrypt(agg, n)
    want = sum(w * d for w, d in zip(WEIGHTS, data))

    for i in range(min(n, 10)):
        print(f"computed: {out[i]:.6f}   actual: {want[i]:.6f}")
    err = float(np.max(np.abs(out - want)))
    print(f"max |computed - actual| over {n} dims: {err:.3e} "
          f"[{args.scheme}] ({backend(helper.device)})")
    if not err < MAX_ERR:
        raise AssertionError(f"weighted average mismatch: {err} >= "
                             f"{MAX_ERR}")
    return err


if __name__ == "__main__":
    main()
