"""Train a zoo model on the synthetic task and cache the weights, the
port's counterpart of benchmarks/train_synth.py.

Gives the param sweep a *trained* model so its Acc-Delta column measures
real test accuracy of FHE- vs plaintext-aggregated weights, mirroring the
reference's FashionMNIST criterion (benchmark_crypto.py:21-49,246-250)
instead of argmax disagreement on random inputs from an untrained net.

Training is the JAX driver's: Adam (lr 1e-3; torch.optim.Adam with
optax.adam's defaults) on the mean softmax cross-entropy over
data/synth.py's images (8192 train, seed 7; 4096 test, seed 99), batches
of 256 taken in order, 600 steps, from the zoo's seed-0 weights, in full
float32 (utils/precision.py) on the card unless `device` says otherwise.

Usage: python -m fhe_fed_tpu_torch.benchmarks.train_synth [--model mlp]
       [--steps 600] [--device cuda] [--out DIR]
Cached at <out>/trained_<model>.npz (default build/results_torch/), the
JAX driver's flat format: np.savez_compressed(path, flat=...), the
parameters in tree_leaves order.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from .. import cuda_lib, models
from ..attack.dlg import leaf_copies
from ..data.synth import make_synth_images
from ..fed.fedavg import flatten_params, tree_leaves, tree_map
from ..utils.precision import full_f32
from .common import backend, results_dir

TRAIN_N, TEST_N = 8192, 4096
BATCH = 256


def predict(apply, params, x: np.ndarray, batch: int = 1024) -> np.ndarray:
    """argmax of apply(params, x) over the classes, in batches of `batch`
    on the parameters' device, in full float32."""
    dev = tree_leaves(params)[0].device
    out = []
    with torch.no_grad(), full_f32():
        for i in range(0, x.shape[0], batch):
            logits = apply(params, torch.as_tensor(x[i:i + batch],
                                                   device=dev))
            out.append(torch.argmax(logits, -1).cpu().numpy())
    return np.concatenate(out)


def evaluate(apply, params, x: np.ndarray, y: np.ndarray,
             batch: int = 1024) -> float:
    """Test accuracy: the share of x whose prediction is y."""
    return int((predict(apply, params, x, batch) == y).sum()) / x.shape[0]


def params_from_flat(like, flat: np.ndarray, device):
    """The tree of `like` with its leaves taken in order from the flat
    float32 vector `flat` (tree_leaves order), on `device`."""
    flat = np.asarray(flat, dtype=np.float32)
    off = 0

    def leaf(x):
        nonlocal off
        t = torch.from_numpy(flat[off:off + x.numel()]).reshape(x.shape)
        off += x.numel()
        return t.to(device)
    return tree_map(leaf, like)


def train(apply, params, x: np.ndarray, y: np.ndarray, steps: int,
          lr: float = 1e-3, batch: int = BATCH):
    """`steps` Adam steps on the mean cross-entropy, batches of `batch`
    taken in order (wrapping around), on the parameters' device. Returns
    the trained tree (detached tensors)."""
    dev = tree_leaves(params)[0].device
    xs = torch.as_tensor(x, device=dev)
    ys = torch.as_tensor(y, dtype=torch.int64, device=dev)
    n_batches = x.shape[0] // batch
    with full_f32():
        tree, leaves = leaf_copies(params)
        opt = torch.optim.Adam(leaves, lr=lr)
        for s in range(steps):
            i = (s % n_batches) * batch
            loss = F.cross_entropy(apply(tree, xs[i:i + batch]),
                                   ys[i:i + batch])
            opt.zero_grad()
            loss.backward()
            opt.step()
    return tree_map(lambda t: t.detach(), tree)


def trained_model(model_name: str, steps: int = 600, lr: float = 1e-3,
                  cache: bool = True, out=None, device="cuda"):
    """Returns (spec, trained_params, test_acc); the parameters on
    `device`. Cached in results_dir(out) (read if there, written after
    training)."""
    dev = cuda_lib.device(device)
    spec = models.build(model_name, device=dev)
    x_te, y_te = make_synth_images(TEST_N, seed=99)
    if cache:
        path = results_dir(out) / f"trained_{model_name}.npz"
        if path.exists():
            with np.load(path) as z:
                params = params_from_flat(spec.params, z["flat"], dev)
            return spec, params, evaluate(spec.apply, params, x_te, y_te)
    x_tr, y_tr = make_synth_images(TRAIN_N, seed=7)
    params = train(spec.apply, spec.params, x_tr, y_tr, steps, lr)
    acc = evaluate(spec.apply, params, x_te, y_te)
    if cache:
        np.savez_compressed(path, flat=flatten_params(params)[0])
    return spec, params, acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)
    spec, params, acc = trained_model(args.model, steps=args.steps,
                                      out=args.out, device=args.device)
    print(f"{args.model}: test_acc={acc:.4f} "
          f"(params={flatten_params(params)[0].size}) "
          f"({backend(args.device)})")
    return acc


if __name__ == "__main__":
    main()
