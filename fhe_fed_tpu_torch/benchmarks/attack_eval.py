"""DLG attack sweep over protected-layer sets, the port's counterpart of
benchmarks/attack_eval.py: reference exp1.py semantics
(attack/exp1.py:462-473: protect-one / protect-all sweeps, similarity
scoring of each reconstruction).

For each protection set: run the attack on a LeNet / CIFAR-shaped input
(zoo "lenet", seed 0, one (1, 32, 32, 3) image of np.random.default_rng(0)
labelled 3 of 100), score the recovered image against the ground truth
(MSSIM / UQI / VIFp / correlation), and report whether protecting those
layers defeats the inversion: the evidence behind selective encryption.

--topk instead sweeps ELEMENT-level protection: per-element gradient
sensitivity (attack/masking.py, reference masking/masking.py:104-145)
-> top-k mask -> mask the shared grads -> attack with the mask known to
the attacker, 7 fractions, each the best of `--restarts` seeds by final
matching loss (the attacker-observable criterion: L-BFGS lands on the
image or on a far local minimum on small changes).

Runs on the card unless --device says otherwise; rows are appended to
attack_eval.jsonl in build/results_torch/ or --out, each with its wall
time and backend.

Usage: python -m fhe_fed_tpu_torch.benchmarks.attack_eval [--steps 400]
       [--small] [--topk] [--restarts 3] [--optimizer lbfgs|adam]
       [--device cuda] [--out DIR]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from .. import attack, cuda_lib, models
from ..fed.fedavg import tree_leaves
from ..models import layers as ML
from ..utils import threefry as tf
from .common import PhaseTimer, append_jsonl, backend

TOPK_FRACTIONS = (0.0, 0.001, 0.01, 0.05, 0.1, 0.2, 0.5)


def _small_net(seed=0, device="cuda"):
    """conv 3x3 1 -> 4 (sigmoid) + dense 1024 -> 10 on a 16 x 16 x 1
    input: the JAX driver's _small_net, from the same threefry keys."""
    k = tf.split(tf.key(seed, cuda_lib.device(device)), 3)
    params = {"conv": ML.conv_init(k[0], 3, 3, 1, 4),
              "fc": ML.dense_init(k[1], 4 * 16 * 16, 10)}

    def apply(p, x):
        h = torch.sigmoid(ML.conv2d(p["conv"], x, stride=1))
        return ML.dense(p["fc"], h.reshape(h.shape[0], -1))
    return params, apply


def target(small: bool, device):
    """(params, apply, x, onehot, n_classes) of the attacked client."""
    rng = np.random.default_rng(0)
    if small:
        params, apply = _small_net(device=device)
        x = rng.random((1, 16, 16, 1), dtype=np.float32)
        n_cls = 10
    else:
        spec = models.build("lenet", device=device)
        params, apply = spec.params, spec.apply
        x = rng.random((1, 32, 32, 3), dtype=np.float32)
        n_cls = 100
    onehot = F.one_hot(torch.tensor([3]), n_cls).to(torch.float32)
    return (params, apply, torch.as_tensor(x, device=device),
            onehot.to(device), n_cls)


def sweeps(topk: bool, n_leaves: int) -> list:
    """(name, protection): layer index pairs, or top-k fractions."""
    if topk:
        return [(f"topk_{k}", k) for k in TOPK_FRACTIONS]
    # exp1-style sweep: no protection, protect layer pairs, all.
    return ([("none", ())]
            + [(f"protect_layer{li}", (2 * li, 2 * li + 1))
               for li in range(n_leaves // 2)]
            + [("protect_all", tuple(range(n_leaves)))])


def score(x: np.ndarray, data: np.ndarray) -> dict:
    """Similarity of the recovered image data[0] to the ground truth x[0]
    (one channel: its (H, W) plane)."""
    gt = x[0, ..., 0] if x.shape[-1] == 1 else x[0]
    rec = data[0, ..., 0] if x.shape[-1] == 1 else data[0]
    return {"mssim": attack.mssim(gt, rec),
            "uqi": attack.uqi(gt, rec),
            "vifp": attack.vifp(gt, rec),
            "corr": float(np.corrcoef(gt.reshape(-1),
                                      rec.reshape(-1))[0, 1])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--optimizer", default="lbfgs",
                    choices=["lbfgs", "adam"],
                    help="lbfgs mirrors the reference attack "
                         "(torch.optim.LBFGS, exp1.py)")
    ap.add_argument("--topk", action="store_true",
                    help="sweep sensitivity-based top-k element masks "
                         "instead of layer sets")
    ap.add_argument("--restarts", type=int, default=3,
                    help="seeds tried per top-k fraction (1, 2, ...)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)

    dev = cuda_lib.device(args.device)
    params, apply, x, onehot, n_cls = target(args.small, dev)
    x_np = x.cpu().numpy()
    if args.topk:
        sens = attack.gradient_sensitivity(apply, params, x, onehot)
    t = PhaseTimer(dev)
    results = []
    for name, protected in sweeps(args.topk, len(tree_leaves(params))):
        with t.phase(name):
            if args.topk:
                frac, mask = protected, None
                grads = attack.model_gradients(apply, params, x, onehot)
                if frac > 0:
                    mask = attack.top_k_mask(sens, frac)
                    grads = attack.mask_gradients(grads, mask)
                res = None
                for seed in range(1, args.restarts + 1):
                    cand = attack.dlg_attack(
                        apply, params, grads, x.shape, n_cls,
                        element_mask=mask, steps=args.steps, lr=0.05,
                        seed=seed, optimizer=args.optimizer)
                    if res is None or cand.losses[-1] < res.losses[-1]:
                        res = cand
            else:
                grads = attack.model_gradients(apply, params, x, onehot,
                                               protected_layers=protected)
                res = attack.dlg_attack(apply, params, grads, x.shape, n_cls,
                                        protected_layers=protected,
                                        steps=args.steps, lr=0.05, seed=1,
                                        optimizer=args.optimizer)
        r = {"protection": name,
             **({"restarts": args.restarts, "selected_by": "final_loss"}
                if args.topk else {}),
             **score(x_np, res.data),
             "final_loss": float(res.losses[-1]),
             "optimizer": args.optimizer, "steps": args.steps,
             "seconds": t.phases[name], "backend": backend(dev)}
        results.append(r)
        append_jsonl("attack_eval.jsonl", r, args.out)
        print(f"{name:20s} mssim={r['mssim']:+.3f} uqi={r['uqi']:+.3f} "
              f"vifp={r['vifp']:+.3f} corr={r['corr']:+.3f} final_loss="
              f"{r['final_loss']:.3e} {r['seconds']:.3f}s ({r['backend']})",
              flush=True)
    return results


if __name__ == "__main__":
    main()
