#!/usr/bin/env python3
"""How far each zoo model's forward moves when every weight moves by a
decryption-sized error: the yardstick of chip_smoke.py's forward check.

    python3 tools/zoo_sensitivity.py [--device cpu|cuda] [--models ...]

For each model, build(name, seed 0) and model_bench's 3-client average
of it (the model's vector plus each client's N(0, 0.01^2) noise, seed 0,
as model_bench.run_model draws it); then each weight of the average moved
by U(-eps, eps) for eps = 1e-6 (the rounds' max_err gate) and 3e-8 (the
rounds' typical error), and the forward at zoo.example_inputs compared,
as chip_smoke.forward_rel does: max |dy| / max(1, max |y|) over the
outputs. The first column moves build(seed 0)'s weights themselves,
where zero-initialised tokens meet LayerNorm's eps 1e-12.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from fhe_fed_tpu_torch.fed.fedavg import (  # noqa: E402
    flatten_params, tree_leaves, tree_map, unflatten_params)
from fhe_fed_tpu_torch.models import zoo  # noqa: E402


def rel_change(spec, tree, base: np.ndarray, moved: np.ndarray, inputs,
               device) -> float:
    """max |f(moved) - f(base)| / max(1, max |f(base)|) over the outputs."""
    def run(flat):
        params = tree_map(lambda t: t.to(device),
                          unflatten_params(flat, tree))
        return tree_leaves(spec.forward(*inputs, params=params))
    y0, y1 = run(base), run(moved)
    return max(float((a - b).abs().max()) / max(1.0, float(a.abs().max()))
               for a, b in zip(y0, y1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--models", nargs="*", default=list(zoo.MODEL_NAMES))
    args = ap.parse_args()
    device = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    print(f"{'model':11s} {'seed-0 weights 1e-6':>20s} "
          f"{'average 1e-6':>14s} {'average 3e-8':>14s}")
    for name in args.models:
        spec = zoo.build(name, seed=0, device=device)
        flat, tree = flatten_params(spec.params)
        rng = np.random.default_rng(0)
        avg = np.mean(np.stack([flat + rng.standard_normal(flat.size).astype(
            np.float32) * 0.01 for _ in range(3)]), axis=0)
        inputs = [torch.as_tensor(x, device=device)
                  for x in zoo.example_inputs(name)]
        move = np.random.default_rng(1)
        cols = []
        for base, eps in ((flat, 1e-6), (avg, 1e-6), (avg, 3e-8)):
            moved = base + move.uniform(-eps, eps, base.size).astype(
                np.float32)
            cols.append(rel_change(spec, tree, base, moved, inputs, device))
        print(f"{name:11s} {cols[0]:20.3e} {cols[1]:14.3e} {cols[2]:14.3e}",
              flush=True)


if __name__ == "__main__":
    main()
