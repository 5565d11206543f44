#!/usr/bin/env python3
"""The logits of Kimi-Linear's stage after a selective secure-FedAvg round
of bfloat16 clients, against the plain reference on the exact average
(CUDA card):

    python3 tools/kimi_linear_logits.py [--seed N] [--out FILE]

Builds the zoo's kimi_linear_shard on the card in bfloat16 (seed N),
makes 3 clients as its weights plus N(0, 0.01^2) noise, rounded to
bfloat16, and averages them through the benchmark's
`kimilinear.selective-bf16` path: fhe_fedavg with SelectivePolicy(rate
0.1) over the clients' bfloat16 state dicts on the card, the program's
CKKS helper at the cell's crypto point (keys from fedbench's reference
keygen) behind the surface's counting wrapper, weights [0.5, 0.2, 0.3].
Then the port's forward (float32) on the FHE-averaged tree is held
against the reference forward (fedbench/reference/kimi_linear.py, float32,
TF32 off, KDA token by token) on the exact float64 average of the
bfloat16 clients cast to float32, on 2 sequences of 1,024 ids drawn from
the held vocabulary; and the reference in bfloat16 against the same.

The tolerance, TOL, is on max |logits - reference| over max |reference|:
the two forwards are one float32 function in other operation orders (KDA
chunk-wise against token by token over 1,024 tokens, dot products of up
to 9,216 terms, 8 layers: a few ulp an operation), and the FHE average
differs from the exact one by ~1e-8 of a weight; bfloat16 rounds every
operation to 2^-8 (the tiny CPU test reads 5e-2 there). One JSON line:
the readings, the smallest margin between a token's 8th and 9th router
choice score (sigmoid score plus correction bias) in the reference (a
near-tie there could flip an expert), the values the helper's encrypting
calls got, the tree's casts (none: the card reads bfloat16 in place), and
`ok`.
"""

from __future__ import annotations

import argparse
import collections
import fractions
import json
import math
import pathlib
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from fedbench import run as bench, spec  # noqa: E402
from fedbench.reference import ckks as ref_ckks  # noqa: E402
from fedbench.reference import kimi_linear as ref  # noqa: E402
from fhe_fed_tpu_torch import SelectivePolicy, fhe_fedavg  # noqa: E402
from fhe_fed_tpu_torch.fed import tree_average  # noqa: E402
from fhe_fed_tpu_torch.models import kimi_linear, zoo  # noqa: E402
from fhe_fed_tpu_torch.utils import threefry as tf  # noqa: E402

TOL = 1e-4
WEIGHTS = [0.5, 0.2, 0.3]
NOISE = 0.01
CELL = "kimilinear.selective-bf16"


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def router_margins(record: list):
    """ref.moe_layer, recording each call's smallest gap between the k-th
    and (k+1)-th choice score of a token."""
    layer = ref.moe_layer

    def moe_layer(state, i, x, cfg):
        m = "model.layers.%d.mlp." % i
        scores = torch.sigmoid(F.linear(x.reshape(-1, x.shape[-1]),
                                        state[m + "gate.weight"]))
        choice = scores + state[m + "gate.e_score_correction_bias"]
        top = choice.topk(cfg["num_experts_per_token"] + 1, -1).values
        record.append(float((top[:, -2] - top[:, -1]).min()))
        return layer(state, i, x, cfg)
    return moe_layer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 tools/kimi_linear_logits.py")
    p.add_argument("--seed", type=int, default=2 ** 31 + 23)
    p.add_argument("--out")
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    config = spec.cell(CELL).config
    crypto = config["crypto"]
    seeds = bench.derive(args.seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.keys)
    keys = ref_ckks.keygen(ref_ckks.make_ring(
        crypto["ring_dim"], crypto["moduli"], device), gen,
        crypto["error_eta"])
    helper = bench.make_helper("program", config, keys, seeds, device)
    counting = spec.load_file(
        spec.HERE / "surfaces" / "selective.py").Counting(helper)

    params = kimi_linear.init(tf.key(args.seed, device), kimi_linear.SHARD,
                              torch.bfloat16)
    model = zoo.spec_from_tree("kimi_linear_shard", params)
    gen.manual_seed(seeds.pool)
    clients = [collections.OrderedDict(
        (k, (v.float() + NOISE * torch.randn(v.shape, generator=gen,
                                             device=device)).bfloat16())
        for k, v in params.items()) for _ in WEIGHTS]
    torch.cuda.synchronize(device)
    tree_average.casts.clear()
    t0 = time.perf_counter()
    averaged = fhe_fedavg(counting, clients, WEIGHTS,
                          SelectivePolicy(rate=config["selective"]["rate"]))
    round_s = time.perf_counter() - t0
    casts = dict(tree_average.casts)
    averaged = collections.OrderedDict(
        (k, v.to(device)) for k, v in averaged.items())
    exact = collections.OrderedDict(
        (k, sum(w * c[k].double() for w, c in zip(WEIGHTS, clients)).float())
        for k in params)
    del clients, params
    weight_err = max(float((averaged[k] - exact[k]).abs().max())
                     for k in exact)
    weight_top = max(float(v.abs().max()) for v in exact.values())

    gen.manual_seed(seeds.sample)
    ids = torch.randint(0, config["vocab_size"], (2, 1024), generator=gen,
                        device=device)
    margins: list = []
    with torch.no_grad():
        t0 = time.perf_counter()
        port = model.forward(ids, params=averaged)
        torch.cuda.synchronize(device)
        port_s = time.perf_counter() - t0
        port_exact = model.forward(ids, params=exact)
        plain_layer, ref.moe_layer = ref.moe_layer, router_margins(margins)
        try:
            t0 = time.perf_counter()
            want = ref.forward(exact, ids, config)
            torch.cuda.synchronize(device)
            ref_s = time.perf_counter() - t0
        finally:
            ref.moe_layer = plain_layer
        low = ref.forward(exact, ids, config, dtype=torch.bfloat16).float()
    readings = {
        "port_fhe_vs_reference": rel(port, want),
        "port_exact_vs_reference": rel(port_exact, want),
        "port_fhe_vs_port_exact": rel(port, port_exact),
        "reference_bfloat16_vs_reference": rel(low, want),
    }
    rate = fractions.Fraction(str(config["selective"]["rate"]))
    encrypted = config["clients"] * sum(
        math.ceil(rate * math.prod(s)) for _, s in ref.layout(config))
    out = {
        "seed": args.seed, "tolerance": TOL, **readings,
        "weights_max_abs_err": weight_err, "weights_max_abs": weight_top,
        "logits_max_abs": float(want.abs().max()),
        "router_min_margin": min(margins), "encrypted_values": counting.values,
        "casts": casts, "round_s": round_s, "port_forward_s": port_s,
        "reference_forward_s": ref_s,
        "ok": (readings["port_fhe_vs_reference"] <= TOL
               < readings["reference_bfloat16_vs_reference"]
               and counting.values == encrypted and not casts),
        "device": torch.cuda.get_device_name(device),
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
