#!/usr/bin/env python3
"""The logits of Granite-4.0-H-Small's stage over the averaged tree of a
timed round of the benchmark's `granite4h.selective-bf16-tied` cell,
against the plain reference on the exact average (CUDA card):

    python3 tools/granite_hybrid_logits.py [--seed N] [--out FILE]

Sets the cell up as fedbench.run does from seed N (the reference's key
pair, the program's CKKS helper behind the surface's counting wrapper,
the pool entry of 3 clients' bfloat16 state dicts with the tied
embedding), runs one warm-up round and one timed round, and keeps the
timed round's averaged float32 tree. The exact average sum_k w_k x_k of
the clients' bfloat16 values is computed in float64 a key at a time on
the card and rounded to float32; then the pool is freed. The port's
forward (models/granite_hybrid.py `apply`, float32, SSD chunk-wise) on
the FHE-averaged tree is held against the reference forward
(fedbench/reference/granite_hybrid.py, float32, TF32 off, SSD token by
token) on the exact average, on 2 sequences of 2,048 ids drawn from the
held vocabulary (8 SSD chunks of 256: chunk boundaries are crossed); and
the reference in bfloat16 against the same.

The tolerance, TOL, is on max |logits - reference| over max |reference|:
the two forwards are one float32 function in other operation orders (SSD
chunk-wise against token by token over 2,048 tokens, fused attention,
gathered experts, dot products of up to 8,192 terms, 10 layers: a few ulp
an operation), and the FHE average differs from the exact one by ~3e-8
of the tree's largest value (the cell's `avg_rel_err`); bfloat16 rounds
every operation to 2^-8 (the tiny CPU test reads ~1e-2 there).

The top-10 routing is a step function of the router's logits: where a
token's 10th and 11th logit lie closer than the CKKS noise moves them
(~1e-7 here), the FHE-averaged tree routes that token to another expert
than the exact average does, and that token's hidden state, and through
the Mamba state and attention every later token's, moves by far more than
TOL. That is the model's, not the port's. So the reference also runs on
the FHE-averaged tree, and the tool counts the routing decisions (layer,
token) whose expert set differs from the exact average's (`route_flips`).
`ok` holds the port on the FHE tree to the reference on the same tree
within TOL, always; to the reference on the exact average within TOL
where no decision flipped; and the bfloat16 reference (on the exact
average) outside TOL.

One JSON line: the readings, the flips, the smallest margin between a
token's 10th and 11th router logit in the reference on the exact average,
the values the helper's encrypting calls got, the tree's casts (none: the
card reads bfloat16 in place) and aliases (the tied pair, a count a
client), the port's `fhe.model.*` spans over one traced forward (calls
and device ms), and `ok`.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from fedbench import rounds, run as bench, spec  # noqa: E402
from fedbench.reference import ckks as ref_ckks  # noqa: E402
from fedbench.reference import granite_hybrid as ref  # noqa: E402
from fhe_fed_tpu_torch.fed import tree_average  # noqa: E402
from fhe_fed_tpu_torch.models import zoo  # noqa: E402

TOL = 1e-4
CELL = "granite4h.selective-bf16-tied"
TOKENS = 2048
SPANS = ("fhe.model.mamba", "fhe.model.attention", "fhe.model.moe")


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def routing(margins: list, routes: list):
    """ref.moe_layer, recording each call's smallest gap between a token's
    k-th and (k+1)-th router logit, and each token's chosen experts in
    ascending order."""
    layer = ref.moe_layer

    def moe_layer(state, i, x, cfg):
        w = state["model.layers.%d.block_sparse_moe.router.layer.weight" % i]
        logits = F.linear(x.reshape(-1, x.shape[-1]), w)
        top = logits.topk(cfg["num_experts_per_tok"] + 1, -1)
        margins.append(float((top.values[:, -2] - top.values[:, -1]).min()))
        routes.append(top.indices[:, :-1].sort(-1).values)
        return layer(state, i, x, cfg)
    return moe_layer


def traced_reference(state, ids, config):
    """The reference's logits, the router margins and the routes."""
    margins, routes = [], []
    plain_layer, ref.moe_layer = ref.moe_layer, routing(margins, routes)
    try:
        return ref.forward(state, ids, config), margins, routes
    finally:
        ref.moe_layer = plain_layer


def span_ms(model, ids, params) -> dict:
    """Calls and device ms of each `fhe.model.*` span over one forward."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        model.forward(ids, params=params)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.key in SPANS:
            out[e.key] = {"count": e.count,
                          "device_ms": e.device_time_total / 1e3}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 tools/granite_hybrid_logits.py")
    p.add_argument("--seed", type=int, default=2 ** 31 + 29)
    p.add_argument("--out")
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    cell = spec.cell(CELL)
    config, crypto = cell.config, cell.config["crypto"]
    seeds = bench.derive(args.seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.keys)
    keys = ref_ckks.keygen(ref_ckks.make_ring(
        crypto["ring_dim"], crypto["moduli"], device), gen,
        crypto["error_eta"])
    helper = bench.make_helper("program", config, keys, seeds, device)
    runner = rounds.runner(cell.traffic, helper, config, rounds.make_pool(
        config, cell.traffic, seeds.pool, device), device)
    runner.round(0)
    tree_average.casts.clear()
    tree_average.aliases.clear()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    obs = runner.round(1)
    round_s = time.perf_counter() - t0
    casts, aliases = dict(tree_average.casts), dict(tree_average.aliases)

    rows, offsets = runner.flat(obs["pool"]), runner.offsets()
    ties = ref.ties(config)
    exact = collections.OrderedDict()
    for name, shape in ref.layout(config):
        if name in ties:
            exact[name] = exact[ties[name]]
            continue
        off, size = offsets[name], torch.Size(shape).numel()
        exact[name] = ref_ckks.weighted_mean(
            [r[off:off + size] for r in rows], runner.weights
        ).float().view(shape)
    del rows
    runner.inputs = []
    runner.helper = helper = None
    torch.cuda.empty_cache()
    averaged = collections.OrderedDict(
        (k, v.to(device)) for k, v in obs["out"].items())
    weight_err = max(float((averaged[k] - exact[k]).abs().max())
                     for k in exact)
    weight_top = max(float(v.abs().max()) for v in exact.values())
    tied_storage = (averaged["lm_head.weight"].data_ptr()
                    == averaged["model.embed_tokens.weight"].data_ptr())

    model = zoo.spec_from_tree("granite_4_0_h_small_shard", averaged)
    gen.manual_seed(seeds.sample)
    ids = torch.randint(0, config["vocab_size"], (2, TOKENS), generator=gen,
                        device=device)
    with torch.no_grad():
        t0 = time.perf_counter()
        port = model.forward(ids, params=averaged)
        torch.cuda.synchronize(device)
        port_s = time.perf_counter() - t0
        port_exact = model.forward(ids, params=exact)
        spans = span_ms(model, ids, averaged)
        t0 = time.perf_counter()
        want, margins, routes = traced_reference(exact, ids, config)
        torch.cuda.synchronize(device)
        ref_s = time.perf_counter() - t0
        want_fhe, _, routes_fhe = traced_reference(averaged, ids, config)
        low = ref.forward(exact, ids, config, dtype=torch.bfloat16).float()
    flips = sum(int((a != b).any(-1).sum())
                for a, b in zip(routes, routes_fhe))
    readings = {
        "port_fhe_vs_reference": rel(port, want),
        "port_fhe_vs_reference_fhe": rel(port, want_fhe),
        "reference_fhe_vs_reference": rel(want_fhe, want),
        "port_exact_vs_reference": rel(port_exact, want),
        "port_fhe_vs_port_exact": rel(port, port_exact),
        "reference_bfloat16_vs_reference": rel(low, want),
    }
    out = {
        "seed": args.seed, "tolerance": TOL, **readings,
        "weights_max_abs_err": weight_err, "weights_max_abs": weight_top,
        "logits_max_abs": float(want.abs().max()),
        "route_flips": flips, "route_decisions": sum(
            r.shape[0] for r in routes),
        "router_min_margin": min(margins), "encrypted_values": obs[
            "encrypted"], "encrypted_want": runner.encrypted,
        "casts": casts, "aliases": aliases,
        "tied_outputs_share_storage": tied_storage, "spans": spans,
        "round_s": round_s, "port_forward_s": port_s,
        "reference_forward_s": ref_s,
        "ok": (readings["port_fhe_vs_reference_fhe"] <= TOL
               < readings["reference_bfloat16_vs_reference"]
               and (flips or readings["port_fhe_vs_reference"] <= TOL)
               and obs["encrypted"] == runner.encrypted and not casts
               and aliases == {"lm_head.weight": config["clients"]}),
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
