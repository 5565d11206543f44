"""Kimi-Linear-48B-A3B in the port's zoo (fhe_fed_tpu_torch/models/
kimi_linear.py) against its plain reference (tests/kimi_linear_reference.py)
at a tiny size on the CPU: the logits, the chunk-wise KDA against the
token-by-token recurrence and two hand checks of that recurrence, the
expert shares against the whole MoE layer, the layout at the published
config and at one expert-parallel stage, and the benchmark's
`selective_bf16` surface through the program, the control and a planted
fault.
"""

import collections
import copy
import json
import math
import pathlib
import time

import pytest
import torch

from fhe_fed_tpu_torch.fed import fedavg as T_fedavg
from fhe_fed_tpu_torch.fed import tree_average as TA
from fhe_fed_tpu_torch.models import kimi_linear as K
from fhe_fed_tpu_torch.models import zoo
from fhe_fed_tpu_torch.utils import threefry as tf
from fedbench import run, spec

import kimi_linear_reference as R

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

TINY = dict(K.KIMI_48B, hidden_size=64, num_attention_heads=2,
            kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
            num_experts=8, router_experts=16, first_expert=0,
            num_experts_per_token=4, vocab_size=256, num_hidden_layers=4,
            linear_attn_config=dict(K.KIMI_48B["linear_attn_config"],
                                    head_dim=16, num_heads=2,
                                    full_attn_layers=[4],
                                    kda_layers=[1, 2, 3]))
# Logits relative to their largest magnitude. The port and the reference
# are one float32 function in other operation orders (KDA chunk-wise
# against token by token, fused attention, gathered experts): 8e-7 to
# 1.1e-6 here over 4 layers and 150 tokens. Computed in bfloat16 (2^-8 a
# rounding) the reference reads 4.7e-2 to 6.5e-2. 5e-5 lies between,
# with more than an order of magnitude of room on each side.
LOGITS_REL = 5e-5


def _tiny_state(seed: int, cfg=TINY):
    """The zoo's draw, with a nonzero router correction bias (its draw is
    zeros), so that the bias takes part in the choice."""
    state = K.init(tf.key(seed), cfg)
    gen = torch.Generator().manual_seed(seed)
    for k in state:
        if k.endswith("e_score_correction_bias"):
            state[k] = 0.05 * torch.randn(state[k].shape, generator=gen)
    return state


def _ids(seed: int, shape=(2, 150), vocab=TINY["vocab_size"]):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logits_match_the_reference(seed):
    """The port's forward against the reference's on the same state dict
    (150 tokens: KDA over three chunks); the reference in bfloat16 fails
    the same tolerance."""
    state, ids = _tiny_state(seed), _ids(seed)
    want = R.forward(state, ids, TINY)
    got = K.apply(state, ids, TINY)
    assert got.shape == (2, 150, TINY["vocab_size"])
    assert _rel(got, want) <= LOGITS_REL
    low = R.forward(state, ids, TINY, dtype=torch.bfloat16).float()
    assert _rel(low, want) > LOGITS_REL


def _kda_inputs(seed, B=2, H=3, T=37, dk=8, dv=5):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen)
    q, k = R.l2_normalize(rand(B, H, T, dk)), R.l2_normalize(rand(B, H, T, dk))
    g = -torch.rand((B, H, T, dk), generator=gen) * 3
    return q, k, rand(B, H, T, dv), g, torch.rand((B, H, T), generator=gen)


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_chunkwise_kda_is_the_recurrence(chunk):
    """kda over chunks of 1, 8 (37 tokens: a short last chunk) and 64 (one
    chunk), from a nonzero state, against the token-by-token recurrence:
    the outputs and the final state."""
    q, k, v, g, beta = _kda_inputs(7)
    s0 = torch.randn(2, 3, 8, 5, generator=torch.Generator().manual_seed(8))
    want, want_s = R.kda_recurrence(q, k, v, g.exp(), beta, s0)
    got, got_s = K.kda(q, k, v, g, beta, s0, chunk=chunk)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((got_s - want_s).abs().max()) <= 1e-5 * float(
        want_s.abs().max())


@pytest.mark.parametrize("impl", ["reference", "port"])
def test_kda_hand_checks(impl):
    """beta = 0 and alpha = 1 leave S at 0 (nothing written, nothing read);
    alpha = 1, beta = 1 and orthonormal keys store each v_t under k_t, so
    reading with q_t = k_t recalls v_t and the final state recalls every
    v_j under k_j."""
    def run_kda(q, k, v, g, beta):
        if impl == "reference":
            return R.kda_recurrence(q, k, v, g.exp(), beta)
        return K.kda(q, k, v, g, beta, chunk=4)

    d, T = 8, 8
    gen = torch.Generator().manual_seed(3)
    keys, _ = torch.linalg.qr(torch.randn(d, d, generator=gen))
    k = keys.T.reshape(1, 1, T, d).contiguous()          # rows orthonormal
    v = torch.randn(1, 1, T, 5, generator=gen)
    q = torch.randn(1, 1, T, d, generator=gen)
    g = torch.zeros(1, 1, T, d)
    o, s = run_kda(q, k, v, g, torch.zeros(1, 1, T))
    assert torch.equal(s, torch.zeros_like(s)) and torch.equal(
        o, torch.zeros_like(o))
    o, s = run_kda(k, k, v, g, torch.ones(1, 1, T))
    torch.testing.assert_close(o, v, atol=1e-5, rtol=0)
    torch.testing.assert_close(k[0, 0] @ s[0, 0], v[0, 0], atol=1e-5, rtol=0)


def test_expert_shares_add_up_to_the_whole_layer():
    """Experts 0-7 on one chip and 8-15 on another, each routing over all
    16 by sigmoid scores and the correction bias: their outputs, with the
    shared expert counted once, add up to the uncut reference layer
    holding all 16."""
    whole = dict(TINY, num_experts=16, router_experts=16)
    state = _tiny_state(5, whole)
    x = torch.randn(2, 40, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(5))
    layer = 1
    assert K.is_moe(whole, layer) and not K.is_mla(whole, layer)
    shares = []
    for first in (0, 8):
        cfg = dict(TINY, first_expert=first)
        names = {n for n, _ in R.layout(cfg)}
        part = {k: v for k, v in state.items() if k in names}
        assert sum(".experts." in k for k in part) == 3 * 8 * 3   # 3 MoE layers
        shares.append(K.moe(part, layer, x, K._ds_cfg(cfg)))
    shared = R.mlp(state, f"model.layers.{layer}.mlp.shared_experts.", x)
    want = R.moe_layer(state, layer, x, whole)
    got = shares[0] + shares[1] - shared
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # Each share alone is short of the whole by the other's experts.
    assert _rel(shares[0], want) > 1e-2


@pytest.mark.parametrize("name,cfg,count,leaves,mla", [
    ("kimi_linear_48b", K.KIMI_48B, 49_122_681_728, 20_493, 7),
    ("kimi_linear_shard", K.SHARD, 1_299_826_624, 493, 2),
])
def test_zoo_layout_is_the_reference_layout(name, cfg, count, leaves, mla):
    """On "meta": the count without memory, and the names and shapes in
    the reference's order; example inputs are ids of the held
    vocabulary."""
    built = zoo.build(name, device="meta")
    assert built.count == count and len(built.params) == leaves
    assert type(built.params) is collections.OrderedDict
    got = [(k, tuple(v.shape)) for k, v in built.params.items()]
    assert got == [(k, tuple(s)) for k, s in R.layout(cfg)]
    assert all(v.is_meta for v in built.params.values())
    assert sum(K.is_mla(cfg, i)
               for i in range(cfg["num_hidden_layers"])) == mla
    (ids,) = zoo.example_inputs(name)
    assert ids.shape == (1, 16) and 0 <= ids.min() <= ids.max() < cfg[
        "vocab_size"]


def test_tiny_layout_dtype_and_the_configuration_file():
    """At the tiny size the layout agrees too and `init` draws in the dtype
    asked for; the benchmark's file is the stage's configuration, and its
    layout holds `parameters`."""
    state = K.init(tf.key(0), TINY, torch.bfloat16)
    assert [(k, tuple(v.shape)) for k, v in state.items()] == [
        (k, tuple(s)) for k, s in R.layout(TINY)]
    assert {v.dtype for v in state.values()} == {torch.bfloat16}
    c = json.loads((ROOT / "fedbench" / "configs"
                    / "kimi-linear-shard-1.30b.json").read_text())
    assert R.layout(c) == R.layout(K.SHARD)
    assert c["parameters"] == sum(math.prod(s) for _, s in R.layout(c))
    assert c["leaves"] == len(R.layout(c))
    assert c["reduced"] == ["num_hidden_layers", "num_experts", "vocab_size"]
    assert c["values"]["dtype"] == "bfloat16"
    assert sum(math.ceil(0.1 * math.prod(s))
               for _, s in R.layout(c)) == 129_982_877
    pub = dict(c, **{k: c["published"][k] for k in (
        "num_hidden_layers", "num_experts", "vocab_size")})
    assert sum(math.prod(s) for _, s in R.layout(pub)) == c["published"][
        "parameters"] == 49_122_681_728


def test_the_two_reference_files_are_one():
    a = (ROOT / "tests" / "kimi_linear_reference.py").read_bytes()
    b = (ROOT / "fedbench" / "reference" / "kimi_linear.py").read_bytes()
    assert a == b


# -- the benchmark's surface ------------------------------------------------

def tiny_cell(**traffic) -> spec.Cell:
    """kimilinear.selective-bf16 with the tiny widths (4 layers, 8 of 16
    experts) and its metrics; a pool of 2, one warm-up round, two
    checked."""
    path = ROOT / "fedbench" / "configs" / "kimi-linear-shard-1.30b.json"
    config = json.loads(path.read_text())
    config.update({k: TINY[k] for k in (
        "hidden_size", "num_attention_heads", "kv_lora_rank",
        "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "intermediate_size", "moe_intermediate_size", "num_experts",
        "router_experts", "num_experts_per_token", "vocab_size",
        "num_hidden_layers", "linear_attn_config")})
    config["parameters"] = sum(math.prod(s) for _, s in R.layout(config))
    mix = json.loads((ROOT / "fedbench" / "traffic" / "selective-bf16.json"
                      ).read_text())
    mix.update(pool=2, warmup_rounds=1, check_rounds=2, traced_rounds=1)
    mix.update(traffic)
    c = spec.cell("kimilinear.selective-bf16")
    return spec.Cell(c.name, 1, copy.deepcopy(config), mix, c.end_to_end,
                     c.per_layer)


def _run(cell, sut="program", trace=False):
    return run.run_cell(cell, 2 ** 33 + 31, 0.0, trace, "cpu", sut=sut,
                        t0=time.perf_counter(), log=lambda m: None)


def test_surface_rounds_through_the_program():
    """The tiny cell through the program on the CPU: correct, its span
    metrics read, and every leaf of every round cast to float32 on the
    CPU (the card reads them in place)."""
    TA.casts.clear()
    r = _run(tiny_cell(), trace=True)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["format_faults"]["value"] == 0
    assert r["checks"]["avg_rel_err"]["value"] <= 1e-4
    assert {"tree_ms.kimi", "encrypted_ms.kimi"} <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in (
        "tree_ms.kimi", "encrypted_ms.kimi"))
    # No kernel on the CPU, so no roofline.
    assert "tree_roofline.kimi" not in r["metrics"]
    leaves = len(R.layout(tiny_cell().config))
    assert set(TA.casts) == {"bfloat16"}
    assert TA.casts["bfloat16"] % (3 * leaves) == 0


def test_surface_control_is_not_correct():
    """The reference in the helper's place at bfloat16 (the control) is
    not correct; at float32 it is."""
    cell = tiny_cell()
    assert _run(cell, sut="reference-bfloat16")["correct"] is False
    assert _run(cell, sut="reference-float32")["correct"] is True


def test_surface_catches_a_program_that_encrypts_less(monkeypatch):
    """A program that encrypts half of each leaf's ceil(0.1 size) and
    averages the rest in plaintext: the average is exact, so only the
    count catches it."""
    monkeypatch.setattr(T_fedavg.SelectivePolicy, "enc_count",
                        lambda self, size: math.ceil(self.rate * size / 2))
    r = _run(tiny_cell())
    assert r["correct"] is False
    assert r["checks"]["format_faults"]["value"] > 0
    assert r["checks"]["avg_rel_err"]["value"] <= 1e-4
