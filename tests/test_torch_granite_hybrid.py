"""Granite-4.0-H-Small in the port's zoo (fhe_fed_tpu_torch/models/
granite_hybrid.py) against its plain reference (tests/
granite_hybrid_reference.py) at a tiny size on the CPU: the logits, the
chunk-wise SSD against the token-by-token recurrence, the expert shares
against the whole MoE layer, the tied embedding, the layout and counts at
the published config and at one expert-parallel stage; the tied bfloat16
tree with stacked expert leaves through fhe_fedavg against the JAX
package, and `tree_average.aliases`; the shared DeepSeek and Kimi code
unchanged bit for bit; the host blocks and the plan past 2^31 positions;
and the benchmark's `selective_bf16_tied` surface through the program.
"""

import collections
import copy
import gc
import json
import math
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import fhe_fed_tpu as J
import fhe_fed_tpu_torch as T
from fhe_fed_tpu_torch.fed import fedavg as T_fedavg
from fhe_fed_tpu_torch.fed import tree_average as TA
from fhe_fed_tpu_torch.models import deepseek_v2 as D
from fhe_fed_tpu_torch.models import granite_hybrid as G
from fhe_fed_tpu_torch.models import kimi_linear as K
from fhe_fed_tpu_torch.models import zoo
from fhe_fed_tpu_torch.utils import threefry as tf
from fedbench import run, spec

import granite_hybrid_reference as R

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = [0.5, 0.2, 0.3]

# Hidden 64, two Mamba-2 heads of 64 (d_inner 128, state 16), 4 query and
# 2 KV heads of 16, 6 experts held of 12 routed top-3, vocabulary 256,
# attention between two Mamba-2 layers; SSD chunks of 32.
TINY = dict(G.GRANITE_H_SMALL, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, mamba_n_heads=2, mamba_d_head=64,
            mamba_d_state=16, mamba_chunk_size=32, intermediate_size=32,
            shared_intermediate_size=48, num_local_experts=6,
            router_experts=12, first_expert=0, num_experts_per_tok=3,
            vocab_size=256, num_hidden_layers=3,
            layer_types=["mamba", "attention", "mamba"])
# Logits relative to their largest magnitude. The port and the reference
# are one float32 function in other operation orders (SSD chunk-wise
# against token by token, fused attention, gathered experts): ~1e-7 to
# 1e-6 here over 3 layers and 150 tokens. Computed in bfloat16 (2^-8 a
# rounding) the reference reads ~1e-2. 5e-5 lies between, with more than
# an order of magnitude of room on each side.
LOGITS_REL = 5e-5


def _tiny_state(seed: int, cfg=TINY):
    """The zoo's draw with the norms, A_log, D, dt_bias and the
    convolution's bias drawn too (their draws are constants), so that each
    takes part."""
    state = G.init(tf.key(seed), cfg)
    gen = torch.Generator().manual_seed(seed)
    for k, v in state.items():
        if v.dim() == 1:
            state[k] = v + 0.3 * torch.randn(v.shape, generator=gen)
    return state


def _ids(seed: int, shape=(2, 150), vocab=TINY["vocab_size"]):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logits_match_the_reference(seed):
    """The port's forward against the reference's on the same state dict
    (150 tokens: SSD over five chunks); the reference in bfloat16 fails
    the same tolerance."""
    state, ids = _tiny_state(seed), _ids(seed)
    want = R.forward(state, ids, TINY)
    got = G.apply(state, ids, TINY)
    assert got.shape == (2, 150, TINY["vocab_size"])
    assert _rel(got, want) <= LOGITS_REL
    low = R.forward(state, ids, TINY, dtype=torch.bfloat16).float()
    assert _rel(low, want) > LOGITS_REL


def _ssd_inputs(seed, b=2, T=37, H=3, P=5, N=4):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen)
    dt = F.softplus(rand(b, T, H))
    A = -torch.rand(H, generator=gen) * 2
    return rand(b, T, H, P), dt, A, rand(b, T, N), rand(b, T, N)


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_chunkwise_ssd_is_the_recurrence(chunk):
    """ssd over chunks of 1, 8 (37 tokens: a short last chunk) and 64 (one
    chunk), from a nonzero state, against the token-by-token recurrence:
    the outputs and the final state."""
    x, dt, A, B, C = _ssd_inputs(7)
    s0 = torch.randn(2, 3, 5, 4, generator=torch.Generator().manual_seed(8))
    want, want_s = R.ssd_recurrence(x, dt, A, B, C, s0)
    got, got_s = G.ssd(x, dt, A, B, C, s0, chunk=chunk)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((got_s - want_s).abs().max()) <= 1e-5 * float(
        want_s.abs().max())


@pytest.mark.parametrize("impl", ["reference", "port"])
def test_ssd_hand_check(impl):
    """A = 0 keeps every write: S_t = sum_{s<=t} dt_s x_s B_s^T, so with one
    state dimension, B = C = 1 and dt = 1, y_t is the running sum of x."""
    x = torch.randn(1, 20, 2, 3, generator=torch.Generator().manual_seed(1))
    ones = torch.ones(1, 20, 1)
    args = (x, torch.ones(1, 20, 2), torch.zeros(2), ones, ones)
    y, _ = (R.ssd_recurrence(*args) if impl == "reference"
            else G.ssd(*args, chunk=8))
    torch.testing.assert_close(y, x.cumsum(1), atol=1e-5, rtol=0)


def test_expert_shares_add_up_to_the_whole_layer():
    """Experts 0-5 on one chip and 6-11 on another, each routing over all
    12 by the softmax of the top-3 logits: their outputs, with the shared
    expert counted once, add up to the uncut reference layer holding all
    12."""
    whole = dict(TINY, num_local_experts=12, router_experts=12)
    state = _tiny_state(5, whole)
    x = torch.randn(2, 40, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(5))
    layer = 1
    e = f"model.layers.{layer}.block_sparse_moe"
    shares = []
    for first in (0, 6):
        cfg = dict(TINY, first_expert=first)
        part = {k: v for k, v in state.items()
                if k in {n for n, _ in R.layout(cfg)}}
        for n in ("input_linear", "output_linear"):
            part[f"{e}.{n}.weight"] = state[f"{e}.{n}.weight"][first:first + 6]
        shares.append(G.experts(part, layer, x, cfg))
    s = f"model.layers.{layer}.shared_mlp."
    shared = R.glu_mlp(state[s + "input_linear.weight"],
                       state[s + "output_linear.weight"], x)
    want = R.moe_layer(state, layer, x, whole)
    got = shares[0] + shares[1] - shared
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # Each share alone is short of the whole by the other's experts.
    assert _rel(shares[0], want) > 1e-2


def test_tied_keys_are_one_storage():
    """The state dict holds the embedding under its key and under
    `lm_head.weight`: one tensor, so a change to one is the other's; the
    reference's `ties` names that pair."""
    state = G.init(tf.key(0), TINY, torch.bfloat16)
    assert R.ties(TINY) == G.TIED == {
        "lm_head.weight": "model.embed_tokens.weight"}
    head, emb = state["lm_head.weight"], state["model.embed_tokens.weight"]
    assert head is emb
    assert head.untyped_storage().data_ptr() == emb.untyped_storage(
        ).data_ptr()
    assert zoo.spec_from_tree("granite_4_0_h_small_shard", state).count == (
        sum(v.numel() for v in state.values()) - head.numel())


@pytest.mark.parametrize("name,cfg,count,keys,positions,attention", [
    ("granite_4_0_h_small", G.GRANITE_H_SMALL, 32_207_337_984, 587,
     32_618_379_776, 4),
    ("granite_4_0_h_small_shard", G.SHARD, 2_955_758_208, 149,
     3_058_518_656, 1),
])
def test_zoo_layout_is_the_reference_layout(name, cfg, count, keys,
                                            positions, attention):
    """On "meta": the count without memory, the tied tensor once; the
    names and shapes in the reference's order; example inputs are ids of
    the held vocabulary."""
    built = zoo.build(name, device="meta")
    assert built.count == count == G.count(cfg)
    assert len(built.params) == keys
    assert len({id(v) for v in built.params.values()}) == keys - 1
    assert sum(v.numel() for v in built.params.values()) == positions
    assert type(built.params) is collections.OrderedDict
    got = [(k, tuple(v.shape)) for k, v in built.params.items()]
    assert got == [(k, tuple(s)) for k, s in R.layout(cfg)]
    assert all(v.is_meta for v in built.params.values())
    assert sum(G.is_attention(cfg, i)
               for i in range(cfg["num_hidden_layers"])) == attention
    (ids,) = zoo.example_inputs(name)
    assert ids.shape == (1, 16) and 0 <= ids.min() <= ids.max() < cfg[
        "vocab_size"]


def test_tiny_layout_dtype_and_the_configuration_file():
    """At the tiny size the layout agrees too and `init` draws in the dtype
    asked for; the benchmark's file is the stage's configuration, holds
    every number of the catalog's config but the three cuts, and its
    layout holds `parameters`, `leaves` and `positions`."""
    state = G.init(tf.key(0), TINY, torch.bfloat16)
    assert [(k, tuple(v.shape)) for k, v in state.items()] == [
        (k, tuple(s)) for k, s in R.layout(TINY)]
    assert {v.dtype for v in state.values()} == {torch.bfloat16}
    c = json.loads((ROOT / "fedbench" / "configs"
                    / "granite-4.0-h-small-shard-2.96b.json").read_text())
    assert R.layout(c) == R.layout(G.SHARD)
    assert c["reduced"] == ["num_hidden_layers", "num_local_experts",
                            "vocab_size"]
    for k, v in G.GRANITE_H_SMALL.items():
        if k not in c["reduced"]:
            assert c[k] == v, k
    assert {k: c[k] for k in c["reduced"]} == {
        k: G.SHARD[k] for k in c["reduced"]}
    sizes = [math.prod(s) for _, s in R.layout(c)]
    tied = math.prod(dict(R.layout(c))["lm_head.weight"])
    assert c["parameters"] == sum(sizes) - tied == G.count(G.SHARD)
    assert c["positions"] == sum(sizes)
    assert c["leaves"] == len(sizes)
    assert c["values"]["dtype"] == "bfloat16"
    assert sum(math.ceil(0.1 * n) for n in sizes) == 305_851_935
    pub = dict(c, **{k: c["published"][k] for k in c["reduced"]})
    assert G.count(pub) == c["published"]["parameters"] == 32_207_337_984


def test_the_two_reference_files_are_one():
    a = (ROOT / "tests" / "granite_hybrid_reference.py").read_bytes()
    b = (ROOT / "fedbench" / "reference" / "granite_hybrid.py").read_bytes()
    assert a == b


# -- the shared model code ---------------------------------------------------

def _parent_route(p, i, x, cfg):
    """deepseek_v2.route before `gate`, verbatim."""
    gate = f"model.layers.{i}.mlp.gate"
    logits = x @ p[f"{gate}.weight"].T
    k = cfg["num_experts_per_tok"]
    if cfg["scoring_func"] == "sigmoid":
        scores = logits.sigmoid()
        _, idx = torch.topk(scores + p[f"{gate}.e_score_correction_bias"],
                            k, dim=-1, sorted=False)
        w = scores.gather(-1, idx)
    else:
        w, idx = torch.topk(logits.softmax(-1), k, dim=-1, sorted=False)
    if cfg["norm_topk_prob"] and k > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg["routed_scaling_factor"], idx


def _parent_moe(p, i, x, cfg):
    """deepseek_v2.moe before `gate`, `stacked` and `shared`, verbatim."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    pre = f"model.layers.{i}.mlp"
    w, idx = _parent_route(p, i, x, cfg)
    out = D._mlp(p, f"{pre}.shared_experts", x)
    for e in D.held_experts(cfg):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = D._mlp(p, f"{pre}.experts.{e}", x[tok]) * w[tok, slot, None]
            out.index_add_(0, tok, y)
    return out.view(shape)


def _parent_causal_conv(w, x):
    """kimi_linear._causal_conv before its bias, verbatim."""
    y = F.conv1d(F.pad(x.transpose(1, 2), (w.shape[-1] - 1, 0)), w,
                 groups=w.shape[0])
    return F.silu(y).transpose(1, 2)


@pytest.mark.parametrize("model", ["deepseek_v2", "kimi_linear"])
def test_shared_code_leaves_deepseek_and_kimi_bit_for_bit(model,
                                                          monkeypatch):
    """DeepSeek-V2-Lite's and Kimi-Linear's logits at tiny widths through
    the functions as they now are and through their earlier bodies
    (patched in): equal bit for bit."""
    if model == "deepseek_v2":
        import test_torch_deepseek_v2 as t
        cfg, mod = t.TINY, D
        state, ids = D.init(tf.key(4), cfg), _ids(4, (2, 40))
    else:
        import test_torch_kimi_linear as t
        cfg, mod = t.TINY, K
        state, ids = t._tiny_state(4), t._ids(4)
    now = mod.apply(state, ids, cfg)
    monkeypatch.setattr(D, "moe", _parent_moe)
    monkeypatch.setattr(K, "moe", _parent_moe)
    monkeypatch.setattr(K, "_causal_conv", _parent_causal_conv)
    before = mod.apply(state, ids, cfg)
    assert torch.equal(now.view(torch.int32), before.view(torch.int32))


# -- the tree through fhe_fedavg ---------------------------------------------

@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    """Helpers of one key pair and one seed, the port's on the CPU, as
    tests/test_torch_tree_average.py makes them."""
    d = str(tmp_path_factory.mktemp("granite"))
    J.CKKS("ckks", 128, 40, cryptodir=d, seed=3).genCryptoContextAndKeyGen()

    def make(cls):
        h = cls("ckks", 128, 40, cryptodir=d, seed=5,
                **({"device": "cpu"} if cls is T.CKKS else {}))
        h.loadCryptoParams()
        return h
    return make


# Narrower still for the rounds on the CPU (9,382 positions): hidden 16,
# one Mamba-2 head of 32 with state 4, 2 query and 1 KV head of 8, 2
# experts of 8 held of 4, vocabulary 32.
MICRO = dict(TINY, hidden_size=16, num_attention_heads=2,
             num_key_value_heads=1, mamba_n_heads=1, mamba_d_head=32,
             mamba_d_state=4, intermediate_size=8, shared_intermediate_size=8,
             num_local_experts=2, router_experts=4, num_experts_per_tok=2,
             vocab_size=32)


@pytest.fixture(scope="module")
def tied_round(helpers):
    """Three clients' tied bfloat16 state dicts at MICRO (stacked 3-d
    expert leaves among them), their fhe_fedavg at rate 0.1, and the
    aliases it counted."""
    trees = [G.init(tf.key(seed), MICRO, torch.bfloat16)
             for seed in (1, 2, 3)]
    TA.aliases.clear()
    got = T.fhe_fedavg(helpers(T.CKKS), trees, WEIGHTS,
                       T.SelectivePolicy(rate=0.1))
    return trees, got, dict(TA.aliases)


def test_tied_tree_equals_the_jax_package(helpers, tied_round):
    """fhe_fedavg of three tied bfloat16 trees with stacked 3-d expert
    leaves at rate 0.1 equals the JAX package's over the same values (as
    float32 numpy, the tied pair two arrays), key for key and bit for
    bit; the tied pair comes back as two keys of their own, each with its
    own encrypted prefix, equal past it."""
    trees, got, _ = tied_round
    assert any(v.dim() == 3 for v in trees[0].values())
    numpy_trees = [collections.OrderedDict(
        (k, v.float().numpy()) for k, v in t.items()) for t in trees]
    want = J.fhe_fedavg(helpers(J.CKKS), numpy_trees, WEIGHTS,
                        J.SelectivePolicy(rate=0.1))
    assert list(got) == list(want) == list(trees[0])
    for k in got:
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      want[k].view(np.int32), err_msg=k)
    head = got["lm_head.weight"].reshape(-1)
    emb = got["model.embed_tokens.weight"].reshape(-1)
    k = math.ceil(0.1 * head.numel())
    assert head.data_ptr() != emb.data_ptr()
    assert torch.equal(head[k:], emb[k:])


def test_aliases_count_the_tied_pair(helpers, tied_round):
    """One count a client under the second key of the pair; untied copies
    of the same values count none."""
    trees, _, aliases = tied_round
    assert aliases == {"lm_head.weight": 3}
    untied = [collections.OrderedDict(t) for t in trees]
    for t in untied:
        t["lm_head.weight"] = t["lm_head.weight"].clone()
    TA.aliases.clear()
    T.fhe_fedavg(helpers(T.CKKS), untied, WEIGHTS,
                 T.SelectivePolicy(rate=0.1))
    assert not TA.aliases


# -- past 2^31 positions -----------------------------------------------------

def test_leaf_plan_offsets_past_two_to_the_31():
    """The plan of the Granite stage's 149 keys (3,058,518,656 positions)
    at rate 0.1, from sizes alone: int64 offsets that end at the totals,
    past 2^31, with the tied tensor's prefix planned under both keys."""
    layout = R.layout(G.SHARD)
    sizes = [math.prod(s) for _, s in layout]
    plan = TA.leaf_plan(sizes, [n for n, _ in layout],
                        T.SelectivePolicy(rate=0.1))
    for a in (plan.enc, plan.plain, plan.out):
        assert a.dtype == np.int64
    assert int(plan.out[-1]) == 3_058_518_656 > 2 ** 31
    assert int(plan.enc[-1]) == 305_851_935
    assert int(plan.plain[-1]) == 3_058_518_656 - 305_851_935
    assert plan.k[0] == plan.k[-1] == math.ceil(0.1 * 25_088 * 4096)
    assert int(plan.out[-2]) == 3_058_518_656 - 25_088 * 4096


def test_host_blocks_are_exact_and_reused():
    """fed/fedavg.py's HostBlocks (page-locking left out here): a block of
    the exact size, handed out again once every tensor on it is freed, and
    not before; `_to_host` takes them above 8 GiB only."""
    registered = []
    blocks = T_fedavg.HostBlocks(lambda a, n: registered.append(n))
    a = blocks.empty((3, 1000), torch.float32)
    a.copy_(torch.arange(3000.).view(3, 1000))
    b = blocks.empty((3, 1000), torch.float32)
    assert registered == [12000, 12000] and b.data_ptr() != a.data_ptr()
    free = blocks.free[12000]
    row, ptr = a[1], a.data_ptr()
    del a
    gc.collect()
    assert not free
    del row
    gc.collect()
    assert [block.ctypes.data for block in free] == [ptr]
    c = blocks.empty((3000,), torch.float32)
    assert c.data_ptr() == ptr and not free and registered == [12000] * 2
    blocks.reserve((5,), torch.float32, 3)
    assert len(blocks.free[20]) == 3 and registered[2:] == [20] * 3
    assert T_fedavg.EXACT_BYTES == 2 ** 33


# -- the benchmark's surface -------------------------------------------------

CELL = "granite4h.selective-bf16-tied"


def tiny_cell(**traffic) -> spec.Cell:
    """granite4h.selective-bf16-tied at the tiny widths, with its metrics;
    one warm-up round, two checked."""
    c = spec.cell(CELL)
    config = copy.deepcopy(c.config)
    config.update({k: TINY[k] for k in (
        "hidden_size", "num_attention_heads", "num_key_value_heads",
        "mamba_n_heads", "mamba_d_head", "mamba_d_state",
        "intermediate_size", "shared_intermediate_size",
        "num_local_experts", "router_experts", "num_experts_per_tok",
        "vocab_size", "num_hidden_layers", "layer_types")})
    config["parameters"] = G.count(config)
    mix = dict(c.traffic, warmup_rounds=1, check_rounds=2, traced_rounds=1)
    mix.update(traffic)
    return spec.Cell(c.name, 1, config, mix, c.end_to_end, c.per_layer)


def _run(cell, sut="program", trace=False):
    return run.run_cell(cell, 2 ** 33 + 37, 0.0, trace, "cpu", sut=sut,
                        t0=time.perf_counter(), log=lambda m: None)


def test_surface_rounds_through_the_program():
    """The tiny cell through the program on the CPU: correct, its span
    metrics read, the tied pair counted a client and round, and every
    leaf of every round cast to float32 on the CPU (the card reads them
    in place)."""
    TA.casts.clear()
    TA.aliases.clear()
    r = _run(tiny_cell(), trace=True)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["format_faults"]["value"] == 0
    assert r["checks"]["avg_rel_err"]["value"] <= 1e-4
    assert {"tree_ms.granite", "encrypted_ms.granite"} <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in (
        "tree_ms.granite", "encrypted_ms.granite"))
    # No kernel on the CPU, so no roofline.
    assert "tree_roofline.granite" not in r["metrics"]
    rounds = TA.aliases["lm_head.weight"]
    assert set(TA.aliases) == {"lm_head.weight"} and rounds % 3 == 0
    # Every key of every client, the tied pair under each of its keys.
    leaves = len(R.layout(tiny_cell().config))
    assert dict(TA.casts) == {"bfloat16": rounds * leaves}


def test_surface_control_is_not_correct():
    """The reference in the helper's place at bfloat16 (the control) is
    not correct; at float32 it is."""
    cell = tiny_cell()
    assert _run(cell, sut="reference-bfloat16")["correct"] is False
    assert _run(cell, sut="reference-float32")["correct"] is True
