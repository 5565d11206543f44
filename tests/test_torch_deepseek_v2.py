"""DeepSeek-V2-Lite in the port's zoo (fhe_fed_tpu_torch/models/
deepseek_v2.py) against its plain reference (tests/deepseek_v2_reference.py)
at a tiny size on the CPU; its layout at the published config and at one
expert-parallel chip's shard; the expert shares against the whole MoE
layer; selective FedAvg over its state dict; and the benchmark's
`selective` surface through the program, the control and planted faults.
"""

import collections
import copy
import json
import math
import pathlib
import time

import numpy as np
import pytest
import torch

import fhe_fed_tpu_torch as T
from fhe_fed_tpu_torch.fed import fedavg as T_fedavg
from fhe_fed_tpu_torch.models import deepseek_v2 as D
from fhe_fed_tpu_torch.models import zoo
from fhe_fed_tpu_torch.utils import threefry as tf
from fedbench import run, spec

import deepseek_v2_reference as R

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

TINY = dict(D.LITE, hidden_size=64, num_attention_heads=2, kv_lora_rank=16,
            qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
            intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, router_experts=16, first_expert=0,
            num_experts_per_tok=3, vocab_size=256, num_hidden_layers=3)
# Logits relative to their largest magnitude. The port and the reference
# are the same float32 function in other operation orders (fused
# attention, gathered experts): a few ulp an operation over 3 layers read
# 2e-7 to 3e-7 here. Computed in bfloat16 (8 significant bits, 2^-8 a
# rounding) the reference reads 7e-3 to 1e-2. 5e-5 lies between, with
# more than two orders of magnitude of room on each side.
LOGITS_REL = 5e-5


def _tiny_state(seed: int, cfg=TINY):
    return D.init(tf.key(seed), cfg)


def _ids(seed: int, shape=(2, 48), vocab=TINY["vocab_size"]):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logits_match_the_reference(seed):
    """The port's forward against the reference's on the same state dict;
    the reference in bfloat16 fails the same tolerance."""
    state, ids = _tiny_state(seed), _ids(seed)
    want = R.forward(state, ids, TINY)
    got = D.apply(state, ids, TINY)
    assert got.shape == (2, 48, TINY["vocab_size"])
    assert _rel(got, want) <= LOGITS_REL
    low = R.forward(state, ids, TINY, dtype=torch.bfloat16).float()
    assert _rel(low, want) > LOGITS_REL


def test_expert_shares_add_up_to_the_whole_layer():
    """Experts 0-7 on one chip and 8-15 on another, each routing over all
    16: their outputs, with the shared experts counted once, add up to the
    uncut reference layer holding all 16."""
    whole = dict(TINY, n_routed_experts=16, router_experts=16)
    state = _tiny_state(5, whole)
    x = torch.randn(2, 40, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(5))
    layer = 1
    assert D.is_moe(whole, layer)
    shares = []
    for first in (0, 8):
        cfg = dict(TINY, first_expert=first)
        names = {n for n, _ in R.layout(cfg)}
        part = {k: v for k, v in state.items() if k in names}
        assert sum(".experts." in k for k in part) == 2 * 8 * 3
        shares.append(D.moe(part, layer, x, cfg))
    shared = R.mlp(state, f"model.layers.{layer}.mlp.shared_experts.", x)
    want = R.moe_layer(state, layer, x, whole)
    got = shares[0] + shares[1] - shared
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # Each share alone is short of the whole by the other's experts.
    assert _rel(shares[0], want) > 1e-2


@pytest.mark.parametrize("name,cfg,count,leaves", [
    ("deepseek_v2_lite", D.LITE, 15_706_484_224, 5291),
    ("deepseek_v2_lite_shard", D.LITE_SHARD, 535_060_992, 153),
])
def test_zoo_layout_is_the_reference_layout(name, cfg, count, leaves):
    """On "meta": the count without memory, and the HF names and shapes in
    the reference's order; example inputs are ids of the held vocabulary."""
    built = zoo.build(name, device="meta")
    assert built.count == count and len(built.params) == leaves
    assert type(built.params) is collections.OrderedDict
    got = [(k, tuple(v.shape)) for k, v in built.params.items()]
    assert got == [(k, tuple(s)) for k, s in R.layout(cfg)]
    assert all(v.is_meta for v in built.params.values())
    (ids,) = zoo.example_inputs(name)
    assert ids.shape == (1, 16) and 0 <= ids.min() <= ids.max() < cfg[
        "vocab_size"]


def test_tiny_layout_and_the_configuration_file():
    """At the tiny size the layout agrees too; the benchmark's file is the
    shard's configuration, and its layout holds `parameters`."""
    assert [(k, tuple(v.shape)) for k, v in _tiny_state(0).items()] == [
        (k, tuple(s)) for k, s in R.layout(TINY)]
    c = json.loads((ROOT / "fedbench" / "configs"
                    / "deepseek-v2-lite-shard-535m.json").read_text())
    assert R.layout(c) == R.layout(D.LITE_SHARD)
    assert c["parameters"] == sum(math.prod(s) for _, s in R.layout(c))
    assert c["leaves"] == len(R.layout(c))
    assert c["reduced"] == ["num_hidden_layers", "n_routed_experts",
                            "vocab_size"]
    assert sum(math.ceil(0.1 * math.prod(s))
               for _, s in R.layout(c)) == 53_506_181


def test_the_two_reference_files_are_one():
    a = (ROOT / "tests" / "deepseek_v2_reference.py").read_bytes()
    b = (ROOT / "fedbench" / "reference" / "deepseek_v2.py").read_bytes()
    assert a == b


@pytest.fixture(scope="module")
def helper(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dsv2"))
    h = T.CKKS("ckks", 4096, 52, cryptodir=d, seed=4, symmetric=True,
               device="cpu")
    h.genCryptoContextAndKeyGen()
    h.loadCryptoParams()
    return h


def _clients(n=3):
    base = _tiny_state(9)
    gen = torch.Generator().manual_seed(9)
    return [collections.OrderedDict(
        (k, v + 0.01 * torch.randn(v.shape, generator=gen))
        for k, v in base.items()) for _ in range(n)]


def test_fhe_fedavg_at_rate_one_tenth(helper):
    """Selective FedAvg of three tiny state dicts (CPU CKKS): the first
    ceil(0.1 size) of each leaf encrypted, against plain_fedavg."""
    clients, weights = _clients(), [0.5, 0.2, 0.3]
    got = T.fhe_fedavg(helper, clients, weights, T.SelectivePolicy(rate=0.1))
    want = T.plain_fedavg(clients, weights)
    assert list(got) == list(clients[0])
    for k in got:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)
        k_enc = math.ceil(0.1 * got[k].numel())
        # The plaintext remainder is plain_fedavg's bit for bit.
        assert torch.equal(got[k].reshape(-1)[k_enc:],
                           want[k].reshape(-1)[k_enc:])


def test_a_predicate_selects_the_attention_by_name():
    """split_by_policy hands a callable layer_mask each leaf's key path:
    the MLA leaves by name, whole, and nothing else."""
    tree = _clients(1)[0]
    flat, spec_ = T.flatten_params(tree)
    assert spec_[3] == list(tree)
    seen = []

    def mla(i, path):
        seen.append((i, path))
        return ".self_attn." in path
    enc, plain, plan = T_fedavg.split_by_policy(
        flat, spec_, T.SelectivePolicy(layer_mask=mla))
    assert seen == list(enumerate(tree))
    want = np.concatenate([v.reshape(-1).numpy() for k, v in tree.items()
                           if ".self_attn." in k])
    np.testing.assert_array_equal(enc, want)
    assert enc.size + plain.size == flat.size
    assert [k for (k, _), n in zip(plan, tree) if k] == [
        v.numel() for n, v in tree.items() if ".self_attn." in n]
    np.testing.assert_array_equal(
        T_fedavg.merge_by_policy(enc, plain, plan), flat)


def test_paths_of_nested_containers():
    tree = {"b": [np.zeros(2), {"y": np.zeros(1)}], "a": np.zeros(3)}
    _, spec_ = T.flatten_params(tree)
    assert spec_[3] == ["a", "b.0", "b.1.y"]


# -- the benchmark's surface ------------------------------------------------

def _tiny_cell(**traffic) -> spec.Cell:
    """dsv2lite.selective with the tiny widths (3 layers, 8 of 16 experts)
    and its metrics; a pool of 2, one warm-up round, two checked."""
    path = ROOT / "fedbench" / "configs" / "deepseek-v2-lite-shard-535m.json"
    config = json.loads(path.read_text())
    config.update({k: TINY[k] for k in (
        "hidden_size", "num_attention_heads", "kv_lora_rank",
        "qk_rope_head_dim", "qk_nope_head_dim", "v_head_dim",
        "intermediate_size", "moe_intermediate_size", "n_routed_experts",
        "router_experts", "num_experts_per_tok", "vocab_size",
        "num_hidden_layers")})
    config["parameters"] = sum(math.prod(s) for _, s in R.layout(config))
    mix = json.loads((ROOT / "fedbench" / "traffic" / "selective.json"
                      ).read_text())
    mix.update(pool=2, warmup_rounds=1, check_rounds=2, traced_rounds=1)
    mix.update(traffic)
    c = spec.cell("dsv2lite.selective")
    return spec.Cell(c.name, 1, copy.deepcopy(config), mix, c.end_to_end,
                     c.per_layer)


def _run(cell, sut="program", trace=False):
    return run.run_cell(cell, 2 ** 33 + 29, 0.0, trace, "cpu", sut=sut,
                        t0=time.perf_counter(), log=lambda m: None)


def test_surface_rounds_through_the_program():
    cell = _tiny_cell()
    r = _run(cell, trace=True)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["format_faults"]["value"] == 0
    assert r["checks"]["avg_rel_err"]["value"] <= 1e-4
    assert {"tree_ms.selective", "plain_ms.selective",
            "encrypted_ms.selective"} <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in (
        "tree_ms.selective", "plain_ms.selective", "encrypted_ms.selective"))


def test_surface_control_is_not_correct():
    """The reference in the helper's place at bfloat16 (the control) is
    not correct; at float32 it is."""
    cell = _tiny_cell()
    assert _run(cell, sut="reference-bfloat16")["correct"] is False
    assert _run(cell, sut="reference-float32")["correct"] is True


@pytest.mark.parametrize("plant", ["nothing_encrypted", "half_encrypted"])
def test_surface_catches_a_program_that_encrypts_less(plant, monkeypatch):
    """A program that hands the helper's encrypting calls less than the
    configuration's ceil(0.1 size) of every leaf (nothing, or half of it)
    and averages the rest in plaintext: the average is exact, so only the
    count catches it."""
    def fewer(self, size):
        return 0 if plant == "nothing_encrypted" else math.ceil(
            self.rate * size / 2)
    monkeypatch.setattr(T_fedavg.SelectivePolicy, "enc_count", fewer)
    r = _run(_tiny_cell())
    assert r["correct"] is False
    assert r["checks"]["format_faults"]["value"] > 0
    assert r["checks"]["avg_rel_err"]["value"] <= 1e-4
