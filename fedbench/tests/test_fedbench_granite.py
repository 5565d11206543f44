"""The `granite4h.selective-bf16-tied` cell's own pieces at a size the CPU
holds: the surface's bfloat16 pool and its tied views, a program that
skips the encrypting calls, and the tree kernel's byte count."""

import copy
import json
import math
import time

import numpy as np
import pytest
import torch

from fedbench import run, spec, trace as tr
from fedbench.reference import granite_hybrid as model

CELL = "granite4h.selective-bf16-tied"
# The widths of tests/test_torch_granite_hybrid.py's tiny configuration.
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            mamba_n_heads=2, mamba_d_head=64, mamba_d_state=16,
            intermediate_size=32, shared_intermediate_size=48,
            num_local_experts=6, router_experts=12, num_experts_per_tok=3,
            vocab_size=256, num_hidden_layers=3,
            layer_types=["mamba", "attention", "mamba"])


def _parameters(config) -> int:
    ties = model.ties(config)
    return sum(math.prod(s) for n, s in model.layout(config)
               if n not in ties)


def tiny_cell() -> spec.Cell:
    """The cell at the tiny widths; one warm-up round, two rounds
    checked, one traced."""
    c = spec.cell(CELL)
    config = copy.deepcopy(c.config)
    config.update(TINY)
    config["parameters"] = _parameters(config)
    mix = dict(c.traffic, warmup_rounds=1, check_rounds=2, traced_rounds=1)
    return spec.Cell(CELL, 1, config, mix, c.end_to_end, c.per_layer)


def _run(cell, trace=False):
    return run.run_cell(cell, 2 ** 35 + 11, 0.0, trace, "cpu",
                        t0=time.perf_counter(), log=lambda m: None)


def test_prepare_gives_tied_views_of_the_bfloat16_row():
    """Each client's state dict is views of its row of the pool entry
    rounded to bfloat16 once: one storage a row, the layout's names,
    shapes and order, nothing copied; `lm_head.weight` is the same view
    as `model.embed_tokens.weight`, so the row holds the tied tensor
    once."""
    cell = tiny_cell()
    surface = spec.load_file(spec.HERE / "surfaces" / "selective_bf16_tied.py")
    x = torch.randn(3, cell.config["parameters"],
                    generator=torch.Generator().manual_seed(1))
    s = surface.Surface(None, cell.config, [x], "cpu")
    rows, trees = s.inputs[0]
    assert rows.dtype == torch.bfloat16 and torch.equal(rows, x.bfloat16())
    assert s.flat(0) is rows
    layout = [(n, tuple(shape)) for n, shape in model.layout(cell.config)]
    offsets = s.offsets()
    for row, tree in zip(rows, trees):
        assert [(k, tuple(v.shape)) for k, v in tree.items()] == layout
        assert tree["lm_head.weight"] is tree["model.embed_tokens.weight"]
        base = row.untyped_storage().data_ptr()
        for name, leaf in tree.items():
            assert leaf.dtype == torch.bfloat16 and leaf.is_contiguous()
            assert leaf.untyped_storage().data_ptr() == base
            assert leaf.data_ptr() == row.data_ptr() + 2 * offsets[name]
    assert offsets["lm_head.weight"] == 0
    assert s.encrypted == 3 * sum(math.ceil(0.1 * math.prod(shape))
                                  for _, shape in layout)


def test_a_program_that_skips_the_encrypting_calls(monkeypatch):
    """A program whose encrypted part is averaged in plaintext, the
    helper's encrypting calls never made: the average is exact, so only
    the count of encrypted values catches it. The plant takes the
    gathered (K, E) tensor, as the port's helper is given it, or host
    rows."""
    from fhe_fed_tpu_torch.fed import fedavg

    def in_the_clear(scheme, encs, weights, use_bytes):
        if torch.is_tensor(encs):
            return sum(w * e.double() for w, e in zip(weights, encs)).float()
        return sum(w * e.astype(np.float64) for w, e in
                   zip(weights, encs)).astype(np.float32)
    monkeypatch.setattr(fedavg, "_encrypted_part", in_the_clear)
    r = _run(tiny_cell())
    assert r["correct"] is False
    assert r["checks"]["format_faults"]["value"] > 0
    assert r["checks"]["avg_rel_err"]["value"] <= 1e-4


def test_tree_roofline_counts_the_bytes_by_hand():
    """K = 3 clients of bfloat16 leaves at rate 0.1, every key read as the
    kernel reads it (the tied tensor twice): the gather reads 2 and writes
    4 bytes an encrypted value a client, the average reads 2 a plain value
    a client and writes 4, the scatter reads and writes 4 an encrypted
    value; against the `tree_` kernels' time a traced round."""
    config = tiny_cell().config
    sizes = [math.prod(s) for _, s in model.layout(config)]
    assert sum(sizes) > config["parameters"]
    enc = sum(-(-n // 10) for n in sizes)          # ceil(0.1 n)
    plain = sum(sizes) - enc
    want = 3 * enc * 6 + (3 * plain * 2 + plain * 4) + 8 * enc
    read = spec.load_reader("tree_roofline.granite")
    assert read.__globals__["round_bytes"](config) == want
    ev = tr.Event
    device = [
        ev("void (anonymous namespace)::tree_gather_kernel<1>(float*, long "
           "long const*, int, int, long long, long long)", "kernel", 10, 3),
        ev("void (anonymous namespace)::tree_average_kernel<1>(float*, long "
           "long const*, int, int, long long)", "kernel", 20, 12),
        ev("(anonymous namespace)::tree_scatter_kernel(float*, float "
           "const*, long long const*, int, int, long long)", "kernel", 40, 1),
        ev("void at::native::vectorized_elementwise_kernel<4>(int)",
           "kernel", 50, 100),
    ]
    t = tr.Trace(device, [ev(tr.WINDOW, "user_annotation", 0, 200)],
                 (0.0, 200.0), 2)
    r = run.Reading(config, {}, 1.0, 1.0, 2, [1.0], {}, t)
    assert read(r) == pytest.approx(100 * want / 3.35e12 / (16e-6 / 2))
    t.device = device[3:]
    assert read(r) is None
    assert read(run.Reading(config, {}, 1.0, 1.0, 2, [1.0], {})) is None


def test_the_stage_round_bytes():
    """At the Granite stage's own layout: 35.48 GB a round, 10.59 ms at
    3.35 TB/s."""
    config = spec.cell(CELL).config
    got = spec.load_reader("tree_roofline.granite").__globals__[
        "round_bytes"](config)
    assert got == 35_478_817_520
    assert got / 3.35e12 == pytest.approx(10.59e-3, abs=5e-6)


def test_the_cell_is_declared_once_with_its_metrics():
    """One configuration, one cell on one chip, three metrics that move
    round_ms and read only this cell."""
    bench = spec.load_benchmark()
    cells = [w for w in bench["workloads"] if w["name"] == CELL]
    assert len(cells) == 1 and cells[0]["chips"] == 1
    assert cells[0]["traffic"] == "selective-bf16-tied"
    config = json.loads((spec.ROOT / next(
        c["file"] for c in bench["configs"]
        if c["name"] == cells[0]["config"])).read_text())
    assert config["values"]["dtype"] == "bfloat16"
    assert config["parameters"] == _parameters(config)
    names = {m.name for m in spec.cell(CELL).per_layer}
    assert names == {"tree_ms.granite", "encrypted_ms.granite",
                     "tree_roofline.granite"}
