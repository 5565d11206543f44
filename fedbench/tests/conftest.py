"""Fixtures of the benchmark's tests. Tests that need the card are marked
`cuda` and skip from the `card` fixture where torch sees none."""

import copy
import json

import pytest
import torch

from fedbench import spec

# Several test workers share the CPU: torch's default of a thread per core
# in each would oversubscribe it many times over.
torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# Every cell of BENCHMARK.json: (config, traffic).
CELLS = {"cnn1.66m.cohort": ("cnn-fedavg-1.66m", "cohort"),
         "cnn1.66m.bytes": ("cnn-fedavg-1.66m", "bytes"),
         "bert-base.streamed": ("bert-base-fedavg-110m", "streamed")}


def tiny_cell(name: str, parameters: int = 20000, **traffic) -> spec.Cell:
    """A cell at a size a CPU test holds: its configuration with
    `parameters` values, a pool of 2, one warm-up round, two rounds
    checked, one traced; BENCHMARK.json's metrics of the cell."""
    config_name, mix_name = CELLS[name]
    config = json.loads(
        (spec.HERE / "configs" / f"{config_name}.json").read_text())
    config["parameters"] = parameters
    mix = json.loads((spec.HERE / "traffic" / f"{mix_name}.json").read_text())
    mix.update(pool=2, warmup_rounds=1, check_rounds=2, traced_rounds=1)
    mix.update(traffic)
    c = spec.cell(name)
    return spec.Cell(name, 1, copy.deepcopy(config), mix, c.end_to_end,
                     c.per_layer)
