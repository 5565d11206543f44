"""Model zoo registry: the reference's 13+ model ladder over parameter
trees, the counterpart of fhe_fed_tpu.models.zoo.

`build(name, seed)` returns a ModelSpec whose `params` (and `state`, the
BatchNorm statistics, where the model has them) are the JAX package's
trees, leaf for leaf, drawn from the same threefry key tree: so
fed.fedavg.flatten_params(spec.params) is the vector the JAX package
encrypts, and a SelectivePolicy's leaf indices mean the same leaves.
Models are built on the card unless `device` says otherwise; on
torch.device("meta") a build costs no memory (shapes and counts only).

Param-count ladder (reference figs/processing.py:11-22 vs ours):

  name        reference    ours
  linear      101          101
  tst         5,609        124,608   (the modern TimeSeriesTransformer)
  mlp         79,510       79,510
  rnn_lstm    822,570      822,570
  cnn_fedavg  1,663,370    1,663,370
  mobilenet   3,315,428    3,315,428
  resnet18    12,556,426   11,689,512 (torchvision's canonical resnet18)
  resnet34    21,797,672   21,797,672
  resnet50    25,557,032   25,557,032
  groupvit    55,726,609   55,726,609
  vit         86,389,248   86,389,248
  bert        109,482,240  109,482,240
  (extra)     gcn 23,063 / lenet 88,648 / tabnet 8,929
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from .. import cuda_lib
from ..utils import threefry as tf
from . import basic, convnets, transformers_zoo, graph_tabular
from .layers import param_count


@dataclasses.dataclass
class ModelSpec:
    name: str
    params: Any
    state: Any                      # BatchNorm running stats or None
    apply: Callable | None
    reference_count: int | None     # published ladder value (None if absent)

    @property
    def count(self) -> int:
        return param_count(self.params)

    def forward(self, *inputs, params=None):
        """apply on `params` (default the spec's own) and, where the model
        has it, the spec's BatchNorm state."""
        params = self.params if params is None else params
        if self.state is None:
            return self.apply(params, *inputs)
        return self.apply(params, self.state, *inputs)


def _stateless(init):
    return lambda key: (init(key), None)


def _resnet(depth):
    return (lambda key: convnets.resnet_init(key, depth),
            functools.partial(convnets.resnet_apply, depth=depth))


# name -> (init(key) -> (params, state), apply, reference_count)
_REGISTRY: dict[str, tuple[Callable, Callable, int | None]] = {
    "linear": (_stateless(basic.linear_init), basic.linear_apply, 101),
    "tst": (_stateless(basic.tst_init), basic.tst_apply, 5609),
    "mlp": (_stateless(basic.mlp_init), basic.mlp_apply, 79510),
    "lenet": (_stateless(basic.lenet_init), basic.lenet_apply, None),
    "rnn_lstm": (_stateless(basic.rnn_lstm_init), basic.rnn_lstm_apply,
                 822570),
    "cnn_fedavg": (_stateless(basic.cnn_fedavg_init),
                   basic.cnn_fedavg_apply, 1663370),
    "mobilenet": (convnets.mobilenet_init, convnets.mobilenet_apply,
                  3315428),
    "resnet18": (*_resnet(18), 12556426),
    "resnet34": (*_resnet(34), 21797672),
    "resnet50": (*_resnet(50), 25557032),
    "groupvit": (_stateless(transformers_zoo.groupvit_init),
                 transformers_zoo.groupvit_apply, 55726609),
    "vit": (_stateless(transformers_zoo.vit_init),
            transformers_zoo.vit_apply, 86389248),
    "bert": (_stateless(transformers_zoo.bert_init),
             transformers_zoo.bert_apply, 109482240),
    "gcn": (_stateless(graph_tabular.gcn_init), graph_tabular.gcn_apply,
            None),
    "tabnet": (graph_tabular.tabnet_init, graph_tabular.tabnet_apply, None),
}

MODEL_NAMES = tuple(_REGISTRY)

# The 12-model figure ladder order (figs/processing.py:11-29).
LADDER = ("linear", "tst", "mlp", "rnn_lstm", "cnn_fedavg", "mobilenet",
          "resnet18", "resnet34", "resnet50", "groupvit", "vit", "bert")


def _registered(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {MODEL_NAMES}")
    return _REGISTRY[name]


def build(name: str, seed: int = 0,
          device: torch.device | str = "cuda") -> ModelSpec:
    init, apply, ref_count = _registered(name)
    params, state = init(tf.key(seed, cuda_lib.device(device)))
    return ModelSpec(name=name, params=params, state=state, apply=apply,
                     reference_count=ref_count)


def spec_from_tree(name: str, params, state=None) -> ModelSpec:
    """A ModelSpec of the zoo model `name` on the given parameter (and
    BatchNorm state) trees."""
    _, apply, ref_count = _registered(name)
    return ModelSpec(name=name, params=params, state=state, apply=apply,
                     reference_count=ref_count)


def example_inputs(name: str, seed: int = 0) -> tuple[np.ndarray, ...]:
    """Forward inputs for `name` as numpy arrays in the JAX layout, at the
    shapes of the JAX package's model tests (tests/test_models.py): MNIST
    28x28, CIFAR 32x32x3, ImageNet 224x224x3 (batch 1 for the four largest
    models), token ids, a 20-node graph (its adjacency already
    normalised), 54 tabular features."""
    rng = np.random.default_rng(seed)

    def img(*shape):
        return rng.random(shape, dtype=np.float32)

    if name == "linear":
        return (np.ones((2, 100), np.float32),)
    if name == "mlp":
        return (np.ones((2, 784), np.float32),)
    if name == "lenet":
        return (img(2, 32, 32, 3),)
    if name == "cnn_fedavg":
        return (img(2, 28, 28),)
    if name == "rnn_lstm":
        return (rng.integers(0, 90, (2, 12)),)
    if name == "tst":
        return img(2, 24, 9), img(2, 8, 9)
    if name in ("mobilenet", "resnet18", "resnet34"):
        return (img(2, 224, 224, 3),)
    if name in ("resnet50", "vit"):
        return (img(1, 224, 224, 3),)
    if name == "bert":
        return (rng.integers(0, 30522, (1, 16)),)
    if name == "groupvit":
        return img(1, 224, 224, 3), rng.integers(1, 49408, (1, 12))
    if name == "gcn":
        x = img(20, 1433)
        a = (rng.random((20, 20)) < 0.2).astype(np.float64) + np.eye(20)
        d = 1.0 / np.sqrt(a.sum(1))
        return x, (a * d[:, None] * d[None, :]).astype(np.float32)
    if name == "tabnet":
        return (img(8, 54),)
    raise KeyError(f"unknown model {name!r}; have {MODEL_NAMES}")
