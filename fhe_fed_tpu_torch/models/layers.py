"""Layer primitives of the model zoo as functions on tensors, the
counterpart of fhe_fed_tpu.models.layers.

A model is an (init, apply) pair over nested dicts and lists of float32
tensors kept in the JAX package's layout: dense weights (in, out),
convolution kernels HWIO, activations NHWC. So a zoo model's parameters
flatten (fed.fedavg.flatten_params) to the JAX package's vector, leaf for
leaf, and a JAX tree carries over unchanged (interop.zoo_model_from_numpy).
The layout is met inside the layers: conv2d hands torch an NCHW view of
the NHWC input and an OIHW view of the HWIO kernel.

Trainable parameters live in `params`, BatchNorm running statistics in a
separate `state` tree, so param_count counts what torch's .parameters()
would. Initialisers draw through utils/threefry.py along the JAX
package's key tree (split and fold_in), on the key's device: uniform
leaves are bit for bit the JAX package's, normal ones within a few ulp.

Numerics follow XLA: "SAME" pads like lax (asymmetric at stride 2 on even
inputs, the extra row and column at the end), BatchNorm is inference mode
with eps 1e-5, LayerNorm uses eps 1e-12, attention masks with -1e9.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..fed.fedavg import tree_leaves
from ..utils import threefry as tf

Params = Any  # nested dicts and lists of tensors


# ---------------------------------------------------------------------------
# Initializers (torch-default parity: U(-1/sqrt(fan_in), 1/sqrt(fan_in)))
# ---------------------------------------------------------------------------

def _uniform(key, shape, bound):
    return tf.uniform(key, shape, -bound, bound)


def dense_init(key, in_dim: int, out_dim: int) -> Params:
    k1, k2 = tf.split(key)
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(k1, (in_dim, out_dim), bound),
            "b": _uniform(k2, (out_dim,), bound)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def conv_init(key, kh: int, kw: int, cin: int, cout: int,
              bias: bool = True) -> Params:
    k1, k2 = tf.split(key)
    bound = 1.0 / math.sqrt(kh * kw * cin)
    p = {"w": _uniform(k1, (kh, kw, cin, cout), bound)}   # HWIO
    if bias:
        p["b"] = _uniform(k2, (cout,), bound)
    return p


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """lax's "SAME" padding of one spatial axis: the output has
    ceil(size / stride) positions, and of the padding needed the smaller
    half goes before, the larger after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, stride: int = 1, padding="SAME",
           groups: int = 1) -> torch.Tensor:
    """x: NHWC. Weight HWIO (I = cin / groups). padding "SAME" or
    "VALID", as lax.conv_general_dilated."""
    w = p["w"]
    if padding == "SAME":
        (t, b), (l, r) = (_same_pads(x.shape[1], w.shape[0], stride),
                          _same_pads(x.shape[2], w.shape[1], stride))
        x = F.pad(x, (0, 0, l, r, t, b))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=stride, groups=groups).permute(0, 2, 3, 1)
    if "b" in p:
        out = out + p["b"]
    return out


def depthwise_conv_init(key, kh: int, kw: int, ch: int,
                        bias: bool = True) -> Params:
    k1, k2 = tf.split(key)
    bound = 1.0 / math.sqrt(kh * kw)
    p = {"w": _uniform(k1, (kh, kw, 1, ch), bound)}       # HWIO, I=1
    if bias:
        p["b"] = _uniform(k2, (ch,), bound)
    return p


def depthwise_conv2d(p: Params, x: torch.Tensor, stride: int = 1,
                     padding="SAME") -> torch.Tensor:
    return conv2d(p, x, stride, padding, groups=x.shape[-1])


def batchnorm_init(ch: int, device) -> tuple[Params, Params]:
    """Returns (params {scale, bias}, state {mean, var})."""
    def full(v):
        return torch.full((ch,), v, dtype=torch.float32, device=device)
    return ({"scale": full(1.0), "bias": full(0.0)},
            {"mean": full(0.0), "var": full(1.0)})


def batchnorm(p: Params, s: Params, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN on the running statistics."""
    inv = torch.rsqrt(s["var"] + eps)
    return (x - s["mean"]) * inv * p["scale"] + p["bias"]


def layernorm_init(dim: int, device) -> Params:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-12
              ) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def embedding_init(key, vocab: int, dim: int) -> Params:
    return {"w": tf.normal(key, (vocab, dim))}


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["w"][ids]


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """"VALID" max pooling of NHWC x (pad with -inf first for "SAME")."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window,
                        stride).permute(0, 2, 3, 1)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    return x.mean((1, 2))


# ---------------------------------------------------------------------------
# LSTM (torch nn.LSTM parity: separate ih/hh weights and both biases)
# ---------------------------------------------------------------------------

def lstm_layer_init(key, in_dim: int, hidden: int) -> Params:
    k = tf.split(key, 4)
    bound = 1.0 / math.sqrt(hidden)
    return {"w_ih": _uniform(k[0], (in_dim, 4 * hidden), bound),
            "w_hh": _uniform(k[1], (hidden, 4 * hidden), bound),
            "b_ih": _uniform(k[2], (4 * hidden,), bound),
            "b_hh": _uniform(k[3], (4 * hidden,), bound)}


def lstm_layer(p: Params, xs: torch.Tensor) -> torch.Tensor:
    """xs: (B, T, in) -> (B, T, hidden); gates in the order i, f, g, o."""
    hidden = p["w_hh"].shape[0]
    h = c = xs.new_zeros((xs.shape[0], hidden))
    hs = []
    for t in range(xs.shape[1]):
        gates = xs[:, t] @ p["w_ih"] + h @ p["w_hh"] + p["b_ih"] + p["b_hh"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1)


# ---------------------------------------------------------------------------
# Multi-head attention (einsum)
# ---------------------------------------------------------------------------

def mha_init(key, dim: int, out_dim: int | None = None) -> Params:
    out_dim = out_dim or dim
    k = tf.split(key, 4)
    return {"q": dense_init(k[0], dim, dim),
            "k": dense_init(k[1], dim, dim),
            "v": dense_init(k[2], dim, dim),
            "o": dense_init(k[3], dim, out_dim)}


def _heads(h: torch.Tensor, num_heads: int) -> torch.Tensor:
    return h.reshape(h.shape[0], h.shape[1], num_heads, -1)


def mha(p: Params, x: torch.Tensor, num_heads: int,
        kv: torch.Tensor | None = None,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, T, D). Self-attention unless kv (B, S, D) is given."""
    kv = x if kv is None else kv
    B, T, D = x.shape
    hd = D // num_heads
    q = _heads(dense(p["q"], x), num_heads)
    k = _heads(dense(p["k"], kv), num_heads)
    v = _heads(dense(p["v"], kv), num_heads)
    logits = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask, logits, -1e9)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", w, v).reshape(B, T, D)
    return dense(p["o"], out)


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
