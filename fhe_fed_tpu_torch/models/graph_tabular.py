"""GCN (Cora-style) and TabNet, the counterpart of
fhe_fed_tpu.models.graph_tabular.

Reference parity:
  gcn     2-layer GCNConv 1433-16-7 over a normalized adjacency
          (reference code/benchmark_gcn.py:50-72).
  tabnet  pytorch-tabnet architecture: shared+independent GLU feature
          transformers, sparsemax attentive transformer, n_d=n_a=8,
          n_steps=3 (reference model_helper.py:494-597, 599-788).

BatchNorms run in inference mode off running stats kept in `state`.
"""

from __future__ import annotations

import torch

from . import layers as L
from ..utils import threefry as tf


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def gcn_init(key, nfeat: int = 1433, nhid: int = 16, nclass: int = 7):
    k1, k2 = tf.split(key)
    return {"conv1": L.dense_init(k1, nfeat, nhid),
            "conv2": L.dense_init(k2, nhid, nclass)}


def gcn_apply(p, x, adj):
    """x: (N, F) node features, adj: (N, N) normalized adjacency
    D^-1/2 (A+I) D^-1/2 (dense)."""
    h = torch.relu(adj @ L.dense(p["conv1"], x))
    return torch.log_softmax(adj @ L.dense(p["conv2"], h), dim=-1)


def normalize_adjacency(a: torch.Tensor) -> torch.Tensor:
    a = a + torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    d_inv_sqrt = torch.rsqrt(torch.clamp_min(a.sum(1), 1e-12))
    return a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]


# ---------------------------------------------------------------------------
# TabNet
# ---------------------------------------------------------------------------

def sparsemax(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sparsemax (Martins & Astudillo 2016): Euclidean projection onto the
    simplex, in the sort-based form."""
    z_sorted = torch.sort(z, dim=dim, descending=True).values
    shape = [1] * z.dim()
    shape[dim] = -1
    k = torch.arange(1, z.shape[dim] + 1, dtype=z.dtype,
                     device=z.device).reshape(shape)
    z_cum = torch.cumsum(z_sorted, dim=dim) - 1.0
    k_max = (k * z_sorted > z_cum).to(z.dtype).sum(dim, keepdim=True)
    tau = torch.gather(z_cum, dim, k_max.long() - 1) / k_max
    return torch.clamp_min(z - tau, 0.0)


def _glu_layer_init(key, in_dim, out_dim):
    # float32 scalars as jnp computes them; each divisor a tensor (a CUDA
    # division by a Python scalar multiplies by its reciprocal)
    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=key.device)
    gain = torch.sqrt(f32(4 * (2 * out_dim) / (in_dim + 2 * out_dim)))
    w = tf.normal(key, (in_dim, 2 * out_dim)) * gain / torch.sqrt(f32(in_dim))
    bn_p, bn_s = L.batchnorm_init(2 * out_dim, key.device)
    return {"fc": {"w": w}, "bn": bn_p}, {"bn": bn_s}


def _glu_layer_apply(p, s, x):
    h = L.batchnorm(p["bn"], s["bn"], x @ p["fc"]["w"])
    out_dim = h.shape[-1] // 2
    return h[..., :out_dim] * torch.sigmoid(h[..., out_dim:])


_SQRT_HALF = 0.7071067811865476


def _feat_transformer_init(key, in_dim, out_dim, n_shared=2, n_independent=2):
    ks = tf.split(key, n_shared + n_independent)
    shared, shared_s = [], []
    d = in_dim
    for i in range(n_shared):
        p, s = _glu_layer_init(ks[i], d, out_dim)
        shared.append(p)
        shared_s.append(s)
        d = out_dim
    indep, indep_s = [], []
    for i in range(n_independent):
        p, s = _glu_layer_init(ks[n_shared + i], d, out_dim)
        indep.append(p)
        indep_s.append(s)
        d = out_dim
    return ({"shared": shared, "indep": indep},
            {"shared": shared_s, "indep": indep_s})


def _feat_transformer_apply(p, s, x, shared_params, shared_state):
    h = None
    for lp, ls in zip(shared_params, shared_state):
        g = _glu_layer_apply(lp, ls, x if h is None else h)
        h = g if h is None else (h + g) * _SQRT_HALF
    for lp, ls in zip(p["indep"], s["indep"]):
        h = (h + _glu_layer_apply(lp, ls, h)) * _SQRT_HALF
    return h


def tabnet_init(key, input_dim: int = 54, output_dim: int = 7,
                n_d: int = 8, n_a: int = 8, n_steps: int = 3):
    """Forest-cover-type defaults (54 features, 7 classes)."""
    ks = tf.split(key, 3 + 2 * n_steps)
    bn0_p, bn0_s = L.batchnorm_init(input_dim, key.device)
    shared_p, shared_s = _feat_transformer_init(
        ks[0], input_dim, n_d + n_a, n_shared=2, n_independent=0)
    init_p, init_s = _feat_transformer_init(
        ks[1], n_d + n_a, n_d + n_a, n_shared=0, n_independent=2)
    params = {"bn0": bn0_p, "shared": shared_p["shared"],
              "initial": init_p, "steps": [], "final": None}
    state = {"bn0": bn0_s, "shared": shared_s["shared"],
             "initial": init_s, "steps": []}
    for i in range(n_steps):
        ft_p, ft_s = _feat_transformer_init(
            ks[2 + 2 * i], n_d + n_a, n_d + n_a, n_shared=0, n_independent=2)
        att_fc = L.dense_init(ks[3 + 2 * i], n_a, input_dim)
        att_bn_p, att_bn_s = L.batchnorm_init(input_dim, key.device)
        params["steps"].append({"ft": ft_p, "att_fc": att_fc,
                                "att_bn": att_bn_p})
        state["steps"].append({"ft": ft_s, "att_bn": att_bn_s})
    params["final"] = L.dense_init(ks[-1], n_d, output_dim)
    return params, state


def tabnet_apply(params, state, x, n_d: int = 8, gamma: float = 1.3):
    """x: (B, input_dim) -> logits (B, output_dim)."""
    x = L.batchnorm(params["bn0"], state["bn0"], x)
    prior = torch.ones_like(x)
    shared_p, shared_s = params["shared"], state["shared"]
    h = _feat_transformer_apply(params["initial"], state["initial"], x,
                                shared_p, shared_s)
    a = h[..., n_d:]
    out_agg = 0.0
    for sp, ss in zip(params["steps"], state["steps"]):
        logits = L.batchnorm(sp["att_bn"], ss["att_bn"],
                             L.dense(sp["att_fc"], a))
        mask = sparsemax(logits * prior)
        prior = prior * (gamma - mask)
        h = _feat_transformer_apply(sp["ft"], ss["ft"], mask * x,
                                    shared_p, shared_s)
        out_agg = out_agg + torch.relu(h[..., :n_d])
        a = h[..., n_d:]
    return L.dense(params["final"], out_agg)
