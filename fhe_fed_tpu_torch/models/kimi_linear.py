"""Kimi-Linear-48B-A3B (KDA + MLA hybrid, DeepSeek-V3-style MoE),
functional, over a state dict: `init(key, cfg, dtype)` and
`apply(params, ids, cfg)` -> logits.

The architecture is the Kimi Linear report's (arXiv:2510.26692) at the
configuration https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-
Instruct/blob/main/config.json (KIMI_48B below, under its keys): 27
decoder layers of hidden size 2,304. Layers whose 1-based index is in
`linear_attn_config.full_attn_layers` (4, 8, ..., 24, 27; 0-based 3, 7,
11, 15, 19, 23, 26) are MLA, the other 20 Kimi Delta Attention (KDA).
Layer 0's feed-forward is a dense SwiGLU of 9,216; the other 26 are MoE
layers of 256 routed SwiGLU experts of 1,024 (top-8 over a sigmoid) and
one shared expert of 1,024. Each layer is pre-norm RMSNorm (eps 1e-5)
before attention and before the feed-forward, both residual; RMSNorm at
the end and an untied output head over 163,840 tokens.
49,122,681,728 parameters in 20,493 leaves.

KDA, per head h (32 heads, d_k = d_v = 128), for token t:

    q, k, v = SiLU(conv_4(W_{q,k,v} x))        2,304 -> 4,096 each; conv_4
                                               the causal depthwise
                                               convolution of width 4
                                               (`*_conv1d`, no bias)
    q <- q / ||q|| * d_k^-1/2,  k <- k / ||k||  per head
    g_t = -exp(A_log_h) * softplus(W_fb W_fa x_t + dt_bias)   (rank 128)
    alpha_t = exp(g_t),  beta_t = sigmoid(W_b x_t)            (one a head)
    S_t = (I - beta_t k_t k_t^T) diag(alpha_t) S_{t-1} + beta_t k_t v_t^T,
    S_0 = 0,  o_t = S_t^T q_t
    y_t = W_o(RMSNorm_128(o_t; o_norm) * sigmoid(W_gb W_ga x_t)) (rank 128)

`kda` computes the recurrence chunk-wise (CHUNK tokens): within a chunk,
with G the running sum of g from the chunk's start and S_0 the state
entering it, the recurrence is S_t = diag(e^{G_t}) S_0 + sum_{s<=t}
diag(e^{G_t - G_s}) k_s u_s^T for the pseudo-values
u_t = beta_t (v_t - (diag(alpha_t) S_{t-1})^T k_t), which solve the unit
lower-triangular system (I + A) U = diag(beta) (V - (K e^G) S_0), with
A_ts = beta_t sum_c k_tc k_sc e^{G_tc - G_sc} for s < t. Every exponent
is of a sum of g over tokens in order, so none exceeds 0.

MLA is models/deepseek_v2.py's `attention` without a query LoRA and with
no rotary embedding (NoPE: the projections keep `qk_rope_head_dim` 64, so
a query head is 192 wide and `kv_a_proj_with_mqa` gives 576; the rope
parts are used unrotated); the softmax scale is 192^-1/2 (`rope_scaling`
is null). The MoE layer is deepseek_v2.py's `moe` and `route` under
`scoring_func` "sigmoid": s = sigmoid(W_gate x) over all 256 experts, the
top-8 chosen on s + `e_score_correction_bias` (one group, so grouped
top-k is plain top-k), weighted by s / sum of the 8 chosen s, times
`routed_scaling_factor` 2.446; `_ds_cfg` gives those functions this
configuration under the DeepSeek keys they read.

`params` is an OrderedDict: `model.embed_tokens.weight`, per layer the
attention's leaves under `self_attn.` (MLA: deepseek_v2.py's five; KDA:
`q_proj`, `k_proj`, `v_proj`, `q_conv1d`, `k_conv1d`, `v_conv1d`,
`f_a_proj`, `f_b_proj`, `A_log` (1, 1, heads, 1), `dt_bias`, `b_proj`,
`g_a_proj`, `g_b_proj`, `o_norm`, `o_proj`), the feed-forward (`mlp.
{gate,up,down}_proj`, or `mlp.experts.{e}.*`, `mlp.gate.weight`,
`mlp.gate.e_score_correction_bias`, `mlp.shared_experts.*`), the two
layer norms, then `model.norm.weight` and `lm_head.weight`; linear
weights (out, in). These names, the absence of convolution biases and the
correction bias's place follow modeling_deepseek.py and the report, not a
read of the checkpoint (fedbench/configs/kimi-linear-shard-1.30b.json
lists them under `assumed`).

Expert parallelism as in deepseek_v2.py: `num_experts` counts the experts
held here, `first_expert` the first one's index, `router_experts`
(default `num_experts`) the router's width; the layer routes over all of
them and adds the held experts' weighted outputs and the shared expert.
SHARD is one stage of the deployment stated in that file: layers 0-7
(the dense layer and 7 MoE layers; 6 KDA and 2 MLA), experts 0-15 of
256, and the first 20,480 rows of the vocabulary: 1,299,826,624
parameters in 493 leaves.

Departures from the published model: no cache (the whole sequence at
once, causal), no padding mask, no dropout, no auxiliary router loss, the
recurrence chunk-wise in place of the report's kernels, and the
computation in the parameters' dtype (float32 for the comparisons). q and
k are L2-normalised as x * rsqrt(sum x^2 + 1e-6), as the report's
reference kernels do. Weights are drawn through utils/threefry.py, a key
per leaf, in float32 and then cast to `dtype`: linear weights and the
embedding normal(0, 0.02), norms ones, the router U(+-1/sqrt(hidden)),
the correction bias zeros, the convolutions U(+-1/sqrt(4)) (Conv1d's
default), A_log log U(1, 16) and dt_bias softplus^-1 of dt = exp(U(log
1e-3, log 1e-1)) floored at 1e-4, the report's initialisation.
"""

from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from ..utils import threefry as tf
from .deepseek_v2 import _mlp, _rms, attention, held_experts, is_moe, moe

KIMI_48B = {
    "first_k_dense_replace": 1, "hidden_size": 2304,
    "intermediate_size": 9216, "kv_lora_rank": 512,
    "linear_attn_config": {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                       21, 22, 23, 25, 26],
        "num_heads": 32, "short_conv_kernel_size": 4},
    "mla_use_nope": True, "moe_intermediate_size": 1024,
    "moe_layer_freq": 1, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_attention_heads": 32,
    "num_experts": 256, "num_experts_per_token": 8,
    "num_hidden_layers": 27, "num_shared_experts": 1, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-5,
    "rope_scaling": None, "routed_scaling_factor": 2.446,
    "v_head_dim": 128, "vocab_size": 163840, "initializer_range": 0.02,
}

SHARD = dict(KIMI_48B, num_hidden_layers=8, num_experts=16,
             router_experts=256, first_expert=0, vocab_size=20480)

CHUNK = 64
L2_EPS = 1e-6


def is_mla(cfg: dict, i: int) -> bool:
    return i + 1 in cfg["linear_attn_config"]["full_attn_layers"]


def _ds_cfg(cfg: dict) -> dict:
    """This configuration under the keys deepseek_v2's `attention`,
    `route` and `moe` read."""
    return dict(cfg, n_routed_experts=cfg["num_experts"],
                num_experts_per_tok=cfg["num_experts_per_token"],
                norm_topk_prob=cfg["moe_renormalize"],
                scoring_func=cfg["moe_router_activation_func"],
                n_shared_experts=cfg["num_shared_experts"])


def layout(cfg: dict) -> list:
    """(name, shape) of every leaf, in the state dict's order."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    rank, v = cfg["kv_lora_rank"], cfg["v_head_dim"]
    lin = cfg["linear_attn_config"]
    d, width = lin["head_dim"], lin["num_heads"] * lin["head_dim"]
    conv = lin["short_conv_kernel_size"]
    router = cfg.get("router_experts", cfg["num_experts"])

    def mlp(prefix, n):
        return [(f"{prefix}.gate_proj.weight", (n, h)),
                (f"{prefix}.up_proj.weight", (n, h)),
                (f"{prefix}.down_proj.weight", (h, n))]

    expert = cfg["moe_intermediate_size"]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        if is_mla(cfg, i):
            out += [(f"{a}.q_proj.weight", (heads * (nope + rope), h)),
                    (f"{a}.kv_a_proj_with_mqa.weight", (rank + rope, h)),
                    (f"{a}.kv_a_layernorm.weight", (rank,)),
                    (f"{a}.kv_b_proj.weight", (heads * (nope + v), rank)),
                    (f"{a}.o_proj.weight", (h, heads * v))]
        else:
            out += [(f"{a}.{n}_proj.weight", (width, h)) for n in "qkv"]
            out += [(f"{a}.{n}_conv1d.weight", (width, 1, conv))
                    for n in "qkv"]
            out += [(f"{a}.f_a_proj.weight", (d, h)),
                    (f"{a}.f_b_proj.weight", (width, d)),
                    (f"{a}.A_log", (1, 1, lin["num_heads"], 1)),
                    (f"{a}.dt_bias", (width,)),
                    (f"{a}.b_proj.weight", (lin["num_heads"], h)),
                    (f"{a}.g_a_proj.weight", (d, h)),
                    (f"{a}.g_b_proj.weight", (width, d)),
                    (f"{a}.o_norm.weight", (d,)),
                    (f"{a}.o_proj.weight", (h, width))]
        if is_moe(cfg, i):
            for e in held_experts(_ds_cfg(cfg)):
                out += mlp(f"{p}.mlp.experts.{e}", expert)
            out += [(f"{p}.mlp.gate.weight", (router, h)),
                    (f"{p}.mlp.gate.e_score_correction_bias", (router,))]
            out += mlp(f"{p}.mlp.shared_experts",
                       expert * cfg["num_shared_experts"])
        else:
            out += mlp(f"{p}.mlp", cfg["intermediate_size"])
        out += [(f"{p}.input_layernorm.weight", (h,)),
                (f"{p}.post_attention_layernorm.weight", (h,))]
    return out + [("model.norm.weight", (h,)),
                  ("lm_head.weight", (cfg["vocab_size"], h))]


def _draw(k: torch.Tensor, name: str, shape, cfg: dict) -> torch.Tensor:
    """Leaf `name`'s initial value in float32 (the module docstring)."""
    if name.endswith("A_log"):
        return tf.uniform(k, shape, 1.0, 16.0).log()
    if name.endswith("dt_bias"):
        dt = tf.uniform(k, shape, math.log(1e-3), math.log(1e-1)).exp()
        dt = dt.clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    if name.endswith("e_score_correction_bias"):
        return torch.zeros(shape, dtype=torch.float32, device=k.device)
    if len(shape) == 1:
        return torch.ones(shape, dtype=torch.float32, device=k.device)
    if name.endswith("mlp.gate.weight"):
        bound = cfg["hidden_size"] ** -0.5
        return tf.uniform(k, shape, -bound, bound)
    if "_conv1d" in name:
        bound = shape[-1] ** -0.5
        return tf.uniform(k, shape, -bound, bound)
    return tf.normal(k, shape) * cfg["initializer_range"]


def init(key: torch.Tensor, cfg: dict,
         dtype: torch.dtype = torch.float32) -> collections.OrderedDict:
    leaves = layout(cfg)
    keys = tf.split(key, len(leaves))
    return collections.OrderedDict(
        (name, _draw(k, name, shape, cfg).to(dtype))
        for k, (name, shape) in zip(keys, leaves))


def kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        beta: torch.Tensor, state: torch.Tensor | None = None,
        chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """The gated delta rule of the module docstring, chunk-wise. q, k, g
    (B, H, T, d_k), v (B, H, T, d_v), beta (B, H, T), state (B, H, d_k,
    d_v) or None for zeros -> (o (B, H, T, d_v), the state after T)."""
    B, H, T, dk = k.shape
    S = (k.new_zeros(B, H, dk, v.shape[-1]) if state is None else state)
    out = []
    for s in range(0, T, chunk):
        qc, kc, vc, gc = (t[:, :, s:s + chunk] for t in (q, k, v, g))
        bc = beta[:, :, s:s + chunk, None]
        C = kc.shape[2]
        G = gc.cumsum(2)
        below = torch.ones(C, C, dtype=torch.bool, device=k.device).tril()
        # decay[t, s] = e^{G_t - G_s} for s <= t, else 0.
        decay = torch.where(below[..., None],
                            G[:, :, :, None] - G[:, :, None],
                            float("-inf")).exp()
        kk = (kc[:, :, :, None] * kc[:, :, None] * decay).sum(-1)
        qk = (qc[:, :, :, None] * kc[:, :, None] * decay).sum(-1)
        eG = G.exp()
        u = torch.linalg.solve_triangular(
            (bc * kk).tril(-1), bc * (vc - (kc * eG) @ S), upper=False,
            unitriangular=True)
        out.append((qc * eG) @ S + qk @ u)
        last = G[:, :, -1:]
        S = (last.transpose(2, 3).exp() * S
             + (kc * (last - G).exp()).transpose(2, 3) @ u)
    return torch.cat(out, 2), S


def _causal_conv(w: torch.Tensor, x: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """SiLU of the causal depthwise convolution: w (C, 1, W), x (B, T, C),
    bias (C,) or None -> (B, T, C), y_t = sum_j w_j x_{t - W + 1 + j}
    (+ bias)."""
    y = F.conv1d(F.pad(x.transpose(1, 2), (w.shape[-1] - 1, 0)), w, bias,
                 groups=w.shape[0])
    return F.silu(y).transpose(1, 2)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def kda_layer(p: dict, i: int, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Kimi Delta Attention of layer i; x (B, T, hidden)."""
    B, T, _ = x.shape
    a = f"model.layers.{i}.self_attn"
    lin = cfg["linear_attn_config"]
    H, d = lin["num_heads"], lin["head_dim"]

    def proj(name, y):
        return y @ p[f"{a}.{name}.weight"].T

    def heads(y):                     # (B, T, H * d) -> (B, H, T, d)
        return y.view(B, T, H, -1).transpose(1, 2)

    q, k, v = (heads(_causal_conv(p[f"{a}.{n}_conv1d.weight"],
                                  proj(f"{n}_proj", x))) for n in "qkv")
    q, k = _l2(q) * d ** -0.5, _l2(k)
    f = proj("f_b_proj", proj("f_a_proj", x)) + p[f"{a}.dt_bias"]
    g = -p[f"{a}.A_log"].exp() * F.softplus(f.view(B, T, H, d))
    beta = proj("b_proj", x).sigmoid().transpose(1, 2)
    o, _ = kda(q, k, v, g.transpose(1, 2), beta)
    gate = proj("g_b_proj", proj("g_a_proj", x)).view(B, T, H, d)
    o = _rms(p[f"{a}.o_norm.weight"], o.transpose(1, 2), cfg["rms_norm_eps"])
    return (o * gate.sigmoid()).reshape(B, T, H * d) @ \
        p[f"{a}.o_proj.weight"].T


def apply(params: dict, ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """ids (B, T) of the held vocabulary -> logits (B, T, vocab_size)."""
    eps = cfg["rms_norm_eps"]
    dcfg = _ds_cfg(cfg)
    ids = torch.as_tensor(ids, device=params["lm_head.weight"].device)
    x = params["model.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        h = _rms(params[f"{pre}.input_layernorm.weight"], x, eps)
        x = x + (attention(params, i, h, dcfg, None) if is_mla(cfg, i)
                 else kda_layer(params, i, h, cfg))
        h = _rms(params[f"{pre}.post_attention_layernorm.weight"], x, eps)
        x = x + (moe(params, i, h, dcfg) if is_moe(cfg, i)
                 else _mlp(params, f"{pre}.mlp", h))
    x = _rms(params["model.norm.weight"], x, eps)
    return x @ params["lm_head.weight"].T
