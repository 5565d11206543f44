"""Granite-4.0-H-Small (Mamba-2 + NoPE-attention hybrid, stacked-expert
MoE), functional, over a state dict: `init(key, cfg, dtype)` and
`apply(params, ids, cfg)` -> logits.

The architecture is Hugging Face transformers' GraniteMoeHybrid at the
configuration https://huggingface.co/ibm-granite/granite-4.0-h-small/
blob/main/config.json (GRANITE_H_SMALL below, under its keys): 40 decoder
layers of hidden size 4,096, of which the four that `layer_types` names
"attention" (0-based 5, 15, 25, 35) are GQA attention and the other 36
Mamba-2 mixers; every layer's feed-forward is an MoE of 72 SwiGLU experts
of 768 (top-10) plus a shared SwiGLU expert of 1,536; the vocabulary of
100,352 tokens is one embedding, tied to the output head.
32,207,337,984 parameters (the tied tensor once) under 587 keys.

Each layer, with RMSNorm eps 1e-5 throughout and the muP multipliers
(`embedding_multiplier` 12, `residual_multiplier` 0.22,
`attention_multiplier` 1/128, `logits_scaling` 16):

    x_0 = 12 E[ids]
    h = x + 0.22 mixer(RMSNorm(x))
    out = h + 0.22 (MoE(RMSNorm(h)) + Shared(RMSNorm(h)))
    logits = RMSNorm(x_L) E^T / 16            (E tied)

Mamba-2 (`mamba.*`; d_inner = expand * hidden = 8,192, H = 128 heads of
P = 64, state N = 128, one group):

    [z | xBC | dt] = W_in x                   8,192 | 8,448 | 128, no bias
    xBC = SiLU(conv_4(xBC) + b_conv) = [x | B | C]   x (H, P), B, C (N,)
    dt_h = softplus(dt_h + dt_bias_h),  A_h = -exp(A_log_h)
    S_t,h = exp(dt_t,h A_h) S_{t-1},h + dt_t,h x_t,h B_t^T    S (P, N), S_0 = 0
    y_t,h = S_t,h C_t + D_h x_t,h
    out = W_out(RMSNorm(y * SiLU(z)) * norm.weight)   over all 8,192

conv_4 is the causal depthwise convolution of width 4 (kimi_linear's,
with its bias); `time_step_limit` is (0, inf), so dt is not clamped.
`ssd` computes the recurrence chunk-wise (`mamba_chunk_size` 256): within
a chunk, with G the running sum of dt A from the chunk's start and S_0 the
state entering it, y_t = e^{G_t} S_0 C_t + sum_{s<=t} e^{G_t - G_s}
(C_t . B_s) dt_s x_s, and the state leaving it e^{G_L} S_0 + sum_s
e^{G_L - G_s} dt_s x_s B_s^T; every exponent is of a sum of dt A <= 0 over
tokens in order.

Attention (`self_attn.*`): q = W_q x (32 heads of 128), k = W_k x and
v = W_v x (8 heads of 128 each), no bias and no rotary embedding
(`position_embedding_type` "nope"); each KV head serves 4 query heads;
causal softmax of q.k * 1/128, then o_proj.

MoE (`block_sparse_moe.*`): the router's logits l = W_r x over all 72
experts; the top 10 by l, weighted by the softmax of those 10 logits,
which is deepseek_v2.route's softmax branch under `norm_topk_prob` and a
scaling of 1 (the same value up to rounding). Expert e is
W_out,e(SiLU(W_in,e[:768] x) * W_in,e[768:] x), its weights slice e of
the stacked `input_linear` (experts, 1,536, 4,096) and `output_linear`
(experts, 4,096, 768); the shared expert (`shared_mlp.*`) is the same
form at 1,536. Through deepseek_v2.moe with `stacked` and `shared`.

`params` is an OrderedDict under GraniteMoeHybrid's names:
`model.embed_tokens.weight`, then per layer `input_layernorm`, the
mixer's leaves (Mamba: `in_proj`, `conv1d.weight`, `conv1d.bias`,
`dt_bias`, `A_log`, `D`, `norm`, `out_proj`; attention: `q_proj`,
`k_proj`, `v_proj`, `o_proj`), `post_attention_layernorm`, the router,
the stacked experts and the shared expert, then `model.norm.weight` and
`lm_head.weight`, which is the same tensor as `model.embed_tokens.weight`
(a tied model's state_dict); linear weights (out, in). The names and
their order follow the transformers module, not a read of the checkpoint
(fedbench/configs/granite-4.0-h-small-shard-2.96b.json lists them under
`assumed`).

Expert parallelism as in deepseek_v2.py: `num_local_experts` counts the
experts held here, `first_expert` the first one's index, `router_experts`
(default `num_local_experts`) the router's width; the layer routes over
all of them and adds the held experts' weighted outputs and the shared
expert. SHARD is one stage of the deployment stated in that file: layers
0-9 (9 Mamba-2, attention at layer 5), experts 0-17 of 72, and the first
25,088 rows of the vocabulary: 2,955,758,208 parameters under 149 keys
(3,058,518,656 positions, the tied tensor under both keys).

Departures from the published model: no cache (the whole sequence at
once, causal), no padding mask, no dropout, no auxiliary router loss, SSD
chunk-wise in place of the Mamba kernels, and the computation in the
parameters' dtype (float32 for the comparisons). Weights are drawn
through utils/threefry.py, a key per leaf, in float32 and then cast to
`dtype`: linear weights, the stacked experts and the embedding
normal(0, 0.02), norms ones, the convolution's weight and bias
U(+-1/sqrt(4)) (Conv1d's default), A_log log(1..H), D ones and dt_bias
ones (the transformers module's initialisation).
"""

from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from ..utils import threefry as tf
from ..utils.spans import traced
from .deepseek_v2 import _rms, moe
from .kimi_linear import _causal_conv

GRANITE_H_SMALL = {
    "attention_multiplier": 0.0078125, "embedding_multiplier": 12,
    "hidden_size": 4096, "intermediate_size": 768,
    "layer_types": ["mamba"] * 5 + ["attention"] + (
        ["mamba"] * 9 + ["attention"]) * 3 + ["mamba"] * 4,
    "logits_scaling": 16, "mamba_chunk_size": 256, "mamba_conv_bias": True,
    "mamba_d_conv": 4, "mamba_d_head": 64, "mamba_d_state": 128,
    "mamba_expand": 2, "mamba_n_groups": 1, "mamba_n_heads": 128,
    "mamba_proj_bias": False, "num_attention_heads": 32,
    "num_experts_per_tok": 10, "num_hidden_layers": 40,
    "num_key_value_heads": 8, "num_local_experts": 72,
    "position_embedding_type": "nope", "residual_multiplier": 0.22,
    "rms_norm_eps": 1e-5, "shared_intermediate_size": 1536,
    "tie_word_embeddings": True, "vocab_size": 100352,
    "initializer_range": 0.02,
}

SHARD = dict(GRANITE_H_SMALL, num_hidden_layers=10, num_local_experts=18,
             router_experts=72, first_expert=0, vocab_size=25088)

TIED = {"lm_head.weight": "model.embed_tokens.weight"}


def is_attention(cfg: dict, i: int) -> bool:
    return cfg["layer_types"][i] == "attention"


def _ds_cfg(cfg: dict) -> dict:
    """This configuration under the keys deepseek_v2's `route` and `moe`
    read: the softmax of the top-k logits."""
    return dict(cfg, n_routed_experts=cfg["num_local_experts"],
                scoring_func="softmax", norm_topk_prob=True,
                routed_scaling_factor=1.0)


def _mamba_widths(cfg: dict) -> tuple[int, int]:
    """(d_inner, the convolution's channels)."""
    inner = cfg["mamba_expand"] * cfg["hidden_size"]
    return inner, inner + 2 * cfg["mamba_n_groups"] * cfg["mamba_d_state"]


def layout(cfg: dict) -> list:
    """(name, shape) of every key, in the state dict's order; the tied
    head is listed under its own key."""
    h = cfg["hidden_size"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = h // heads
    inner, conv = _mamba_widths(cfg)
    H = cfg["mamba_n_heads"]
    held = cfg["num_local_experts"]
    width, shared = cfg["intermediate_size"], cfg["shared_intermediate_size"]
    router = cfg.get("router_experts", held)
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out.append((f"{p}.input_layernorm.weight", (h,)))
        if is_attention(cfg, i):
            a = f"{p}.self_attn"
            out += [(f"{a}.q_proj.weight", (heads * d, h)),
                    (f"{a}.k_proj.weight", (kv * d, h)),
                    (f"{a}.v_proj.weight", (kv * d, h)),
                    (f"{a}.o_proj.weight", (h, heads * d))]
        else:
            m = f"{p}.mamba"
            out += [(f"{m}.in_proj.weight", (inner + conv + H, h)),
                    (f"{m}.conv1d.weight", (conv, 1, cfg["mamba_d_conv"])),
                    (f"{m}.conv1d.bias", (conv,)),
                    (f"{m}.dt_bias", (H,)), (f"{m}.A_log", (H,)),
                    (f"{m}.D", (H,)), (f"{m}.norm.weight", (inner,)),
                    (f"{m}.out_proj.weight", (h, inner))]
        e = f"{p}.block_sparse_moe"
        out += [(f"{p}.post_attention_layernorm.weight", (h,)),
                (f"{e}.router.layer.weight", (router, h)),
                (f"{e}.input_linear.weight", (held, 2 * width, h)),
                (f"{e}.output_linear.weight", (held, h, width)),
                (f"{p}.shared_mlp.input_linear.weight", (2 * shared, h)),
                (f"{p}.shared_mlp.output_linear.weight", (h, shared))]
    return out + [("model.norm.weight", (h,)),
                  ("lm_head.weight", (cfg["vocab_size"], h))]


def _draw(k: torch.Tensor, name: str, shape, cfg: dict) -> torch.Tensor:
    """Key `name`'s initial value in float32 (the module docstring)."""
    if name.endswith("A_log"):
        return torch.arange(1, shape[0] + 1, dtype=torch.float32,
                            device=k.device).log()
    if "conv1d" in name:
        bound = cfg["mamba_d_conv"] ** -0.5
        return tf.uniform(k, shape, -bound, bound)
    if len(shape) == 1:
        return torch.ones(shape, dtype=torch.float32, device=k.device)
    return tf.normal(k, shape) * cfg["initializer_range"]


def init(key: torch.Tensor, cfg: dict,
         dtype: torch.dtype = torch.float32) -> collections.OrderedDict:
    """The state dict, with `lm_head.weight` the same tensor as
    `model.embed_tokens.weight`."""
    leaves = [(n, s) for n, s in layout(cfg) if n not in TIED]
    keys = tf.split(key, len(leaves))
    out = collections.OrderedDict(
        (name, _draw(k, name, shape, cfg).to(dtype))
        for k, (name, shape) in zip(keys, leaves))
    for name, source in TIED.items():
        out[name] = out[source]
    return out


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, state: torch.Tensor | None = None,
        chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 recurrence of the module docstring without the D term,
    chunk-wise. x (b, T, H, P), dt (b, T, H) (after the softplus), A (H,),
    B and C (b, T, N) (one group), state (b, H, P, N) or None for zeros ->
    (y (b, T, H, P), the state after T)."""
    b, T, H, P = x.shape
    S = (x.new_zeros(b, H, P, B.shape[-1]) if state is None else state)
    out = []
    for s in range(0, T, chunk):
        xc, dc = x[:, s:s + chunk], dt[:, s:s + chunk]
        Bc, Cc = B[:, s:s + chunk], C[:, s:s + chunk]
        L = xc.shape[1]
        G = (dc * A).cumsum(1)                                 # (b, L, H)
        below = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        # decay[t, s] = e^{G_t - G_s} for s <= t, else 0.
        decay = torch.where(below[..., None],
                            G[:, :, None] - G[:, None], float("-inf")).exp()
        mix = decay * (Cc @ Bc.transpose(1, 2))[..., None] * dc[:, None]
        y = torch.einsum("btsh,bshp->bthp", mix, xc)
        y = y + G.exp()[..., None] * torch.einsum("btn,bhpn->bthp", Cc, S)
        out.append(y)
        last = G[:, -1]                                        # (b, H)
        w = (last[:, None] - G).exp() * dc                     # (b, L, H)
        S = (last.exp()[..., None, None] * S
             + torch.einsum("blh,blhp,bln->bhpn", w, xc, Bc))
    return torch.cat(out, 1), S


@traced("fhe.model.mamba")
def mamba(p: dict, i: int, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The Mamba-2 mixer of layer i; x (b, T, hidden)."""
    b, T, _ = x.shape
    m = f"model.layers.{i}.mamba"
    H, P, N = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    inner, conv = _mamba_widths(cfg)
    z, xbc, dt = (x @ p[f"{m}.in_proj.weight"].T).split([inner, conv, H], -1)
    xbc = _causal_conv(p[f"{m}.conv1d.weight"], xbc, p[f"{m}.conv1d.bias"])
    xs, B, C = xbc.split([inner, N, N], -1)
    dt = F.softplus(dt + p[f"{m}.dt_bias"])
    xs = xs.view(b, T, H, P)
    y, _ = ssd(xs, dt, -p[f"{m}.A_log"].exp(), B, C,
               chunk=cfg["mamba_chunk_size"])
    y = (y + p[f"{m}.D"][:, None] * xs).reshape(b, T, inner)
    y = _rms(p[f"{m}.norm.weight"], y * F.silu(z), cfg["rms_norm_eps"])
    return y @ p[f"{m}.out_proj.weight"].T


@traced("fhe.model.attention")
def attention(p: dict, i: int, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """GQA without a positional embedding, layer i; x (b, T, hidden)."""
    b, T, h = x.shape
    a = f"model.layers.{i}.self_attn"
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = h // heads

    def proj(name, n):
        y = x @ p[f"{a}.{name}_proj.weight"].T
        return y.view(b, T, n, d).transpose(1, 2)

    q = proj("q", heads)
    k, v = (proj(n, kv).repeat_interleave(heads // kv, 1) for n in "kv")
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       scale=cfg["attention_multiplier"])
    return o.transpose(1, 2).reshape(b, T, heads * d) @ \
        p[f"{a}.o_proj.weight"].T


@traced("fhe.model.moe")
def experts(p: dict, i: int, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The MoE of layer i as held here, plus its shared expert."""
    e = f"model.layers.{i}.block_sparse_moe"
    s = f"model.layers.{i}.shared_mlp"
    return moe(p, i, x, _ds_cfg(cfg), gate=f"{e}.router.layer",
               stacked=(p[f"{e}.input_linear.weight"],
                        p[f"{e}.output_linear.weight"]),
               shared=(p[f"{s}.input_linear.weight"],
                       p[f"{s}.output_linear.weight"]))


def apply(params: dict, ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """ids (b, T) of the held vocabulary -> logits (b, T, vocab_size)."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    ids = torch.as_tensor(ids, device=params["lm_head.weight"].device)
    x = params["model.embed_tokens.weight"][ids] * cfg["embedding_multiplier"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        h = _rms(params[f"{pre}.input_layernorm.weight"], x, eps)
        mixer = attention if is_attention(cfg, i) else mamba
        x = x + r * mixer(params, i, h, cfg)
        h = _rms(params[f"{pre}.post_attention_layernorm.weight"], x, eps)
        x = x + r * experts(params, i, h, cfg)
    x = _rms(params["model.norm.weight"], x, eps)
    return x @ params["lm_head.weight"].T / cfg["logits_scaling"]


def count(cfg: dict) -> int:
    """Parameters under `cfg`, the tied tensor once."""
    return sum(math.prod(s) for n, s in layout(cfg) if n not in TIED)
