"""DeepSeek-V2-Lite (MLA + DeepSeekMoE), functional, over a Hugging Face
state dict: `init(key, cfg)` and `apply(params, ids, cfg)` -> logits.

The architecture is modeling_deepseek.py's DeepseekV2ForCausalLM at the
configuration https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/
main/config.json (LITE below): 27 decoder layers of hidden size 2,048,
the first with a dense SwiGLU MLP of 10,944, the other 26 DeepSeekMoE
layers (64 routed experts of 1,408, greedy top-6 over a softmax,
`norm_topk_prob` false, two shared experts as one MLP of 2,816); multi-
head latent attention without a query LoRA (kv_lora_rank 512, 16 heads of
qk_nope 128 + qk_rope 64, v 128) under yarn RoPE (factor 40, mscale
0.707, so the softmax scale is q_head_dim^-0.5 * mscale^2); RMSNorm
(eps 1e-6) before attention, before the MLP, on the latent and at the
end; an untied output head. 15,706,484,224 parameters.

`params` is an OrderedDict under the HF key names in the HF module order
(`model.embed_tokens.weight`, per layer `self_attn.{q_proj,
kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj, o_proj}`, the MLP or
`mlp.experts.{e}.*`, `mlp.gate.weight`, `mlp.shared_experts.*`, the two
layer norms, then `model.norm.weight`, `lm_head.weight`), linear weights
(out, in): so fed.fedavg.flatten_params orders the leaves as a user's
checkpoint does, and a SelectivePolicy's predicate sees those names.

`route` and `moe` also serve models/granite_hybrid.py, whose router
reads another key (`gate`) and whose experts are slices of stacked
tensors with a fused input projection (`stacked`, `shared`).
`attention`, `route` and `moe` also serve models/kimi_linear.py: with
`rope` None the attention applies no rotary embedding (NoPE, with the
rope part of q and k kept), and with `scoring_func` "sigmoid" the router
is DeepSeek-V3's (noaux_tc): sigmoid scores, the top-k chosen on the
scores plus `mlp.gate.e_score_correction_bias`, weighted by the scores
(renormalised under `norm_topk_prob`) times `routed_scaling_factor`.

Expert parallelism: the configuration's `n_routed_experts` counts the
experts held here, `first_expert` the first one's index, and
`router_experts` (default `n_routed_experts`) the router's width. The
MoE layer routes each token over all `router_experts`, and adds only the
weighted outputs of the experts held here, plus the shared experts; the
absent experts' part is left out, as on a chip of an expert-parallel
deployment without its exchange. LITE_SHARD is one chip's share of the
deployment stated in fedbench/configs/deepseek-v2-lite-shard-535m.json:
the dense layer and 4 MoE layers (the rest are further pipeline stages),
experts 0-7 of 64, and the first 12,800 rows of the vocabulary in the
embedding and the head: 535,060,992 parameters in 153 leaves.

Departures from modeling_deepseek.py: no KV cache, no padding mask
(causal attention over positions 0..T-1 only), no dropout, no auxiliary
router loss (training only), no `moe_infer` sort (each held expert
gathers its own tokens), attention through scaled_dot_product_attention
(the same function in another order of operations), and float32
throughout, where the checkpoint is bfloat16 (HF computes the router and
the attention softmax in float32 in any case). Weights are drawn as
HF's `_init_weights` draws them, normal(0, initializer_range 0.02) for
linear layers and the embedding and ones for the norms, and the router as
MoEGate's kaiming-uniform, U(+-1/sqrt(hidden)); through utils/threefry.py
on the key's device, a key per leaf, so a build on "meta" costs no
memory.
"""

from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from ..utils import threefry as tf

LITE = {
    "hidden_size": 2048, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": 6,
    "norm_topk_prob": False, "routed_scaling_factor": 1.0,
    "scoring_func": "softmax", "topk_method": "greedy",
    "num_attention_heads": 16, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "vocab_size": 102400, "initializer_range": 0.02,
}

LITE_SHARD = dict(LITE, num_hidden_layers=5, n_routed_experts=8,
                  router_experts=64, first_expert=0, vocab_size=12800)


def is_moe(cfg: dict, i: int) -> bool:
    return (i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


def held_experts(cfg: dict) -> range:
    first = cfg.get("first_expert", 0)
    return range(first, first + cfg["n_routed_experts"])


def layout(cfg: dict) -> list:
    """(name, shape) of every leaf, in the HF state dict's order."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    rank, v = cfg["kv_lora_rank"], cfg["v_head_dim"]
    router = cfg.get("router_experts", cfg["n_routed_experts"])

    def mlp(prefix, width):
        return [(f"{prefix}.gate_proj.weight", (width, h)),
                (f"{prefix}.up_proj.weight", (width, h)),
                (f"{prefix}.down_proj.weight", (h, width))]

    expert = cfg["moe_intermediate_size"]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        out += [(f"{a}.q_proj.weight", (heads * (nope + rope), h)),
                (f"{a}.kv_a_proj_with_mqa.weight", (rank + rope, h)),
                (f"{a}.kv_a_layernorm.weight", (rank,)),
                (f"{a}.kv_b_proj.weight", (heads * (nope + v), rank)),
                (f"{a}.o_proj.weight", (h, heads * v))]
        if is_moe(cfg, i):
            for e in held_experts(cfg):
                out += mlp(f"{p}.mlp.experts.{e}", expert)
            out.append((f"{p}.mlp.gate.weight", (router, h)))
            out += mlp(f"{p}.mlp.shared_experts",
                       expert * cfg["n_shared_experts"])
        else:
            out += mlp(f"{p}.mlp", cfg["intermediate_size"])
        out += [(f"{p}.input_layernorm.weight", (h,)),
                (f"{p}.post_attention_layernorm.weight", (h,))]
    return out + [("model.norm.weight", (h,)),
                  ("lm_head.weight", (cfg["vocab_size"], h))]


def init(key: torch.Tensor, cfg: dict) -> collections.OrderedDict:
    leaves = layout(cfg)
    keys = tf.split(key, len(leaves))
    std, gate_bound = cfg["initializer_range"], cfg["hidden_size"] ** -0.5
    out = collections.OrderedDict()
    for k, (name, shape) in zip(keys, leaves):
        if len(shape) == 1:
            out[name] = torch.ones(shape, dtype=torch.float32,
                                   device=key.device)
        elif name.endswith("mlp.gate.weight"):
            out[name] = tf.uniform(k, shape, -gate_bound, gate_bound)
        else:
            out[name] = tf.normal(k, shape) * std
    return out


def _rms(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _mlp(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p[f"{prefix}.gate_proj.weight"].T)
    return (g * (x @ p[f"{prefix}.up_proj.weight"].T)) @ \
        p[f"{prefix}.down_proj.weight"].T


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = _yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale *= m * m
    return scale


def rope_tables(cfg: dict, positions: int, device):
    """(cos, sin), each (positions, rope / 2): DeepseekV2YarnRotaryEmbedding's
    cache at the configuration, in float32 as HF computes it."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (rs["factor"] * base ** exps)
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    inv_freq = inter * (1 - keep) + extra * keep
    freqs = torch.outer(torch.arange(positions, dtype=torch.float32,
                                     device=device), inv_freq)
    m = (_yarn_mscale(rs["factor"], rs["mscale"])
         / _yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
    return freqs.cos() * m, freqs.sin() * m


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    """HF's apply_rotary_pos_emb: the interleaved pairs (x[2j], x[2j+1])
    rotated by position, written out halves first (q and k alike, so the
    dot products are unchanged). x: (B, heads, T, rope)."""
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat((a * cos - b * sin, b * cos + a * sin), -1)


def attention(p: dict, i: int, x: torch.Tensor, cfg: dict, rope
              ) -> torch.Tensor:
    """Multi-head latent attention of layer i; x (B, T, hidden). `rope`:
    rope_tables' (cos, sin), or None for no rotary embedding (NoPE)."""
    B, T, _ = x.shape
    pre = f"model.layers.{i}.self_attn"
    heads = cfg["num_attention_heads"]
    nope, rdim = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    rank, vdim = cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = (x @ p[f"{pre}.q_proj.weight"].T).view(B, T, heads, nope + rdim)
    q = q.transpose(1, 2)
    ckv = x @ p[f"{pre}.kv_a_proj_with_mqa.weight"].T
    latent, k_pe = ckv.split([rank, rdim], -1)
    kv = _rms(p[f"{pre}.kv_a_layernorm.weight"], latent, cfg["rms_norm_eps"])
    kv = (kv @ p[f"{pre}.kv_b_proj.weight"].T).view(B, T, heads, nope + vdim)
    k_nope, v = kv.transpose(1, 2).split([nope, vdim], -1)
    k_pe = k_pe.view(B, 1, T, rdim)
    if rope is not None:
        cos, sin = rope
        q_pe = _rotate(q[..., nope:], cos, sin)
        k_pe = _rotate(k_pe, cos, sin)
        q = torch.cat((q[..., :nope], q_pe), -1)
    k = torch.cat((k_nope, k_pe.expand(B, heads, T, rdim)), -1)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         scale=softmax_scale(cfg))
    out = out.transpose(1, 2).reshape(B, T, heads * vdim)
    return out @ p[f"{pre}.o_proj.weight"].T


def route(p: dict, i: int, x: torch.Tensor, cfg: dict,
          gate: str | None = None):
    """MoEGate: (weights, experts), each (tokens, num_experts_per_tok), over
    all the router's experts; x (tokens, hidden). `scoring_func` softmax:
    the top-k of the softmax scores; sigmoid: the top-k of the sigmoid
    scores plus the correction bias, weighted by their scores. `gate`:
    the router's key prefix (default layer i's `mlp.gate`)."""
    gate = f"model.layers.{i}.mlp.gate" if gate is None else gate
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


def _fused_mlp(w_in: torch.Tensor, w_out: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """SwiGLU from a fused input projection: w_in (2 * width, hidden),
    its first half the gate and its second the up projection; w_out
    (hidden, width)."""
    g, u = (x @ w_in.T).chunk(2, -1)
    return (F.silu(g) * u) @ w_out.T


def moe(p: dict, i: int, x: torch.Tensor, cfg: dict, gate: str | None = None,
        stacked: tuple | None = None, shared: tuple | None = None
        ) -> torch.Tensor:
    """The DeepSeekMoE layer i as held here: the shared experts plus the
    weighted outputs of the held experts for the tokens routed to them.
    x (..., hidden). By default the experts are the SwiGLUs under layer
    i's `mlp.experts.{e}` and `mlp.shared_experts`; `stacked`, the held
    experts' (input, output) weights (held, 2 * width, hidden) and (held,
    hidden, width), makes expert e the fused SwiGLU of slices
    e - first_expert, and `shared`, an (input, output) pair, the shared
    expert the fused SwiGLU of it. `gate` is route's."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    pre = f"model.layers.{i}.mlp"
    w, idx = route(p, i, x, cfg, gate)
    out = (_mlp(p, f"{pre}.shared_experts", x) if shared is None
           else _fused_mlp(*shared, x))
    first = cfg.get("first_expert", 0)
    for e in held_experts(cfg):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = (_mlp(p, f"{pre}.experts.{e}", x[tok]) if stacked is None
                 else _fused_mlp(stacked[0][e - first], stacked[1][e - first],
                                 x[tok]))
            out.index_add_(0, tok, y * w[tok, slot, None])
    return out.view(shape)


def apply(params: dict, ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """ids (B, T) of the held vocabulary -> logits (B, T, vocab_size)."""
    eps = cfg["rms_norm_eps"]
    ids = torch.as_tensor(ids, device=params["lm_head.weight"].device)
    x = params["model.embed_tokens.weight"][ids]
    rope = rope_tables(cfg, ids.shape[1], x.device)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        x = x + attention(params, i, _rms(
            params[f"{pre}.input_layernorm.weight"], x, eps), cfg, rope)
        h = _rms(params[f"{pre}.post_attention_layernorm.weight"], x, eps)
        x = x + (moe(params, i, h, cfg) if is_moe(cfg, i)
                 else _mlp(params, f"{pre}.mlp", h))
    x = _rms(params["model.norm.weight"], x, eps)
    return x @ params["lm_head.weight"].T
