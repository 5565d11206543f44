"""Plain reference of DeepSeek-V2-Lite's forward pass (MLA + DeepSeekMoE),
in plain torch and float32, written after Hugging Face's
modeling_deepseek.py (DeepseekV2ForCausalLM) for the configuration
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json.

It imports nothing of the program. `layout(cfg)` gives the leaves' (name,
shape) in the HF state dict's order, and `forward(state, ids, cfg)` the
logits over such a state dict; `moe_layer` is one DeepSeekMoE layer.

The configuration is the HF config's keys, with expert parallelism read
so: `n_routed_experts` counts the experts held here, `first_expert` the
index of the first (default 0), and `router_experts` the router's width
(default `n_routed_experts`). A token is routed over all the router's
experts, and only the held experts' weighted outputs are added, with the
shared experts, as on one chip of an expert-parallel deployment without
its exchange.

Departures from modeling_deepseek.py: no KV cache and no padding mask
(causal attention over positions 0..T-1), no dropout, no auxiliary loss,
each expert applied to the tokens routed to it in a loop in place of
`moe_infer`'s sort, and `dtype` (float32 by default) for the whole
computation, where HF casts the router and the attention softmax to
float32. TF32 is turned off, so that float32 matrix products on a GPU are
float32.
"""

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _moe_layer_index(cfg, i):
    return (i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


def _held(cfg):
    first = cfg.get("first_expert", 0)
    return list(range(first, first + cfg["n_routed_experts"]))


def layout(cfg):
    """[(name, shape), ...] of the state dict, in its order; linear
    weights are (out, in)."""
    h = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    q_dim = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    names = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        a = "model.layers.%d.self_attn." % i
        names.append((a + "q_proj.weight", (heads * q_dim, h)))
        names.append((a + "kv_a_proj_with_mqa.weight",
                      (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"], h)))
        names.append((a + "kv_a_layernorm.weight", (cfg["kv_lora_rank"],)))
        names.append((a + "kv_b_proj.weight",
                      (heads * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]),
                       cfg["kv_lora_rank"])))
        names.append((a + "o_proj.weight", (h, heads * cfg["v_head_dim"])))
        m = "model.layers.%d.mlp." % i
        if _moe_layer_index(cfg, i):
            w = cfg["moe_intermediate_size"]
            for e in _held(cfg):
                for proj, shape in (("gate_proj", (w, h)), ("up_proj", (w, h)),
                                    ("down_proj", (h, w))):
                    names.append((m + "experts.%d.%s.weight" % (e, proj),
                                  shape))
            router = cfg.get("router_experts", cfg["n_routed_experts"])
            names.append((m + "gate.weight", (router, h)))
            w = cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
            for proj, shape in (("gate_proj", (w, h)), ("up_proj", (w, h)),
                                ("down_proj", (h, w))):
                names.append((m + "shared_experts.%s.weight" % proj, shape))
        else:
            w = cfg["intermediate_size"]
            for proj, shape in (("gate_proj", (w, h)), ("up_proj", (w, h)),
                                ("down_proj", (h, w))):
                names.append((m + "%s.weight" % proj, shape))
        names.append(("model.layers.%d.input_layernorm.weight" % i, (h,)))
        names.append(("model.layers.%d.post_attention_layernorm.weight" % i,
                      (h,)))
    names.append(("model.norm.weight", (h,)))
    names.append(("lm_head.weight", (cfg["vocab_size"], h)))
    return names


def rms_norm(weight, x, eps):
    variance = x.pow(2).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(variance + eps))


def mlp(state, prefix, x):
    gate = F.linear(x, state[prefix + "gate_proj.weight"])
    up = F.linear(x, state[prefix + "up_proj.weight"])
    return F.linear(F.silu(gate) * up, state[prefix + "down_proj.weight"])


def yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_cos_sin(cfg, seq_len, device, dtype):
    """DeepseekV2YarnRotaryEmbedding's cos and sin caches, (seq_len, dim)."""
    dim = cfg["qk_rope_head_dim"]
    base = cfg["rope_theta"]
    rs = cfg["rope_scaling"]
    factor = rs["factor"]
    freq_extra = 1.0 / (base ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    freq_inter = 1.0 / (factor * base ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    low = math.floor(yarn_find_correction_dim(
        rs["beta_fast"], dim, base, rs["original_max_position_embeddings"]))
    high = math.ceil(yarn_find_correction_dim(
        rs["beta_slow"], dim, base, rs["original_max_position_embeddings"]))
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    t = torch.arange(seq_len, device=device, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    mscale = (yarn_get_mscale(factor, rs["mscale"])
              / yarn_get_mscale(factor, rs["mscale_all_dim"]))
    emb = torch.cat((freqs, freqs), dim=-1)
    return (emb.cos() * mscale).to(dtype), (emb.sin() * mscale).to(dtype)


def rotate_half(x):
    x1 = x[..., : x.shape[-1] // 2]
    x2 = x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    cos = cos[None, None]
    sin = sin[None, None]
    b, h, s, d = q.shape
    q = q.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    b, h, s, d = k.shape
    k = k.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def attention(state, i, x, cfg, cos, sin):
    bsz, q_len, _ = x.shape
    a = "model.layers.%d.self_attn." % i
    heads = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v_dim, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q_head_dim = nope + rope
    q = F.linear(x, state[a + "q_proj.weight"])
    q = q.view(bsz, q_len, heads, q_head_dim).transpose(1, 2)
    q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
    compressed_kv = F.linear(x, state[a + "kv_a_proj_with_mqa.weight"])
    compressed_kv, k_pe = torch.split(compressed_kv, [rank, rope], dim=-1)
    k_pe = k_pe.view(bsz, q_len, 1, rope).transpose(1, 2)
    kv = F.linear(rms_norm(state[a + "kv_a_layernorm.weight"], compressed_kv,
                           cfg["rms_norm_eps"]),
                  state[a + "kv_b_proj.weight"])
    kv = kv.view(bsz, q_len, heads, nope + v_dim).transpose(1, 2)
    k_nope, value_states = torch.split(kv, [nope, v_dim], dim=-1)
    q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
    query_states = torch.cat([q_nope, q_pe], dim=-1)
    key_states = torch.cat([k_nope, k_pe.expand(bsz, heads, q_len, rope)],
                           dim=-1)
    softmax_scale = q_head_dim ** (-0.5)
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        softmax_scale = softmax_scale * m * m
    weights = torch.matmul(query_states, key_states.transpose(2, 3))
    weights = weights * softmax_scale
    future = torch.ones(q_len, q_len, dtype=torch.bool,
                        device=x.device).triu(1)
    weights = weights.masked_fill(future, float("-inf"))
    weights = torch.softmax(weights, dim=-1)
    out = torch.matmul(weights, value_states)
    out = out.transpose(1, 2).reshape(bsz, q_len, heads * v_dim)
    return F.linear(out, state[a + "o_proj.weight"])


def moe_layer(state, i, x, cfg):
    """DeepseekV2MoE as held here: the shared experts' output plus, for
    each token, the router's weight times the output of each held expert
    among its top experts."""
    m = "model.layers.%d.mlp." % i
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    logits = F.linear(x, state[m + "gate.weight"])
    scores = logits.softmax(dim=-1)
    topk_weight, topk_idx = torch.topk(scores, k=cfg["num_experts_per_tok"],
                                       dim=-1, sorted=False)
    if cfg["num_experts_per_tok"] > 1 and cfg["norm_topk_prob"]:
        topk_weight = topk_weight / (topk_weight.sum(-1, keepdim=True)
                                     + 1e-20)
    topk_weight = topk_weight * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in _held(cfg):
        chosen = topk_idx == e                        # (tokens, k)
        rows = chosen.any(-1)
        if not bool(rows.any()):
            continue
        weight = (topk_weight * chosen).sum(-1)       # (tokens,)
        out = mlp(state, m + "experts.%d." % e, x[rows])
        y[rows] = y[rows] + weight[rows, None] * out
    y = y + mlp(state, m + "shared_experts.", x)
    return y.view(shape)


def forward(state, ids, cfg, dtype=torch.float32):
    """Logits (B, T, vocab_size) of ids (B, T), every weight and activation
    in `dtype`."""
    state = {k: v.to(dtype) for k, v in state.items()}
    eps = cfg["rms_norm_eps"]
    ids = torch.as_tensor(ids).to(state["lm_head.weight"].device)
    h = state["model.embed_tokens.weight"][ids]
    cos, sin = yarn_cos_sin(cfg, ids.shape[1], h.device, dtype)
    for i in range(cfg["num_hidden_layers"]):
        p = "model.layers.%d." % i
        residual = h
        h = rms_norm(state[p + "input_layernorm.weight"], h, eps)
        h = residual + attention(state, i, h, cfg, cos, sin)
        residual = h
        h = rms_norm(state[p + "post_attention_layernorm.weight"], h, eps)
        if _moe_layer_index(cfg, i):
            h = residual + moe_layer(state, i, h, cfg)
        else:
            h = residual + mlp(state, p + "mlp.", h)
    h = rms_norm(state["model.norm.weight"], h, eps)
    return F.linear(h, state["lm_head.weight"])
