"""Plain reference of Kimi-Linear-48B-A3B's forward pass (Kimi Delta
Attention, MLA without rotary embedding, a sigmoid-routed MoE), in plain
torch and float32, written after the Kimi Linear report (arXiv:2510.26692)
for the configuration https://huggingface.co/moonshotai/Kimi-Linear-48B-
A3B-Instruct/blob/main/config.json, under its keys.

It imports nothing of the program. `layout(cfg)` gives the leaves' (name,
shape) in the state dict's order, and `forward(state, ids, cfg)` the
logits over such a state dict; `kda_recurrence` is the gated delta rule
token by token, `kda_layer`, `mla` and `moe_layer` one layer each.

Layers whose 1-based index is in `linear_attn_config.full_attn_layers`
are MLA, the others KDA; layers from `first_k_dense_replace` on (every
`moe_layer_freq`-th) have an MoE feed-forward, the others a dense SwiGLU.
Each layer: h + attention(RMSNorm(h)), then h + ffn(RMSNorm(h)).

KDA, per head (d_k = d_v = `linear_attn_config.head_dim`):
  q, k, v = SiLU(causal depthwise conv (width `short_conv_kernel_size`, no
  bias) of W_{q,k,v} x); q, k L2-normalised per head as
  x / sqrt(sum x^2 + 1e-6), q times d_k^-1/2;
  g_t = -exp(A_log) softplus(W_fb W_fa x_t + dt_bias), alpha_t = exp(g_t);
  beta_t = sigmoid(W_b x_t);
  S_t = (I - beta_t k_t k_t^T) diag(alpha_t) S_{t-1} + beta_t k_t v_t^T,
  S_0 = 0, o_t = S_t^T q_t;
  y_t = W_o(RMSNorm(o_t; o_norm) * sigmoid(W_gb W_ga x_t)).
MLA: no query LoRA, no rotary embedding (the rope part of q and of the
shared key is used as it is), softmax scale (qk_nope + qk_rope)^-1/2.
MoE: s = sigmoid(W_gate x) over the router's experts; the top
`num_experts_per_token` chosen on s + e_score_correction_bias; weights s
over the chosen, divided by their sum (+1e-20) under `moe_renormalize`,
times `routed_scaling_factor`; SwiGLU experts and the shared experts'
SwiGLU of `moe_intermediate_size * num_shared_experts`.

Expert parallelism: `num_experts` counts the experts held here,
`first_expert` the first one's index (default 0), `router_experts` the
router's width (default `num_experts`); a token is routed over all of
them and only the held experts' weighted outputs are added, with the
shared experts, as on one chip of an expert-parallel deployment without
its exchange.

Departures from the published model: no cache, no padding mask, no
dropout, no auxiliary loss, each expert applied to its tokens in a loop,
and `dtype` (float32 by default) for the whole computation. TF32 is turned
off, so that float32 matrix products on a GPU are float32.
"""

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _is_mla(cfg, i):
    return i + 1 in cfg["linear_attn_config"]["full_attn_layers"]


def _is_moe(cfg, i):
    return (i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


def _held(cfg):
    first = cfg.get("first_expert", 0)
    return list(range(first, first + cfg["num_experts"]))


def layout(cfg):
    """[(name, shape), ...] of the state dict, in its order; linear
    weights are (out, in)."""
    h = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    lin = cfg["linear_attn_config"]
    kda_heads, d = lin["num_heads"], lin["head_dim"]
    width = kda_heads * d
    names = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]

    def swiglu(prefix, w):
        for proj, shape in (("gate_proj", (w, h)), ("up_proj", (w, h)),
                            ("down_proj", (h, w))):
            names.append((prefix + proj + ".weight", shape))

    for i in range(cfg["num_hidden_layers"]):
        a = "model.layers.%d.self_attn." % i
        if _is_mla(cfg, i):
            q_dim = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
            names.append((a + "q_proj.weight", (heads * q_dim, h)))
            names.append((a + "kv_a_proj_with_mqa.weight",
                          (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"], h)))
            names.append((a + "kv_a_layernorm.weight",
                          (cfg["kv_lora_rank"],)))
            names.append((a + "kv_b_proj.weight",
                          (heads * (cfg["qk_nope_head_dim"]
                                    + cfg["v_head_dim"]),
                           cfg["kv_lora_rank"])))
            names.append((a + "o_proj.weight",
                          (h, heads * cfg["v_head_dim"])))
        else:
            for n in ("q", "k", "v"):
                names.append((a + n + "_proj.weight", (width, h)))
            for n in ("q", "k", "v"):
                names.append((a + n + "_conv1d.weight",
                              (width, 1, lin["short_conv_kernel_size"])))
            names.append((a + "f_a_proj.weight", (d, h)))
            names.append((a + "f_b_proj.weight", (width, d)))
            names.append((a + "A_log", (1, 1, kda_heads, 1)))
            names.append((a + "dt_bias", (width,)))
            names.append((a + "b_proj.weight", (kda_heads, h)))
            names.append((a + "g_a_proj.weight", (d, h)))
            names.append((a + "g_b_proj.weight", (width, d)))
            names.append((a + "o_norm.weight", (d,)))
            names.append((a + "o_proj.weight", (h, width)))
        m = "model.layers.%d.mlp." % i
        if _is_moe(cfg, i):
            for e in _held(cfg):
                swiglu(m + "experts.%d." % e, cfg["moe_intermediate_size"])
            router = cfg.get("router_experts", cfg["num_experts"])
            names.append((m + "gate.weight", (router, h)))
            names.append((m + "gate.e_score_correction_bias", (router,)))
            swiglu(m + "shared_experts.",
                   cfg["moe_intermediate_size"] * cfg["num_shared_experts"])
        else:
            swiglu(m, cfg["intermediate_size"])
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


def l2_normalize(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def causal_conv(weight, x):
    """y_t = sum_j weight[:, 0, j] * x_{t - W + 1 + j} (zeros before the
    first token); weight (C, 1, W), x (B, T, C)."""
    width = weight.shape[-1]
    T = x.shape[1]
    y = torch.zeros_like(x)
    for j in range(width):
        shift = width - 1 - j
        if shift < T:
            y[:, shift:] = y[:, shift:] + weight[:, 0, j] * x[:, :T - shift]
    return y


def kda_recurrence(q, k, v, alpha, beta, state=None):
    """The gated delta rule token by token. q, k, alpha (B, H, T, d_k), v
    (B, H, T, d_v), beta (B, H, T), state (B, H, d_k, d_v) or None for
    zeros -> (o (B, H, T, d_v), the state after T)."""
    B, H, T, dk = k.shape
    if state is None:
        state = torch.zeros(B, H, dk, v.shape[-1], dtype=v.dtype,
                            device=v.device)
    out = []
    for t in range(T):
        state = alpha[:, :, t, :, None] * state
        kt, vt, bt = k[:, :, t], v[:, :, t], beta[:, :, t, None]
        recalled = (kt[..., None] * state).sum(-2)             # k^T S
        state = state + (bt * kt)[..., None] * (vt - recalled)[..., None, :]
        out.append((q[:, :, t, :, None] * state).sum(-2))      # S^T q
    return torch.stack(out, 2), state


def kda_layer(state, i, x, cfg):
    a = "model.layers.%d.self_attn." % i
    lin = cfg["linear_attn_config"]
    H, d = lin["num_heads"], lin["head_dim"]
    B, T, _ = x.shape

    def heads(y):
        return y.reshape(B, T, H, d).transpose(1, 2)

    q, k, v = (heads(F.silu(causal_conv(state[a + n + "_conv1d.weight"],
                                        F.linear(x, state[a + n +
                                                          "_proj.weight"]))))
               for n in ("q", "k", "v"))
    q = l2_normalize(q) * d ** -0.5
    k = l2_normalize(k)
    f = F.linear(F.linear(x, state[a + "f_a_proj.weight"]),
                 state[a + "f_b_proj.weight"]) + state[a + "dt_bias"]
    g = -torch.exp(state[a + "A_log"]) * F.softplus(f.reshape(B, T, H, d))
    alpha = torch.exp(g).transpose(1, 2)
    beta = torch.sigmoid(F.linear(x, state[a + "b_proj.weight"])
                         ).transpose(1, 2)
    o, _ = kda_recurrence(q, k, v, alpha, beta)
    o = rms_norm(state[a + "o_norm.weight"], o.transpose(1, 2),
                 cfg["rms_norm_eps"])
    gate = F.linear(F.linear(x, state[a + "g_a_proj.weight"]),
                    state[a + "g_b_proj.weight"]).reshape(B, T, H, d)
    o = (o * torch.sigmoid(gate)).reshape(B, T, H * d)
    return F.linear(o, state[a + "o_proj.weight"])


def mla(state, i, x, cfg):
    """Multi-head latent attention without a query LoRA and without a
    rotary embedding."""
    bsz, q_len, _ = x.shape
    a = "model.layers.%d.self_attn." % i
    heads = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v_dim, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = F.linear(x, state[a + "q_proj.weight"])
    q = q.view(bsz, q_len, heads, nope + rope).transpose(1, 2)
    compressed_kv = F.linear(x, state[a + "kv_a_proj_with_mqa.weight"])
    compressed_kv, k_pe = torch.split(compressed_kv, [rank, rope], dim=-1)
    k_pe = k_pe.view(bsz, 1, q_len, rope).expand(bsz, heads, q_len, rope)
    kv = F.linear(rms_norm(state[a + "kv_a_layernorm.weight"], compressed_kv,
                           cfg["rms_norm_eps"]),
                  state[a + "kv_b_proj.weight"])
    kv = kv.view(bsz, q_len, heads, nope + v_dim).transpose(1, 2)
    k_nope, value_states = torch.split(kv, [nope, v_dim], dim=-1)
    key_states = torch.cat([k_nope, k_pe], dim=-1)
    weights = torch.matmul(q, key_states.transpose(2, 3)) * (
        (nope + rope) ** -0.5)
    future = torch.ones(q_len, q_len, dtype=torch.bool,
                        device=x.device).triu(1)
    weights = torch.softmax(weights.masked_fill(future, float("-inf")), -1)
    out = torch.matmul(weights, value_states)
    out = out.transpose(1, 2).reshape(bsz, q_len, heads * v_dim)
    return F.linear(out, state[a + "o_proj.weight"])


def moe_layer(state, i, x, cfg):
    """The MoE layer as held here: the shared experts' output plus, for
    each token, the router's weight times the output of each held expert
    among its chosen experts."""
    m = "model.layers.%d.mlp." % i
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    scores = torch.sigmoid(F.linear(x, state[m + "gate.weight"]))
    _, topk_idx = torch.topk(scores + state[m + "gate.e_score_correction_bias"],
                             k=cfg["num_experts_per_token"], dim=-1)
    topk_weight = scores.gather(1, topk_idx)
    if cfg["num_experts_per_token"] > 1 and cfg["moe_renormalize"]:
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
    for i in range(cfg["num_hidden_layers"]):
        p = "model.layers.%d." % i
        residual = h
        h = rms_norm(state[p + "input_layernorm.weight"], h, eps)
        h = residual + (mla(state, i, h, cfg) if _is_mla(cfg, i)
                        else kda_layer(state, i, h, cfg))
        residual = h
        h = rms_norm(state[p + "post_attention_layernorm.weight"], h, eps)
        if _is_moe(cfg, i):
            h = residual + moe_layer(state, i, h, cfg)
        else:
            h = residual + mlp(state, p + "mlp.", h)
    h = rms_norm(state["model.norm.weight"], h, eps)
    return F.linear(h, state["lm_head.weight"])
