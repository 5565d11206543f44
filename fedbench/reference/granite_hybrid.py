"""Plain reference of Granite-4.0-H-Small's forward pass (Mamba-2 and
NoPE GQA attention mixers, a stacked-expert MoE with a shared expert, the
muP multipliers, a tied embedding), in plain torch and float32, written
after Hugging Face transformers' GraniteMoeHybrid for the configuration
https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/
config.json, under its keys.

It imports nothing of the program. `layout(cfg)` gives the state dict's
(name, shape) in its order, `ties(cfg)` the keys that name another key's
tensor, and `forward(state, ids, cfg)` the logits over such a state dict;
`ssd_recurrence` is the Mamba-2 recurrence token by token, `mamba_mixer`,
`gqa` and `moe_layer` one layer each.

Each layer, RMSNorm eps `rms_norm_eps`:
  h = x + residual_multiplier * mixer(RMSNorm(x)), the mixer Mamba-2 or
  attention by `layer_types`;
  out = h + residual_multiplier * (MoE(RMSNorm(h)) + Shared(RMSNorm(h))).
The embedding is multiplied by `embedding_multiplier`; the logits are
RMSNorm(x) E^T / `logits_scaling` with E the embedding (tied).

Mamba-2, one group: [z | xBC | dt] = in_proj(x); xBC = SiLU(causal
depthwise conv (width `mamba_d_conv`, with bias) of xBC) = [x | B | C];
dt = softplus(dt + dt_bias), A = -exp(A_log); per head h,
S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, S_0 = 0, y_t = S_t C_t + D x_t;
out = out_proj(RMSNorm(y * SiLU(z)) * norm.weight), the norm over all of
d_inner.
Attention: q (num_attention_heads), k and v (num_key_value_heads), heads
of hidden / num_attention_heads, no bias, no rotary embedding; query head
j reads KV head j // (heads / kv heads); causal softmax of q.k *
`attention_multiplier`.
MoE: logits l = router(x) over the router's experts; the top
`num_experts_per_tok` by l, weighted by the softmax over those logits;
expert e: output_linear[e](SiLU(a) * b) with [a | b] = input_linear[e] x;
the shared expert the same form over `shared_mlp`.

Expert parallelism: `num_local_experts` counts the experts held here
(rows of the stacked tensors), `first_expert` the first one's index
(default 0), `router_experts` the router's width (default
`num_local_experts`); a token is routed over all of them and only the
held experts' weighted outputs are added, with the shared expert, as on
one chip of an expert-parallel deployment without its exchange.

Departures from the published model: no cache, no padding mask, no
dropout, no auxiliary loss, each expert applied to its tokens in a loop,
and `dtype` (float32 by default) for the whole computation. TF32 is turned
off, so that float32 matrix products on a GPU are float32.
"""

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _is_attention(cfg, i):
    return cfg["layer_types"][i] == "attention"


def ties(cfg):
    """{key: the key whose tensor it is}."""
    if cfg.get("tie_word_embeddings", True):
        return {"lm_head.weight": "model.embed_tokens.weight"}
    return {}


def layout(cfg):
    """[(name, shape), ...] of the state dict, in its order, tied keys
    included; linear weights are (out, in)."""
    h = cfg["hidden_size"]
    head_dim = h // cfg["num_attention_heads"]
    d_inner = cfg["mamba_expand"] * h
    groups_state = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    conv_dim = d_inner + 2 * groups_state
    n_heads = cfg["mamba_n_heads"]
    held = cfg["num_local_experts"]
    names = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        p = "model.layers.%d." % i
        names.append((p + "input_layernorm.weight", (h,)))
        if _is_attention(cfg, i):
            kv = cfg["num_key_value_heads"] * head_dim
            names.append((p + "self_attn.q_proj.weight",
                          (cfg["num_attention_heads"] * head_dim, h)))
            names.append((p + "self_attn.k_proj.weight", (kv, h)))
            names.append((p + "self_attn.v_proj.weight", (kv, h)))
            names.append((p + "self_attn.o_proj.weight",
                          (h, cfg["num_attention_heads"] * head_dim)))
        else:
            m = p + "mamba."
            names.append((m + "in_proj.weight",
                          (d_inner + conv_dim + n_heads, h)))
            names.append((m + "conv1d.weight",
                          (conv_dim, 1, cfg["mamba_d_conv"])))
            names.append((m + "conv1d.bias", (conv_dim,)))
            names.append((m + "dt_bias", (n_heads,)))
            names.append((m + "A_log", (n_heads,)))
            names.append((m + "D", (n_heads,)))
            names.append((m + "norm.weight", (d_inner,)))
            names.append((m + "out_proj.weight", (h, d_inner)))
        names.append((p + "post_attention_layernorm.weight", (h,)))
        e = p + "block_sparse_moe."
        names.append((e + "router.layer.weight",
                      (cfg.get("router_experts", held), h)))
        names.append((e + "input_linear.weight",
                      (held, 2 * cfg["intermediate_size"], h)))
        names.append((e + "output_linear.weight",
                      (held, h, cfg["intermediate_size"])))
        names.append((p + "shared_mlp.input_linear.weight",
                      (2 * cfg["shared_intermediate_size"], h)))
        names.append((p + "shared_mlp.output_linear.weight",
                      (h, cfg["shared_intermediate_size"])))
    names.append(("model.norm.weight", (h,)))
    names.append(("lm_head.weight", (cfg["vocab_size"], h)))
    return names


def rms_norm(weight, x, eps):
    variance = x.pow(2).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(variance + eps))


def glu_mlp(w_in, w_out, x):
    """output(SiLU(a) * b), [a | b] = input(x)."""
    a, b = F.linear(x, w_in).chunk(2, dim=-1)
    return F.linear(F.silu(a) * b, w_out)


def causal_conv(weight, bias, x):
    """y_t = bias + sum_j weight[:, 0, j] * x_{t - W + 1 + j} (zeros before
    the first token); weight (C, 1, W), x (B, T, C)."""
    width = weight.shape[-1]
    T = x.shape[1]
    y = bias.expand_as(x).clone()
    for j in range(width):
        shift = width - 1 - j
        if shift < T:
            y[:, shift:] = y[:, shift:] + weight[:, 0, j] * x[:, :T - shift]
    return y


def ssd_recurrence(x, dt, A, B, C, state=None):
    """The Mamba-2 recurrence token by token, without the D term. x (b, T,
    H, P), dt (b, T, H), A (H,), B and C (b, T, N), state (b, H, P, N) or
    None for zeros -> (y (b, T, H, P), the state after T)."""
    b, T, H, P = x.shape
    if state is None:
        state = torch.zeros(b, H, P, B.shape[-1], dtype=x.dtype,
                            device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)                         # (b, H)
        write = (dt[:, t, :, None] * x[:, t])[..., None] \
            * B[:, t, None, None, :]                             # (b, H, P, N)
        state = decay[..., None, None] * state + write
        ys.append((state * C[:, t, None, None, :]).sum(-1))     # (b, H, P)
    return torch.stack(ys, 1), state


def mamba_mixer(state, i, x, cfg):
    m = "model.layers.%d.mamba." % i
    bsz, T, h = x.shape
    d_inner = cfg["mamba_expand"] * h
    n_state = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    n_heads, head = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    proj = F.linear(x, state[m + "in_proj.weight"])
    gate = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n_state]
    dt = proj[..., 2 * d_inner + 2 * n_state:]
    xbc = F.silu(causal_conv(state[m + "conv1d.weight"],
                             state[m + "conv1d.bias"], xbc))
    xs = xbc[..., :d_inner].reshape(bsz, T, n_heads, head)
    B = xbc[..., d_inner:d_inner + n_state]
    C = xbc[..., d_inner + n_state:]
    dt = F.softplus(dt + state[m + "dt_bias"])
    A = -torch.exp(state[m + "A_log"])
    y, _ = ssd_recurrence(xs, dt, A, B, C)
    y = y + state[m + "D"][:, None] * xs
    y = y.reshape(bsz, T, d_inner) * F.silu(gate)
    y = rms_norm(state[m + "norm.weight"], y, cfg["rms_norm_eps"])
    return F.linear(y, state[m + "out_proj.weight"])


def gqa(state, i, x, cfg):
    a = "model.layers.%d.self_attn." % i
    bsz, T, h = x.shape
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = h // heads
    q = F.linear(x, state[a + "q_proj.weight"]).view(bsz, T, heads, d)
    k = F.linear(x, state[a + "k_proj.weight"]).view(bsz, T, kv_heads, d)
    v = F.linear(x, state[a + "v_proj.weight"]).view(bsz, T, kv_heads, d)
    group = heads // kv_heads
    kv_of = torch.arange(heads, device=x.device) // group
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)[:, kv_of]
    v = v.transpose(1, 2)[:, kv_of]
    scores = torch.matmul(q, k.transpose(2, 3)) * cfg["attention_multiplier"]
    future = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    scores = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    out = torch.matmul(scores, v).transpose(1, 2).reshape(bsz, T, heads * d)
    return F.linear(out, state[a + "o_proj.weight"])


def moe_layer(state, i, x, cfg):
    """The MoE as held here plus the shared expert: for each token the
    router's weight times the output of each held expert among its
    chosen."""
    e = "model.layers.%d.block_sparse_moe." % i
    s = "model.layers.%d.shared_mlp." % i
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    logits = F.linear(x, state[e + "router.layer.weight"])
    top_logits, top_idx = torch.topk(logits, cfg["num_experts_per_tok"],
                                     dim=-1)
    gates = torch.softmax(top_logits, dim=-1)
    first = cfg.get("first_expert", 0)
    y = torch.zeros_like(x)
    for slot in range(cfg["num_local_experts"]):
        chosen = top_idx == first + slot
        rows = chosen.any(-1)
        if not bool(rows.any()):
            continue
        weight = (gates * chosen).sum(-1)
        out = glu_mlp(state[e + "input_linear.weight"][slot],
                      state[e + "output_linear.weight"][slot], x[rows])
        y[rows] = y[rows] + weight[rows, None] * out
    y = y + glu_mlp(state[s + "input_linear.weight"],
                    state[s + "output_linear.weight"], x)
    return y.view(shape)


def forward(state, ids, cfg, dtype=torch.float32):
    """Logits (B, T, vocab_size) of ids (B, T), every weight and activation
    in `dtype`."""
    state = {k: v.to(dtype) for k, v in state.items()}
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    ids = torch.as_tensor(ids).to(state["lm_head.weight"].device)
    h = state["model.embed_tokens.weight"][ids] * cfg["embedding_multiplier"]
    for i in range(cfg["num_hidden_layers"]):
        p = "model.layers.%d." % i
        residual = h
        h = rms_norm(state[p + "input_layernorm.weight"], h, eps)
        mixed = (gqa(state, i, h, cfg) if _is_attention(cfg, i)
                 else mamba_mixer(state, i, h, cfg))
        h = residual + mixed * r
        residual = h
        h = rms_norm(state[p + "post_attention_layernorm.weight"], h, eps)
        h = residual + moe_layer(state, i, h, cfg) * r
    h = rms_norm(state["model.norm.weight"], h, eps)
    return F.linear(h, state["lm_head.weight"]) / cfg["logits_scaling"]
