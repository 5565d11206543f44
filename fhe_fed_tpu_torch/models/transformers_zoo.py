"""ViT-base, BERT-base and GroupViT (einsum attention), the counterpart of
fhe_fed_tpu.models.transformers_zoo.

Reference parity (code/benchmark.py:400-415: ViTModel(ViTConfig()),
BertModel(BertConfig()), GroupViTModel(GroupViTConfig())), trainable
param counts:

  vit       86,389,248
  bert     109,482,240
  groupvit  55,726,609  (logit_scale + text 22,145,792 + vision 28,837,136
                         + visual_projection 2,633,984 + text_projection
                         2,109,696)

GroupViT's grouping blocks are soft-assignment cross-attention: a softmax
over the group axis, then each group's weights divided by their sum plus
one (assign_eps). GELU is the exact one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers as L
from ..utils import threefry as tf


def _gelu(x):
    return F.gelu(x)


def _zeros(shape, key):
    return torch.zeros(shape, dtype=torch.float32, device=key.device)


# ---------------------------------------------------------------------------
# Transformer encoder block (pre/post-LN switchable)
# ---------------------------------------------------------------------------

def _block_init(key, d, ffn):
    k = tf.split(key, 3)
    return {"attn": L.mha_init(k[0], d),
            "ln1": L.layernorm_init(d, key.device),
            "ln2": L.layernorm_init(d, key.device),
            "fc1": L.dense_init(k[1], d, ffn),
            "fc2": L.dense_init(k[2], ffn, d)}


def _block_apply_preln(p, x, heads, mask=None):
    x = x + L.mha(p["attn"], L.layernorm(p["ln1"], x), heads, mask=mask)
    h = L.layernorm(p["ln2"], x)
    return x + L.dense(p["fc2"], _gelu(L.dense(p["fc1"], h)))


def _block_apply_postln(p, x, heads, mask=None):
    x = L.layernorm(p["ln1"], x + L.mha(p["attn"], x, heads, mask=mask))
    h = L.dense(p["fc2"], _gelu(L.dense(p["fc1"], x)))
    return L.layernorm(p["ln2"], x + h)


# ---------------------------------------------------------------------------
# ViT-base (image 224, patch 16, d=768, 12 layers, heads 12, ffn 3072)
# ---------------------------------------------------------------------------

_VIT_D, _VIT_LAYERS, _VIT_HEADS, _VIT_FFN = 768, 12, 12, 3072
_VIT_PATCH, _VIT_IMG = 16, 224
_VIT_TOKENS = (_VIT_IMG // _VIT_PATCH) ** 2 + 1          # 197


def vit_init(key):
    k = tf.split(key, 3 + _VIT_LAYERS)
    return {
        "cls": _zeros((1, 1, _VIT_D), key),
        "pos": _zeros((1, _VIT_TOKENS, _VIT_D), key),
        "patch": L.conv_init(k[0], _VIT_PATCH, _VIT_PATCH, 3, _VIT_D),
        "blocks": [_block_init(k[2 + i], _VIT_D, _VIT_FFN)
                   for i in range(_VIT_LAYERS)],
        "ln": L.layernorm_init(_VIT_D, key.device),
        "pooler": L.dense_init(k[1], _VIT_D, _VIT_D),
    }


def vit_apply(p, x):
    """x: (B, 224, 224, 3) -> (sequence (B,197,768), pooled (B,768))."""
    B = x.shape[0]
    h = L.conv2d(p["patch"], x, stride=_VIT_PATCH, padding="VALID")
    h = h.reshape(B, -1, _VIT_D)
    h = torch.cat([p["cls"].expand(B, 1, _VIT_D), h], 1) + p["pos"]
    for blk in p["blocks"]:
        h = _block_apply_preln(blk, h, _VIT_HEADS)
    h = L.layernorm(p["ln"], h)
    return h, torch.tanh(L.dense(p["pooler"], h[:, 0]))


# ---------------------------------------------------------------------------
# BERT-base (vocab 30522, d=768, 12 layers, heads 12, ffn 3072)
# ---------------------------------------------------------------------------

_BERT_D, _BERT_LAYERS, _BERT_HEADS, _BERT_FFN = 768, 12, 12, 3072
_BERT_VOCAB, _BERT_POS, _BERT_TYPES = 30522, 512, 2


def bert_init(key):
    k = tf.split(key, 5 + _BERT_LAYERS)
    return {
        "word_emb": L.embedding_init(k[0], _BERT_VOCAB, _BERT_D),
        "pos_emb": L.embedding_init(k[1], _BERT_POS, _BERT_D),
        "type_emb": L.embedding_init(k[2], _BERT_TYPES, _BERT_D),
        "emb_ln": L.layernorm_init(_BERT_D, key.device),
        "blocks": [_block_init(k[4 + i], _BERT_D, _BERT_FFN)
                   for i in range(_BERT_LAYERS)],
        "pooler": L.dense_init(k[3], _BERT_D, _BERT_D),
    }


def bert_apply(p, ids, type_ids=None):
    """ids: (B, T) int -> (sequence (B,T,768), pooled (B,768))."""
    if type_ids is None:
        type_ids = torch.zeros_like(ids)
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    h = (L.embedding(p["word_emb"], ids)
         + L.embedding(p["pos_emb"], pos)
         + L.embedding(p["type_emb"], type_ids))
    h = L.layernorm(p["emb_ln"], h)
    for blk in p["blocks"]:
        h = _block_apply_postln(blk, h, _BERT_HEADS)
    return h, torch.tanh(L.dense(p["pooler"], h[:, 0]))


# ---------------------------------------------------------------------------
# GroupViT (HF GroupViTModel(GroupViTConfig()) structure)
# ---------------------------------------------------------------------------

_GV_VD, _GV_VHEADS, _GV_VFFN = 384, 6, 1536     # vision
_GV_TD, _GV_THEADS, _GV_TFFN = 256, 4, 1024     # text
_GV_TVOCAB, _GV_TPOS, _GV_TLAYERS = 49408, 77, 12
_GV_DEPTHS = (6, 3, 3)
_GV_GROUP_TOKENS = (64, 8, 0)
_GV_OUT_GROUPS = (64, 8, 8)
_GV_PROJ_INTER, _GV_PROJ = 4096, 256


def _gv_cross_attn_init(key, d, ffn):
    """GroupViTCrossAttentionLayer: attn + norm2 + mlp + norm_post."""
    k = tf.split(key, 3)
    return {"attn": L.mha_init(k[0], d),
            "norm2": L.layernorm_init(d, key.device),
            "fc1": L.dense_init(k[1], d, ffn),
            "fc2": L.dense_init(k[2], ffn, d),
            "norm_post": L.layernorm_init(d, key.device)}


def _gv_cross_attn_apply(p, q, kv, heads):
    x = q + L.mha(p["attn"], q, heads, kv=kv)
    x = x + L.dense(p["fc2"], _gelu(L.dense(p["fc1"],
                                            L.layernorm(p["norm2"], x))))
    return L.layernorm(p["norm_post"], x)


def _gv_downsample_init(key, d, ffn, n_in_tokens, n_out, mixer_hidden):
    """GroupViTTokenAssign (grouping block)."""
    k = tf.split(key, 4)
    dev = key.device
    return {
        "norm_tokens": L.layernorm_init(d, dev),
        "mlp_inter": {"fc1": L.dense_init(k[0], n_in_tokens, mixer_hidden),
                      "fc2": L.dense_init(k[1], mixer_hidden, n_out)},
        "norm_post_tokens": L.layernorm_init(d, dev),
        "norm_x": L.layernorm_init(d, dev),
        "pre_assign_attn": _gv_cross_attn_init(k[2], d, ffn),
        "assign": L.mha_init(tf.fold_in(k[3], 0), d),
        "norm_new_x": L.layernorm_init(d, dev),
        "mlp_channels": {"fc1": L.dense_init(tf.fold_in(k[3], 1), d, ffn),
                         "fc2": L.dense_init(tf.fold_in(k[3], 2), ffn, d)},
    }


def _gv_assign_attn(p, q, kv, heads):
    """Assignment attention, soft (inference) assignment: a softmax over
    the groups (the query axis), so each image token picks a group."""
    B, S, D = kv.shape
    hd = D // heads
    qq = L.dense(p["q"], q).reshape(B, -1, heads, hd)
    kk = L.dense(p["k"], kv).reshape(B, S, heads, hd)
    vv = L.dense(p["v"], kv).reshape(B, S, heads, hd)
    logits = torch.einsum("bthd,bshd->bhts", qq, kk) / math.sqrt(hd)
    attn = torch.softmax(logits, dim=-2)
    attn = attn / (attn.sum(dim=-1, keepdim=True) + 1.0)   # assign_eps
    out = torch.einsum("bhts,bshd->bthd", attn, vv).reshape(B, -1, D)
    return L.dense(p["o"], out)


def _gv_downsample_apply(p, x, group_tokens):
    """x: (B, S, D) image tokens; group_tokens: (B, G_in, D).
    Returns new_x: (B, G_out, D)."""
    gt = L.layernorm(p["norm_tokens"], group_tokens)
    t = gt.transpose(1, 2)                                   # (B, D, G_in)
    t = L.dense(p["mlp_inter"]["fc2"],
                _gelu(L.dense(p["mlp_inter"]["fc1"], t)))
    proj_gt = L.layernorm(p["norm_post_tokens"], t.transpose(1, 2))
    xn = L.layernorm(p["norm_x"], x)
    proj_gt = _gv_cross_attn_apply(p["pre_assign_attn"], proj_gt, xn,
                                   _GV_VHEADS)
    new_x = proj_gt + _gv_assign_attn(p["assign"], proj_gt, xn, _GV_VHEADS)
    return new_x + L.dense(
        p["mlp_channels"]["fc2"],
        _gelu(L.dense(p["mlp_channels"]["fc1"],
                      L.layernorm(p["norm_new_x"], new_x))))


def groupvit_init(key):
    ks = iter(tf.split(key, 64))
    dev = key.device
    vision = {
        "pos": _zeros((1, 196, _GV_VD), key),
        "patch": L.conv_init(next(ks), 16, 16, 3, _GV_VD),
        "emb_ln": L.layernorm_init(_GV_VD, dev),
        "stages": [],
        "ln": L.layernorm_init(_GV_VD, dev),
    }
    for si, depth in enumerate(_GV_DEPTHS):
        stage = {"layers": [_block_init(next(ks), _GV_VD, _GV_VFFN)
                            for _ in range(depth)]}
        if _GV_GROUP_TOKENS[si]:
            stage["group_token"] = _zeros((1, _GV_GROUP_TOKENS[si], _GV_VD),
                                          key)
            stage["downsample"] = _gv_downsample_init(
                next(ks), _GV_VD, _GV_VFFN, _GV_GROUP_TOKENS[si],
                _GV_OUT_GROUPS[si], mixer_hidden=_GV_VD // 2)
        if si == 1:
            # projects the previous stage's 64 groups into this stage's 8
            # group-token inits: LN + token-mixing MLP 64 -> 192 -> 8.
            stage["group_projector"] = {
                "norm": L.layernorm_init(_GV_VD, dev),
                "fc1": L.dense_init(next(ks), _GV_OUT_GROUPS[0],
                                    _GV_VD // 2),
                "fc2": L.dense_init(next(ks), _GV_VD // 2,
                                    _GV_GROUP_TOKENS[1]),
            }
        vision["stages"].append(stage)

    text = {
        "tok_emb": L.embedding_init(next(ks), _GV_TVOCAB, _GV_TD),
        "pos_emb": L.embedding_init(next(ks), _GV_TPOS, _GV_TD),
        "blocks": [_block_init(next(ks), _GV_TD, _GV_TFFN)
                   for _ in range(_GV_TLAYERS)],
        "ln": L.layernorm_init(_GV_TD, dev),
    }

    def proj_init(in_d):
        k1, k2 = tf.split(next(ks))
        return {"fc1": L.dense_init(k1, in_d, _GV_PROJ_INTER),
                "bn": L.batchnorm_init(_GV_PROJ_INTER, dev)[0],
                "fc2": L.dense_init(k2, _GV_PROJ_INTER, _GV_PROJ)}

    return {"logit_scale": torch.full((), math.log(1 / 0.07),
                                      dtype=torch.float32, device=dev),
            "vision": vision, "text": text,
            "visual_projection": proj_init(_GV_VD),
            "text_projection": proj_init(_GV_TD)}


def _gv_project(p, x, state_mean=0.0, state_var=1.0):
    """fc1, an inference-mode BN (eps 1e-5) on (mean, var), ReLU, fc2."""
    h = L.dense(p["fc1"], x)
    # float32 sqrt and division, as jnp: torch would divide by a Python
    # scalar through its reciprocal on the card
    std = torch.sqrt(torch.full((), state_var + 1e-5, device=h.device))
    h = (h - state_mean) / std
    h = h * p["bn"]["scale"] + p["bn"]["bias"]
    return L.dense(p["fc2"], torch.relu(h))


def groupvit_apply(p, images, ids):
    """images: (B,224,224,3), ids: (B,T<=77) -> (image_embeds, text_embeds)
    both (B, 256), plus the logit scale."""
    v = p["vision"]
    B = images.shape[0]
    x = L.conv2d(v["patch"], images, stride=16, padding="VALID")
    x = L.layernorm(v["emb_ln"], x.reshape(B, -1, _GV_VD) + v["pos"])
    prev_groups = None
    for stage in v["stages"]:
        if "group_token" in stage:
            gt = stage["group_token"].expand(
                (B,) + tuple(stage["group_token"].shape[1:]))
            if "group_projector" in stage and prev_groups is not None:
                gp = stage["group_projector"]
                t = L.layernorm(gp["norm"], prev_groups).transpose(1, 2)
                t = L.dense(gp["fc2"], _gelu(L.dense(gp["fc1"], t)))
                gt = gt + t.transpose(1, 2)
            h = torch.cat([x, gt], dim=1)
        else:
            h = x
        for blk in stage["layers"]:
            h = _block_apply_preln(blk, h, _GV_VHEADS)
        if "group_token" in stage:
            n_img = x.shape[1]
            x = _gv_downsample_apply(stage["downsample"], h[:, :n_img],
                                     h[:, n_img:])
            prev_groups = x
        else:
            x = h
    x = L.layernorm(v["ln"], x)
    image_embeds = _gv_project(p["visual_projection"], x.mean(1))

    t = p["text"]
    T = ids.shape[1]
    h = L.embedding(t["tok_emb"], ids) + t["pos_emb"]["w"][None, :T]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=ids.device))[None, None]
    for blk in t["blocks"]:
        h = _block_apply_preln(blk, h, _GV_THEADS, mask=causal)
    h = L.layernorm(t["ln"], h)
    eot = h[torch.arange(h.shape[0], device=h.device), ids.argmax(-1)]
    text_embeds = _gv_project(p["text_projection"], eot)
    return image_embeds, text_embeds, torch.exp(p["logit_scale"])
