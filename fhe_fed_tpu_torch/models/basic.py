"""Small models of the reference zoo, the counterpart of
fhe_fed_tpu.models.basic.

Reference parity (param counts, reference code/benchmark.py):
  linear      101        nn.Linear(100, 1)            (benchmark.py:50-53)
  mlp         79,510     784-100-10 ReLU MLP          (benchmark.py:64-78)
  lenet       88,648     4xconv(12ch,5x5)+fc768-100   (benchmark.py:81-105)
  cnn_fedavg  1,663,370  FedAvg-paper MNIST CNN       (benchmark.py:152-219)
  rnn_lstm    822,570    2xLSTM(256)+fc, vocab 90     (benchmark.py:108-149)
  tst         124,608    TimeSeriesTransformer (modern config shape)

Each model is `init(key) -> params` + `apply(params, x) -> y` over the JAX
package's parameter trees (models/layers.py). CNNOriginalFedAvg is the same
CNN as a torch module with a state_dict in torch's layout: its feature map
flattens NCHW (c, h, w) where cnn_fedavg_apply flattens NHWC (h, w, c), so
carried-over fc1 weights are permuted
(interop.cnn_fedavg_state_dict_from_numpy).
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from ..utils import threefry as tf


# --- Linear regression: nn.Linear(100, 1) ---------------------------------

def linear_init(key):
    return L.dense_init(key, 100, 1)


def linear_apply(p, x):
    return L.dense(p, x)


# --- MLP 784-100-10 --------------------------------------------------------

def mlp_init(key):
    k1, k2 = tf.split(key)
    return {"fc1": L.dense_init(k1, 784, 100),
            "fc2": L.dense_init(k2, 100, 10)}


def mlp_apply(p, x):
    x = x.reshape(x.shape[0], -1)
    return L.dense(p["fc2"], torch.relu(L.dense(p["fc1"], x)))


# --- LeNet (DLG-attack variant: 4 convs, sigmoid, fc 768->100) -------------

def lenet_init(key):
    k = tf.split(key, 5)
    return {"conv1": L.conv_init(k[0], 5, 5, 3, 12),
            "conv2": L.conv_init(k[1], 5, 5, 12, 12),
            "conv3": L.conv_init(k[2], 5, 5, 12, 12),
            "conv4": L.conv_init(k[3], 5, 5, 12, 12),
            "fc": L.dense_init(k[4], 768, 100)}


def lenet_apply(p, x):
    """x: (B, 32, 32, 3) NHWC (CIFAR)."""
    act = torch.sigmoid
    x = act(L.conv2d(p["conv1"], x, stride=2))
    x = act(L.conv2d(p["conv2"], x, stride=2))
    x = act(L.conv2d(p["conv3"], x, stride=1))
    x = act(L.conv2d(p["conv4"], x, stride=1))
    return L.dense(p["fc"], x.reshape(x.shape[0], -1))


# --- CNN_OriginalFedAvg (1,663,370 params) --------------------------------

def cnn_fedavg_init(key, only_digits: bool = True):
    k = tf.split(key, 4)
    return {"conv1": L.conv_init(k[0], 5, 5, 1, 32),
            "conv2": L.conv_init(k[1], 5, 5, 32, 64),
            "fc1": L.dense_init(k[2], 3136, 512),
            "fc2": L.dense_init(k[3], 512, 10 if only_digits else 62)}


def cnn_fedavg_apply(p, x):
    """x: (B, 28, 28) or (B, 28, 28, 1)."""
    if x.dim() == 3:
        x = x[..., None]
    x = L.max_pool(torch.relu(L.conv2d(p["conv1"], x)), 2, 2)
    x = L.max_pool(torch.relu(L.conv2d(p["conv2"], x)), 2, 2)
    x = torch.relu(L.dense(p["fc1"], x.reshape(x.shape[0], -1)))
    return L.dense(p["fc2"], x)


class CNNOriginalFedAvg(nn.Module):
    """conv 5x5 SAME 1->32, max-pool 2, conv 5x5 SAME 32->64, max-pool 2,
    fc 3136->512, fc 512->10 (62 without only_digits), ReLUs."""

    def __init__(self, only_digits: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2)
        self.fc1 = nn.Linear(3136, 512)
        self.fc2 = nn.Linear(512, 10 if only_digits else 62)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 28, 28) or (B, 1, 28, 28) -> logits (B, classes)."""
        if x.dim() == 3:
            x = x[:, None]
        x = nn.functional.max_pool2d(torch.relu(self.conv1(x)), 2)
        x = nn.functional.max_pool2d(torch.relu(self.conv2(x)), 2)
        x = torch.relu(self.fc1(x.flatten(1)))
        return self.fc2(x)


# --- RNN_OriginalFedAvg: embed(90,8) + 2xLSTM(256) + fc(256,90) ------------

def rnn_lstm_init(key, vocab: int = 90, embed: int = 8, hidden: int = 256):
    k = tf.split(key, 4)
    return {"embed": L.embedding_init(k[0], vocab, embed),
            "lstm1": L.lstm_layer_init(k[1], embed, hidden),
            "lstm2": L.lstm_layer_init(k[2], hidden, hidden),
            "fc": L.dense_init(k[3], hidden, vocab)}


def rnn_lstm_apply(p, ids):
    """ids: (B, T) int -> logits (B, vocab): next-char prediction."""
    x = L.embedding(p["embed"], ids)
    x = L.lstm_layer(p["lstm1"], x)
    x = L.lstm_layer(p["lstm2"], x)
    return L.dense(p["fc"], x[:, -1])


# --- Time-series transformer (encoder-decoder, d=64) -----------------------

_TST_D = 64
_TST_FFN = 32
_TST_HEADS = 2
_TST_CTX = 24          # context_length
_TST_PRED = 24         # prediction_length
_TST_FEAT = 9          # lags(7) + log-scale features etc. -> input dim


def _tst_block_init(key, cross: bool):
    k = tf.split(key, 6)
    dev = key.device
    p = {"attn": L.mha_init(k[0], _TST_D),
         "ln1": L.layernorm_init(_TST_D, dev),
         "fc1": L.dense_init(k[1], _TST_D, _TST_FFN),
         "fc2": L.dense_init(k[2], _TST_FFN, _TST_D),
         "ln2": L.layernorm_init(_TST_D, dev)}
    if cross:
        p["xattn"] = L.mha_init(k[3], _TST_D)
        p["lnx"] = L.layernorm_init(_TST_D, dev)
    return p


def _tst_block_apply(p, x, enc=None):
    x = L.layernorm(p["ln1"], x + L.mha(p["attn"], x, _TST_HEADS))
    if enc is not None:
        x = L.layernorm(p["lnx"], x + L.mha(p["xattn"], x, _TST_HEADS,
                                            kv=enc))
    h = L.dense(p["fc2"], torch.relu(L.dense(p["fc1"], x)))
    return L.layernorm(p["ln2"], x + h)


def tst_init(key, enc_layers: int = 2, dec_layers: int = 2):
    k = tf.split(key, 3 + enc_layers + dec_layers)
    return {"value_proj": {"w": tf.normal(k[0], (_TST_FEAT, _TST_D)) * 0.02},
            "enc_pos": tf.normal(k[1], (2 * _TST_CTX, _TST_D)) * 0.02,
            "dec_pos": tf.normal(k[2], (2 * _TST_PRED, _TST_D)) * 0.02,
            "enc": [_tst_block_init(k[3 + i], cross=False)
                    for i in range(enc_layers)],
            "dec": [_tst_block_init(k[3 + enc_layers + i], cross=True)
                    for i in range(dec_layers)]}


def tst_apply(p, past, future):
    """past: (B, T, feat), future: (B, S, feat) -> decoder states (B,S,D)."""
    e = past @ p["value_proj"]["w"] + p["enc_pos"][None, :past.shape[1]]
    for blk in p["enc"]:
        e = _tst_block_apply(blk, e)
    d = future @ p["value_proj"]["w"] + p["dec_pos"][None, :future.shape[1]]
    for blk in p["dec"]:
        d = _tst_block_apply(blk, d, enc=e)
    return d
