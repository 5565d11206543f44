"""MobileNet-v1 and ResNet-18/34/50 (NHWC), the counterpart of
fhe_fed_tpu.models.convnets.

Reference parity:
  mobilenet  3,315,428 trainable params at width=1, class_num=100
             (reference code/benchmark.py:229-365: stem BasicConv2d
             bias=False + depth-separable stacks; depthwise convs
             bias=False, pointwise nn.Conv2d(.,.,1) keeps default bias)
  resnet18/34/50  torchvision canonical 1000-class models
             (reference code/benchmark.py:393-398): 11,689,512 /
             21,797,672 / 25,557,032 trainable params.

`init` returns (params, state): `state` holds BatchNorm running stats
(buffers), excluded from param_count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from ..utils import threefry as tf


# ---------------------------------------------------------------------------
# MobileNet v1 (reference width=1, class_num=100)
# ---------------------------------------------------------------------------

def _ds_init(key, cin, cout):
    """DepthSeperabelConv2d: dw 3x3 (no bias) + BN, pw 1x1 (bias) + BN."""
    k1, k2 = tf.split(key)
    dw = L.depthwise_conv_init(k1, 3, 3, cin, bias=False)
    pw = L.conv_init(k2, 1, 1, cin, cout, bias=True)
    bn1p, bn1s = L.batchnorm_init(cin, key.device)
    bn2p, bn2s = L.batchnorm_init(cout, key.device)
    return ({"dw": dw, "bn1": bn1p, "pw": pw, "bn2": bn2p},
            {"bn1": bn1s, "bn2": bn2s})


def _ds_apply(p, s, x, stride):
    x = torch.relu(L.batchnorm(p["bn1"], s["bn1"],
                               L.depthwise_conv2d(p["dw"], x, stride)))
    return torch.relu(L.batchnorm(p["bn2"], s["bn2"], L.conv2d(p["pw"], x)))


_MOBILENET_CFG = [  # (cout, stride) per depth-separable block, cin chains
    (64, 1),
    (128, 2), (128, 1),
    (256, 2), (256, 1),
    (512, 2), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
]


def mobilenet_init(key, width: float = 1.0, class_num: int = 100):
    def a(c):
        return int(c * width)
    ks = tf.split(key, 2 + len(_MOBILENET_CFG))
    stem = L.conv_init(ks[0], 3, 3, 3, a(32), bias=False)
    bn0p, bn0s = L.batchnorm_init(a(32), key.device)
    params = {"stem": stem, "bn0": bn0p, "blocks": [], "fc": None}
    state = {"bn0": bn0s, "blocks": []}
    cin = a(32)
    for i, (cout, _) in enumerate(_MOBILENET_CFG):
        bp, bs = _ds_init(ks[1 + i], cin, a(cout))
        params["blocks"].append(bp)
        state["blocks"].append(bs)
        cin = a(cout)
    params["fc"] = L.dense_init(ks[-1], cin, class_num)
    return params, state


def mobilenet_apply(params, state, x):
    """x: (B, H, W, 3) NHWC."""
    x = torch.relu(L.batchnorm(params["bn0"], state["bn0"],
                               L.conv2d(params["stem"], x)))
    for bp, bs, (_, stride) in zip(params["blocks"], state["blocks"],
                                   _MOBILENET_CFG):
        x = _ds_apply(bp, bs, x, stride)
    return L.dense(params["fc"], L.avg_pool_global(x))


# ---------------------------------------------------------------------------
# ResNet (torchvision canonical, 1000 classes)
# ---------------------------------------------------------------------------

def _basic_block_init(key, cin, cout, stride):
    k = tf.split(key, 3)
    dev = key.device
    p = {"conv1": L.conv_init(k[0], 3, 3, cin, cout, bias=False),
         "conv2": L.conv_init(k[1], 3, 3, cout, cout, bias=False)}
    s = {}
    p["bn1"], s["bn1"] = L.batchnorm_init(cout, dev)
    p["bn2"], s["bn2"] = L.batchnorm_init(cout, dev)
    if stride != 1 or cin != cout:
        p["down"] = L.conv_init(k[2], 1, 1, cin, cout, bias=False)
        p["down_bn"], s["down_bn"] = L.batchnorm_init(cout, dev)
    return p, s


def _shortcut(p, s, x, stride):
    if "down" not in p:
        return x
    return L.batchnorm(p["down_bn"], s["down_bn"],
                       L.conv2d(p["down"], x, stride))


def _basic_block_apply(p, s, x, stride):
    out = torch.relu(L.batchnorm(p["bn1"], s["bn1"],
                                 L.conv2d(p["conv1"], x, stride)))
    out = L.batchnorm(p["bn2"], s["bn2"], L.conv2d(p["conv2"], out))
    return torch.relu(out + _shortcut(p, s, x, stride))


def _bottleneck_init(key, cin, cmid, stride):
    cout = cmid * 4
    k = tf.split(key, 4)
    dev = key.device
    p = {"conv1": L.conv_init(k[0], 1, 1, cin, cmid, bias=False),
         "conv2": L.conv_init(k[1], 3, 3, cmid, cmid, bias=False),
         "conv3": L.conv_init(k[2], 1, 1, cmid, cout, bias=False)}
    s = {}
    p["bn1"], s["bn1"] = L.batchnorm_init(cmid, dev)
    p["bn2"], s["bn2"] = L.batchnorm_init(cmid, dev)
    p["bn3"], s["bn3"] = L.batchnorm_init(cout, dev)
    if stride != 1 or cin != cout:
        p["down"] = L.conv_init(k[3], 1, 1, cin, cout, bias=False)
        p["down_bn"], s["down_bn"] = L.batchnorm_init(cout, dev)
    return p, s


def _bottleneck_apply(p, s, x, stride):
    out = torch.relu(L.batchnorm(p["bn1"], s["bn1"],
                                 L.conv2d(p["conv1"], x)))
    out = torch.relu(L.batchnorm(p["bn2"], s["bn2"],
                                 L.conv2d(p["conv2"], out, stride)))
    out = L.batchnorm(p["bn3"], s["bn3"], L.conv2d(p["conv3"], out))
    return torch.relu(out + _shortcut(p, s, x, stride))


_RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}


def resnet_init(key, depth: int, num_classes: int = 1000):
    bottleneck = depth >= 50
    layers = _RESNET_LAYERS[depth]
    ks = tf.split(key, 2 + sum(layers))
    params = {"stem": L.conv_init(ks[0], 7, 7, 3, 64, bias=False),
              "layers": []}
    state = {"layers": []}
    params["bn0"], state["bn0"] = L.batchnorm_init(64, key.device)
    cin = 64
    ki = 1
    for li, (n_blocks, cmid) in enumerate(zip(layers, (64, 128, 256, 512))):
        lp, ls = [], []
        for b in range(n_blocks):
            stride = 2 if (b == 0 and li > 0) else 1
            if bottleneck:
                bp, bs = _bottleneck_init(ks[ki], cin, cmid, stride)
                cin = cmid * 4
            else:
                bp, bs = _basic_block_init(ks[ki], cin, cmid, stride)
                cin = cmid
            lp.append(bp)
            ls.append(bs)
            ki += 1
        params["layers"].append(lp)
        state["layers"].append(ls)
    params["fc"] = L.dense_init(ks[-1], cin, num_classes)
    return params, state


def resnet_apply(params, state, x, depth: int):
    block = _bottleneck_apply if depth >= 50 else _basic_block_apply
    x = torch.relu(L.batchnorm(params["bn0"], state["bn0"],
                               L.conv2d(params["stem"], x, stride=2)))
    x = L.max_pool(F.pad(x, (0, 0, 1, 1, 1, 1), value=-torch.inf), 3, 2)
    for li, n_blocks in enumerate(_RESNET_LAYERS[depth]):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and li > 0) else 1
            x = block(params["layers"][li][b], state["layers"][li][b], x,
                      stride)
    return L.dense(params["fc"], L.avg_pool_global(x))
