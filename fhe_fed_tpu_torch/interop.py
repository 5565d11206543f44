"""Carry state from the JAX package into the port.

Each helper takes the JAX package's arrays as numpy (u32 residues, u32
Shoup words, int8 matrices) and returns the port's objects with its dtype
rules: residues int32, Shoup words int64, int8 unchanged. Nothing here
imports jax: callers pass `np.asarray(jax_array)`. Like the other entry
points, the helpers put their tensors on the card unless `device` says
otherwise (cuda_lib.device).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from . import cuda_lib
from .ckks.keys import SecretKey, PublicKey
from .ckks.ops import Ciphertext, SeededCiphertext
from .ckks.keyswitch import KSwitchKey
from .ckks.threshold import PartySecrets
from .fed.fedavg import tree_map
from .models import zoo
from .models.zoo import ModelSpec


def _tensor(name: str, a, device) -> torch.Tensor:
    device = cuda_lib.device(device)
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.as_tensor(a, device=device)
    if name.endswith("shoup"):
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype.kind in "ui" and a.size and int(a.max()) >= 2 ** 31:
        raise ValueError(f"{name}: residues must be < 2**31")
    return torch.as_tensor(a.astype(np.int32) if a.dtype.kind in "ui" else a,
                           device=device)


def context_arrays_from_numpy(arrays: dict, device="cuda") -> dict:
    """{name: numpy array} -> {name: tensor}; names ending in 'shoup' are
    Shoup words (int64), other integer arrays residues (int32)."""
    return {k: _tensor(k, v, device) for k, v in arrays.items()}


def keys_from_numpy(sk_arrays, pk_arrays, device="cuda"):
    """(s, s_shoup) and (p0, p0_shoup, p1, p1_shoup) -> (SecretKey,
    PublicKey); either tuple may be None."""
    sk = pk = None
    if sk_arrays is not None:
        sk = SecretKey(**context_arrays_from_numpy(
            dict(zip(("s", "s_shoup"), sk_arrays)), device))
    if pk_arrays is not None:
        pk = PublicKey(**context_arrays_from_numpy(
            dict(zip(("p0", "p0_shoup", "p1", "p1_shoup"), pk_arrays)),
            device))
    return sk, pk


def ciphertext_from_numpy(data, scale: float, level: int,
                          device="cuda") -> Ciphertext:
    """u32 ciphertext data (..., chunks, 2, live, N) -> Ciphertext."""
    return Ciphertext(data=_tensor("data", data, device), scale=float(scale),
                      level=int(level))


def seeded_ciphertext_from_numpy(c0, seed, scale: float, level: int,
                                 device="cuda") -> SeededCiphertext:
    """u32 c0 (chunks, live, N) and u32 seed (4,) -> SeededCiphertext."""
    return SeededCiphertext(
        c0=_tensor("c0", c0, device),
        seed=torch.as_tensor(np.asarray(seed, dtype=np.uint32).astype(
            np.int64), device=cuda_lib.device(device)),
        scale=float(scale), level=int(level))


def cnn_fedavg_state_dict_from_numpy(params) -> collections.OrderedDict:
    """The JAX model's parameters {conv1, conv2, fc1, fc2: {w, b}} (numpy)
    -> a CNNOriginalFedAvg state_dict. Conv kernels HWIO -> OIHW, dense
    (in, out) -> (out, in); fc1's input rows are the JAX model's NHWC
    flatten (h, w, c) and are permuted to torch's (c, h, w)."""
    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32))

    sd = collections.OrderedDict()
    for name in ("conv1", "conv2"):
        sd[f"{name}.weight"] = t(np.transpose(params[name]["w"],
                                              (3, 2, 0, 1)))
        sd[f"{name}.bias"] = t(params[name]["b"])
    w1 = np.asarray(params["fc1"]["w"])
    c = w1.shape[0] // 49                        # 7 x 7 x c feature map
    sd["fc1.weight"] = t(w1.reshape(7, 7, c, -1).transpose(2, 0, 1, 3)
                         .reshape(w1.shape).T)
    sd["fc1.bias"] = t(params["fc1"]["b"])
    sd["fc2.weight"] = t(np.asarray(params["fc2"]["w"]).T)
    sd["fc2.bias"] = t(params["fc2"]["b"])
    return sd


def zoo_model_from_numpy(name: str, params, state=None,
                         device="cuda") -> ModelSpec:
    """A JAX zoo model's (params, state), nested dicts and lists of numpy
    arrays, -> the port's model (models.zoo.ModelSpec) on `device`.

    The port keeps the JAX package's trees and layouts (models/layers.py),
    so every leaf carries over as it is: dense weights stay (in, out),
    convolution kernels HWIO, LSTM gate blocks (in, 4 * hidden) in the
    order i, f, g, o, and dense layers after a convolution keep reading
    the NHWC flatten. Nothing is permuted here, unlike for the torch
    module CNNOriginalFedAvg (cnn_fedavg_state_dict_from_numpy)."""
    device = cuda_lib.device(device)

    def leaf(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    return zoo.spec_from_tree(
        name, tree_map(leaf, params),
        None if state is None else tree_map(leaf, state))


def kswitch_key_from_numpy(b, b_shoup, a, a_shoup,
                           device="cuda") -> KSwitchKey:
    """A relinearisation or Galois key's (dnum, L, N) rows -> KSwitchKey."""
    return KSwitchKey(**context_arrays_from_numpy(
        dict(b=b, b_shoup=b_shoup, a=a, a_shoup=a_shoup), device))


def party_secrets_from_numpy(s, s_shoup, device="cuda") -> PartySecrets:
    """Threshold shares (P, L, N) and their Shoup words -> PartySecrets."""
    return PartySecrets(**context_arrays_from_numpy(
        dict(s=s, s_shoup=s_shoup), device))
