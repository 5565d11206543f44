"""Gradient-sensitivity masking (reference attack/masking/masking.py), the
counterpart of fhe_fed_tpu.attack.masking.

The sensitivity of a gradient element is d(grad_theta L)/d(label) at the
true class. The JAX package takes jax.jacfwd over the one-hot label of
jax.grad. The loss is linear in the label,

    L = -(1/B) sum_b sum_c onehot[b, c] * log_softmax(f(x))[b, c],

so that derivative is exactly -(1/B) * grad_theta log_softmax(f(x))[b, c]:
one reverse pass per sample b at its true class gives the columns the JAX
function keeps, where jacfwd computes all n_classes of them.

The top-|sensitivity| fraction of elements is the protection mask, the
part selective encryption should cover (masking.py:15-21 get_top_k_mask).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.precision import full_f32
from .dlg import leaf_copies


def gradient_sensitivity(apply: Callable, params, x: torch.Tensor,
                         onehot: torch.Tensor) -> torch.Tensor:
    """|d grad_theta L / d label| at the true class, summed over the batch
    and flattened to (n_params,) in tree_leaves order, on the parameters'
    device, in full float32. Mirrors sensitivity_each_element
    (masking.py:115-135)."""
    batch = onehot.shape[0]
    gt_class = torch.argmax(onehot, -1).tolist()
    total = None
    with full_f32():
        tree, leaves = leaf_copies(params)
        log_probs = torch.log_softmax(apply(tree, x), -1)
        for b, c in enumerate(gt_class):
            g = torch.autograd.grad(-log_probs[b, c] / batch, leaves,
                                    retain_graph=b < batch - 1)
            sens = torch.cat([t.reshape(-1) for t in g]).abs()
            total = sens if total is None else total + sens
    return total


def top_k_mask(sensitivity, fraction: float) -> torch.Tensor:
    """1.0 for the top-`fraction` most sensitive elements, else 0.0:
    get_top_k_mask (masking.py:15-21), on the sensitivity's device. The
    sort is stable, as jnp.argsort is, so ties (ReLU models give many
    exact-zero sensitivities) fall in index order and both packages pick
    the same elements. NOTE: the protection semantics zero the protected
    elements, so the mask to APPLY to shared grads is (1 - this)."""
    s = torch.as_tensor(sensitivity)
    n = s.shape[0]
    k = int(np.ceil(fraction * n))
    idx = torch.argsort(-s, stable=True)[:k]
    mask = torch.zeros(n, dtype=torch.float32, device=s.device)
    mask[idx] = 1.0
    return mask


def mask_gradients(grads: list, mask_flat) -> list:
    """Zero the protected (mask == 1) elements of a leaf-grad list
    (masking.py:141-145: flat grads * (1 - mask) semantics)."""
    m = torch.as_tensor(mask_flat, device=grads[0].device)
    out = []
    off = 0
    for g in grads:
        out.append(g * (1.0 - m[off:off + g.numel()].reshape(g.shape)))
        off += g.numel()
    return out
