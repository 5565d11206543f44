"""DLG gradient-inversion attack (Deep Leakage from Gradients) in PyTorch,
the counterpart of fhe_fed_tpu.attack.dlg.

Reference parity: code/attack/code.py:446-543 and exp1.py: reconstruct a
client's training input from its shared gradients by optimizing dummy
(data, label) so that the dummy gradients match; layers listed in
`protected_layers` have their gradients zeroed on BOTH sides
(code.py:466-477), modeling selective encryption of those layers.

A model is the zoo's functional pair: `apply(params, x)` over a tree of
float32 leaf tensors (models/layers.py), the JAX package's trees. Leaf
indices (`protected_layers`, the element mask's flat order) follow
fed.fedavg.tree_leaves, which is jax.tree_util's order, so an index names
the same leaf in both packages. Gradients are taken with
torch.autograd.grad on detached copies of the leaves; the attack's
objective differentiates a gradient (create_graph=True), so the dummy's
update is a second-order gradient, as jax.grad of jax.grad.

Everything runs on the device the parameters live on, in full float32
with cuDNN's deterministic algorithms (utils/precision.py): TF32, which
cuDNN uses for float32 convolutions on Hopper by default, breaks gradient
matching as bf16 did on the TPU (fhe_fed_tpu/attack/dlg.py:57-66).

Optimizers: "adam" is torch.optim.Adam (optax.adam's defaults: b1 0.9,
b2 0.999, eps 1e-8); "lbfgs" is torch.optim.LBFGS, the reference's own
optimizer, with history 10 and a strong-Wolfe line search. One step is
one update in both packages: Adam's, or one `LBFGS.step(closure)` with
max_iter=1, as one optax.lbfgs update. Three settings make torch's L-BFGS
run as many useful updates as optax's:
  - max_eval=26: torch's default max_eval (max_iter * 5 // 4 = 1) leaves
    the line search no evaluation at max_iter=1; 26 gives it the 25 that
    torch's strong-Wolfe search allows by default;
  - tolerance_grad = tolerance_change = 0: optax runs every step it is
    given, and the attack's objective falls below torch's defaults (1e-7,
    1e-9) long before it converges;
  - L-BFGS minimises the objective times 2**24 (LBFGS_SCALE): torch
    updates its curvature memory only where y.s > 1e-10, an absolute
    threshold that the objective's scale (1e-9 and below near the optimum)
    falls under, which turns L-BFGS into gradient descent there (LeNet
    stalled at corr 0.86 against optax's 0.98 on the CPU). A power of two
    scales every value and gradient exactly, and the steps L-BFGS takes
    do not depend on the scale otherwise; the recorded losses are the
    objective's own.
Where the line search finds no point below the current loss (at a ReLU
kink, say) it returns step 0: the point and the memory then stay as they
are and every later step would repeat the failure, so the attack starts a
fresh L-BFGS (empty memory, a steepest-descent step) there.
The two L-BFGS implementations choose their first step and line search
differently, so their trajectories differ; their outcomes are compared,
not their paths.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..fed.fedavg import tree_leaves, tree_map
from ..utils import threefry as tf
from ..utils.precision import full_f32


LBFGS_SCALE = 2.0 ** 24


def cross_entropy_onehot(logits: torch.Tensor,
                         onehot: torch.Tensor) -> torch.Tensor:
    """mean(sum(-onehot * log_softmax(logits))) (code.py cross_entropy)."""
    return torch.mean(torch.sum(-onehot * torch.log_softmax(logits, -1), -1))


def _zero_protected(grads: list, protected: Sequence[int]) -> list:
    protected = set(protected)
    return [torch.zeros_like(g) if i in protected else g
            for i, g in enumerate(grads)]


def _apply_element_mask(grads: list, keep_flat: torch.Tensor) -> list:
    """Multiply a flat leaf-grad list by a flat (n_params,) keep mask:
    element-level protection (reference masking.py:141-145 semantics:
    shared grads * (1 - top_k_mask))."""
    out = []
    off = 0
    for g in grads:
        out.append(g * keep_flat[off:off + g.numel()].reshape(g.shape))
        off += g.numel()
    return out


def leaf_copies(params):
    """(tree, leaves): the tree of `params` with every leaf replaced by a
    detached copy that requires grad, and those copies in tree_leaves
    order (what torch.autograd.grad differentiates against)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    return tree_map(lambda _: next(it), params), leaves


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def model_gradients(apply: Callable, params, x: torch.Tensor,
                    onehot: torch.Tensor,
                    protected_layers: Sequence[int] = ()) -> list:
    """The client's shared gradient, with protected layers zeroed
    (code.py:466-477): a list of leaf gradients in tree_leaves order, on
    the parameters' device, in full float32 whatever the caller's TF32
    settings."""
    with full_f32():
        tree, leaves = leaf_copies(params)
        grads = torch.autograd.grad(
            cross_entropy_onehot(apply(tree, x), onehot), leaves)
    return _zero_protected(list(grads), protected_layers)


@dataclasses.dataclass
class DLGResult:
    data: np.ndarray          # recovered input
    label: np.ndarray         # recovered label distribution
    losses: np.ndarray        # grad-matching loss per recorded step
    history: list             # snapshots of the recovered input


def initial_dummies(seed: int, data_shape, n_classes: int,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """The dummy (data, label logits) the attack starts from: normal draws
    under jax.random.split(jax.random.key(seed)) as the JAX attack makes
    them, from the port's threefry (within a few ulp of jax.random)."""
    k1, k2 = tf.split(tf.key(seed, device))
    return (tf.normal(k1, tuple(data_shape)),
            tf.normal(k2, (data_shape[0], n_classes)))


def match_objective(apply: Callable, params, target_grads: list,
                    protected_layers: Sequence[int] = (),
                    element_mask=None) -> Callable:
    """loss(data, label_logits): the squared distance between the model's
    gradient at (data, softmax(label_logits)) and `target_grads`, over the
    unprotected leaves (and, with `element_mask`, the unmasked elements),
    differentiable in both arguments (code.py:482-531). Call it inside
    full_f32(), as dlg_attack does."""
    dev = _device(params)
    tree, leaves = leaf_copies(params)
    protected = tuple(protected_layers)
    keep = (None if element_mask is None else
            1.0 - torch.as_tensor(element_mask, dtype=torch.float32,
                                  device=dev))
    target = [torch.as_tensor(g, device=dev) for g in target_grads]

    def loss(data: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        onehot = torch.softmax(label, -1)
        grads = torch.autograd.grad(
            cross_entropy_onehot(apply(tree, data), onehot), leaves,
            create_graph=True)
        grads = _zero_protected(list(grads), protected)
        if keep is not None:
            grads = _apply_element_mask(grads, keep)
        total = 0
        for gx, gy in zip(grads, target):
            total = total + torch.sum((gx - gy) ** 2)
        return total
    return loss


def dlg_attack(apply: Callable, params, target_grads: list,
               data_shape, n_classes: int,
               protected_layers: Sequence[int] = (),
               element_mask=None,
               steps: int = 300, lr: float = 0.1, seed: int = 0,
               record_every: int = 50,
               optimizer: str = "adam") -> DLGResult:
    """Run the attack: optimize (dummy_data, dummy_label) so that
    grad(model; dummy) matches `target_grads` (code.py:482-531), on the
    parameters' device.

    element_mask: optional flat (n_params,) 0/1 array or tensor: 1 marks
    elements protected by sensitivity-based selective encryption
    (masking.top_k_mask); the attacker knows the mask and matches only the
    unprotected elements (the element-level analogue of protected_layers).
    `lr` is Adam's; L-BFGS steps with lr 1 and its line search. losses[j]
    is the objective before the update of the j-th recorded step (every
    `record_every`-th and the last), history[j] the data after it."""
    if optimizer not in ("adam", "lbfgs"):
        raise ValueError(f"optimizer {optimizer!r}: 'adam' or 'lbfgs'")
    dev = _device(params)
    losses, history = [], []
    with full_f32():
        objective = match_objective(apply, params, target_grads,
                                    protected_layers, element_mask)
        data, label = initial_dummies(seed, data_shape, n_classes, dev)
        data.requires_grad_(True)
        label.requires_grad_(True)

        def lbfgs():
            return torch.optim.LBFGS([data, label], lr=1, max_iter=1,
                                     max_eval=26, history_size=10,
                                     tolerance_grad=0.0,
                                     tolerance_change=0.0,
                                     line_search_fn="strong_wolfe")
        if optimizer == "lbfgs":
            opt, scale = lbfgs(), LBFGS_SCALE
        else:
            opt, scale = torch.optim.Adam([data, label], lr=lr), 1.0

        def closure():
            loss = objective(data, label) * scale
            if loss.requires_grad:
                # contiguous: a convolution's input gradient on the card
                # can come back strided, and torch's L-BFGS views it flat
                data.grad, label.grad = (g.contiguous() for g in
                                         torch.autograd.grad(loss,
                                                             [data, label]))
            else:   # every leaf protected: a constant 0, as in JAX
                data.grad, label.grad = (torch.zeros_like(data),
                                         torch.zeros_like(label))
            return loss.detach()

        for i in range(steps):
            if optimizer == "lbfgs":
                loss = opt.step(closure)
                if opt.state[data].get("t") == 0:    # the line search failed
                    opt = lbfgs()
            else:
                loss = closure()
                opt.step()
            if i % record_every == 0 or i == steps - 1:
                losses.append(float(loss) / scale)
                history.append(data.detach().cpu().numpy().copy())
    return DLGResult(data=data.detach().cpu().numpy(),
                     label=torch.softmax(label.detach(), -1).cpu().numpy(),
                     losses=np.asarray(losses), history=history)
