"""Full float32 arithmetic for the extent of a `with` block.

On an H100, cuDNN runs float32 convolutions in TF32 unless told otherwise
(`torch.backends.cudnn.allow_tf32` is True by default), and cuBLAS does
too where a caller allowed it. The attack suite and the training driver
need full float32, as the JAX package's counterparts run under
`jax.default_matmul_precision("highest")`: gradient matching stalls at
TF32 / bf16 rounding (fhe_fed_tpu/attack/dlg.py:57-66). A library function
must not rely on its caller's global settings, so each entry point sets
them here and puts the caller's back afterwards.

Only the two per-backend switches are touched. `matmul.allow_tf32 =
False` is what torch.set_float32_matmul_precision("highest") does to
cuBLAS; the generic setter is not used because it also sets the CPU's
matmul precision, and restoring it after a caller that set the backends
one by one leaves a state whose generic read raises in torch >= 2.9
("mix of the legacy and new APIs").
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN, and cuDNN's deterministic algorithms
    (its backward-weight algorithms may otherwise sum in a varying order),
    inside the block; the caller's three settings restored on exit."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic = saved
