"""CNN_OriginalFedAvg, the FedAvg paper's MNIST CNN (1,663,370 parameters),
the counterpart of fhe_fed_tpu.models.basic.cnn_fedavg_init/_apply.

conv 5x5 SAME 1->32, max-pool 2, conv 5x5 SAME 32->64, max-pool 2,
fc 3136->512, fc 512->10 (62 without only_digits), ReLUs. The feature map
is flattened in torch's NCHW (c, h, w) order, as the reference's torch
model does; the JAX model flattens NHWC (h, w, c), so carried-over fc1
weights are permuted (interop.cnn_fedavg_state_dict_from_numpy).
"""

from __future__ import annotations

import torch
from torch import nn


class CNNOriginalFedAvg(nn.Module):
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
