"""Shared network building blocks; port of ``mmtrl_tpu/models/common.py``.

Parameters are float32 and keep flax's names and auto-numbering
(``Conv_0``, ``Dense_0``) so ``convert.dt_params_from_flax`` maps a flax
tree onto them one to one.  As flax does with ``dtype=``, each layer runs
in the dtype of its input and casts its float32 parameters to it, and adds
the bias after the product, so a bf16 layer rounds twice as flax's does.  Init
follows the reference's CleanRL convention: orthogonal weights, zero biases.

Layout is NCHW, PyTorch's own; ``AtariTower`` permutes to NHWC before its
flatten so ``Dense_0``'s rows line up with the JAX tower's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mmtrl_tpu_torch import DeviceLike, resolve_device

SQRT2 = math.sqrt(2.0)
IMG = 84  # observation height and width


class Dense(nn.Linear):
    """flax ``nn.Dense``: orthogonal(scale) weight, zero bias, runs in the
    input's dtype."""

    def __init__(self, in_features: int, out_features: int, scale: float = SQRT2,
                 device: DeviceLike = None):
        super().__init__(in_features, out_features, device=resolve_device(device))
        with torch.no_grad():
            nn.init.orthogonal_(self.weight, scale)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with VALID padding: orthogonal(sqrt 2) weight, zero
    bias, runs in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 device: DeviceLike = None):
        super().__init__(in_channels, out_channels, kernel, stride,
                         device=resolve_device(device))
        with torch.no_grad():
            nn.init.orthogonal_(self.weight, SQRT2)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride)
        return y + self.bias.to(x.dtype)[:, None, None]


# (widths, kernels, strides) per tower size (the reference's conv_factory,
# src/agents.py:30-55).
TOWER_SPECS = {
    "big": ((32, 64, 64), (8, 4, 3), (4, 2, 1)),
    "small": ((16, 32), (8, 4), (4, 2)),
}


class AtariTower(nn.Module):
    """The Nature-CNN tower, 'big' (512-d) or 'small' (256-d).

    Input (N, C, 84, 84) scaled by the caller; output (N, feature_size).
    ``Conv_0`` is a plain 8x8 stride-4 conv on the (F, C, 8, 8) weight: the
    JAX tower's space-to-depth rewrite of it is an exact rewrite for the
    TPU's lanes, not another function.
    """

    def __init__(self, size: str = "big", in_channels: int = 1, device: DeviceLike = None):
        super().__init__()
        if size not in TOWER_SPECS:
            raise ValueError(f"unknown tower size {size!r}")
        device = resolve_device(device)
        widths, kernels, strides = TOWER_SPECS[size]
        c, hw = in_channels, IMG
        for i, (w, k, s) in enumerate(zip(widths, kernels, strides)):
            self.add_module(f"Conv_{i}", Conv(c, w, k, s, device=device))
            c, hw = w, (hw - k) // s + 1
        self.n_convs = len(widths)
        self.feature_size = 512 if size == "big" else 256
        self.Dense_0 = Dense(c * hw * hw, self.feature_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten NHWC
        return F.relu(self.Dense_0(x))
