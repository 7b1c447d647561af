"""Shared network building blocks; port of ``mmtrl_tpu/models/common.py``.

Parameters are float32 and keep flax's names and auto-numbering
(``Conv_0``, ``Dense_0``) so ``convert.dt_params_from_flax`` maps a flax
tree onto them one to one.  As flax does with ``dtype=``, each layer runs
in the dtype of its input and casts its float32 parameters to it, and adds
the bias after the product, so a bf16 layer rounds twice as flax's does.  Init
follows the reference's CleanRL convention: orthogonal weights, zero biases.

Layout is NCHW, PyTorch's own; ``AtariTower`` and ``ImpalaTower`` permute
to NHWC before their flatten so ``Dense_0``'s rows line up with the JAX
towers'.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


class SameConv(nn.Conv2d):
    """flax ``nn.Conv(features, (3, 3), padding="SAME")`` with flax's default
    init, as the IMPALA trunk uses it: lecun-normal weight (a normal of
    variance 1 / fan_in truncated at two standard deviations), zero bias;
    runs in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, device: DeviceLike = None):
        super().__init__(in_channels, out_channels, 3, padding=1, device=resolve_device(device))
        std = math.sqrt(1.0 / (in_channels * 9)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, padding=1)
        return y + self.bias.to(x.dtype)[:, None, None]


# (widths, kernels, strides) per tower size (the reference's conv_factory,
# src/agents.py:30-55).
TOWER_SPECS = {
    "big": ((32, 64, 64), (8, 4, 3), (4, 2, 1)),
    "small": ((16, 32), (8, 4), (4, 2)),
}


class AtariTower(nn.Module):
    """The Nature-CNN tower, 'big' (512-d) or 'small' (256-d).

    Input (N, C, 84, 84) scaled by the caller; output (N, feature_size),
    ``features`` when given (the google variant's big trunk projected to
    256, src/minecraft_lstm_google.py:36-59).  ``Conv_0`` is a plain 8x8
    stride-4 conv on the (F, C, 8, 8) weight: the JAX tower's
    space-to-depth rewrite of it is an exact rewrite for the TPU's lanes,
    not another function.
    """

    def __init__(self, size: str = "big", in_channels: int = 1, device: DeviceLike = None,
                 features: Optional[int] = None):
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
        self.feature_size = features or (512 if size == "big" else 256)
        self.Dense_0 = Dense(c * hw * hw, self.feature_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten NHWC
        return F.relu(self.Dense_0(x))


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``: the
    output is ceil(n / 2) wide and the padding, -inf, goes where XLA puts
    it, its odd element after the input: (0, 1) at 84 and 42, (1, 1) at 21.
    ``nn.MaxPool2d(3, 2, padding=1)`` would pad (1, 1) at every size and
    shift every window at the even ones."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), 3, 2)


class ResidualBlock(nn.Module):
    """IMPALA residual block (the reference's ppg_procgen.py:122)."""

    def __init__(self, channels: int, device: DeviceLike = None):
        super().__init__()
        self.Conv_0 = SameConv(channels, channels, device)
        self.Conv_1 = SameConv(channels, channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.Conv_1(F.relu(self.Conv_0(F.relu(x))))


class ConvSequence(nn.Module):
    """IMPALA conv + maxpool + 2 residual blocks (ppg_procgen.py:141)."""

    def __init__(self, in_channels: int, channels: int, device: DeviceLike = None):
        super().__init__()
        self.Conv_0 = SameConv(in_channels, channels, device)
        self.ResidualBlock_0 = ResidualBlock(channels, device)
        self.ResidualBlock_1 = ResidualBlock(channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_same(self.Conv_0(x))
        return self.ResidualBlock_1(self.ResidualBlock_0(x))


class ImpalaTower(nn.Module):
    """IMPALA CNN trunk (the reference's PPG/Procgen encoder): input
    (N, C, 84, 84) scaled by the caller, output (N, hidden)."""

    def __init__(self, in_channels: int, channel_seq: Sequence[int] = (16, 32, 32),
                 hidden: int = 256, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        c, hw = in_channels, IMG
        for i, ch in enumerate(channel_seq):
            self.add_module(f"ConvSequence_{i}", ConvSequence(c, ch, device))
            c, hw = ch, -(-hw // 2)
        self.n_seqs = len(channel_seq)
        self.feature_size = hidden
        self.Dense_0 = Dense(c * hw * hw, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_seqs):
            x = getattr(self, f"ConvSequence_{i}")(x)
        x = F.relu(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))  # flatten NHWC
        return F.relu(self.Dense_0(x))


class MLPTower(nn.Module):
    """MLP trunk for vector observations, tanh or relu (the reference's
    classic control agents, cleanrl/ppo.py)."""

    ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu}

    def __init__(self, in_features: int, widths: Sequence[int] = (64, 64),
                 activation: str = "tanh", device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.act = self.ACTIVATIONS[activation]
        for i, w in enumerate(widths):
            self.add_module(f"Dense_{i}", Dense(in_features, w, device=device))
            in_features = w
        self.n_layers = len(widths)
        self.feature_size = in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = self.act(getattr(self, f"Dense_{i}")(x))
        return x
