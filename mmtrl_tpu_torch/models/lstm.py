"""Done-masked LSTM cell; port of ``mmtrl_tpu/models/lstm.py``.

Not ``nn.LSTMCell``: the two Dense layers keep flax's names ``ih`` and
``hh``, each with its own bias, so a flax tree loads onto it one to one.
Gates split in the order i, f, g, o (sigmoid i/f/o, tanh g, no forget bias);
weights orthogonal(1.0) and biases zero like the reference's LSTM init
(src/agents.py:122-126).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.models.common import Dense

Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (B, H)


class LSTMCell(nn.Module):
    def __init__(self, in_features: int, features: int = 128, device: DeviceLike = None):
        super().__init__()
        self.features = features
        self.ih = Dense(in_features, 4 * features, scale=1.0, device=device)
        self.hh = Dense(features, 4 * features, scale=1.0, device=device)

    def forward(self, carry: Carry, x: torch.Tensor, done: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        """One step.  ``done`` (B,) is the flag that PRECEDED this input: the
        carry is reset before use, like the reference's ``(1 - d) *
        lstm_state`` masking (src/agents.py:150-156)."""
        h, c = carry
        mask = (1.0 - done.float())[:, None]
        h, c = h * mask, c * mask
        gates = self.ih(x) + self.hh(h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    @staticmethod
    def initial_carry(batch_size: int, features: int = 128, device: DeviceLike = None) -> Carry:
        z = torch.zeros((batch_size, features), dtype=torch.float32,
                        device=resolve_device(device))
        return (z, z)
