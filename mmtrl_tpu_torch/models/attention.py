"""Crossmodal attention and fusion modules; port of
``mmtrl_tpu/models/attention.py``.

- ``CaslAttention``: ``softmax(W(tanh(Wv v + Wa a + Wh h)))`` over the two
  modalities, each modality's features scaled by its weight
  (src/agents.py:58-75).
- ``NewAttention``: ``softmax(W(tanh(FC([v; a; h]))))`` (src/agents.py:78-90).
- ``SigmoidGate``: ``w = sigmoid(MLP([v; a]))``; returns ``v*w``,
  ``a*(1-w)`` and the scalar gate, which the agent concatenates onto the
  LSTM output (src/minecraft_lstm_attention.py:59-104).

Each returns (scaled video, scaled audio, weights).  Layer names are
flax's, so a flax tree loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mmtrl_tpu_torch import DeviceLike
from mmtrl_tpu_torch.models.common import Dense

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class CaslAttention(nn.Module):
    def __init__(self, video_features: int, audio_features: int, state_features: int,
                 hidden: int = 32, device: DeviceLike = None):
        super().__init__()
        self.video_fc = Dense(video_features, hidden, scale=1.0, device=device)
        self.audio_fc = Dense(audio_features, hidden, scale=1.0, device=device)
        self.state_fc = Dense(state_features, hidden, scale=1.0, device=device)
        self.attention = Dense(hidden, 2, scale=1.0, device=device)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, h: torch.Tensor) -> Out:
        act = torch.tanh(self.video_fc(video) + self.audio_fc(audio) + self.state_fc(h))
        weights = torch.softmax(self.attention(act), dim=-1)
        return weights[:, 0:1] * video, weights[:, 1:2] * audio, weights


class NewAttention(nn.Module):
    def __init__(self, video_features: int, audio_features: int, state_features: int,
                 hidden: int = 128, device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = Dense(video_features + audio_features + state_features, hidden,
                             scale=1.0, device=device)
        self.attention = Dense(hidden, 2, scale=1.0, device=device)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, h: torch.Tensor) -> Out:
        act = torch.tanh(self.Dense_0(torch.cat([video, audio, h], dim=-1)))
        weights = torch.softmax(self.attention(act), dim=-1)
        return weights[:, 0:1] * video, weights[:, 1:2] * audio, weights


class SigmoidGate(nn.Module):
    def __init__(self, video_features: int, audio_features: int, hidden: int = 512,
                 device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = Dense(video_features + audio_features, hidden, device=device)
        self.Dense_1 = Dense(hidden, 1, device=device)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, h: torch.Tensor) -> Out:
        x = torch.relu(self.Dense_0(torch.cat([video, audio], dim=-1)))
        gate = torch.sigmoid(self.Dense_1(x))  # (B, 1)
        return gate * video, (1.0 - gate) * audio, gate
