"""Actor-critic agents, Q networks and the continuous-control actors and
critics; port of ``MultimodalRecurrentAgent``, ``RecurrentAgent``,
``CNNAgent``, ``MLPActorCritic``, ``ContinuousActorCritic``, ``QNetwork``,
``DistributionalQNetwork``, ``QFunction``, ``DeterministicActor`` and
``SquashedGaussianActor`` of ``mmtrl_tpu/models/agents.py``.

One call of a recurrent agent takes a whole (T, B, ...) window: the
rollout passes T = 1, the PPO update the full ``num_steps`` sequence.  The
towers run on all T x B frames at once; the attention / fusion / LSTM
recurrence runs as a Python loop over T where JAX has ``nn.scan``.  Submodules are named as the flax tree nests
them (``video_net``, ``audio_net``, ``core.attn``, ``core.lstm``,
``actor``, ``critic``; ``network`` for the single tower), so
``convert.agent_params_from_flax`` loads a JAX agent with ``strict=True``.

Kept from the JAX agents:

- ``input_scale = 255``: the reference divides observations by 255 although
  the env already emits [-1, 1] (src/agents.py:133-134); 1.0 is the sane
  scale.
- ``fusion_type='concat'`` with casl or new attention raises, the
  reference's broken path (src/agents.py:138); the gate always sums.
- The gate agent concatenates the scalar gate onto the LSTM output: 129-d
  actor and critic heads (src/minecraft_lstm_attention.py:59-104).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.models.attention import CaslAttention, NewAttention, SigmoidGate
from mmtrl_tpu_torch.models.common import AtariTower, Dense, MLPTower
from mmtrl_tpu_torch.models.lstm import Carry, LSTMCell

ATTENTION = {"casl": CaslAttention, "new": NewAttention}


class _RecurrentCore(nn.Module):
    """Per-timestep recurrence: (attention ->) fusion -> masked LSTM."""

    def __init__(self, attn_type: Optional[str], fusion_type: str, features: int,
                 lstm_features: int, device: DeviceLike = None):
        super().__init__()
        if fusion_type not in ("sum", "concat"):
            raise NotImplementedError(fusion_type)
        self.attn_type, self.fusion_type = attn_type, fusion_type
        if attn_type in ATTENTION:
            self.attn = ATTENTION[attn_type](features, features, lstm_features, device=device)
        elif attn_type == "gate":
            self.attn = SigmoidGate(features, features, device=device)
        elif attn_type is not None:
            raise ValueError(f"unknown attention type {attn_type!r}")
        self.sums = fusion_type == "sum" or attn_type == "gate"
        self.lstm = LSTMCell(features if self.sums else 2 * features, lstm_features,
                             device=device)

    def forward(self, carry: Carry, video: torch.Tensor, audio: torch.Tensor,
                done: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        gate = None
        if self.attn_type is not None:
            video, audio, weights = self.attn(video, audio, carry[0])
            if self.attn_type == "gate":
                gate = weights
        fused = video + audio if self.sums else torch.cat([video, audio], dim=-1)
        carry, hidden = self.lstm(carry, fused, done)
        if gate is not None:
            hidden = torch.cat([hidden, gate], dim=-1)
        return carry, hidden


def _scan(core: nn.Module, carry: Carry, inputs) -> Tuple[Carry, torch.Tensor]:
    """``core`` over dim 0 of every input, threading the carry."""
    hidden = []
    for t in range(inputs[0].shape[0]):
        carry, h = core(carry, *(x[t] for x in inputs))
        hidden.append(h)
    return carry, torch.stack(hidden)


class _Heads(nn.Module):
    def _heads(self, hidden: int, num_actions: int, device: torch.device) -> None:
        self.actor = Dense(hidden, num_actions, scale=0.01, device=device)
        self.critic = Dense(hidden, 1, scale=1.0, device=device)

    def initial_carry(self, batch_size: int, device: DeviceLike = None) -> Carry:
        if device is None:
            device = self.actor.weight.device
        return LSTMCell.initial_carry(batch_size, self.lstm_features, device)


class MultimodalRecurrentAgent(_Heads):
    """Two CNN towers (video on channel 0, audio on channels 1:) +
    crossmodal attention + fusion + done-masked LSTM + actor/critic heads:
    the reference's MinecraftAgent (src/agents.py:93-171) and its
    sigmoid-gate variant."""

    def __init__(self, num_actions: int, conv_type: str = "big",
                 attn_type: Optional[str] = None, fusion_type: str = "sum",
                 lstm_features: int = 128, input_scale: float = 255.0,
                 audio_channels: int = 1, device: DeviceLike = None):
        super().__init__()
        if attn_type in ("casl", "new") and fusion_type == "concat":
            raise ValueError(
                "concat fusion with attention is the reference's broken path "
                "(src/agents.py:138); use fusion_type='sum'"
            )
        device = resolve_device(device)
        self.lstm_features, self.input_scale = lstm_features, input_scale
        self.video_net = AtariTower(conv_type, 1, device=device)
        self.audio_net = AtariTower(conv_type, audio_channels, device=device)
        features = self.video_net.feature_size
        self.core = _RecurrentCore(attn_type, fusion_type, features, lstm_features, device)
        self._heads(lstm_features + (attn_type == "gate"), num_actions, device)

    def forward(self, obs: torch.Tensor, done: torch.Tensor,
                carry: Carry) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
        """obs (T, B, C, 84, 84), done (T, B), carry ((B, H), (B, H)) ->
        logits (T, B, A), value (T, B), carry."""
        T, B = obs.shape[:2]
        flat = obs.reshape((T * B,) + obs.shape[2:]) / self.input_scale
        video = self.video_net(flat[:, 0:1]).reshape(T, B, -1)
        audio = self.audio_net(flat[:, 1:]).reshape(T, B, -1)
        carry, hidden = _scan(self.core, carry, (video, audio, done))
        return self.actor(hidden), self.critic(hidden)[..., 0], carry


class _PlainCore(nn.Module):
    def __init__(self, features: int, lstm_features: int, device: DeviceLike = None):
        super().__init__()
        self.lstm = LSTMCell(features, lstm_features, device=device)

    def forward(self, carry: Carry, feat: torch.Tensor, done: torch.Tensor):
        return self.lstm(carry, feat, done)


class RecurrentAgent(_Heads):
    """Single CNN tower + LSTM + heads: the reference's GymAgent/OldAgent
    (src/agents.py:174-275) and cleanrl/ppo_atari_lstm.py's Agent."""

    def __init__(self, num_actions: int, conv_type: str = "big", lstm_features: int = 128,
                 input_scale: float = 255.0, in_channels: int = 1, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.lstm_features, self.input_scale = lstm_features, input_scale
        self.network = AtariTower(conv_type, in_channels, device=device)
        self.core = _PlainCore(self.network.feature_size, lstm_features, device)
        self._heads(lstm_features, num_actions, device)

    def forward(self, obs: torch.Tensor, done: torch.Tensor,
                carry: Carry) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
        T, B = obs.shape[:2]
        flat = obs.reshape((T * B,) + obs.shape[2:]) / self.input_scale
        feat = self.network(flat).reshape(T, B, -1)
        carry, hidden = _scan(self.core, carry, (feat, done))
        return self.actor(hidden), self.critic(hidden)[..., 0], carry


class CNNAgent(nn.Module):
    """Feed-forward CNN actor-critic over the full multi-channel observation,
    the reference's minecraft_cnn.py Agent (no LSTM): obs (N, C, 84, 84) ->
    logits (N, A), value (N,).  As in the JAX agent, the ``input_scale``
    divide applies to both heads (minecraft_cnn.py:142 omits it for the
    policy, a bug not replicated)."""

    def __init__(self, num_actions: int, conv_type: str = "big", input_scale: float = 255.0,
                 in_channels: int = 2, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.input_scale = input_scale
        self.network = AtariTower(conv_type, in_channels, device=device)
        self.actor = Dense(self.network.feature_size, num_actions, scale=0.01, device=device)
        self.critic = Dense(self.network.feature_size, 1, scale=1.0, device=device)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.network(obs / self.input_scale)
        return self.actor(feat), self.critic(feat)[..., 0]


class MLPActorCritic(nn.Module):
    """Separate 64-64 tanh actor and critic for vector observations, the
    reference's cleanrl/ppo.py Agent: obs (N, obs_dim) -> logits (N, A),
    value (N,)."""

    def __init__(self, num_actions: int, obs_dim: int, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.actor_trunk = MLPTower(obs_dim, device=device)
        self.actor_out = Dense(self.actor_trunk.feature_size, num_actions, scale=0.01,
                               device=device)
        self.critic_trunk = MLPTower(obs_dim, device=device)
        self.critic_out = Dense(self.critic_trunk.feature_size, 1, scale=1.0, device=device)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.actor_out(self.actor_trunk(obs)),
                self.critic_out(self.critic_trunk(obs))[..., 0])


class ContinuousActorCritic(MLPActorCritic):
    """Gaussian policy with a state-independent log-std, and a separate
    critic: cleanrl/ppo_continuous_action.py's Agent.  obs (N, obs_dim) ->
    mean (N, A), log_std (N, A) (the ``log_std`` parameter, from zeros,
    broadcast), value (N,)."""

    def __init__(self, action_dim: int, obs_dim: int, device: DeviceLike = None):
        super().__init__(action_dim, obs_dim, device=device)
        self.log_std = nn.Parameter(torch.zeros(action_dim, device=self.actor_out.weight.device))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean, value = super().forward(obs)
        return mean, self.log_std.expand_as(mean), value


def _lecun_dense(in_features: int, out_features: int, device: torch.device) -> Dense:
    """flax ``nn.Dense`` at its default init: a lecun-normal (truncated)
    weight and a zero bias."""
    layer = Dense(in_features, out_features, device=device)
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    return layer


class _QTrunk(nn.Module):
    """The Q networks' trunk: ``AtariTower('big')`` on (C, 84, 84) images
    divided by ``input_scale`` (cleanrl/dqn_atari_jax.py), a 120-84 ReLU
    ``MLPTower`` on vectors (cleanrl/dqn.py), which are not scaled."""

    def _trunk(self, obs_shape: Sequence[int], input_scale: float,
               device: torch.device) -> int:
        self.input_scale = input_scale
        if len(obs_shape) == 3:
            self.network = AtariTower("big", obs_shape[0], device=device)
        else:
            self.network = MLPTower(obs_shape[0], (120, 84), activation="relu", device=device)
        return self.network.feature_size

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        if obs.dim() >= 4:
            obs = obs / self.input_scale
        return self.network(obs)


class QNetwork(_QTrunk):
    """DQN's Q network: obs (B, *obs_shape) -> Q values (B, A)."""

    def __init__(self, num_actions: int, input_scale: float = 255.0,
                 obs_shape: Sequence[int] = (3, 84, 84), device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.q = _lecun_dense(self._trunk(obs_shape, input_scale, device), num_actions, device)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.q(self.features(obs))


class DistributionalQNetwork(_QTrunk):
    """C51's network: obs -> per-action probabilities over ``n_atoms``
    support points, (B, A, n_atoms) (cleanrl/c51_atari_jax.py)."""

    def __init__(self, num_actions: int, n_atoms: int = 101, input_scale: float = 255.0,
                 obs_shape: Sequence[int] = (3, 84, 84), device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.num_actions, self.n_atoms = num_actions, n_atoms
        self.q = _lecun_dense(self._trunk(obs_shape, input_scale, device),
                              num_actions * n_atoms, device)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        logits = self.q(self.features(obs))
        return torch.softmax(logits.reshape(-1, self.num_actions, self.n_atoms), dim=-1)


# ---- continuous-control actors and critics (DDPG, TD3, SAC) -----------------
class QFunction(nn.Module):
    """Q(s, a): a 256-256 ReLU ``MLPTower`` on the concatenated observation
    and action, a lecun-normal output (cleanrl/ddpg_continuous_action_jax.py's
    QNetwork).  obs (B, obs_dim), action (B, A) -> (B,)."""

    def __init__(self, obs_dim: int, action_dim: int, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.MLPTower_0 = MLPTower(obs_dim + action_dim, (256, 256), activation="relu",
                                   device=device)
        self.Dense_0 = _lecun_dense(256, 1, device)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(self.MLPTower_0(torch.cat([obs, action], dim=-1)))[..., 0]


class DeterministicActor(nn.Module):
    """The tanh-squashed deterministic policy of DDPG and TD3: a 256-256
    ReLU ``MLPTower``, a lecun-normal ``Dense``, tanh, then the action
    space's scale and bias (buffers, not in the state dict, as flax keeps
    them in the module's fields).  obs (B, obs_dim) -> action (B, A)."""

    def __init__(self, obs_dim: int, action_dim: int, action_scale: Sequence[float],
                 action_bias: Sequence[float], device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.MLPTower_0 = MLPTower(obs_dim, (256, 256), activation="relu", device=device)
        self.Dense_0 = _lecun_dense(256, action_dim, device)
        for name, value in (("action_scale", action_scale), ("action_bias", action_bias)):
            self.register_buffer(name, torch.tensor(value, device=device), persistent=False)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.Dense_0(self.MLPTower_0(obs)))
        return x * self.action_scale + self.action_bias


LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


class SquashedGaussianActor(nn.Module):
    """SAC's actor: a 256-256 ReLU ``MLPTower``, lecun-normal ``mean`` and
    ``log_std`` heads, the log-std squashed by tanh into [LOG_STD_MIN,
    LOG_STD_MAX] (cleanrl/sac_continuous_action.py:110-140).  obs ->
    (mean, log_std), each (B, A); the sampler squashes and scales."""

    def __init__(self, obs_dim: int, action_dim: int, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.MLPTower_0 = MLPTower(obs_dim, (256, 256), activation="relu", device=device)
        self.mean = _lecun_dense(256, action_dim, device)
        self.log_std = _lecun_dense(256, action_dim, device)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.MLPTower_0(obs)
        log_std = torch.tanh(self.log_std(x))
        log_std = LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (log_std + 1)
        return self.mean(x), log_std
