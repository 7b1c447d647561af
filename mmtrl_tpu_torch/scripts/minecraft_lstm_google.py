"""Google-variant multimodal PPO-LSTM, the reference's
src/minecraft_lstm_google.py; twin of ``scripts/minecraft_lstm_google.py``:
full Nature conv trunks with 256-d projections (:36-59, NOT conv_factory's
'small' towers), concat fusion into LSTM(512->128), and distinct MLP heads
with std=1 hidden inits (actor: Tanh(32) :67-71, critic: Tanh(128) :73-77).

--policy-offset: the reference parses and stores this flag
(minecraft_lstm_google.py:35) but never wires it into the forward pass.
As in the JAX twin, the documented intent is implemented: when > 0 the
action distribution is mixed toward uniform, p' = (1-o)*softmax(logits) +
o/A.  Pass --policy-offset 0 for the reference's behaviour.

    python -m mmtrl_tpu_torch.scripts.minecraft_lstm_google --policy-offset 0.5
    python -m mmtrl_tpu_torch.scripts.minecraft_lstm_google --cuda False --num-steps 8 --total-timesteps 16
"""

import dataclasses
from typing import Tuple

import torch
from torch import nn

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.algos.ppo import make_recurrent_ppo
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.models.agents import _RecurrentCore, _scan
from mmtrl_tpu_torch.models.common import AtariTower, Dense
from mmtrl_tpu_torch.models.lstm import Carry, LSTMCell
from mmtrl_tpu_torch.scripts._common import (
    BasePPOArgs,
    device_from,
    field,
    ppo_config_from,
    seeded,
)


class GoogleAgent(nn.Module):
    """Two big towers projected to 256, concat fusion, LSTM, MLP heads; the
    policy offset mixes the action distribution with uniform.  flax numbers
    the two hidden Dense layers in the order it creates them: ``Dense_0``
    (the actor's 32) and ``Dense_1`` (the critic's 128)."""

    def __init__(self, num_actions: int, policy_offset: float = 0.5, lstm_features: int = 128,
                 input_scale: float = 255.0, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.num_actions, self.policy_offset = num_actions, policy_offset
        self.lstm_features, self.input_scale = lstm_features, input_scale
        self.video_net = AtariTower("big", 1, device=device, features=256)
        self.audio_net = AtariTower("big", 1, device=device, features=256)
        self.core = _RecurrentCore(None, "concat", 256, lstm_features, device)
        # hidden layers take the std=1 orthogonal init (reference :68,74)
        self.Dense_0 = Dense(lstm_features, 32, scale=1.0, device=device)
        self.actor = Dense(32, num_actions, scale=0.01, device=device)
        self.Dense_1 = Dense(lstm_features, 128, scale=1.0, device=device)
        self.critic = Dense(128, 1, scale=1.0, device=device)

    def forward(self, obs: torch.Tensor, done: torch.Tensor,
                carry: Carry) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
        """obs (T, B, 2, 84, 84), done (T, B), carry -> logits (T, B, A),
        value (T, B), carry."""
        T, B = obs.shape[:2]
        flat = obs.reshape((T * B,) + obs.shape[2:]) / self.input_scale
        video = self.video_net(flat[:, 0:1]).reshape(T, B, -1)
        audio = self.audio_net(flat[:, 1:]).reshape(T, B, -1)
        carry, hidden = _scan(self.core, carry, (video, audio, done))
        logits = self.actor(torch.tanh(self.Dense_0(hidden)))
        if self.policy_offset > 0:
            probs = torch.softmax(logits, dim=-1)
            probs = (1.0 - self.policy_offset) * probs + self.policy_offset / self.num_actions
            logits = torch.log(probs)
        value = self.critic(torch.tanh(self.Dense_1(hidden)))[..., 0]
        return logits, value, carry

    def initial_carry(self, batch_size: int, device: DeviceLike = None) -> Carry:
        if device is None:
            device = self.actor.weight.device
        return LSTMCell.initial_carry(batch_size, self.lstm_features, device)


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("minecraft_lstm_google", "the name of this experiment")
    env_id: str = field("minecraft", "the id of the environment")
    num_envs: int = field(1, "parallel envs")
    num_minibatches: int = field(1, "mini-batches")
    update_epochs: int = field(1, "update epochs")


def make_agent(args, env, device) -> GoogleAgent:
    """The run's agent, its parameters initialised from ``--seed``.  As in
    the JAX twin, it takes its default input scale, 255, and does not read
    ``--input-scale``."""
    return seeded(args.seed, device, lambda: GoogleAgent(
        num_actions=env.num_actions, policy_offset=args.policy_offset, device=device))


def build(args):
    """(algorithm, run config, device) of a run."""
    device = device_from(args)
    env = make(args.env_id, device=device)
    cfg = ppo_config_from(args)
    return make_recurrent_ppo(env, make_agent(args, env, device), cfg), cfg, device


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device = build(args)
    return run_training(algo, cfg, args, device)


if __name__ == "__main__":
    main()
