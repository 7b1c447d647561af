"""Feedforward CNN PPO on Minecraft2d, the reference's src/minecraft_cnn.py:
the whole (2, 84, 84) observation through one CNN, no LSTM; twin of
``scripts/minecraft_cnn.py``.  (The reference's policy-path /255 omission,
minecraft_cnn.py:142, is a bug and is not replicated: both heads see
consistently scaled input.)

    python -m mmtrl_tpu_torch.scripts.minecraft_cnn --num-envs 8
    python -m mmtrl_tpu_torch.scripts.minecraft_cnn --cuda False --conv-size small --total-timesteps 64
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo import make_ppo
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.models.agents import CNNAgent
from mmtrl_tpu_torch.scripts._common import (
    BasePPOArgs,
    device_from,
    field,
    ppo_config_from,
    seeded,
)


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("minecraft_cnn", "the name of this experiment")
    env_id: str = field("minecraft", "the id of the environment")
    num_envs: int = field(4, "parallel envs")


def make_agent(args, env, device) -> CNNAgent:
    """The run's agent, its parameters initialised from ``--seed``."""
    return seeded(args.seed, device, lambda: CNNAgent(
        num_actions=env.num_actions, conv_type=args.conv_size, input_scale=args.input_scale,
        in_channels=env.observation_space.shape[0], device=device))


def build(args):
    """(algorithm, run config, device) of a run."""
    device = device_from(args)
    env = make(args.env_id, device=device)
    cfg = ppo_config_from(args)
    return make_ppo(env, make_agent(args, env, device), cfg), cfg, device


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device = build(args)
    return run_training(algo, cfg, args, device)


if __name__ == "__main__":
    main()
