"""Parameter-sharing multi-agent PPO, the reference's
cleanrl/ppo_pettingzoo_ma_atari.py structure on the two-agent Minecraft2d;
twin of ``scripts/ppo_ma_minecraft.py``.  One shared policy is batched over
every agent slot, each slot's observation carrying an agent-indicator
channel (the SuperSuit agent_indicator pattern, reference :150-159).  The
PPO batch is 2 x ``--num-envs`` slots, so ``global_step`` counts
slot-steps.  As in the JAX twin, the agent is ``CNNAgent`` at its defaults
(big tower, input scale 255): ``--conv-size`` and ``--input-scale`` are
not read.

    python -m mmtrl_tpu_torch.scripts.ppo_ma_minecraft --num-envs 4
    python -m mmtrl_tpu_torch.scripts.ppo_ma_minecraft --cuda False --num-envs 2 --num-steps 8 --total-timesteps 64
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo import make_ppo
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.minecraft2d_ma import NUM_AGENTS, MultiAgentMinecraft2d
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
    exp_name: str = field("ppo_ma_minecraft", "the name of this experiment")
    env_id: str = field("minecraft_ma", "the id of the environment")
    num_envs: int = field(4, "parallel JOINT envs (each holds 2 agent slots)")


def make_agent(args, env, device) -> CNNAgent:
    """The run's agent, its parameters initialised from ``--seed``."""
    return seeded(args.seed, device, lambda: CNNAgent(
        num_actions=env.num_actions, in_channels=env.observation_space.shape[0],
        device=device))


def build(args):
    """(algorithm, run config, device) of a run."""
    device = device_from(args)
    env = MultiAgentMinecraft2d(device=device)
    # Parameter sharing: the PPO batch dim is num_envs * num_agents slots.
    cfg = ppo_config_from(args, num_envs=args.num_envs * NUM_AGENTS)
    return make_ppo(env, make_agent(args, env, device), cfg), cfg, device


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device = build(args)
    return run_training(algo, cfg, args, device)


if __name__ == "__main__":
    main()
