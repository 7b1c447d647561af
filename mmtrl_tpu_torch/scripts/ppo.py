"""PPO on classic control, the reference's cleanrl/ppo.py; twin of
``scripts/ppo.py``.  The generic feedforward PPO
(``algos/ppo/core.py::make_ppo``) with the 64-64 tanh actor and critic
(``MLPActorCritic``) on a classic env on the card; raw rewards
(``--clip-rewards`` False).  Same CLI and defaults as the JAX script;
``--capture-video`` records greedy episodes (the argmax of the logits) as
GIFs under ``videos/<run_name>/``.

    python -m mmtrl_tpu_torch.scripts.ppo --env-id CartPole-v1 --total-timesteps 500000
    python -m mmtrl_tpu_torch.scripts.ppo --cuda False --env-id Acrobot-v1 --total-timesteps 2048
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo import make_ppo
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.models.agents import MLPActorCritic
from mmtrl_tpu_torch.scripts._common import (
    BasePPOArgs,
    device_from,
    field,
    ppo_config_from,
    seeded,
)


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("ppo", "the name of this experiment")
    clip_rewards: bool = field(False, "classic control uses raw rewards")


def make_agent(args, env, device) -> MLPActorCritic:
    """The run's agent, its parameters initialised from ``--seed``."""
    return seeded(args.seed, device, lambda: MLPActorCritic(
        env.num_actions, env.observation_space.shape[0], device=device))


def build(args):
    """(algorithm, run config, device) of a run."""
    device = device_from(args)
    env = make(args.env_id, device=device)
    cfg = ppo_config_from(args)
    return make_ppo(env, make_agent(args, env, device), cfg), cfg, device


def video_policy(model, obs, done, carry, generator):
    """The greedy step: the argmax of the logits."""
    logits, _ = model(obs)
    return logits.argmax(-1), carry


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device = build(args)
    video_setup = (algo.env, video_policy, lambda rs: rs.model,
                   None) if args.capture_video else None
    return run_training(algo, cfg, args, device, video_setup=video_setup)


if __name__ == "__main__":
    main()
