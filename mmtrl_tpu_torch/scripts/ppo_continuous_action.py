"""PPO with a diagonal-Gaussian policy, the reference's
cleanrl/ppo_continuous_action.py; twin of ``scripts/ppo_continuous_action.py``.
``algos/ppo/core.py::make_continuous_ppo`` with ``ContinuousActorCritic``
(64-64 tanh actor and critic, a state-independent log-std) on a registry
env on the card, under the reference's wrapper stack: ``ClipAction``,
``NormalizeObservation`` and ``NormalizeReward`` (each a flag), per-env
statistics.  Any other id (MuJoCo's HalfCheetah-v4, Hopper-v4, ...) runs
``--num-envs`` gymnasium envs on the host (``envs/gym_bridge.py::GymPool``,
which needs the gymnasium package) under gymnasium's own wrapper stack
when ``--norm-obs`` or ``--norm-reward`` is set; each step then copies the
action to the host and the results back.  Same CLI and defaults as the
JAX script.

    python -m mmtrl_tpu_torch.scripts.ppo_continuous_action --env-id Pendulum-v1
    python -m mmtrl_tpu_torch.scripts.ppo_continuous_action --cuda False --num-envs 2 \\
        --num-steps 64 --num-minibatches 2 --update-epochs 2 --total-timesteps 256
    python -m mmtrl_tpu_torch.scripts.ppo_continuous_action --cuda False --env-id HalfCheetah-v4 \\
        --num-envs 2 --num-steps 64 --num-minibatches 2 --update-epochs 2 --total-timesteps 256
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo import make_continuous_ppo
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.gym_bridge import make_any
from mmtrl_tpu_torch.envs.wrappers import ClipAction, NormalizeObservation, NormalizeReward
from mmtrl_tpu_torch.models.agents import ContinuousActorCritic
from mmtrl_tpu_torch.scripts._common import (
    BasePPOArgs,
    device_from,
    field,
    ppo_config_from,
    seeded,
)


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("ppo_continuous_action", "the name of this experiment")
    env_id: str = field("Pendulum-v1", "the id of the environment")
    total_timesteps: int = field(1000000, "total timesteps")
    learning_rate: float = field(3e-4, "learning rate")
    num_steps: int = field(2048, "rollout length")
    num_minibatches: int = field(32, "mini-batches")
    update_epochs: int = field(10, "update epochs")
    ent_coef: float = field(0.0, "entropy coefficient")
    clip_rewards: bool = field(False, "continuous control uses raw rewards")
    rpo_alpha: float = field(0.0, "RPO mean-perturbation radius (0 disables)")
    clip_action: bool = field(True, "clip actions to the action-space bounds")
    norm_obs: bool = field(True, "running mean/var observation normalization")
    norm_reward: bool = field(True, "discounted-return reward normalization")


def make_env(args, device):
    """A registry env under the flags' functional wrapper stack, normalizers
    outermost (cleanrl/ppo_continuous_action.py:90-94); any other id a
    ``GymPool`` of ``--num-envs`` host envs seeded from ``--seed``, each
    under gymnasium's reference stack when a normalizer flag is set (JAX's
    ``scripts/ppo_continuous_action.py:43-59``)."""
    env, is_bridge = make_any(
        args.env_id, num_envs=args.num_envs, seed=args.seed,
        wrap="ppo_continuous" if (args.norm_obs or args.norm_reward) else "none",
        gamma=args.gamma, device=device)
    if is_bridge:
        return env
    if args.clip_action:
        env = ClipAction(env)
    if args.norm_obs:
        env = NormalizeObservation(env)
    if args.norm_reward:
        env = NormalizeReward(env, gamma=args.gamma)
    return env


def build(args):
    """(algorithm, run config, device) of a run; the agent's parameters
    are initialised from ``--seed``."""
    device = device_from(args)
    env = make_env(args, device)
    cfg = ppo_config_from(args)
    model = seeded(args.seed, device, lambda: ContinuousActorCritic(
        env.action_space.shape[0], env.observation_space.shape[0], device=device))
    return make_continuous_ppo(env, model, cfg), cfg, device


def video_policy(model, obs, done, carry, generator):
    """The greedy step: the Gaussian's mean."""
    return model(obs)[0], carry


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device = build(args)
    video_setup = (algo.env, video_policy, lambda rs: rs.model,
                   None) if args.capture_video else None
    return run_training(algo, cfg, args, device, video_setup=video_setup)


if __name__ == "__main__":
    main()
