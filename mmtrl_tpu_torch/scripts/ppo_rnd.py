"""PPO + Random Network Distillation, the reference's
cleanrl/ppo_rnd_envpool.py, on the batched envs; twin of
``scripts/ppo_rnd.py``.

    python -m mmtrl_tpu_torch.scripts.ppo_rnd --env-id minecraft
    python -m mmtrl_tpu_torch.scripts.ppo_rnd --cuda False --num-envs 2 --num-steps 8 --total-timesteps 32
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo.rnd import RNDAgent, RNDConfig, RNDNetwork, make_rnd_ppo
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.scripts._common import BasePPOArgs, device_from, field, seeded


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("ppo_rnd", "the name of this experiment")
    env_id: str = field("minecraft", "the id of the environment")
    num_envs: int = field(8, "parallel envs")
    int_coef: float = field(1.0, "intrinsic advantage coefficient")
    ext_coef: float = field(2.0, "extrinsic advantage coefficient")
    int_gamma: float = field(0.99, "intrinsic discount")
    update_proportion: float = field(0.25, "predictor batch fraction")


def rnd_config_from(args) -> RNDConfig:
    """The JAX twin's config: ``--clip-vloss`` and ``--target-kl`` are not
    passed (RND's loss reads neither)."""
    return RNDConfig(
        total_timesteps=args.total_timesteps,
        learning_rate=args.learning_rate,
        num_envs=args.num_envs,
        num_steps=args.num_steps,
        anneal_lr=args.anneal_lr,
        gamma=args.gamma,
        gae_lambda=args.gae_lambda,
        num_minibatches=args.num_minibatches,
        update_epochs=args.update_epochs,
        norm_adv=args.norm_adv,
        clip_coef=args.clip_coef,
        ent_coef=args.ent_coef,
        vf_coef=args.vf_coef,
        max_grad_norm=args.max_grad_norm,
        clip_rewards=args.clip_rewards,
        int_coef=args.int_coef,
        ext_coef=args.ext_coef,
        int_gamma=args.int_gamma,
        update_proportion=args.update_proportion,
    )


def make_agent(args, env, device):
    """The run's (agent, target, predictor), initialised from ``--seed``;
    the agent at input scale 1, as the JAX twin builds it."""
    shape = env.observation_space.shape
    return seeded(args.seed, device, lambda: (
        RNDAgent(env.num_actions, shape, device=device),
        RNDNetwork(shape, device=device),
        RNDNetwork(shape, predictor=True, device=device)))


def build(args):
    """(algorithm, run config, device) of a run."""
    device = device_from(args)
    env = make(args.env_id, device=device)
    cfg = rnd_config_from(args)
    model, target, predictor = make_agent(args, env, device)
    return make_rnd_ppo(env, model, cfg, target, predictor), cfg, device


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device = build(args)
    return run_training(algo, cfg, args, device)


if __name__ == "__main__":
    main()
