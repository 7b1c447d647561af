"""Phasic Policy Gradient, the reference's cleanrl/ppg_procgen.py; twin of
``scripts/ppg.py``.  The IMPALA CNN agent and the PPG phase structure are
the reference's.  The JAX twin's ``procmaze`` env (and the train/held-out
evaluation that only it runs) is not ported yet: ``--env-id procmaze``
raises, naming ROADMAP A.7.

    python -m mmtrl_tpu_torch.scripts.ppg --env-id minecraft --n-iteration 4
    python -m mmtrl_tpu_torch.scripts.ppg --cuda False --num-envs 2 --num-steps 4 --n-iteration 2 --total-timesteps 16
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo.ppg import PPGAgent, PPGConfig, cycle_config, make_ppg
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.scripts._common import BasePPOArgs, device_from, field, seeded

PROCMAZE = ("procmaze and its train/held-out evaluation are not ported yet "
            "(ROADMAP A.7)")


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("ppg", "the name of this experiment")
    env_id: str = field("minecraft", "the id of the environment")
    num_envs: int = field(8, "parallel envs")
    num_steps: int = field(64, "rollout length")
    n_iteration: int = field(32, "policy-phase rollouts per PPG cycle")
    e_policy: int = field(1, "policy epochs per rollout")
    e_auxiliary: int = field(6, "auxiliary epochs per cycle")
    beta_clone: float = field(1.0, "KL clone coefficient")
    num_aux_minibatches: int = field(4, "aux-phase minibatches")
    clip_rewards: bool = field(False, "PPG uses raw rewards")
    num_levels: int = field(200, "procgen-style train-level count (procmaze)")
    start_level: int = field(0, "procgen-style first train level (procmaze)")
    aux_store_dtype: str = field(
        "auto",
        "aux-phase obs storage dtype: 'auto' (int8 for procmaze, whose "
        "{-1,+1} planes it stores exactly; bfloat16 otherwise), or an "
        "explicit dtype",
    )
    eval_rollout_steps: int = field(
        512,
        "greedy-eval rollout length per env for the procmaze train/held-out "
        "generalization split (longer = more episodes = lower eval variance)",
    )


def ppg_config_from(args) -> PPGConfig:
    """The JAX twin's config, field for field (it passes no ``norm_adv``,
    ``clip_vloss``, ``clip_rewards`` or ``target_kl``)."""
    return PPGConfig(
        total_timesteps=args.total_timesteps,
        learning_rate=args.learning_rate,
        num_envs=args.num_envs,
        num_steps=args.num_steps,
        anneal_lr=args.anneal_lr,
        gamma=args.gamma,
        gae_lambda=args.gae_lambda,
        num_minibatches=args.num_minibatches,
        update_epochs=args.update_epochs,
        clip_coef=args.clip_coef,
        ent_coef=args.ent_coef,
        vf_coef=args.vf_coef,
        max_grad_norm=args.max_grad_norm,
        n_iteration=args.n_iteration,
        e_policy=args.e_policy,
        e_auxiliary=args.e_auxiliary,
        beta_clone=args.beta_clone,
        num_aux_minibatches=args.num_aux_minibatches,
        aux_store_dtype="bfloat16" if args.aux_store_dtype == "auto" else args.aux_store_dtype,
    )


def make_agent(args, env, device) -> PPGAgent:
    """The run's agent, its parameters initialised from ``--seed``."""
    return seeded(args.seed, device, lambda: PPGAgent(
        env.num_actions, env.observation_space.shape, device=device))


def build(args):
    """(algorithm, run config, device) of a run: one ``train_iteration`` is a
    PPG cycle of n_iteration rollouts, and the run config counts cycles."""
    if args.env_id.lower() == "procmaze":
        raise NotImplementedError(PROCMAZE)
    device = device_from(args)
    env = make(args.env_id, device=device)
    cfg = ppg_config_from(args)
    return make_ppg(env, make_agent(args, env, device), cfg), cycle_config(cfg), device


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device = build(args)
    return run_training(algo, cfg, args, device)


if __name__ == "__main__":
    main()
