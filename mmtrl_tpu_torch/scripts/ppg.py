"""Phasic Policy Gradient, the reference's cleanrl/ppg_procgen.py; twin of
``scripts/ppg.py``.  The IMPALA CNN agent and the PPG phase structure are
the reference's; the benchmark env is ``procmaze``, the procgen-contract
distribution of generated levels (envs/procmaze.py), with the reference's
``--num-levels``/``--start-level`` train split (ppg_procgen.py:73-76).
After training on procmaze the run evaluates the policy greedily on its
train window and on the held-out window [800, 1000), prints both returns
and logs them as ``charts/train_eval_return`` and
``charts/heldout_return``.

    python -m mmtrl_tpu_torch.scripts.ppg --env-id procmaze --num-levels 200
    python -m mmtrl_tpu_torch.scripts.ppg --env-id minecraft --n-iteration 4
    python -m mmtrl_tpu_torch.scripts.ppg --cuda False --num-envs 2 --num-steps 4 --n-iteration 2 --total-timesteps 16
"""

import dataclasses

import torch

from mmtrl_tpu_torch.algos.ppo.ppg import PPGAgent, PPGConfig, cycle_config, make_ppg
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.envs.procmaze import ProcMaze
from mmtrl_tpu_torch.scripts._common import BasePPOArgs, device_from, field, seeded
from mmtrl_tpu_torch.utils.evaluate import evaluate_policy

HELD_OUT = (800, 1000)  # procmaze's held-out level window
EVAL_ENVS = 64


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


def is_procmaze(args) -> bool:
    return args.env_id.lower() == "procmaze"


def ppg_config_from(args) -> PPGConfig:
    """The JAX twin's config, field for field (it passes no ``norm_adv``,
    ``clip_vloss``, ``clip_rewards`` or ``target_kl``)."""
    if args.aux_store_dtype == "auto":
        store = "int8" if is_procmaze(args) else "bfloat16"
    else:
        store = args.aux_store_dtype
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
        aux_store_dtype=store,
    )


def make_env(args, device: torch.device) -> Environment:
    if is_procmaze(args):
        return make(args.env_id, num_levels=args.num_levels, start_level=args.start_level,
                    device=device)
    return make(args.env_id, device=device)


def make_agent(args, env, device) -> PPGAgent:
    """The run's agent, its parameters initialised from ``--seed``."""
    return seeded(args.seed, device, lambda: PPGAgent(
        env.num_actions, env.observation_space.shape, device=device))


def build(args):
    """(algorithm, run config, device) of a run: one ``train_iteration`` is a
    PPG cycle of n_iteration rollouts, and the run config counts cycles."""
    device = device_from(args)
    env = make_env(args, device)
    cfg = ppg_config_from(args)
    return make_ppg(env, make_agent(args, env, device), cfg), cycle_config(cfg), device


def generalization(args, model: torch.nn.Module, device: torch.device):
    """The procgen generalization metric (ppg_procgen.py's purpose): the
    greedy policy's mean episodic return on the train level window and on
    the disjoint held-out window, 64 envs x ``--eval-rollout-steps`` each.
    Returns ({"train": ..., "test": ...}, the two evaluations' metrics)."""
    tr_lo, tr_hi = args.start_level, args.start_level + args.num_levels
    if max(tr_lo, HELD_OUT[0]) < min(tr_hi, HELD_OUT[1]):
        raise SystemExit(
            f"train levels [{tr_lo},{tr_hi}) overlap the held-out "
            "window [800,1000) — shrink --num-levels/--start-level"
        )
    test_env = ProcMaze(num_levels=HELD_OUT[1] - HELD_OUT[0], start_level=HELD_OUT[0],
                        device=device)
    res, metrics = {}, {}
    for i, (tag, env) in enumerate((("train", make_env(args, device)), ("test", test_env))):
        generator = torch.Generator(device=device).manual_seed(args.seed + 1000 + i)
        m = evaluate_policy(env, model, generator, num_envs=EVAL_ENVS,
                            num_steps=args.eval_rollout_steps)
        res[tag] = float(m["eval/episodic_return"])
        metrics[tag] = m
        print(f"procmaze {tag} levels: return={res[tag]:.2f} over "
              f"{int(m['eval/episodes'])} episodes")
    return res, metrics


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device = build(args)
    out = run_training(algo, cfg, args, device)
    if is_procmaze(args):
        res, _ = generalization(args, out["runner"].model, device)
        out["generalization"] = res
        # the split in TensorBoard, so a tuner can optimise the held-out
        # return (the reference's tuner reads TB scalars back)
        w = MetricsWriter(out["run_name"])
        w.scalar("charts/heldout_return", res["test"], out["global_step"])
        w.scalar("charts/train_eval_return", res["train"], out["global_step"])
        w.close()
    return out


if __name__ == "__main__":
    main()
