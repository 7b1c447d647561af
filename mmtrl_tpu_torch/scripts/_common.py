"""Shared CLI argument surface of the entry scripts; port of
``scripts/_common.py``.

Flag for flag the reference's parse_args (src/utils.py:47-129): same names,
same defaults, same strtobool booleans.  ``--cuda`` and
``--torch-deterministic`` have the reference's own meaning here; the JAX
scripts accept and ignore them.  The JAX scripts' ``--platform`` (a JAX
backend) has no counterpart: ``--cuda`` chooses the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from mmtrl_tpu_torch import resolve_device
from mmtrl_tpu_torch.algos.ppo import PPOConfig


def field(default, help="", **kw):  # noqa: A002
    return dataclasses.field(default=default, metadata={"help": help, **kw})


@dataclasses.dataclass
class BasePPOArgs:
    exp_name: str = field("ppo", "the name of this experiment")
    seed: int = field(1, "seed of the experiment")
    torch_deterministic: bool = field(
        True, "set torch.backends.cudnn.deterministic (deterministic cuDNN algorithms)")
    cuda: bool = field(True, "run on the CUDA card (raises without one); False: on the CPU")
    track: bool = field(False, "mirror metrics to the local wandb journal (wandb_local/)")
    wandb_project_name: str = field("minecraft", "the wandb's project name")
    wandb_entity: Optional[str] = field(None, "the entity (team) of wandb's project")
    capture_video: bool = field(False, "capture videos of the agent (videos/ folder)")

    env_id: str = field("CartPole-v1", "the id of the environment")
    total_timesteps: int = field(500000, "total timesteps of the experiments")
    learning_rate: float = field(2.5e-4, "the learning rate of the optimizer")
    num_envs: int = field(4, "the number of parallel game environments")
    num_steps: int = field(128, "steps per environment per policy rollout")
    anneal_lr: bool = field(True, "toggle learning rate annealing")
    gamma: float = field(0.99, "the discount factor gamma")
    gae_lambda: float = field(0.95, "the lambda for GAE")
    num_minibatches: int = field(4, "the number of mini-batches")
    update_epochs: int = field(4, "the K epochs to update the policy")
    norm_adv: bool = field(True, "toggle advantage normalization")
    clip_coef: float = field(0.2, "the surrogate clipping coefficient")
    clip_vloss: bool = field(True, "toggle clipped value loss")
    ent_coef: float = field(0.01, "coefficient of the entropy")
    vf_coef: float = field(0.5, "coefficient of the value function")
    max_grad_norm: float = field(0.5, "max norm for gradient clipping")
    target_kl: Optional[float] = field(None, "the target KL divergence threshold")

    # MMTRL extensions (src/utils.py:103-124)
    save_interval: int = field(0, "save the run every n updates (0: never)")
    save_dir: str = field("saved_agents", "folder in which to save the run")
    load_from: str = field("", "checkpoint path from which to load the run")
    max_episode_len: int = field(10000, "maximal length of a single episode")
    policy_offset: float = field(0.5, "policy distribution offset (google variant)")
    max_episodes: int = field(1000000, "maximum number of episodes")
    attn_type: Optional[str] = field(None, "attention type: None, 'casl' or 'new'")
    fusion_type: str = field("sum", "feature fusion: 'sum' or 'concat'")
    conv_size: str = field("big", "conv tower size: 'big' or 'small'")
    print_interval: int = field(1, "print stats every so many updates")
    clip_rewards: bool = field(True, "sign-clip env rewards")
    profile: bool = field(False, "capture a torch.profiler trace of updates 3-7")
    input_scale: float = field(
        255.0,
        "observation divisor; 255 replicates the reference's double "
        "normalization quirk (agents.py:133-134), 1.0 is the sane scale",
    )


def ppo_config_from(args, **overrides) -> PPOConfig:
    base = dict(
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
        clip_vloss=args.clip_vloss,
        ent_coef=args.ent_coef,
        vf_coef=args.vf_coef,
        max_grad_norm=args.max_grad_norm,
        clip_rewards=getattr(args, "clip_rewards", False),
        rpo_alpha=getattr(args, "rpo_alpha", 0.0),
        target_kl=getattr(args, "target_kl", None),
    )
    base.update(overrides)
    return PPOConfig(**base)


def config_of(cls, args):
    """The dataclass ``cls`` from the fields of ``args`` of the same names;
    the others keep their defaults."""
    return cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cls)
                  if hasattr(args, f.name)})


def device_from(args) -> torch.device:
    """``--cuda`` (the default) -> the card, raising without one; else the
    CPU.  Applies ``--torch-deterministic`` as the reference does."""
    torch.backends.cudnn.deterministic = bool(getattr(args, "torch_deterministic", True))
    return resolve_device(None if args.cuda else "cpu")


def seeded(seed: int, device: torch.device, build: Callable[[], nn.Module]) -> nn.Module:
    """``build()`` with the global RNG seeded from ``seed`` for the
    parameter init, the caller's RNG state left as it was."""
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        return build()
