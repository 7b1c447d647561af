"""Trained-policy evaluation, the reference's cleanrl_utils/evals role;
port of ``mmtrl_tpu/utils/evaluate.py``.

Runs a policy greedily (or sampling) in the batched env on the model's
device for a fixed number of steps and reports episode statistics.  Works
with feedforward ``model(obs) -> (logits, value, ...)`` and recurrent
``model(obs[T, B], done[T, B], carry) -> (logits, value, carry)`` agents.
One ``torch.Generator`` drives the reset draws and, when sampling, the
actions.  ``evaluate_actions`` is the off-policy trainers' final greedy
evaluation, generic over the action rule.  The env is a device env or a
native pool (``envs/skeleton_native.py``), whose ``reset``/``step`` cross
to the host each step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from mmtrl_tpu_torch.core.metrics import EpisodeStatistics
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.models.distributions import categorical_sample


@torch.no_grad()
def evaluate_policy(
    env: Environment,
    model: nn.Module,
    generator: torch.Generator,
    num_envs: int = 16,
    num_steps: int = 256,
    greedy: bool = True,
    recurrent: bool = False,
    initial_carry: Optional[Any] = None,
) -> Dict[str, torch.Tensor]:
    obs, env_state = env.reset(num_envs, generator)
    done = torch.zeros(num_envs, dtype=torch.bool, device=obs.device)
    stats = EpisodeStatistics.create(num_envs, obs.device)
    carry = initial_carry
    for _ in range(num_steps):
        if recurrent:
            logits, _, carry = model(obs[None], done[None], carry)
            logits = logits[0]
        else:
            logits = model(obs)[0]
        action = logits.argmax(dim=-1) if greedy else categorical_sample(generator, logits)
        obs, env_state, reward, done, _ = env.step(env_state, action, generator)
        stats = stats.update(reward, done)
    return {
        "eval/episodic_return": stats.mean_return,
        "eval/episodic_length": stats.mean_length,
        "eval/episodes": stats.episode_count,
    }


@torch.no_grad()
def evaluate_actions(
    env: Environment,
    act_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    num_envs: int = 16,
    num_steps: int = 1000,
) -> Dict[str, torch.Tensor]:
    """``num_steps`` steps of ``num_envs`` envs under ``act_fn(obs) ->
    action``: argmax-Q for DQN, the expected-Q argmax for C51.  A native
    pool has a fixed size, which replaces ``num_envs``.  Episode returns
    take the env's ``raw_reward`` where it reports one."""
    num_envs = getattr(env, "num_envs", num_envs)  # a native pool's fixed size
    obs, env_state = env.reset(num_envs, generator)
    stats = EpisodeStatistics.create(num_envs, obs.device)
    for _ in range(num_steps):
        obs, env_state, reward, done, info = env.step(env_state, act_fn(obs), generator)
        stats = stats.update(info.get("raw_reward", reward), done)
    return {
        "eval/episodic_return": stats.mean_return,
        "eval/episodic_length": stats.mean_length,
        "eval/episodes": stats.episode_count,
    }
