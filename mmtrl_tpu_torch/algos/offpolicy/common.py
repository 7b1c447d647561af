"""What the off-policy trainers share; port of
``mmtrl_tpu/algos/offpolicy/common.py``: the runner of the fused device
loops, one env step's store into the replay buffer, the draws a test can
replay, and the exploration schedule."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mmtrl_tpu_torch.algos.ppo.core import load_runner_payload, runner_payload
from mmtrl_tpu_torch.core.metrics import EpisodeStatistics

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class OffPolicyRunner:
    """Everything an iteration of a fused off-policy loop carries.  The
    global step is a host integer (JAX keeps a device scalar): the cadence,
    epsilon and PER's beta are read from it with no copy from the device."""

    train_state: Any  # the algorithm's train state (DQNTrainState, ActorCriticState)
    buffer: Any  # ReplayBuffer or PrioritizedReplayBuffer
    env_state: Any
    obs: torch.Tensor  # (num_envs, ...) current observation
    global_step: int  # env steps taken, num_envs a step
    stats: EpisodeStatistics
    generator: torch.Generator

    def payload(self) -> Dict[str, Any]:
        """The whole runner as plain CPU tensors, numbers and dicts: the
        network, target and Adam state, the replay buffer (with PER's tree
        and largest priority), the env state, the statistics and the
        generator's state, so a resume continues bit for bit."""
        return runner_payload(self)

    def load_payload(self, payload: Dict[str, Any]) -> "OffPolicyRunner":
        return load_runner_payload(self, payload)


class StepDraws(NamedTuple):
    """One step's draws, for a test to replay another implementation's:
    the random actions, the uniforms compared with epsilon, and for the
    update (None when the step does not train, or to draw from the
    generator) the replay indices, or the descent's uniforms under PER."""

    random_action: torch.Tensor
    explore_u: torch.Tensor
    sample_idx: Optional[torch.Tensor]


def step_env(env, runner: OffPolicyRunner, action: torch.Tensor
             ) -> Tuple[OffPolicyRunner, Dict[str, torch.Tensor]]:
    """Step every env with ``action`` and update the episode statistics:
    the runner after the step (its global step and buffer as they were)
    and the transitions to store.  SB3's ``handle_timeout_termination``
    (the reference's replay path): a time-limit truncation is stored as not
    done, so the update bootstraps through it, with the true
    post-transition observation (``final_obs``, before the auto-reset)."""
    next_obs, env_state, reward, done, info = env.step(runner.env_state, action,
                                                        runner.generator)
    stats = runner.stats.update(reward, done)
    truncated = info.get("truncated", torch.zeros_like(done))
    transition = dict(obs=runner.obs, action=action, reward=reward,
                      next_obs=info.get("final_obs", next_obs), done=(done & ~truncated).float())
    return dataclasses.replace(runner, env_state=env_state, obs=next_obs, stats=stats), transition


def store_transition(env, runner: OffPolicyRunner, action: torch.Tensor) -> OffPolicyRunner:
    """``step_env``, then the transitions stored and the global step
    advanced."""
    runner, transition = step_env(env, runner, action)
    runner.buffer.add_batch(transition, action.shape[0])
    return dataclasses.replace(runner, global_step=runner.global_step + action.shape[0])


def linear_epsilon(start_e: float, end_e: float, duration: float, step: int) -> np.float32:
    """The reference's linear schedule for epsilon-greedy (cleanrl/dqn.py),
    as the compiled JAX step computes it: the float32 slope times the step
    plus ``start_e`` rounded once to float32 (XLA fuses the two into one
    multiply-add), so a uniform draw falls on the same side of it."""
    slope = float(np.float32((end_e - start_e) / duration))
    return max(np.float32(slope * step + start_e), np.float32(end_e))
