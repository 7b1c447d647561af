"""TD3; port of ``mmtrl_tpu/algos/offpolicy/td3.py`` (the reference's
cleanrl/td3_continuous_action(_jax).py:187-244): DDPG's fused loop
(``ddpg.make_actor_critic_loop``) with twin critics trained against the
smaller of their two target Qs, target-policy smoothing (normals times
``policy_noise``, clipped to ``noise_clip``, scaled to the action space)
and the actor, on the first critic, delayed to every
``policy_frequency`` steps with the Polyak sync of all three targets."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mmtrl_tpu_torch.algos.offpolicy.ddpg import (
    ActionSpace,
    ActorCriticAlgo,
    ActorCriticState,
    bootstrap,
    critic_step,
    deterministic_greedy,
    make_actor_critic_loop,
    noisy_explore,
    zeros_of,
)
from mmtrl_tpu_torch.algos.offpolicy.dqn import Batch, adam_step, create_dqn_state, sync_target
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.models.distributions import standard_normal


@dataclasses.dataclass
class TD3Config:
    """Field for field the JAX ``TD3Config`` and its defaults."""

    total_timesteps: int = 1_000_000
    learning_rate: float = 3e-4
    num_envs: int = 1
    buffer_size: int = 131_072
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    exploration_noise: float = 0.1
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    learning_starts: int = 25_000
    policy_frequency: int = 2
    steps_per_iteration: int = 512

    @property
    def num_iterations(self) -> int:
        return self.total_timesteps // (self.steps_per_iteration * self.num_envs)


def make_td3(env: Environment, actor: nn.Module, qf1: nn.Module, qf2: nn.Module,
             cfg: TD3Config) -> ActorCriticAlgo:
    """TD3's fused loop; ``actor`` a ``DeterministicActor``, ``qf1`` and
    ``qf2`` two ``QFunction``s initialised apart, on the env's device; each
    target starts as a copy of its network."""
    space = ActionSpace.of(env)
    names = ("losses/qf_loss", "losses/actor_loss", "losses/qf1_values")

    def make_state():
        return ActorCriticState(actor=create_dqn_state(actor, cfg.learning_rate),
                                critics=(create_dqn_state(qf1, cfg.learning_rate),
                                         create_dqn_state(qf2, cfg.learning_rate)))

    def update(ts: ActorCriticState, batch: Batch, step_idx: int, draws=None, generator=None):
        q1, q2 = ts.critics
        with torch.no_grad():
            smooth = standard_normal(generator, batch["action"],
                                     None if draws is None else draws.target_noise)
            noise = torch.clamp(smooth * cfg.policy_noise, -cfg.noise_clip,
                                cfg.noise_clip) * space.scale
            next_obs = batch["next_obs"]
            next_a = torch.clamp(ts.actor.target(next_obs) + noise, space.low, space.high)
            target = bootstrap(cfg.gamma, batch, torch.minimum(q1.target(next_obs, next_a),
                                                               q2.target(next_obs, next_a)))
        l1, q_mean = critic_step(q1, batch, target)
        l2, _ = critic_step(q2, batch, target)
        a_loss = torch.zeros_like(l1)
        if step_idx % cfg.policy_frequency == 0:
            loss = -q1.model(batch["obs"], ts.actor.model(batch["obs"])).mean()
            adam_step(ts.actor, loss)
            for net in (ts.actor, q1, q2):
                sync_target(net, cfg.tau)
            a_loss = loss.detach()
        return ts, dict(zip(names, (l1 + l2, a_loss, q_mean)))

    return make_actor_critic_loop(env, cfg, space, make_state,
                                  noisy_explore(cfg.exploration_noise), deterministic_greedy,
                                  update, lambda ts: zeros_of(ts, *names))
