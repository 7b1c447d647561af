"""SAC; port of ``mmtrl_tpu/algos/offpolicy/sac.py`` (the reference's
cleanrl/sac_continuous_action.py): DDPG's fused loop
(``ddpg.make_actor_critic_loop``) with twin soft-Q critics, a
tanh-squashed Gaussian actor and the temperature alpha autotuned against
the target entropy -dim(A) (reference :196-200, 279-287).

A training step: both critics against ``min(Q1', Q2') - alpha * log pi``
of a next action sampled from the current actor; every
``policy_frequency`` steps, ``policy_frequency`` passes of the actor and
then alpha, each on fresh normals (JAX folds the pass number into its
key), alpha's loss on the log-probabilities of the actor before that
pass's step and each pass's actor loss on the alpha that the pass before
left; every ``target_network_frequency`` steps the Polyak sync of both
critics' targets.  The actor has no target.  ``log_alpha`` has its own
``optax.adam`` at the critics' rate.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from mmtrl_tpu_torch.algos.offpolicy.ddpg import (
    ActionSpace,
    ActorCriticAlgo,
    ActorCriticState,
    bootstrap,
    critic_step,
    make_actor_critic_loop,
    zeros_of,
)
from mmtrl_tpu_torch.algos.offpolicy.dqn import Batch, adam_step, create_dqn_state, sync_target
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.models.distributions import squashed_normal_sample_log_prob
from mmtrl_tpu_torch.ops.fused_optim import fused_clip_adamw, init_adam_state


@dataclasses.dataclass
class SACConfig:
    """Field for field the JAX ``SACConfig`` and its defaults."""

    total_timesteps: int = 1_000_000
    q_lr: float = 1e-3
    policy_lr: float = 3e-4
    num_envs: int = 1
    buffer_size: int = 131_072
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    learning_starts: int = 5_000
    policy_frequency: int = 2
    target_network_frequency: int = 1
    alpha: float = 0.2
    autotune: bool = True
    steps_per_iteration: int = 512

    @property
    def num_iterations(self) -> int:
        return self.total_timesteps // (self.steps_per_iteration * self.num_envs)


def greedy_action(actor: nn.Module, obs: torch.Tensor, space: ActionSpace) -> torch.Tensor:
    """The evaluation's action: ``tanh(mean) * scale + bias``."""
    return torch.tanh(actor(obs)[0]) * space.scale + space.bias


def make_sac(env: Environment, actor: nn.Module, qf1: nn.Module, qf2: nn.Module,
             cfg: SACConfig) -> ActorCriticAlgo:
    """SAC's fused loop; ``actor(obs) -> (mean, log_std)``
    (``SquashedGaussianActor``), ``qf1`` and ``qf2`` two ``QFunction``s,
    on the env's device; each critic's target starts as its copy."""
    space = ActionSpace.of(env)
    target_entropy = -float(math.prod(space.shape))
    names = ("losses/qf_loss", "losses/actor_loss", "losses/qf1_values")

    def make_state():
        log_alpha = torch.log(torch.tensor(cfg.alpha, device=env.device))
        return ActorCriticState(
            actor=create_dqn_state(actor, cfg.policy_lr, with_target=False),
            critics=(create_dqn_state(qf1, cfg.q_lr), create_dqn_state(qf2, cfg.q_lr)),
            log_alpha=log_alpha, alpha_opt_state=init_adam_state([log_alpha]))

    def sample(actor_module, obs, generator, noise, sp: ActionSpace = space):
        mean, log_std = actor_module(obs)
        return squashed_normal_sample_log_prob(generator, mean, log_std, sp.scale, sp.bias,
                                               noise=noise)[:2]

    def explore(actor: nn.Module, obs: torch.Tensor, noise: torch.Tensor, sp: ActionSpace):
        return sample(actor, obs, None, noise, sp)[0]

    def actor_and_alpha(ts: ActorCriticState, obs: torch.Tensor, generator, noise):
        alpha = torch.exp(ts.log_alpha)
        a, logp = sample(ts.actor.model, obs, generator, noise)
        q1, q2 = (qf.model(obs, a) for qf in ts.critics)
        loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        adam_step(ts.actor, loss)
        if cfg.autotune:
            la = ts.log_alpha.detach().requires_grad_()
            alpha_loss = (-torch.exp(la) * (logp.detach() + target_entropy)).mean()
            (grad,) = torch.autograd.grad(alpha_loss, la)
            ts.alpha_opt_state = fused_clip_adamw([ts.log_alpha], [grad], ts.alpha_opt_state,
                                                  cfg.q_lr, weight_decay=0.0, max_grad_norm=None)
        return loss.detach()

    def update(ts: ActorCriticState, batch: Batch, step_idx: int, draws=None, generator=None):
        q1, q2 = ts.critics
        next_obs = batch["next_obs"]
        with torch.no_grad():
            next_a, next_logp = sample(ts.actor.model, next_obs, generator,
                                       None if draws is None else draws.target_noise)
            soft_next = (torch.minimum(q1.target(next_obs, next_a), q2.target(next_obs, next_a))
                         - torch.exp(ts.log_alpha) * next_logp)
            target = bootstrap(cfg.gamma, batch, soft_next)
        l1, q_mean = critic_step(q1, batch, target)
        l2, _ = critic_step(q2, batch, target)
        a_loss = torch.zeros_like(l1)
        if step_idx % cfg.policy_frequency == 0:
            for i in range(cfg.policy_frequency):
                noise = None if draws is None or draws.actor_noise is None else draws.actor_noise[i]
                a_loss = actor_and_alpha(ts, batch["obs"], generator, noise)
        if step_idx % cfg.target_network_frequency == 0:
            sync_target(q1, cfg.tau)
            sync_target(q2, cfg.tau)
        metrics = dict(zip(names, (l1 + l2, a_loss, q_mean)))
        metrics["losses/alpha"] = torch.exp(ts.log_alpha)
        return ts, metrics

    def zero_metrics(ts: ActorCriticState):
        return dict(zeros_of(ts, *names), **{"losses/alpha": torch.exp(ts.log_alpha)})

    return make_actor_critic_loop(env, cfg, space, make_state, explore, greedy_action, update,
                                  zero_metrics)
