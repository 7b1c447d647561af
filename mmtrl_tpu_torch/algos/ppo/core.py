"""Recurrent PPO on tensors; port of ``PPOConfig``, ``RunnerState`` and
``make_recurrent_ppo`` of ``mmtrl_tpu/algos/ppo/core.py``.

One training iteration is the JAX program's three stages as Python loops
over tensors on the run's device:

  rollout -- ``num_steps`` agent steps (T = 1), categorical samples, env
             steps and episode statistics;
  gae     -- the reverse loop of ``ops/gae.py``;
  update  -- ``update_epochs`` epochs of ``num_minibatches`` minibatches,
             a fresh permutation of the env indices per epoch; each
             minibatch replays its envs' whole sequences from the
             rollout's initial carry (the reference's sequence-preserving
             scheme, src/train.py:200-218), so the agent's LSTM runs
             ``num_steps`` steps forward and back per minibatch.

One ``torch.Generator`` on the run's device drives the env's reset draws,
the action samples and the permutations, in that order within an
iteration.  The optimizer is ``ops/fused_optim.py::fused_clip_adamw`` with
``weight_decay=0`` and ``eps=1e-5``: term for term JAX's
``optax.chain(clip_by_global_norm, adam(eps=1e-5))``, under the linear
anneal ``lr * (1 - (count // opt_steps_per_update) / num_updates)`` read at
the count before the increment.  The feedforward and continuous PPO
variants are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch.core.metrics import EpisodeStatistics
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.models.distributions import (
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
)
from mmtrl_tpu_torch.models.lstm import Carry
from mmtrl_tpu_torch.ops.fused_optim import (
    ScaleByAdamState,
    fused_clip_adamw,
    init_adam_state,
)
from mmtrl_tpu_torch.ops.gae import compute_gae

# (obs, actions, logprobs, rewards, dones, values), each (T, N, ...)
Rollout = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class PPOConfig:
    """Field for field the JAX ``PPOConfig``, less ``rpo_alpha`` (RPO's mean
    noise, read only by the continuous variant, which is not ported)."""

    total_timesteps: int = 500_000
    learning_rate: float = 2.5e-4
    num_envs: int = 4
    num_steps: int = 128
    anneal_lr: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    num_minibatches: int = 4
    update_epochs: int = 4
    norm_adv: bool = True
    clip_coef: float = 0.2
    clip_vloss: bool = True
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    clip_rewards: bool = False  # sign-clip like SB3 ClipRewardEnv
    target_kl: Optional[float] = None  # early-stop epochs past this KL

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.num_steps

    @property
    def minibatch_size(self) -> int:
        return self.batch_size // self.num_minibatches

    @property
    def num_updates(self) -> int:
        return self.total_timesteps // self.batch_size

    @property
    def opt_steps_per_update(self) -> int:
        """Optimizer steps per ``train_iteration``: the LR anneal quantum and
        the resume-time update-counter divisor."""
        return self.num_minibatches * self.update_epochs


@dataclasses.dataclass
class RunnerState:
    """Everything an iteration carries: the agent (its parameters are the
    trained weights) and the optimizer state over ``model.parameters()`` in
    order, the env state, the current observation, the done flag that
    preceded it, the LSTM carry, the episode statistics and the generator."""

    model: nn.Module
    opt_state: ScaleByAdamState
    env_state: Any
    obs: torch.Tensor  # (N, ...) current observation
    done: torch.Tensor  # (N,) done preceding the current obs
    carry: Carry
    stats: EpisodeStatistics
    generator: torch.Generator

    @property
    def step(self) -> torch.Tensor:
        return self.opt_state.count

    def payload(self) -> Dict[str, Any]:
        """A checkpoint payload of plain tensors, lists and dicts on the CPU,
        loadable with ``torch.load(weights_only=True)``."""
        cpu = lambda x: x.detach().cpu()  # noqa: E731
        fields = lambda dc: {f.name: cpu(getattr(dc, f.name)) for f in dataclasses.fields(dc)}  # noqa: E731
        return {
            "model": {k: cpu(v) for k, v in self.model.state_dict().items()},
            "opt_state": {"count": cpu(self.opt_state.count),
                          "mu": [cpu(x) for x in self.opt_state.mu],
                          "nu": [cpu(x) for x in self.opt_state.nu]},
            "env_state": fields(self.env_state),
            "obs": cpu(self.obs),
            "done": cpu(self.done),
            "carry": [cpu(x) for x in self.carry],
            "stats": fields(self.stats),
            "generator": self.generator.get_state(),
        }

    def load_payload(self, payload: Dict[str, Any]) -> "RunnerState":
        """This runner with every field taken from ``payload``, on this
        runner's device; the model and the generator are loaded in place."""
        device = self.obs.device
        on = lambda x: x.to(device)  # noqa: E731
        self.model.load_state_dict(payload["model"])
        self.generator.set_state(payload["generator"].cpu())  # a CPU ByteTensor, any device
        opt = payload["opt_state"]
        return dataclasses.replace(
            self,
            opt_state=ScaleByAdamState(on(opt["count"]), [on(x) for x in opt["mu"]],
                                       [on(x) for x in opt["nu"]]),
            env_state=type(self.env_state)(**{k: on(v) for k, v in payload["env_state"].items()}),
            obs=on(payload["obs"]),
            done=on(payload["done"]),
            carry=tuple(on(x) for x in payload["carry"]),
            stats=EpisodeStatistics(**{k: on(v) for k, v in payload["stats"].items()}),
        )


def lr_schedule(cfg: PPOConfig) -> Callable[[torch.Tensor], torch.Tensor] | float:
    """The reference's per-update linear decay, read from the count."""
    if not cfg.anneal_lr:
        return cfg.learning_rate
    steps_per_update = cfg.opt_steps_per_update

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - (count // steps_per_update).float() / cfg.num_updates
        return cfg.learning_rate * frac

    return schedule


def _maybe_clip(cfg: PPOConfig, reward: torch.Tensor) -> torch.Tensor:
    return torch.sign(reward) if cfg.clip_rewards else reward


def _ppo_loss(
    cfg: PPOConfig,
    newlogprob: torch.Tensor,
    entropy: torch.Tensor,
    newvalue: torch.Tensor,
    logprob_old: torch.Tensor,
    advantages: torch.Tensor,
    returns: torch.Tensor,
    values_old: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clip objective + clipped value loss + entropy bonus (reference:
    src/train.py:232-253).  Advantages are normalized by their population
    standard deviation, as ``jnp.std`` computes it."""
    logratio = newlogprob - logprob_old
    ratio = torch.exp(logratio)
    approx_kl = ((ratio - 1.0) - logratio).mean()

    if cfg.norm_adv:
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)

    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)
    pg_loss = torch.maximum(pg_loss1, pg_loss2).mean()

    if cfg.clip_vloss:
        v_clipped = values_old + torch.clamp(newvalue - values_old, -cfg.clip_coef, cfg.clip_coef)
        v_loss = 0.5 * torch.maximum((newvalue - returns) ** 2, (v_clipped - returns) ** 2).mean()
    else:
        v_loss = 0.5 * ((newvalue - returns) ** 2).mean()

    entropy_loss = entropy.mean()
    loss = pg_loss - cfg.ent_coef * entropy_loss + v_loss * cfg.vf_coef
    clipfrac = ((ratio - 1.0).abs() > cfg.clip_coef).float().mean()
    metrics = {
        "losses/policy_loss": pg_loss,
        "losses/value_loss": v_loss,
        "losses/entropy": entropy_loss,
        "losses/approx_kl": approx_kl,
        "losses/clipfrac": clipfrac,
    }
    return loss, metrics


def _explained_variance(values: torch.Tensor, returns: torch.Tensor) -> torch.Tensor:
    """Population variances, as ``jnp.var``; NaN when the returns are flat."""
    var_y = returns.var(correction=0)
    return torch.where(var_y == 0, torch.nan, 1 - (returns - values).var(correction=0) / var_y)


@dataclasses.dataclass
class RecurrentPPO:
    """The functions of ``make_recurrent_ppo``, by name (JAX returns them in
    an ``AlgoParts`` tuple); ``rollout`` is the first half of
    ``train_iteration``, ``update_from_rollout`` the second."""

    init_runner: Callable[..., RunnerState]
    rollout: Callable[[RunnerState], Tuple[RunnerState, Rollout]]
    train_iteration: Callable[[RunnerState], Tuple[RunnerState, Dict[str, torch.Tensor]]]
    update_from_rollout: Callable[..., Tuple[RunnerState, Dict[str, torch.Tensor]]]
    policy_step: Callable[..., Tuple[torch.Tensor, ...]]


def make_recurrent_ppo(env: Environment, model: nn.Module, cfg: PPOConfig) -> RecurrentPPO:
    """``model(obs (T, B, ...), done (T, B), carry) -> (logits, value,
    carry)``; minibatching is over env indices so each minibatch replays
    full sequences from the rollout's initial carry (reference:
    src/train.py:200-218).  ``init_runner`` takes ``model``; the other
    functions use the runner's own model."""
    if cfg.num_envs % cfg.num_minibatches:
        raise ValueError("recurrent PPO needs num_envs divisible by num_minibatches "
                         "(sequence-preserving minibatches)")
    envs_per_batch = cfg.num_envs // cfg.num_minibatches
    schedule = lr_schedule(cfg)

    def init_runner(generator: torch.Generator) -> RunnerState:
        obs, env_state = env.reset(cfg.num_envs, generator)
        return RunnerState(
            model=model,
            opt_state=init_adam_state(list(model.parameters())),
            env_state=env_state,
            obs=obs,
            done=torch.zeros(cfg.num_envs, dtype=torch.bool, device=obs.device),
            carry=model.initial_carry(cfg.num_envs, obs.device),
            stats=EpisodeStatistics.create(cfg.num_envs, obs.device),
            generator=generator,
        )

    @torch.no_grad()
    def policy_step(agent: nn.Module, obs: torch.Tensor, done: torch.Tensor, carry: Carry,
                    generator: Optional[torch.Generator]):
        """One behaviour-policy step: (action, logprob, value, carry)."""
        logits, value, new_carry = agent(obs[None], done[None], carry)
        action = categorical_sample(generator, logits[0])
        return action, categorical_log_prob(logits[0], action), value[0], new_carry

    def rollout(rs: RunnerState) -> Tuple[RunnerState, Rollout]:
        T, N = cfg.num_steps, cfg.num_envs
        device = rs.obs.device
        obs = torch.empty((T,) + tuple(rs.obs.shape), dtype=rs.obs.dtype, device=device)
        actions = torch.empty((T, N), dtype=torch.long, device=device)
        logprobs, rewards, values = (torch.empty((T, N), device=device) for _ in range(3))
        dones = torch.empty((T, N), dtype=torch.bool, device=device)
        env_state, o, done, carry, stats = rs.env_state, rs.obs, rs.done, rs.carry, rs.stats
        for t in range(T):
            action, logprob, value, carry = policy_step(rs.model, o, done, carry, rs.generator)
            obs[t], actions[t], logprobs[t], dones[t], values[t] = o, action, logprob, done, value
            o, env_state, reward, done, info = env.step(env_state, action, rs.generator)
            # Episode statistics take the RAW reward when a reward-transforming
            # wrapper reports one (src/train.py:52-57); the loss the clipped one.
            stats = stats.update(info.get("raw_reward", reward), done)
            rewards[t] = _maybe_clip(cfg, reward)
        rs = dataclasses.replace(rs, env_state=env_state, obs=o, done=done, carry=carry,
                                 stats=stats)
        return rs, (obs, actions, logprobs, rewards, dones, values)

    def update_from_rollout(
        rs: RunnerState, initial_carry: Carry, rollout: Rollout,
        perms: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[RunnerState, Dict[str, torch.Tensor]]:
        """PPO update from a completed rollout.  ``rs`` carries the
        post-rollout (obs, done, carry) for the value bootstrap; ``rollout``
        is time-major (T, N, ...).  ``perms`` (one permutation of the env
        indices per epoch) replaces the generator's draws, so a test can
        replay another implementation's."""
        obs, actions, logprobs, rewards, dones, values = rollout
        model = rs.model
        with torch.no_grad():
            _, next_value, _ = model(rs.obs[None], rs.done[None], rs.carry)
        advantages, returns = compute_gae(rewards, values, dones, next_value[0], rs.done,
                                          cfg.gamma, cfg.gae_lambda)
        params = list(model.parameters())
        opt_state, stop, metrics = rs.opt_state, False, {}
        for epoch in range(cfg.update_epochs):
            if perms is None:
                perm = torch.randperm(cfg.num_envs, generator=rs.generator,
                                      device=rs.generator.device)
            else:
                perm = perms[epoch]
            perm = perm.to(obs.device).reshape(cfg.num_minibatches, envs_per_batch)
            # After the target KL was crossed an epoch still runs, from the
            # frozen state, and its update is discarded (its metrics stay),
            # as JAX's ``_kl_epoch_scan`` does.
            frozen = ([p.detach().clone() for p in params], opt_state) if stop else None
            for idx in perm:
                logits, newvalue, _ = model(obs[:, idx], dones[:, idx],
                                            tuple(c[idx] for c in initial_carry))
                loss, metrics = _ppo_loss(
                    cfg,
                    categorical_log_prob(logits, actions[:, idx]).reshape(-1),
                    categorical_entropy(logits).reshape(-1),
                    newvalue.reshape(-1),
                    logprobs[:, idx].reshape(-1),
                    advantages[:, idx].reshape(-1),
                    returns[:, idx].reshape(-1),
                    values[:, idx].reshape(-1),
                )
                grads = torch.autograd.grad(loss, params)
                opt_state = fused_clip_adamw(params, grads, opt_state, schedule, eps=1e-5,
                                             weight_decay=0.0, max_grad_norm=cfg.max_grad_norm)
            if frozen is not None:
                with torch.no_grad():
                    for p, saved in zip(params, frozen[0]):
                        p.copy_(saved)
                opt_state = frozen[1]
            elif cfg.target_kl is not None:
                stop = bool(metrics["losses/approx_kl"] > cfg.target_kl)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["losses/explained_variance"] = _explained_variance(values.reshape(-1),
                                                                   returns.reshape(-1))
        return dataclasses.replace(rs, opt_state=opt_state), metrics

    def train_iteration(rs: RunnerState) -> Tuple[RunnerState, Dict[str, torch.Tensor]]:
        initial_carry = rs.carry
        rs, data = rollout(rs)
        return update_from_rollout(rs, initial_carry, data)

    return RecurrentPPO(init_runner, rollout, train_iteration, update_from_rollout, policy_step)
