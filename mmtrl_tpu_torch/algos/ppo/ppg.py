"""Phasic Policy Gradient on tensors; port of ``mmtrl_tpu/algos/ppo/ppg.py``
(the reference's cleanrl/ppg_procgen.py).

One ``train_iteration`` is a PPG cycle:

  policy phase -- ``n_iteration`` feedforward PPO iterations (rollout, GAE,
                  ``e_policy`` epochs over permutations of all rows), the
                  aux value head detached from the trunk (the reference's
                  get_pi_value_and_aux_value, ppg_procgen.py:204);
  aux phase    -- the old policy's logits over every stored observation,
                  in ``num_aux_minibatches`` chunks without gradients, then
                  ``e_auxiliary`` epochs over permutations of all stored
                  rows minimizing real-value MSE + aux-value MSE +
                  ``beta_clone`` * KL(old pi || new pi).

Kept from the JAX module: the stored observations are cast to
``aux_store_dtype``, flattened to one row each, and read back with
``.float()``.  bfloat16 (the default) rounds Minecraft2d's [-1, 1] floats
as JAX's store does; int8 (``scripts/ppg.py``'s choice on procmaze) holds
procmaze's {-1, +1} planes exactly in a quarter of float32's bytes.  The
rollout's rewards are never sign-clipped and there is no
target-KL stop.  Both phases step the one clipped, annealed optimizer, whose
anneal counts PPG cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.algos.ppo.core import (
    PPOConfig,
    Rollout,
    RunnerState,
    draw_perm,
    feedforward_rollout,
    feedforward_update,
    init_feedforward_runner,
    lr_schedule,
    ppo_step,
    run_epochs,
)
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.models.common import Dense, ImpalaTower, MLPTower


@dataclasses.dataclass
class PPGConfig(PPOConfig):
    n_iteration: int = 32  # policy-phase rollouts per PPG cycle
    e_policy: int = 1  # policy epochs (update_epochs alias)
    e_auxiliary: int = 6  # aux-phase epochs
    beta_clone: float = 1.0
    num_aux_minibatches: int = 4
    aux_store_dtype: str = "bfloat16"  # a torch dtype's name

    @property
    def num_updates(self) -> int:
        """PPG cycles: one train_iteration = n_iteration rollouts."""
        return max(1, self.total_timesteps // (self.batch_size * self.n_iteration))

    @property
    def opt_steps_per_update(self) -> int:
        """Optimizer steps per CYCLE (policy phase + aux phase), so the LR
        anneal decays over cycles."""
        return (
            self.n_iteration * self.e_policy * self.num_minibatches
            + self.e_auxiliary * self.num_aux_minibatches
        )


class PPGAgent(nn.Module):
    """IMPALA trunk (or a tanh MLP for vector obs) + actor + value head +
    aux value head on the DETACHED feature: obs (N, ...) -> logits (N, A),
    value (N,), aux_value (N,)."""

    def __init__(self, num_actions: int, obs_shape: Sequence[int], input_scale: float = 1.0,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.input_scale = input_scale
        self.image = len(obs_shape) >= 3  # JAX branches on obs.ndim >= 4 of a batch
        if self.image:
            self.network = ImpalaTower(obs_shape[0], device=device)
        else:
            self.network = MLPTower(obs_shape[0], (64, 64), device=device)
        f = self.network.feature_size
        self.actor = Dense(f, num_actions, scale=0.01, device=device)
        self.critic = Dense(f, 1, scale=1.0, device=device)
        self.aux_critic = Dense(f, 1, scale=1.0, device=device)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        feat = self.network(obs / self.input_scale if self.image else obs)
        return (self.actor(feat), self.critic(feat)[..., 0],
                self.aux_critic(feat.detach())[..., 0])


@dataclasses.dataclass
class PPG:
    """The functions of ``make_ppg``, by name.  ``train_iteration`` is one
    cycle; it takes a ``rollout`` function and the ``perms`` and
    ``aux_perms`` draws in their place, so a test can replay another
    implementation's."""

    init_runner: Callable[[torch.Generator], RunnerState]
    rollout: Callable[[RunnerState], Tuple[RunnerState, Rollout]]
    train_iteration: Callable[..., Tuple[RunnerState, Dict[str, torch.Tensor]]]


def make_ppg(env: Environment, model: PPGAgent, cfg: PPGConfig) -> PPG:
    obs_shape = tuple(env.observation_space.shape)
    store_dtype = getattr(torch, cfg.aux_store_dtype)
    policy_cfg = dataclasses.replace(cfg, update_epochs=cfg.e_policy, target_kl=None,
                                     clip_rewards=False)
    schedule = lr_schedule(cfg)

    def rollout(rs: RunnerState):
        return feedforward_rollout(env, policy_cfg, rs)

    def aux_phase(rs: RunnerState, aux_obs: torch.Tensor, aux_returns: torch.Tensor,
                  old_logits: torch.Tensor, perms: Optional[Sequence[torch.Tensor]]):
        """``aux_obs`` (rows, prod(obs_shape)) in the store dtype; each
        minibatch gathers its own rows by the epoch's permutation."""
        total = aux_obs.shape[0]
        mb = total // cfg.num_aux_minibatches
        params = list(rs.model.parameters())

        def minibatch_step(opt_state, idx):
            b_obs = aux_obs[idx].reshape((mb,) + obs_shape).float()
            b_ret = aux_returns[idx]
            logits, value, aux_value = rs.model(b_obs)
            aux_loss = 0.5 * ((aux_value - b_ret) ** 2).mean()
            real_loss = 0.5 * ((value - b_ret) ** 2).mean()
            old_logp = torch.log_softmax(old_logits[idx], dim=-1)
            new_logp = torch.log_softmax(logits, dim=-1)
            kl = (old_logp.exp() * (old_logp - new_logp)).sum(-1).mean()
            loss = real_loss + aux_loss + cfg.beta_clone * kl
            return (ppo_step(cfg, schedule, params, opt_state, loss),
                    {"losses/aux_value_loss": aux_loss, "losses/kl_clone": kl})

        shape = (cfg.num_aux_minibatches, mb)
        opt_state, metrics = run_epochs(
            cfg.e_auxiliary, None, params, rs.opt_state,
            lambda e: draw_perm(rs.generator, total, perms, e, shape, aux_obs.device),
            minibatch_step)
        return dataclasses.replace(rs, opt_state=opt_state), metrics

    def train_iteration(
        rs: RunnerState,
        rollout_fn: Optional[Callable[[RunnerState], Tuple[RunnerState, Rollout]]] = None,
        perms: Optional[Sequence[Sequence[torch.Tensor]]] = None,
        aux_perms: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[RunnerState, Dict[str, torch.Tensor]]:
        """One PPG cycle.  ``perms[i]`` replaces policy iteration i's
        permutations, ``aux_perms`` the aux phase's; ``rollout_fn`` the
        rollout."""
        rollout_fn = rollout_fn or rollout
        stored_obs, stored_returns = [], []
        for i in range(cfg.n_iteration):
            rs, data = rollout_fn(rs)
            # the policy phase's loss does not reach the aux head: zeros
            rs, metrics, returns = feedforward_update(policy_cfg, rs, data,
                                                      None if perms is None else perms[i],
                                                      allow_unused=True)
            stored_obs.append(data[0].to(store_dtype).reshape(cfg.batch_size, -1))
            stored_returns.append(returns.reshape(-1))
        aux_obs, aux_returns = torch.cat(stored_obs), torch.cat(stored_returns)
        del stored_obs
        # the old policy's logits over the whole store, chunk by chunk: one
        # call would hold every row's conv activations at once
        with torch.no_grad():
            old_logits = torch.cat([
                rs.model(chunk.reshape((-1,) + obs_shape).float())[0]
                for chunk in aux_obs.reshape((cfg.num_aux_minibatches, -1, aux_obs.shape[-1]))
            ])
        rs, aux_metrics = aux_phase(rs, aux_obs, aux_returns, old_logits, aux_perms)
        metrics.update(aux_metrics)
        return rs, metrics

    return PPG(
        init_runner=lambda generator: init_feedforward_runner(env, model, cfg.num_envs, generator),
        rollout=rollout,
        train_iteration=train_iteration,
    )


def cycle_config(cfg: PPGConfig) -> Any:
    """What the PPO runner reads of a PPG run: one ``train_iteration`` is a
    cycle of ``n_iteration`` rollouts, so its batch is ``batch_size *
    n_iteration`` env steps (``scripts/ppg.py``'s ``CycleCfg``)."""
    return _CycleConfig(num_updates=cfg.num_updates, batch_size=cfg.batch_size * cfg.n_iteration,
                        anneal_lr=cfg.anneal_lr, learning_rate=cfg.learning_rate,
                        opt_steps_per_update=cfg.opt_steps_per_update)


@dataclasses.dataclass(frozen=True)
class _CycleConfig:
    num_updates: int
    batch_size: int
    anneal_lr: bool
    learning_rate: float
    opt_steps_per_update: int
