"""DQN: its configuration, train state, TD update and the fused loop on
the device; port of ``mmtrl_tpu/algos/offpolicy/dqn.py`` (the reference's
cleanrl/dqn.py).

The train state holds the Q network (its parameters are the trained
weights), a frozen copy as the target network and the optimizer state over
``model.parameters()`` in order.  The optimizer is ``optax.adam`` (no
clipping, no weight decay): ``ops/fused_optim.fused_clip_adamw`` with
``max_grad_norm=None`` and ``weight_decay=0`` at a constant rate, and
Adam's eps of the run (1e-8; C51 takes 0.01 / batch_size).  The update is
the jitted update of the reference's dqn_atari_jax.py:186-199: the MSE of
Q(s, a) against r + gamma (1 - done) max_a' Q_target(s', a'), each
sample's square weighted by PER's importance-sampling weight when given.

``make_dqn`` is JAX's scanned ``train_iteration``: ``steps_per_iteration``
batched env steps on the device, each acting epsilon-greedily, storing the
transition and, on the cadence, sampling a batch for the TD update and
syncing the target.  JAX runs the steps as one ``lax.scan`` with
``lax.cond`` branches; here they are a Python loop, and the global step is
a host integer, so the cadence, epsilon and PER's beta cost no copy from
the device.  As in JAX, the iteration reports the LAST step's loss and mean
Q, which are 0 when that step did not train.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mmtrl_tpu_torch.algos.offpolicy.common import (
    Metrics,
    OffPolicyRunner,
    StepDraws,
    linear_epsilon,
    store_transition,
)
from mmtrl_tpu_torch.core.metrics import EpisodeStatistics
from mmtrl_tpu_torch.data.buffers import PrioritizedReplayBuffer, ReplayBuffer
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.ops.fused_optim import ScaleByAdamState, fused_clip_adamw, init_adam_state

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class DQNConfig:
    """Field for field the JAX ``DQNConfig`` and its defaults.  The
    cartridge host loop reads neither ``steps_per_iteration`` nor the PER
    fields."""

    total_timesteps: int = 500_000
    learning_rate: float = 2.5e-4
    num_envs: int = 1
    buffer_size: int = 10_000
    gamma: float = 0.99
    tau: float = 1.0
    target_network_frequency: int = 500
    batch_size: int = 128
    start_e: float = 1.0
    end_e: float = 0.05
    exploration_fraction: float = 0.5
    learning_starts: int = 10_000
    train_frequency: int = 10
    steps_per_iteration: int = 512  # env steps of one train_iteration
    # Prioritized replay (Schaul et al.; the reference's
    # PrioritizedReplayBuffer, cleanrl_utils/buffers.py:581)
    prioritized_replay: bool = False
    per_alpha: float = 0.6
    per_beta_start: float = 0.4  # annealed to 1.0 over total_timesteps

    @property
    def num_iterations(self) -> int:
        return self.total_timesteps // (self.steps_per_iteration * self.num_envs)


@dataclasses.dataclass
class DQNTrainState:
    """A network, its target (None for SAC's actor, which has none) and
    its Adam state: DQN's and C51's Q network, and each actor and critic
    of DDPG, TD3 and SAC."""

    model: nn.Module
    target: Optional[nn.Module]
    opt_state: ScaleByAdamState
    learning_rate: float
    adam_eps: float = 1e-8

    @property
    def step(self) -> torch.Tensor:
        return self.opt_state.count

    @property
    def params(self):
        return list(self.model.parameters())

    def payload(self) -> Dict[str, Any]:
        """Parameters, target and Adam state as plain CPU tensors."""
        def cpu(m):
            return None if m is None else {k: v.detach().cpu() for k, v in m.state_dict().items()}

        opt = self.opt_state
        return {"model": cpu(self.model), "target": cpu(self.target),
                "opt_state": {"count": opt.count.cpu(), "mu": [m.cpu() for m in opt.mu],
                              "nu": [v.cpu() for v in opt.nu]}}

    def load_payload(self, payload: Dict[str, Any]) -> "DQNTrainState":
        self.model.load_state_dict(payload["model"])
        if self.target is not None:
            self.target.load_state_dict(payload["target"])
        device = self.opt_state.count.device
        opt = payload["opt_state"]
        self.opt_state = ScaleByAdamState(opt["count"].to(device),
                                          [m.to(device) for m in opt["mu"]],
                                          [v.to(device) for v in opt["nu"]])
        return self


def create_dqn_state(model: nn.Module, learning_rate: float, adam_eps: float = 1e-8,
                     with_target: bool = True) -> DQNTrainState:
    """``model`` as the online network, its copy as the target (none
    without ``with_target``)."""
    target = copy.deepcopy(model).requires_grad_(False) if with_target else None
    return DQNTrainState(model=model, target=target,
                         opt_state=init_adam_state(list(model.parameters())),
                         learning_rate=learning_rate, adam_eps=adam_eps)


def adam_step(ts: DQNTrainState, loss: torch.Tensor) -> DQNTrainState:
    """One ``optax.adam`` step of ``ts.model`` on ``loss``, in place."""
    params = ts.params
    grads = torch.autograd.grad(loss, params)
    ts.opt_state = fused_clip_adamw(params, grads, ts.opt_state, ts.learning_rate,
                                    eps=ts.adam_eps, weight_decay=0.0, max_grad_norm=None)
    return ts


@torch.no_grad()
def sync_target(ts: DQNTrainState, tau: float) -> None:
    """target <- tau * params + (1 - tau) * target (``optax.incremental_update``)."""
    for p, t in zip(ts.model.parameters(), ts.target.parameters()):
        t.copy_(tau * p + (1.0 - tau) * t)


def dqn_td_update(gamma: float, ts: DQNTrainState, batch: Batch,
                  weights: Optional[torch.Tensor] = None
                  ) -> Tuple[DQNTrainState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TD update: ``(ts, loss, mean Q(s, a), |TD error|)``.  ``batch``
    holds ``obs``, ``action``, ``reward``, ``next_obs`` and ``done``;
    ``weights`` (B,) are PER's importance-sampling weights."""
    with torch.no_grad():
        q_next = ts.target(batch["next_obs"]).max(dim=-1).values
        td_target = batch["reward"] + gamma * (1.0 - batch["done"]) * q_next
    q = ts.model(batch["obs"])
    q_a = q.gather(-1, batch["action"].long()[:, None])[:, 0]
    td_error = q_a - td_target
    per_sample = td_error**2
    if weights is not None:
        per_sample = per_sample * weights
    loss = per_sample.mean()
    ts = adam_step(ts, loss)
    return ts, loss.detach(), q_a.mean().detach(), td_error.abs().detach()


def argmax_q(model: nn.Module, obs: torch.Tensor) -> torch.Tensor:
    return model(obs).argmax(dim=-1)


def per_beta(cfg: DQNConfig, global_step: int) -> np.float32:
    """PER's importance-sampling exponent at ``global_step``: annealed from
    ``per_beta_start`` to 1 over ``total_timesteps``, as the compiled JAX
    step computes it: XLA folds ``(1 - start) / total_timesteps`` into one
    float32 constant and fuses the multiply-add, which the float64 sum
    rounded once to float32 reproduces."""
    start = np.float32(cfg.per_beta_start)
    slope = np.float32(np.float32(1.0 - cfg.per_beta_start) / np.float32(cfg.total_timesteps))
    beta = np.float32(float(np.float32(global_step)) * float(slope) + float(start))
    return min(max(beta, start), np.float32(1.0))


class OffPolicyAlgo(NamedTuple):
    """``init_runner(generator)`` and ``train_iteration(runner, draws=None)
    -> (runner, metrics)``: ``steps_per_iteration`` env steps of every env,
    ``draws`` one ``StepDraws`` a step replacing the generator's."""

    init_runner: Callable[[torch.Generator], OffPolicyRunner]
    train_iteration: Callable[..., Tuple[OffPolicyRunner, Metrics]]


def make_value_loop(env: Environment, model: nn.Module, cfg, greedy_fn, update_fn,
                    make_buffer, loss_name: str, adam_eps: float = 1e-8) -> OffPolicyAlgo:
    """The fused loop of DQN and C51: epsilon-greedy acting with
    ``greedy_fn(model, obs)``, a store into ``make_buffer(example)``, on
    the cadence ``update_fn(runner, batch_draw) -> (ts, loss, q_mean)``
    and the target sync.  ``loss_name`` names the loss metric."""
    n = cfg.num_envs
    zero = torch.zeros((), device=env.device)  # the metrics of a step that does not train

    def init_runner(generator: torch.Generator) -> OffPolicyRunner:
        obs, env_state = env.reset(n, generator)
        device = obs.device
        example = dict(obs=obs[0], action=torch.zeros((), dtype=torch.long, device=device),
                       reward=torch.zeros((), device=device), next_obs=obs[0],
                       done=torch.zeros((), device=device))
        return OffPolicyRunner(
            train_state=create_dqn_state(model, cfg.learning_rate, adam_eps),
            buffer=make_buffer(example), env_state=env_state, obs=obs, global_step=0,
            stats=EpisodeStatistics.create(n, device), generator=generator)

    def step_fn(runner: OffPolicyRunner, draws: Optional[StepDraws] = None):
        gen, device = runner.generator, runner.obs.device
        eps = linear_epsilon(cfg.start_e, cfg.end_e,
                             cfg.exploration_fraction * cfg.total_timesteps, runner.global_step)
        ts = runner.train_state
        with torch.no_grad():
            greedy = greedy_fn(ts.model, runner.obs)
        if draws is None:
            draws = StepDraws(
                torch.randint(0, env.num_actions, (n,), generator=gen, device=device),
                torch.rand(n, generator=gen, device=device), None)
        action = torch.where(draws.explore_u.to(device) < eps,
                             draws.random_action.to(device), greedy)
        runner = store_transition(env, runner, action)
        gs = runner.global_step
        if gs > cfg.learning_starts and (gs // n) % cfg.train_frequency == 0:
            ts, loss, q_mean = update_fn(runner, draws.sample_idx)
        else:
            loss = q_mean = zero
        if (gs // n) % cfg.target_network_frequency == 0:
            sync_target(ts, getattr(cfg, "tau", 1.0))
        runner = dataclasses.replace(runner, train_state=ts)
        return runner, {loss_name: loss, "losses/q_values": q_mean}

    def train_iteration(runner: OffPolicyRunner,
                        draws: Optional[Sequence[StepDraws]] = None):
        for k in range(cfg.steps_per_iteration):
            runner, metrics = step_fn(runner, None if draws is None else draws[k])
        return runner, metrics

    return OffPolicyAlgo(init_runner, train_iteration)


def make_dqn(env: Environment, model: nn.Module, cfg: DQNConfig) -> OffPolicyAlgo:
    """DQN's fused loop; ``model(obs) -> Q (B, A)`` on the env's device.
    With ``prioritized_replay`` the ring is PER's, the loss is weighted by
    the batch's importance-sampling weights at the annealed beta, and the
    sampled leaves take |TD error| as their new priorities.  A step's
    ``StepDraws.sample_idx`` replaces the replay indices (uniform ring) or
    the descent's uniforms (PER)."""

    def make_buffer(example):
        if cfg.prioritized_replay:
            return PrioritizedReplayBuffer.create(example, cfg.buffer_size, alpha=cfg.per_alpha)
        return ReplayBuffer.create(example, cfg.buffer_size)

    def update_fn(runner: OffPolicyRunner, sample_draw: Optional[torch.Tensor]):
        buf, gen = runner.buffer, runner.generator
        if cfg.prioritized_replay:
            beta = per_beta(cfg, runner.global_step)
            batch, idx, weights = buf.sample(gen, cfg.batch_size, beta, sample_draw)
            ts, loss, q_mean, td_abs = dqn_td_update(cfg.gamma, runner.train_state, batch,
                                                     weights)
            buf.update_priorities(idx, td_abs)
        else:
            batch = buf.sample(gen, cfg.batch_size, sample_draw)
            ts, loss, q_mean, _ = dqn_td_update(cfg.gamma, runner.train_state, batch)
        return ts, loss, q_mean

    return make_value_loop(env, model, cfg, argmax_q, update_fn, make_buffer,
                           "losses/td_loss")
