"""DQN's configuration, train state and TD update; port of ``DQNConfig``,
``DQNTrainState`` and ``dqn_td_update`` in ``mmtrl_tpu/algos/offpolicy/dqn.py``.

The train state holds the Q network (its parameters are the trained
weights), a frozen copy as the target network and the optimizer state over
``model.parameters()`` in order.  The optimizer is ``optax.adam`` (no
clipping, no weight decay): ``ops/fused_optim.fused_clip_adamw`` with
``max_grad_norm=None`` and ``weight_decay=0`` at a constant rate, and
Adam's eps of the run (1e-8; C51 takes 0.01 / batch_size).  The update is
the jitted update of the reference's dqn_atari_jax.py:186-199: the MSE of
Q(s, a) against r + gamma (1 - done) max_a' Q_target(s', a').
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch.ops.fused_optim import ScaleByAdamState, fused_clip_adamw, init_adam_state

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class DQNConfig:
    """The host loop's fields of the JAX ``DQNConfig``, its defaults; the
    fused path's (``steps_per_iteration``, the PER options) wait with it."""

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


@dataclasses.dataclass
class DQNTrainState:
    model: nn.Module
    target: nn.Module
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
            return {k: v.detach().cpu() for k, v in m.state_dict().items()}

        opt = self.opt_state
        return {"model": cpu(self.model), "target": cpu(self.target),
                "opt_state": {"count": opt.count.cpu(), "mu": [m.cpu() for m in opt.mu],
                              "nu": [v.cpu() for v in opt.nu]}}

    def load_payload(self, payload: Dict[str, Any]) -> "DQNTrainState":
        self.model.load_state_dict(payload["model"])
        self.target.load_state_dict(payload["target"])
        device = self.opt_state.count.device
        opt = payload["opt_state"]
        self.opt_state = ScaleByAdamState(opt["count"].to(device),
                                          [m.to(device) for m in opt["mu"]],
                                          [v.to(device) for v in opt["nu"]])
        return self


def create_dqn_state(model: nn.Module, learning_rate: float,
                     adam_eps: float = 1e-8) -> DQNTrainState:
    """``model`` as the online network, its copy as the target."""
    target = copy.deepcopy(model).requires_grad_(False)
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


def dqn_td_update(gamma: float, ts: DQNTrainState, batch: Batch
                  ) -> Tuple[DQNTrainState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TD update: ``(ts, loss, mean Q(s, a), |TD error|)``.  ``batch``
    holds ``obs``, ``action``, ``reward``, ``next_obs`` and ``done``."""
    with torch.no_grad():
        q_next = ts.target(batch["next_obs"]).max(dim=-1).values
        td_target = batch["reward"] + gamma * (1.0 - batch["done"]) * q_next
    q = ts.model(batch["obs"])
    q_a = q.gather(-1, batch["action"].long()[:, None])[:, 0]
    td_error = q_a - td_target
    loss = (td_error**2).mean()
    ts = adam_step(ts, loss)
    return ts, loss.detach(), q_a.mean().detach(), td_error.abs().detach()
