"""C51, the categorical DQN: its configuration, the projection of the
target distribution, the TD update and the fused loop on the device; port
of ``mmtrl_tpu/algos/offpolicy/c51.py`` (the reference's cleanrl/c51.py
and c51_atari_jax.py:219-239).  ``make_c51`` is ``make_dqn``'s loop
(``dqn.make_value_loop``) with C51's greedy rule, update and Adam eps
(0.01 / batch_size), on the uniform ring.

The projection is the JAX package's dense one-hot sum over a (B, n_atoms,
n_atoms) product rather than a scatter: on the card a float scatter-add
(``index_add_``) sums by atomics, in no fixed order, and the same batch
would not give the same bits twice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch.algos.offpolicy.common import OffPolicyRunner
from mmtrl_tpu_torch.algos.offpolicy.dqn import (
    Batch,
    DQNTrainState,
    OffPolicyAlgo,
    adam_step,
    make_value_loop,
)
from mmtrl_tpu_torch.data.buffers import ReplayBuffer
from mmtrl_tpu_torch.envs.base import Environment


@dataclasses.dataclass
class C51Config:
    """Field for field the JAX ``C51Config`` and its defaults.  The
    cartridge host loop does not read ``steps_per_iteration``."""

    total_timesteps: int = 500_000
    learning_rate: float = 2.5e-4
    num_envs: int = 1
    buffer_size: int = 10_000
    gamma: float = 0.99
    n_atoms: int = 101
    v_min: float = -100.0
    v_max: float = 100.0
    target_network_frequency: int = 500
    batch_size: int = 128
    start_e: float = 1.0
    end_e: float = 0.05
    exploration_fraction: float = 0.5
    learning_starts: int = 10_000
    train_frequency: int = 10
    steps_per_iteration: int = 512  # env steps of one train_iteration

    @property
    def num_iterations(self) -> int:
        return self.total_timesteps // (self.steps_per_iteration * self.num_envs)


def categorical_projection(reward: torch.Tensor, done: torch.Tensor, next_pmf: torch.Tensor,
                           atoms: torch.Tensor, gamma: float) -> torch.Tensor:
    """(B, n_atoms) projection of r + gamma (1 - done) z onto the support
    ``atoms`` ((n_atoms,), evenly spaced), for next-state probabilities
    ``next_pmf`` (B, n_atoms).  Where b = (Tz - v_min) / dz is integral,
    all the mass goes to its atom."""
    n_atoms = atoms.shape[0]
    v_min, v_max = atoms[0], atoms[-1]
    delta_z = (v_max - v_min) / (n_atoms - 1)
    tz = torch.clamp(reward[:, None] + (gamma * (1.0 - done))[:, None] * atoms, v_min, v_max)
    b = (tz - v_min) / delta_z
    lo, hi = torch.floor(b), torch.ceil(b)
    w_lo = torch.where(lo == hi, 1.0, hi - b)
    w_hi = b - lo
    idx = torch.arange(n_atoms, device=atoms.device, dtype=b.dtype)
    onehot_lo = (lo[..., None] == idx).to(next_pmf.dtype)  # (B, source, target)
    onehot_hi = (hi[..., None] == idx).to(next_pmf.dtype)
    return (((next_pmf * w_lo)[..., None] * onehot_lo).sum(-2)
            + ((next_pmf * w_hi)[..., None] * onehot_hi).sum(-2))


def expected_q_greedy(atoms: torch.Tensor):
    """C51's greedy policy: ``(model, obs) -> argmax_a sum_i p_i(s, a) z_i``
    over the support ``atoms``."""
    def greedy_fn(model, obs):
        return (model(obs) * atoms).sum(dim=-1).argmax(dim=-1)

    return greedy_fn


def c51_td_update(atoms: torch.Tensor, gamma: float, ts: DQNTrainState, batch: Batch
                  ) -> Tuple[DQNTrainState, torch.Tensor, torch.Tensor]:
    """One categorical TD step (projection and cross-entropy):
    ``(ts, loss, mean expected Q(s, a))``."""
    rows = torch.arange(batch["action"].shape[0], device=atoms.device)
    with torch.no_grad():
        next_pmfs = ts.target(batch["next_obs"])  # (B, A, n_atoms)
        best = (next_pmfs * atoms).sum(-1).argmax(dim=-1)
        target_pmf = categorical_projection(batch["reward"], batch["done"],
                                            next_pmfs[rows, best], atoms, gamma)
    pmf_a = ts.model(batch["obs"])[rows, batch["action"].long()]
    loss = -(target_pmf * torch.log(torch.clamp(pmf_a, 1e-5, 1.0))).sum(-1).mean()
    q_a = (pmf_a * atoms).sum(-1)
    ts = adam_step(ts, loss)
    return ts, loss.detach(), q_a.mean().detach()


def make_c51(env: Environment, model: nn.Module, cfg: C51Config) -> OffPolicyAlgo:
    """C51's fused loop; ``model(obs) -> probabilities (B, A, n_atoms)`` on
    the env's device, over ``n_atoms`` atoms evenly spaced on [v_min,
    v_max].  A step's ``StepDraws.sample_idx`` replaces the replay
    indices."""
    atoms = torch.linspace(cfg.v_min, cfg.v_max, cfg.n_atoms, device=env.device)

    def update_fn(runner: OffPolicyRunner, sample_draw: Optional[torch.Tensor]):
        batch = runner.buffer.sample(runner.generator, cfg.batch_size, sample_draw)
        return c51_td_update(atoms, cfg.gamma, runner.train_state, batch)

    return make_value_loop(env, model, cfg, expected_q_greedy(atoms), update_fn,
                           lambda example: ReplayBuffer.create(example, cfg.buffer_size),
                           "losses/loss", adam_eps=0.01 / cfg.batch_size)
