"""On-device episode statistics; port of ``EpisodeStatistics`` in
``mmtrl_tpu/core/metrics.py`` (reference: cleanrl/ppo_atari_envpool_xla_jax.py:158-164)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EpisodeStatistics:
    """Per-env running episode accumulators, all fixed-shape tensors."""

    episode_returns: torch.Tensor  # (num_envs,) running sum of raw rewards
    episode_lengths: torch.Tensor  # (num_envs,) running step count
    returned_episode_returns: torch.Tensor  # (num_envs,) last completed return
    returned_episode_lengths: torch.Tensor  # (num_envs,) last completed length
    episode_count: torch.Tensor  # () int32 total completed episodes
    sum_returns: torch.Tensor  # () sum of ALL completed episode returns
    sum_lengths: torch.Tensor  # () sum of ALL completed episode lengths

    @classmethod
    def create(cls, num_envs: int, device: torch.device) -> "EpisodeStatistics":
        z = torch.zeros(num_envs, dtype=torch.float32, device=device)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return cls(
            episode_returns=z,
            episode_lengths=z,
            returned_episode_returns=z,
            returned_episode_lengths=z,
            episode_count=torch.zeros((), dtype=torch.int32, device=device),
            sum_returns=zero,
            sum_lengths=zero,
        )

    @property
    def mean_return(self) -> torch.Tensor:
        """Mean over ALL completed episodes (not just each env's last)."""
        return self.sum_returns / self.episode_count.clamp(min=1)

    @property
    def mean_length(self) -> torch.Tensor:
        return self.sum_lengths / self.episode_count.clamp(min=1)

    def update(self, reward: torch.Tensor, done: torch.Tensor) -> "EpisodeStatistics":
        """Accumulate one batched env step (raw rewards)."""
        done_f = done.float()
        new_returns = self.episode_returns + reward
        new_lengths = self.episode_lengths + 1.0
        return EpisodeStatistics(
            episode_returns=new_returns * (1.0 - done_f),
            episode_lengths=new_lengths * (1.0 - done_f),
            returned_episode_returns=torch.where(done, new_returns, self.returned_episode_returns),
            returned_episode_lengths=torch.where(done, new_lengths, self.returned_episode_lengths),
            episode_count=self.episode_count + done.int().sum(dtype=torch.int32),
            sum_returns=self.sum_returns + torch.where(done, new_returns, 0.0).sum(),
            sum_lengths=self.sum_lengths + torch.where(done, new_lengths, 0.0).sum(),
        )
