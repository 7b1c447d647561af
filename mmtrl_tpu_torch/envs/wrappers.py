"""Running mean and variance of a stream of batches; the ``RunningStat`` of
``mmtrl_tpu/envs/wrappers.py``.  The env wrappers of that module
(``ClipReward``, ``FrameStack``, the observation and action wrappers) serve
envs the port does not have yet and are not ported."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device


@dataclasses.dataclass
class RunningStat:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # () float32, from 1e-4 as the reference's RunningMeanStd

    @classmethod
    def create(cls, shape: Tuple[int, ...], device: DeviceLike = None) -> "RunningStat":
        device = resolve_device(device)
        return cls(mean=torch.zeros(shape, device=device), var=torch.ones(shape, device=device),
                   count=torch.tensor(1e-4, device=device))

    def update(self, batch: torch.Tensor) -> "RunningStat":
        """The parallel-variance merge of the batch's population statistics
        (reference: cleanrl/ppo_rnd_envpool.py:239-263), term for term."""
        b_mean = batch.mean(dim=0)
        b_var = batch.var(dim=0, correction=0)
        b_count = batch.shape[0]
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * b_count / tot
        m_a = self.var * self.count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta**2 * self.count * b_count / tot
        return RunningStat(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var + eps)
