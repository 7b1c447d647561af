"""What the classic-control envs share: a device, the uniform reset draw
and the ``sampler`` hook that replaces it."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs.base import Environment

# (n, generator) -> (n, k) float32: the state values a reset draws
Sampler = Callable[[int, Optional[torch.Generator]], torch.Tensor]


class ClassicEnv(Environment):
    """A reset draws ``reset_width`` values uniform in ``reset_range``;
    ``sampler`` replaces that draw, so a test can replay the draws another
    implementation made.  ``step`` returns ``truncated`` in its info: the
    episode hit ``max_steps`` and did not terminate, so an off-policy
    buffer bootstraps through it."""

    reset_width: int
    reset_range: tuple
    max_steps: int

    def __init__(self, device: DeviceLike = None, sampler: Optional[Sampler] = None):
        self.device = resolve_device(device)
        self.sampler = sampler or self.draw_reset

    def draw_reset(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(n, reset_width) uniform in ``reset_range``, computed as
        ``jax.random.uniform`` with ``minval`` and ``maxval`` does."""
        lo, hi = self.reset_range
        u = torch.rand(n, self.reset_width, generator=generator, device=self.device)
        return torch.clamp(u * (hi - lo) + lo, min=lo)

    def _draw(self, n: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        return self.sampler(n, generator).to(self.device, torch.float32)

    def _time_limit(self, t: torch.Tensor, terminated: torch.Tensor):
        """(done, info) of a step that ended at step count ``t``."""
        truncated = (t >= self.max_steps) & ~terminated
        return terminated | truncated, {"truncated": truncated}
