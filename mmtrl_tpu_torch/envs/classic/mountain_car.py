"""MountainCar-v0, batched on the device (Moore's underpowered car); port
of ``mmtrl_tpu/envs/classic/mountain_car.py``.

gymnasium's MountainCar-v0 constants and reward, and its 200-step time
limit folded into ``done`` and reported as ``truncated``.  Each operation
is the JAX env's, in its order and in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.base import StepResult
from mmtrl_tpu_torch.envs.classic._base import ClassicEnv


@dataclasses.dataclass
class MountainCarState:
    position: torch.Tensor  # (n,) float32
    velocity: torch.Tensor
    t: torch.Tensor  # (n,) long


class MountainCar(ClassicEnv):
    min_position = -1.2
    max_position = 0.6
    max_speed = 0.07
    goal_position = 0.5
    goal_velocity = 0.0
    force = 0.001
    gravity = 0.0025
    max_steps = 200
    reset_width = 1  # the position; the velocity starts at 0
    reset_range = (-0.6, -0.4)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        pos = self._draw(num_envs, generator)[:, 0]
        state = MountainCarState(position=pos, velocity=torch.zeros_like(pos),
                                 t=torch.zeros(num_envs, dtype=torch.long, device=self.device))
        return self._obs(state), state

    def _obs(self, s: MountainCarState) -> torch.Tensor:
        return torch.stack([s.position, s.velocity], dim=-1)

    def _step_env(self, state: MountainCarState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        """Deterministic: draws nothing from ``generator``."""
        velocity = state.velocity + (action - 1) * self.force + torch.cos(
            3 * state.position
        ) * (-self.gravity)
        velocity = torch.clamp(velocity, -self.max_speed, self.max_speed)
        position = torch.clamp(state.position + velocity, self.min_position, self.max_position)
        velocity = torch.where((position <= self.min_position) & (velocity < 0), 0.0, velocity)
        new = MountainCarState(position=position, velocity=velocity, t=state.t + 1)
        terminated = (position >= self.goal_position) & (velocity >= self.goal_velocity)
        done, info = self._time_limit(new.t, terminated)
        return self._obs(new), new, torch.full_like(position, -1.0), done, info

    @property
    def observation_space(self):
        return spaces.Box([self.min_position, -self.max_speed],
                          [self.max_position, self.max_speed], (2,))

    @property
    def action_space(self):
        return spaces.Discrete(3)

    @property
    def name(self):
        return "MountainCar-v0"
