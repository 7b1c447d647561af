"""Pendulum-v1, batched on the device (gymnasium's swing-up with a
continuous torque); port of ``mmtrl_tpu/envs/classic/pendulum.py``.

The action is (n, 1), clipped to the torque limit; the reward is the
negative cost of angle, speed and torque.  ``done`` is only the 200-step
time limit, so ``info["truncated"]`` equals ``done`` and an off-policy
buffer bootstraps through every episode end.  Each operation is the JAX
env's, in its order and in float32 (``pi`` and ``2 pi`` as float32
constants); the angle is wrapped by ``torch.remainder``, the floor-mod of
``jnp.mod`` (``fmod`` differs for negative angles).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.base import StepResult
from mmtrl_tpu_torch.envs.classic._base import ClassicEnv

PI32 = float(np.float32(math.pi))
TWO_PI32 = float(np.float32(2 * math.pi))


@dataclasses.dataclass
class PendulumState:
    theta: torch.Tensor  # (n,) float32
    theta_dot: torch.Tensor
    t: torch.Tensor  # (n,) long


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + PI32, TWO_PI32) - PI32


class Pendulum(ClassicEnv):
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0
    max_steps = 200
    reset_width = 2  # theta, theta_dot
    reset_range = ((-PI32, -1.0), (PI32, 1.0))  # (low, high) of each column

    def draw_reset(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(n, 2): theta uniform in [-pi, pi), theta_dot in [-1, 1), each as
        ``jax.random.uniform`` with ``minval`` and ``maxval`` draws it."""
        lo, hi = (torch.tensor(b, device=self.device) for b in self.reset_range)
        u = torch.rand(n, self.reset_width, generator=generator, device=self.device)
        return torch.maximum(u * (hi - lo) + lo, lo)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        vals = self._draw(num_envs, generator)
        state = PendulumState(theta=vals[:, 0], theta_dot=vals[:, 1],
                              t=torch.zeros(num_envs, dtype=torch.long, device=self.device))
        return self._obs(state), state

    def _obs(self, s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)

    def _step_env(self, state: PendulumState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        """Deterministic: draws nothing from ``generator``."""
        u = torch.clamp(action.reshape(action.shape[0]), -self.max_torque, self.max_torque)
        cost = (_angle_normalize(state.theta) ** 2 + 0.1 * state.theta_dot**2
                + 0.001 * u**2)
        new_theta_dot = state.theta_dot + (
            3 * self.g / (2 * self.length) * torch.sin(state.theta)
            + 3.0 / (self.m * self.length**2) * u
        ) * self.dt
        new_theta_dot = torch.clamp(new_theta_dot, -self.max_speed, self.max_speed)
        new = PendulumState(theta=state.theta + new_theta_dot * self.dt,
                            theta_dot=new_theta_dot, t=state.t + 1)
        done, info = self._time_limit(new.t, torch.zeros_like(new.t, dtype=torch.bool))
        return self._obs(new), new, -cost, done, info

    @property
    def observation_space(self):
        high = [1.0, 1.0, self.max_speed]
        return spaces.Box([-h for h in high], high, (3,))

    @property
    def action_space(self):
        return spaces.Box(-self.max_torque, self.max_torque, (1,))

    @property
    def name(self):
        return "Pendulum-v1"
