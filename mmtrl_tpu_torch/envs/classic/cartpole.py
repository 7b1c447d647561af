"""CartPole-v1, batched on the device (Barto, Sutton and Anderson's
dynamics); port of ``mmtrl_tpu/envs/classic/cartpole.py``.

Euler integration with gymnasium's CartPole-v1 constants and termination
thresholds; the 500-step time limit is folded into ``done`` and reported
as ``truncated``.  Each operation is the JAX env's, in its order and in
float32, so the two agree step for step from the same state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.base import StepResult
from mmtrl_tpu_torch.envs.classic._base import ClassicEnv


@dataclasses.dataclass
class CartPoleState:
    x: torch.Tensor  # (n,) float32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # (n,) long


class CartPole(ClassicEnv):
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masscart + masspole
    length = 0.5
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4
    max_steps = 500
    reset_width = 4
    reset_range = (-0.05, 0.05)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        vals = self._draw(num_envs, generator)
        state = CartPoleState(
            x=vals[:, 0], x_dot=vals[:, 1], theta=vals[:, 2], theta_dot=vals[:, 3],
            t=torch.zeros(num_envs, dtype=torch.long, device=self.device),
        )
        return self._obs(state), state

    def _obs(self, s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def _step_env(self, state: CartPoleState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        """Deterministic: draws nothing from ``generator``."""
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costh = torch.cos(state.theta)
        sinth = torch.sin(state.theta)
        temp = (
            force + self.polemass_length * state.theta_dot**2 * sinth
        ) / self.total_mass
        theta_acc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh**2 / self.total_mass)
        )
        x_acc = temp - self.polemass_length * theta_acc * costh / self.total_mass

        new = CartPoleState(
            x=state.x + self.tau * state.x_dot,
            x_dot=state.x_dot + self.tau * x_acc,
            theta=state.theta + self.tau * state.theta_dot,
            theta_dot=state.theta_dot + self.tau * theta_acc,
            t=state.t + 1,
        )
        terminated = (
            (torch.abs(new.x) > self.x_threshold)
            | (torch.abs(new.theta) > self.theta_threshold)
        )
        done, info = self._time_limit(new.t, terminated)
        reward = torch.ones_like(new.x)
        return self._obs(new), new, reward, done, info

    @property
    def observation_space(self):
        high = [4.8, math.inf, 0.42, math.inf]
        return spaces.Box([-h for h in high], high, (4,))

    @property
    def action_space(self):
        return spaces.Discrete(2)

    @property
    def name(self):
        return "CartPole-v1"
