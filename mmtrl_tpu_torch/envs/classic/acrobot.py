"""Acrobot-v1, batched on the device (Sutton's two-link underactuated
swing-up); port of ``mmtrl_tpu/envs/classic/acrobot.py``.

RK4 integration of the book's dynamics with gymnasium's Acrobot-v1
constants and termination; the 500-step time limit is folded into
``done`` and reported as ``truncated``.  Each operation is the JAX env's,
in its order and in float32; the dynamics are chaotic, so the two stay
close over a few steps from the same state, not over an episode.
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
class AcrobotState:
    joint: torch.Tensor  # (n, 4) float32: theta1, theta2, dtheta1, dtheta2
    t: torch.Tensor  # (n,) long


def _wrap(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``lo + jnp.mod(x - lo, hi - lo)``: the remainder takes the sign of
    the (positive) divisor, as ``jnp.mod`` computes it from ``fmod``."""
    span = hi - lo
    r = torch.fmod(x - lo, span)
    return lo + torch.where(r < 0, r + span, r)


class Acrobot(ClassicEnv):
    dt = 0.2
    link_length_1 = 1.0
    link_mass_1 = 1.0
    link_mass_2 = 1.0
    link_com_1 = 0.5
    link_com_2 = 0.5
    link_moi = 1.0
    max_vel_1 = 4 * math.pi
    max_vel_2 = 9 * math.pi
    max_steps = 500
    reset_width = 4
    reset_range = (-0.1, 0.1)

    def _dsdt(self, augmented: torch.Tensor) -> torch.Tensor:
        """(n, 5) derivative of (theta1, theta2, dtheta1, dtheta2, torque)."""
        m1, m2 = self.link_mass_1, self.link_mass_2
        l1 = self.link_length_1
        lc1, lc2 = self.link_com_1, self.link_com_2
        i1 = i2 = self.link_moi
        g = 9.8
        a = augmented[:, -1]
        th1, th2, dth1, dth2 = augmented[:, 0], augmented[:, 1], augmented[:, 2], augmented[:, 3]
        d1 = (
            m1 * lc1**2
            + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(th2))
            + i1
            + i2
        )
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(th2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(th1 + th2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dth2**2 * torch.sin(th2)
            - 2 * m2 * l1 * lc2 * dth2 * dth1 * torch.sin(th2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(th1 - math.pi / 2)
            + phi2
        )
        ddth2 = (
            a + d2 / d1 * phi1 - m2 * l1 * lc2 * dth1**2 * torch.sin(th2) - phi2
        ) / (m2 * lc2**2 + i2 - d2**2 / d1)
        ddth1 = -(d2 * ddth2 + phi1) / d1
        return torch.stack([dth1, dth2, ddth1, ddth2, torch.zeros_like(a)], dim=-1)

    def _rk4(self, y0: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        k1 = self._dsdt(y0)
        k2 = self._dsdt(y0 + dt / 2 * k1)
        k3 = self._dsdt(y0 + dt / 2 * k2)
        k4 = self._dsdt(y0 + dt * k3)
        return y0 + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        state = AcrobotState(joint=self._draw(num_envs, generator),
                             t=torch.zeros(num_envs, dtype=torch.long, device=self.device))
        return self._obs(state), state

    def _obs(self, s: AcrobotState) -> torch.Tensor:
        th1, th2 = s.joint[:, 0], s.joint[:, 1]
        return torch.stack([torch.cos(th1), torch.sin(th1), torch.cos(th2), torch.sin(th2),
                            s.joint[:, 2], s.joint[:, 3]], dim=-1)

    def _step_env(self, state: AcrobotState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        """Deterministic: draws nothing from ``generator``."""
        torque = (action - 1).to(state.joint.dtype)  # torques (-1, 0, 1)[action]
        ns = self._rk4(torch.cat([state.joint, torque[:, None]], dim=-1))
        ns = torch.stack([
            _wrap(ns[:, 0], -math.pi, math.pi),
            _wrap(ns[:, 1], -math.pi, math.pi),
            torch.clamp(ns[:, 2], -self.max_vel_1, self.max_vel_1),
            torch.clamp(ns[:, 3], -self.max_vel_2, self.max_vel_2),
        ], dim=-1)
        new = AcrobotState(joint=ns, t=state.t + 1)
        terminated = -torch.cos(ns[:, 0]) - torch.cos(ns[:, 1] + ns[:, 0]) > 1.0
        done, info = self._time_limit(new.t, terminated)
        reward = torch.where(terminated, 0.0, -1.0)
        return self._obs(new), new, reward, done, info

    @property
    def observation_space(self):
        high = [1.0, 1.0, 1.0, 1.0, self.max_vel_1, self.max_vel_2]
        return spaces.Box([-h for h in high], high, (6,))

    @property
    def action_space(self):
        return spaces.Discrete(3)

    @property
    def name(self):
        return "Acrobot-v1"
