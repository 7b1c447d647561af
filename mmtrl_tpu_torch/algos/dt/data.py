"""Trajectory data for the offline decision-transformer phase; port of
``mmtrl_tpu/algos/dt/data.py``.

A behaviour policy is rolled in the batched device env, returns-to-go are
computed with a reverse loop over time, and fixed-length context windows
are gathered on the device.  Sampling is split in two: ``draw_windows``
draws where each window ends and in which stream, ``gather_windows``
gathers and masks the windows deterministically from those indices, so a
test can feed it the indices another implementation drew.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from mmtrl_tpu_torch.envs.base import Environment


def returns_to_go(rewards: torch.Tensor, dones: torch.Tensor) -> torch.Tensor:
    """Undiscounted within-episode returns-to-go over time-major (T, N).

    ``dones[t]`` marks the END of the episode at step t (the flag returned by
    ``env.step``), so the sum restarts after including step t's reward."""
    rewards, dones = rewards.float(), dones.float()
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + (1.0 - dones[t]) * carry
        out[t] = carry
    return out


@dataclasses.dataclass
class TrajectoryBuffer:
    """Stream-major (N, T, ...) storage of batched rollouts, window-sampled on
    the device.  States are stored flat, (N, T, prod(state_shape)), so every
    context window is one contiguous (K, F) slab.  ``timesteps`` restart at
    episode boundaries; a window's positions from an earlier episode are
    masked out when it is gathered."""

    states: torch.Tensor  # (N, T, F)
    actions: torch.Tensor  # (N, T) long
    rtg: torch.Tensor  # (N, T) float32
    timesteps: torch.Tensor  # (N, T) long
    episode_starts: torch.Tensor  # (N, T) bool: step t begins a new episode
    state_shape: tuple = ()

    @property
    def horizon(self) -> int:
        return self.states.shape[1]

    @property
    def num_streams(self) -> int:
        return self.states.shape[0]

    def draw_windows(
        self, generator: Optional[torch.Generator], batch_size: int, context_len: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t_end, n_idx), each (B,): window ends uniform in [K - 1, T) and
        streams uniform in [0, N), as the JAX ``sample`` draws them."""
        device = self.states.device
        t_end = torch.randint(context_len - 1, self.horizon, (batch_size,),
                              generator=generator, device=device)
        n_idx = torch.randint(0, self.num_streams, (batch_size,),
                              generator=generator, device=device)
        return t_end, n_idx

    def gather_windows(
        self, t_end: torch.Tensor, n_idx: torch.Tensor, context_len: int
    ) -> Tuple[torch.Tensor, ...]:
        """(rtg, states, actions, timesteps, mask), each (B, K, ...), of the
        windows of ``context_len`` steps ending at ``t_end`` in streams
        ``n_idx``.  A position is valid iff the episode timestep counts down
        consistently to the window's end; invalid positions are zeroed."""
        K = context_len
        offsets = torch.arange(K, device=t_end.device) - (K - 1)
        t_idx = t_end[:, None] + offsets  # (B, K)
        n = n_idx[:, None]
        states = self.states[n, t_idx].reshape((t_end.shape[0], K) + tuple(self.state_shape))
        actions, rtg, timesteps = (x[n, t_idx] for x in (self.actions, self.rtg, self.timesteps))
        expected = timesteps[:, -1:] + offsets
        mask = (expected >= 0) & (timesteps == expected)

        def zero(x):
            m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
            return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))

        return zero(rtg), zero(states), zero(actions), zero(timesteps), mask

    def sample(
        self, generator: Optional[torch.Generator], batch_size: int, context_len: int
    ) -> Tuple[torch.Tensor, ...]:
        """``gather_windows`` of freshly drawn windows."""
        return self.gather_windows(
            *self.draw_windows(generator, batch_size, context_len), context_len
        )


def random_buffer(
    num_streams: int,
    horizon: int,
    generator: torch.Generator,
    state_shape: tuple = (2, 84, 84),
    num_actions: int = 4,
) -> TrajectoryBuffer:
    """``bench.py``'s synthetic buffer on the generator's device: bf16 frames
    uniform in [-1, 1], uniform actions, returns-to-go uniform in [-30, 10]
    and timesteps cycling through 64, with no episode starts marked."""
    device = generator.device
    N, T = num_streams, horizon
    states = torch.rand((N, T, math.prod(state_shape)), generator=generator, device=device,
                        dtype=torch.bfloat16)
    return TrajectoryBuffer(
        states=states.mul_(2).sub_(1),
        actions=torch.randint(0, num_actions, (N, T), generator=generator, device=device),
        rtg=torch.rand((N, T), generator=generator, device=device) * 40.0 - 30.0,
        timesteps=(torch.arange(T, device=device) % 64).repeat(N, 1),
        episode_starts=torch.zeros((N, T), dtype=torch.bool, device=device),
        state_shape=tuple(state_shape),
    )


def collect_trajectories(
    env: Environment,
    num_steps: int,
    num_envs: int,
    policy_fn: Optional[Callable] = None,
    policy_carry: Optional[object] = None,
    state_dtype: torch.dtype = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
) -> TrajectoryBuffer:
    """Roll a behaviour policy for (num_steps, num_envs) on the env's device
    and package a ``TrajectoryBuffer``.

    ``policy_fn(generator, obs, done, carry) -> (action, carry)``; uniform
    over the env's actions when None.  ``policy_carry`` seeds a recurrent
    policy.  ``generator`` drives the env's reset draws and the uniform
    policy."""
    device = env.device
    if policy_fn is None:

        def policy_fn(gen, obs, done, carry):
            action = torch.randint(0, env.num_actions, (obs.shape[0],),
                                   generator=gen, device=device)
            return action, carry

    obs, env_state = env.reset(num_envs, generator)
    state_shape = tuple(obs.shape[1:])
    t_in_ep = torch.zeros(num_envs, dtype=torch.long, device=device)
    done = torch.zeros(num_envs, dtype=torch.bool, device=device)
    carry = policy_carry
    states = torch.empty((num_steps, num_envs, obs[0].numel()), dtype=state_dtype,
                         device=device)
    actions = torch.empty((num_steps, num_envs), dtype=torch.long, device=device)
    rewards = torch.empty((num_steps, num_envs), dtype=torch.float32, device=device)
    dones = torch.empty((num_steps, num_envs), dtype=torch.bool, device=device)
    timesteps = torch.empty((num_steps, num_envs), dtype=torch.long, device=device)
    for t in range(num_steps):
        action, carry = policy_fn(generator, obs, done, carry)
        states[t] = obs.reshape(num_envs, -1)
        actions[t], timesteps[t] = action, t_in_ep
        obs, env_state, reward, done, _ = env.step(env_state, action, generator)
        rewards[t], dones[t] = reward, done
        t_in_ep = torch.where(done, 0, t_in_ep + 1)
    rtg = returns_to_go(rewards, dones)
    # Stored stream-major (N, T, ...) so that sampled windows are contiguous.
    swap = lambda x: x.transpose(0, 1).contiguous()  # noqa: E731
    return TrajectoryBuffer(
        states=swap(states), actions=swap(actions), rtg=swap(rtg),
        timesteps=swap(timesteps), episode_starts=swap(timesteps == 0),
        state_shape=state_shape,
    )
