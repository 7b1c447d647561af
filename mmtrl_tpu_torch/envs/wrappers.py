"""Running statistics and the env wrappers; port of ``ClipReward``,
``FrameStack``, ``RunningStat``, ``ClipAction``, ``NormalizeObservation``
and ``NormalizeReward`` of ``mmtrl_tpu/envs/wrappers.py``.

A wrapper is an ``Environment`` around another and steps the whole batch
at once.  JAX steps its wrappers under ``jax.vmap``, one env at a time, so
each env keeps statistics of its own, updated with a batch of one; here
the statistics carry the env batch on dim 0 (``RunningStat.create_each``,
``update_each``) and every env's row is updated from its own observation
or return, as JAX's are.  The normalizers call the inner env's ``step``,
whose auto-reset touches only the inner state, so the statistics and the
discounted return outlive an episode: wrap them outermost.
``ClipReward`` and ``FrameStack`` step through the base class's auto-reset,
as JAX's do: the inner env's transition without its own reset, then the
wrapper's reset where an episode ended (a fresh stack of k copies).  No
entry script of either package uses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.base import Environment, StepResult


@dataclasses.dataclass
class RunningStat:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # float32 from 1e-4 as the reference's RunningMeanStd; (n,) per env

    @classmethod
    def create(cls, shape: Tuple[int, ...], device: DeviceLike = None) -> "RunningStat":
        device = resolve_device(device)
        return cls(mean=torch.zeros(shape, device=device), var=torch.ones(shape, device=device),
                   count=torch.tensor(1e-4, device=device))

    @classmethod
    def create_each(cls, n: int, shape: Tuple[int, ...], device: DeviceLike = None
                    ) -> "RunningStat":
        """``n`` statistics of ``shape``, one per env, in one."""
        device = resolve_device(device)
        return cls(mean=torch.zeros((n,) + tuple(shape), device=device),
                   var=torch.ones((n,) + tuple(shape), device=device),
                   count=torch.full((n,), 1e-4, device=device))

    def _merge(self, count, b_mean, b_var, b_count):
        """The parallel-variance merge (reference:
        cleanrl/ppo_rnd_envpool.py:239-263), term for term."""
        delta = b_mean - self.mean
        tot = count + b_count
        new_mean = self.mean + delta * b_count / tot
        m_a = self.var * count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta**2 * count * b_count / tot
        return new_mean, m2 / tot, tot

    def update(self, batch: torch.Tensor) -> "RunningStat":
        """Merge the batch's population statistics (dim 0 is the batch)."""
        mean, var, tot = self._merge(self.count, batch.mean(dim=0),
                                     batch.var(dim=0, correction=0), batch.shape[0])
        return RunningStat(mean=mean, var=var, count=tot)

    def update_each(self, x: torch.Tensor) -> "RunningStat":
        """Per-env statistics: row i of ``x`` is env i's batch of one (its
        mean is itself, its variance 0), as JAX's ``update(x[None])`` under
        ``vmap``."""
        count = self.count.reshape(self.count.shape + (1,) * (x.dim() - 1))
        mean, var, tot = self._merge(count, x, torch.zeros_like(x), 1)
        return RunningStat(mean=mean, var=var, count=tot.reshape(self.count.shape))

    def normalize(self, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var + eps)


class _Wrapper(Environment):
    def __init__(self, env: Environment):
        self.env = env
        self.device = env.device

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def name(self):
        return self.env.name


class ClipReward(_Wrapper):
    """Sign-clip rewards like SB3's ClipRewardEnv (reference: src/train.py:57,
    flag --clip-rewards at src/utils.py:123-124); the raw reward is
    ``info["raw_reward"]``, for the episode statistics."""

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.env.reset(num_envs, generator)

    def _step_env(self, state: Any, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        obs, state, reward, done, info = self.env._step_env(state, action, generator)
        return obs, state, torch.sign(reward), done, dict(info, raw_reward=reward)


@dataclasses.dataclass
class StackState:
    inner: Any
    frames: torch.Tensor  # (n, k, C, H, W), newest last


class FrameStack(_Wrapper):
    """Stack the last k observations and flatten them into channels, the
    CASL queue pattern (casl_environment.py:42-94) without a host-side
    deque: the stack is part of the env state."""

    def __init__(self, env: Environment, k: int = 4):
        super().__init__(env)
        self.k = k

    @staticmethod
    def _stack_obs(frames: torch.Tensor) -> torch.Tensor:
        return frames.reshape((frames.shape[0], -1) + tuple(frames.shape[3:]))

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        obs, inner = self.env.reset(num_envs, generator)
        frames = obs[:, None].repeat_interleave(self.k, dim=1)
        return self._stack_obs(frames), StackState(inner=inner, frames=frames)

    def _step_env(self, state: StackState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        obs, inner, reward, done, info = self.env._step_env(state.inner, action, generator)
        frames = torch.cat([state.frames[:, 1:], obs[:, None]], dim=1)
        return self._stack_obs(frames), StackState(inner=inner, frames=frames), reward, done, info

    @property
    def observation_space(self):
        sp = self.env.observation_space
        return type(sp)(sp.low, sp.high, (sp.shape[0] * self.k,) + tuple(sp.shape[1:]))


class ClipAction(_Wrapper):
    """Clip continuous actions to the action-space bounds (reference:
    gym.wrappers.ClipAction in cleanrl/ppo_continuous_action.py:90).  Only
    the env sees the clipped action."""

    def __init__(self, env: Environment):
        super().__init__(env)
        sp = env.action_space
        self._low, self._high = (torch.as_tensor(b, dtype=torch.float32, device=self.device)
                                 for b in (sp.low, sp.high))

    def _clip(self, action: torch.Tensor) -> torch.Tensor:
        return torch.clamp(action, self._low, self._high)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.env.reset(num_envs, generator)

    def step(self, state: Any, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> StepResult:
        return self.env.step(state, self._clip(action), generator)

    def _step_env(self, state: Any, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        return self.env._step_env(state, self._clip(action), generator)


@dataclasses.dataclass
class NormObsState:
    inner: Any
    rms: RunningStat  # per env: mean and var (n, *obs_shape), count (n,)


class NormalizeObservation(_Wrapper):
    """Running mean/var observation normalization + clip, the reference's
    gym.wrappers.NormalizeObservation + TransformObservation clip
    (cleanrl/ppo_continuous_action.py:91-92).  ``info["final_obs"]`` stays
    the inner env's, unnormalized, as in JAX."""

    def __init__(self, env: Environment, clip: float = 10.0):
        super().__init__(env)
        self.clip = clip

    def _norm(self, rms: RunningStat, obs: torch.Tensor) -> torch.Tensor:
        return torch.clamp(rms.normalize(obs), -self.clip, self.clip)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        obs, inner = self.env.reset(num_envs, generator)
        rms = RunningStat.create_each(num_envs, obs.shape[1:], obs.device).update_each(obs)
        return self._norm(rms, obs), NormObsState(inner=inner, rms=rms)

    def step(self, state: NormObsState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> StepResult:
        obs, inner, reward, done, info = self.env.step(state.inner, action, generator)
        rms = state.rms.update_each(obs)
        return self._norm(rms, obs), NormObsState(inner=inner, rms=rms), reward, done, info

    _step_env = step

    @property
    def observation_space(self):
        return spaces.Box(-self.clip, self.clip, self.env.observation_space.shape)


@dataclasses.dataclass
class NormRewardState:
    inner: Any
    rms: RunningStat  # per env, of the discounted return: (n,)
    ret: torch.Tensor  # (n,) running discounted return


class NormalizeReward(_Wrapper):
    """Scale rewards by the std of the discounted return + clip, the
    reference's gym.wrappers.NormalizeReward + TransformReward clip
    (cleanrl/ppo_continuous_action.py:93-94).  The return's statistics
    take the return before an episode's end resets it; the unscaled
    reward is ``info["raw_reward"]``."""

    def __init__(self, env: Environment, gamma: float = 0.99, clip: float = 10.0):
        super().__init__(env)
        self.gamma, self.clip = gamma, clip

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        obs, inner = self.env.reset(num_envs, generator)
        return obs, NormRewardState(inner=inner,
                                    rms=RunningStat.create_each(num_envs, (), obs.device),
                                    ret=torch.zeros(num_envs, device=obs.device))

    def step(self, state: NormRewardState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> StepResult:
        obs, inner, reward, done, info = self.env.step(state.inner, action, generator)
        ret = state.ret * self.gamma + reward
        rms = state.rms.update_each(ret)
        ret = torch.where(done, 0.0, ret)
        scaled = torch.clamp(reward / torch.sqrt(rms.var + 1e-8), -self.clip, self.clip)
        info = dict(info, raw_reward=reward)
        return obs, NormRewardState(inner=inner, rms=rms, ret=ret), scaled, done, info

    _step_env = step
