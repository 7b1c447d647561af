"""Host-bound gymnasium/MuJoCo envs behind the batched-env surface; port of
``mmtrl_tpu/envs/gym_bridge.py`` (the reference's continuous-control
benchmark path, cleanrl/ppo_continuous_action.py:86-96 and the td3, ddpg
and sac MuJoCo scripts).

MuJoCo's C engine runs on the host.  ``GymPool`` steps ``num_envs``
``gymnasium.make(env_id)`` instances there with EnvPool's auto-reset: the
observation returned with done is the fresh episode's first, while
``final_obs`` carries the true post-transition observation and
``truncated`` the time-limit flag, the SB3 ``handle_timeout_termination``
contract the off-policy buffers rely on.  Two surfaces step the pool:

- the host loops (``algos/offpolicy/hostloop.py``) call ``_host_reset`` and
  ``_host_step`` on numpy arrays;
- ``reset(num_envs)``/``step(state, action)`` on the pool's device, the
  batched-env surface of the fused loops (``algos/ppo/core.py``,
  ``algos/offpolicy/ddpg.py``, ``utils/evaluate.py``): the JAX pool's
  ``v_reset``/``v_step``, which reach the host through an ordered
  ``io_callback``.  Here each step copies the action to the host once and
  the six result arrays back in one copy; the state is a step counter.

``wrap="ppo_continuous"`` applies the reference's own wrapper stack to
each sub-env (gymnasium's ``ClipAction``, ``NormalizeObservation``,
``NormalizeReward`` and the +-10 clips), recording the raw reward before
the reward transforms.  Every sub-env is built by ``_make_sub_env``, which
alone imports gymnasium (or dm_control): without the package the pool
raises ``ModuleNotFoundError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs import spaces


def _gymnasium(what: str):
    """The gymnasium module; without it a ``ModuleNotFoundError`` saying
    that ``what`` needs it."""
    try:
        import gymnasium
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(f"{what}: host gymnasium envs need the gymnasium package, "
                                  "which is not installed", name="gymnasium") from e
    return gymnasium


def _raw_reward_recorder(env):
    """``env`` wrapped to put its pre-normalization reward in
    ``info["raw_reward"]``, so the episode statistics report raw returns
    (the reference applies RecordEpisodeStatistics under the reward
    transforms)."""
    gym = _gymnasium("GymPool")

    class RawRewardRecorder(gym.Wrapper):
        def step(self, action):
            obs, reward, term, trunc, info = self.env.step(action)
            return obs, reward, term, trunc, dict(info, raw_reward=float(reward))

    return RawRewardRecorder(env)


def _dm_control_env(env_id: str, seed: int = 0):
    """A minimal dm_control -> gymnasium shim (shimmy is not installed).

    The reference's RPO benchmark runs the dm_control suite through
    shimmy's DmControlCompatibility and FlattenObservation
    (cleanrl/rpo_continuous_action.py, rpo.md:116+).  ``env_id`` is
    ``dm_control/<domain>-<task>`` (e.g. dm_control/ball_in_cup-catch); the
    observation flattens to a float64 vector, and dm_control's 1,000-step
    episode end (discount 1 at ``last()``) is a time-limit truncation."""
    gym = _gymnasium(env_id)
    from dm_control import suite

    domain, task = env_id.split("/", 1)[1].rsplit("-", 1)

    class DmControlToGym(gym.Env):
        def __init__(self):
            self._env = suite.load(domain, task, task_kwargs={"random": seed})
            spec = self._env.action_spec()
            self.action_space = gym.spaces.Box(np.asarray(spec.minimum, np.float32),
                                               np.asarray(spec.maximum, np.float32),
                                               dtype=np.float32)
            dim = sum(max(1, int(np.prod(v.shape)))
                      for v in self._env.observation_spec().values())
            self.observation_space = gym.spaces.Box(-np.inf, np.inf, (dim,), np.float64)

        @staticmethod
        def _flat(obs) -> np.ndarray:
            return np.concatenate([np.asarray(v, np.float64).ravel() for v in obs.values()])

        def reset(self, seed=None, options=None):
            # gymnasium's contract: an explicit seed restarts the stream,
            # even when it equals the one in use
            if seed is not None:
                self._env = suite.load(domain, task, task_kwargs={"random": seed})
            return self._flat(self._env.reset().observation), {}

        def step(self, action):
            ts = self._env.step(np.asarray(action))
            last = ts.last()
            terminated = bool(last and ts.discount == 0.0)
            return (self._flat(ts.observation), float(ts.reward or 0.0), terminated,
                    bool(last and not terminated), {})

    return DmControlToGym()


class GymPool:
    """``num_envs`` host gymnasium envs, stepped as one batch; sub-env ``i``
    resets with seed ``seed * 1000 + i``.  Tensors of the batched-env
    surface live on ``device`` (None: the card, raising without one)."""

    def __init__(self, env_id: str, num_envs: int, seed: int = 0, wrap: str = "none",
                 gamma: float = 0.99, device: DeviceLike = None):
        if wrap not in ("none", "ppo_continuous"):
            raise ValueError(f"wrap must be 'none' or 'ppo_continuous', not {wrap!r}")
        self.env_id = env_id
        self.num_envs = num_envs
        self.seed = seed
        self.device = resolve_device(device)
        self._envs = []
        for i in range(num_envs):
            e = self._make_sub_env(i)
            if wrap == "ppo_continuous":
                e = self._reference_stack(e, gamma)
            self._envs.append(e)
        self._seeds = [seed * 1000 + i for i in range(num_envs)]
        obs_space, act_space = self._envs[0].observation_space, self._envs[0].action_space
        self._obs_shape = tuple(obs_space.shape)
        self._discrete = hasattr(act_space, "n")
        if self._discrete:
            self._act_space = spaces.Discrete(int(act_space.n))
        else:
            self._act_space = spaces.Box(np.asarray(act_space.low, np.float32),
                                         np.asarray(act_space.high, np.float32),
                                         tuple(act_space.shape))
        lo, hi = getattr(obs_space, "low", None), getattr(obs_space, "high", None)
        self._obs_space = spaces.Box(-np.inf if lo is None else lo, np.inf if hi is None else hi,
                                     self._obs_shape)

    def _make_sub_env(self, index: int):
        """Sub-env ``index``, before any wrapper: ``gymnasium.make(env_id)``,
        or the dm_control shim for a ``dm_control/`` id."""
        if self.env_id.startswith("dm_control/"):
            return _dm_control_env(self.env_id, seed=self.seed * 1000 + index)
        return _gymnasium(f"GymPool({self.env_id!r})").make(self.env_id)

    @staticmethod
    def _reference_stack(e, gamma: float):
        """cleanrl/ppo_continuous_action.py:86-96, without the video
        recorder."""
        gym = _gymnasium("GymPool wrap='ppo_continuous'")
        e = gym.wrappers.ClipAction(e)
        e = gym.wrappers.NormalizeObservation(e)
        e = gym.wrappers.TransformObservation(e, lambda obs: np.clip(obs, -10, 10),
                                              e.observation_space)
        e = _raw_reward_recorder(e)
        e = gym.wrappers.NormalizeReward(e, gamma=gamma)
        return gym.wrappers.TransformReward(e, lambda r: float(np.clip(r, -10, 10)))

    # ---- host side ---------------------------------------------------------
    def _host_reset(self) -> np.ndarray:
        """(N, *obs) float32: every sub-env reset with its own seed."""
        return np.stack([e.reset(seed=s)[0]
                         for e, s in zip(self._envs, self._seeds)]).astype(np.float32)

    def _host_step(self, actions: np.ndarray):
        """(obs, final_obs, reward, raw_reward, done, truncated) of one step
        of every sub-env: float32 observations and rewards, uint8 flags; a
        done sub-env is reset and ``obs`` holds its first observation."""
        n = self.num_envs
        obs = np.zeros((n,) + self._obs_shape, np.float32)
        final_obs = np.zeros_like(obs)
        rewards = np.zeros(n, np.float32)
        raw_rewards = np.zeros(n, np.float32)
        dones = np.zeros(n, np.uint8)
        truncs = np.zeros(n, np.uint8)
        for i, e in enumerate(self._envs):
            a = int(actions[i]) if self._discrete else actions[i]
            o, r, term, trunc, info = e.step(a)
            rewards[i] = r
            raw_rewards[i] = info.get("raw_reward", r)
            final_obs[i] = o
            if term or trunc:
                dones[i] = 1
                truncs[i] = 1 if (trunc and not term) else 0
                o, _ = e.reset()
            obs[i] = o
        return obs, final_obs, rewards, raw_rewards, dones, truncs

    def close(self):
        for e in self._envs:
            e.close()

    # ---- batched-env surface of the fused loops ------------------------------
    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """(obs, state): the pool's reset on its device, the state an int32
        step counter at 0.  ``num_envs`` must be the pool's size;
        ``generator`` is accepted and unused, as JAX ignores its keys: each
        sub-env draws from its own seeded generator."""
        if num_envs != self.num_envs:
            raise ValueError(f"{self.name}: a pool of {self.num_envs} envs cannot reset "
                             f"{num_envs}")
        obs = torch.as_tensor(self._host_reset(), device=self.device)
        return obs, torch.zeros(num_envs, dtype=torch.int32, device=self.device)

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """(obs, state + 1, reward, done, info) of one pool step under
        ``action``: the action is copied to the host (a device -> host
        sync), every sub-env steps and auto-resets, and the six arrays come
        back packed in one float32 copy.  ``info`` holds ``final_obs``,
        ``raw_reward`` and ``truncated`` (bool).  ``generator`` is unused,
        as in ``reset``."""
        actions = action.detach().cpu().numpy()
        obs, final_obs, reward, raw_reward, done, trunc = self._host_step(actions)
        n = self.num_envs
        packed = np.concatenate([obs.reshape(n, -1), final_obs.reshape(n, -1),
                                 np.stack([reward, raw_reward, done, trunc], axis=1)], axis=1,
                                dtype=np.float32)
        dev = torch.from_numpy(packed).to(self.device)
        width = obs[0].size
        info: Dict[str, torch.Tensor] = {
            "final_obs": dev[:, width:2 * width].reshape(obs.shape),
            "raw_reward": dev[:, 2 * width + 1],
            "truncated": dev[:, 2 * width + 3] != 0,
        }
        return (dev[:, :width].reshape(obs.shape), state + 1, dev[:, 2 * width],
                dev[:, 2 * width + 2] != 0, info)

    # ---- spaces ------------------------------------------------------------
    @property
    def observation_space(self) -> spaces.Box:
        return self._obs_space

    @property
    def action_space(self):
        return self._act_space

    @property
    def num_actions(self) -> int:
        return self._act_space.n

    @property
    def name(self) -> str:
        return self.env_id


def make_any(env_id: str, num_envs: Optional[int] = None, seed: int = 0, wrap: str = "none",
             gamma: float = 0.99, device: DeviceLike = None) -> Tuple[object, bool]:
    """(env, is_bridge): the registry's device env when it has ``env_id``,
    else a ``GymPool`` of ``num_envs`` (default 1) host envs.  A bridge
    pool has a fixed size and ignores the generators."""
    from mmtrl_tpu_torch.envs.registry import make, registry

    if env_id.lower() in registry:
        return make(env_id, device=device), False
    return GymPool(env_id, num_envs or 1, seed=seed, wrap=wrap, gamma=gamma, device=device), True
