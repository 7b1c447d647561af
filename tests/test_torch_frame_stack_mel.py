"""``envs/wrappers.py::ClipReward`` and ``FrameStack`` and
``ops/mfcc.py::log_mel_spectrogram`` against the JAX package's: the
wrappers on a deterministic counter env written twice (once per package),
exactly, and stacked on Minecraft2d under JAX's reset draws, within the
env's observation tolerance; the log-mel features under numpy bit for bit
and under torch against jnp in float32."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import struct
from mmtrl_tpu.envs import spaces as jax_spaces
from mmtrl_tpu.envs.base import Environment as JaxEnvironment
from mmtrl_tpu.envs.minecraft2d import Minecraft2d as JaxMinecraft2d
from mmtrl_tpu.envs.wrappers import ClipReward as JaxClipReward
from mmtrl_tpu.envs.wrappers import FrameStack as JaxFrameStack
from mmtrl_tpu.ops import log_mel_spectrogram as jax_log_mel
from mmtrl_tpu.ops.mfcc import SKELETON_PLUS_PARAMS as JAX_SKELETON_PARAMS
from mmtrl_tpu.ops.mfcc import MFCCParams as JaxMFCCParams
from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
from mmtrl_tpu_torch.envs.wrappers import ClipReward, FrameStack
from mmtrl_tpu_torch.ops import MFCCParams, log_mel_spectrogram
from mmtrl_tpu_torch.ops.mfcc import SKELETON_PLUS_PARAMS
from test_torch_envs import OBS_ATOL, Replay, _jax_draws


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- a counter env, once per package ------------------------------------------
# Each step adds the action less 1 to v and counts t; the reward is 1.5 v
# (negative, zero or positive); an episode ends once t reaches 4 + action;
# the observation is a (2, 3, 2) image of t and v.  Reset draws nothing.
@struct.dataclass
class JaxCounterState:
    t: jnp.ndarray
    v: jnp.ndarray


class JaxCounter(JaxEnvironment):
    def _obs(self, s):
        return jnp.stack([jnp.full((3, 2), s.t, jnp.float32), jnp.full((3, 2), s.v) + jnp.arange(2.0)])

    def _reset(self, key):
        s = JaxCounterState(t=jnp.zeros((), jnp.int32), v=jnp.zeros((), jnp.float32))
        return self._obs(s), s

    def _step_env(self, key, state, action):
        s = JaxCounterState(t=state.t + 1, v=state.v + action - 1.0)
        return self._obs(s), s, 1.5 * s.v, s.t >= 4 + action, {"t": s.t}

    @property
    def observation_space(self):
        return jax_spaces.Box(-10.0, 10.0, (2, 3, 2))

    @property
    def action_space(self):
        return jax_spaces.Discrete(3)

    @property
    def name(self):
        return "counter"


@dataclasses.dataclass
class CounterState:
    t: torch.Tensor
    v: torch.Tensor


class Counter(Environment):
    device = torch.device("cpu")

    def _obs(self, s):
        n = s.t.shape[0]
        return torch.stack([s.t.float()[:, None, None].expand(n, 3, 2),
                            (s.v[:, None, None] + torch.arange(2.0)).expand(n, 3, 2)], dim=1)

    def reset(self, num_envs, generator=None):
        s = CounterState(t=torch.zeros(num_envs, dtype=torch.int32), v=torch.zeros(num_envs))
        return self._obs(s), s

    def _step_env(self, state, action, generator=None):
        s = CounterState(t=state.t + 1, v=state.v + action - 1.0)
        return self._obs(s), s, 1.5 * s.v, s.t >= 4 + action, {"t": s.t}

    @property
    def observation_space(self):
        return spaces.Box(-10.0, 10.0, (2, 3, 2))

    @property
    def action_space(self):
        return spaces.Discrete(3)

    @property
    def name(self):
        return "counter"


def _run_pair(jenv, env, n, steps, seed=0, atol=0.0):
    """``steps`` random actions through both; every output compared."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jobs, jstate = jax.jit(jenv.v_reset)(keys)
    obs, state = env.reset(n)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=atol)
    v_step = jax.jit(jenv.v_step)
    actions = np.random.RandomState(seed).randint(0, env.num_actions, (steps, n))
    key = jax.random.PRNGKey(seed + 1)
    dones = 0
    for a in actions:
        key, k = jax.random.split(key)
        jobs, jstate, jrew, jdone, jinfo = v_step(jax.random.split(k, n), jstate, jnp.asarray(a))
        obs, state, rew, done, info = env.step(state, torch.from_numpy(a).long())
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=atol)
        np.testing.assert_allclose(info["final_obs"].numpy(), np.asarray(jinfo["final_obs"]),
                                   rtol=0, atol=atol)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        if "raw_reward" in jinfo:
            np.testing.assert_array_equal(info["raw_reward"].numpy(), np.asarray(jinfo["raw_reward"]))
        dones += int(done.sum())
    return dones


@pytest.mark.parametrize("wrap", ["clip", "stack", "stack_of_clip", "clip_of_stack"])
def test_wrappers_on_the_counter_match_jax(wrap):
    builds = {"clip": lambda e, C, F: C(e), "stack": lambda e, C, F: F(e, 3),
              "stack_of_clip": lambda e, C, F: F(C(e), 4), "clip_of_stack": lambda e, C, F: C(F(e, 2))}
    jenv = builds[wrap](JaxCounter(), JaxClipReward, JaxFrameStack)
    env = builds[wrap](Counter(), ClipReward, FrameStack)
    assert env.observation_space.shape == jenv.observation_space.shape
    assert env.name == jenv.name == "counter"  # the inner env's, through the wrappers
    assert env.num_actions == jenv.num_actions == 3
    assert _run_pair(jenv, env, n=3, steps=30) >= 6  # the auto-reset restacks


def test_stacked_minecraft_matches_jax_under_its_draws():
    """``ClipReward(FrameStack(Minecraft2d, 4))`` for 40 steps of 4 envs,
    the port's resets replayed from JAX's keys: observations within the
    render's OBS_ATOL, rewards (clipped and raw) and dones equal."""
    n, steps = 4, 40
    jinner = JaxMinecraft2d()
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    draws = [_jax_draws(jinner, keys)]
    key = jax.random.PRNGKey(1)
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(_jax_draws(jinner, jax.vmap(lambda x: jax.random.split(x)[1])(
            jax.random.split(k, n))))
    env = ClipReward(FrameStack(Minecraft2d(device="cpu", sampler=Replay(draws)), 4))
    jenv = JaxClipReward(JaxFrameStack(jinner, 4))
    assert env.observation_space.shape == jenv.observation_space.shape == (8, 84, 84)
    _run_pair(jenv, env, n, steps, seed=0, atol=OBS_ATOL)


# ---- log-mel --------------------------------------------------------------------
def _signals():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(4000), np.zeros(1200), rng.uniform(-1, 1, 300),
            np.sin(np.arange(16000) * 0.05) * 0.3]


@pytest.mark.parametrize("which", ["default", "skeleton_plus"])
def test_log_mel_spectrogram_matches_jax(which):
    params, jparams = ((MFCCParams(), JaxMFCCParams()) if which == "default"
                       else (SKELETON_PLUS_PARAMS, JAX_SKELETON_PARAMS))
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    for signal in _signals():
        ours = log_mel_spectrogram(signal, params)
        ref = jax_log_mel(signal, jparams)
        assert ours.dtype == np.float64
        np.testing.assert_array_equal(ours, ref)  # numpy on both sides: bit for bit
        t_ours = log_mel_spectrogram(torch.tensor(signal, dtype=torch.float32), params, xp=torch)
        t_ref = np.asarray(jax_log_mel(jnp.asarray(signal, jnp.float32), jparams, xp=jnp))
        assert t_ours.dtype == torch.float32 and t_ours.shape == t_ref.shape
        # float32 FFTs of two libraries: within 1e-4 of the features' scale
        np.testing.assert_allclose(t_ours.numpy(), t_ref, rtol=0,
                                   atol=1e-4 * max(np.abs(t_ref).max(), 1.0))
