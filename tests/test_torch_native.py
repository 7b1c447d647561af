"""The native 2600 envs and the DT host loop of the port against the JAX
package on the CPU: RALLY and BRICK stepped on the same seed and actions
(host arrays equal, observations and rewards within tolerance), the MFCC
tensor path against JAX's ``xp=jnp`` path, ``collect_trajectories_host``
buffer for buffer and ``evaluate_dt_host`` action for action."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.dt.hostloop import collect_trajectories_host as jax_collect
from mmtrl_tpu.algos.dt.hostloop import evaluate_dt_host as jax_evaluate
from mmtrl_tpu.algos.ppo.hostloop import _shaped_reward_np as jax_reward_np
from mmtrl_tpu.data.quant import dequant_audio_u8 as jax_dequant
from mmtrl_tpu.data.quant import quant_audio_u8 as jax_quant
from mmtrl_tpu.envs.homebrew_native import make_native_env as jax_make_native_env
from mmtrl_tpu.models.decision_transformer import DecisionTransformer as JaxDT
from mmtrl_tpu.models.decision_transformer import DTConfig as JaxDTConfig
from mmtrl_tpu_torch.algos.dt.hostloop import collect_trajectories_host, evaluate_dt_host
from mmtrl_tpu_torch.convert import dt_params_from_flax
from mmtrl_tpu_torch.data.quant import dequant_audio_u8, quant_audio_u8
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.homebrew_native import make_native_env
from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer, DTConfig
from mmtrl_tpu_torch.ops.mfcc import SKELETON_PLUS_PARAMS, mfcc_tensor

jax_mfcc = importlib.import_module("mmtrl_tpu.ops.mfcc")  # the package exports a function mfcc

# Observations in [-1, 1], float32 on both sides: the FFTs (pocketfft in
# both, other plans), the log and the projections round in other orders
# (about 1e-5 of cepstra up to 40), and each MFCC plane is divided by its
# own range; measured 2.3e-6 at most.
OBS_ATOL = 2e-5
STEPS = 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(env_id, n=2, **kw):
    kw = dict(num_envs=n, seed=5, episode_steps=30, **kw)
    return jax_make_native_env(env_id, **kw), make_native_env(env_id, device="cpu", **kw)


@pytest.mark.parametrize("env_id,sticky", [("rally_native", 0.0), ("brick_native", 0.25)])
def test_native_env_matches_jax(env_id, sticky):
    """Same seed, same actions: every host array equal (frames, audio,
    reward components, done, the sticky-action draws), and the observation
    built from the u8 audio code and the reward as JAX's."""
    jenv, env = _pair(env_id, repeat_action_probability=sticky)
    try:
        assert env.name == jenv.name == env_id
        assert env.num_actions == jenv.num_actions == 6
        assert env.observation_space.shape == jenv.observation_space.shape == (3, 84, 84)
        (jf, ja), (f, a) = jenv._host_reset(), env._host_reset()
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(a, ja)
        actions = np.random.RandomState(0).randint(0, 6, (STEPS, 2)).astype(np.int32)
        worst, dones = 0.0, 0
        for t in range(STEPS):
            code = quant_audio_u8(a)
            np.testing.assert_array_equal(code, jax_quant(ja))
            obs = env._obs(f, dequant_audio_u8(torch.from_numpy(code)))
            ref = np.asarray(jenv._obs(jnp.asarray(jf), jax_dequant(jnp.asarray(code))))
            worst = max(worst, float(np.abs(obs.numpy() - ref).max()))
            jout, out = jenv._host_step(actions[t]), env._host_step(actions[t])
            for x, y in zip(out, jout):
                np.testing.assert_array_equal(x, y)
            jf, ja, kd, ld, done, win = jout[:6]
            f, a = out[:2]
            reward = env._reward(kd, ld, win)
            assert reward.dtype == np.float32
            np.testing.assert_array_equal(reward, np.asarray(jenv._reward(kd, ld, win)))
            np.testing.assert_array_equal(reward, jax_reward_np(jenv, kd, ld, win))
            dones += int(done.sum())
        assert worst <= OBS_ATOL, worst
        assert dones >= 2  # the 30-step cap ended an episode in each env
        assert env.ram().shape == (2, 128)
        np.testing.assert_array_equal(env.ram(), jenv.ram())
    finally:
        env.close()
        jenv.close()


def test_mfcc_tensor_path_matches_jax():
    """Random 4-bit TIA windows, a blip and a silent window through the
    streaming Skeleton+ parameters.  The silent window's plane spans the
    energy column's log(eps) = -15.9 to cepstra near 0, so the 1e-6 floor
    of the per-window min-max is never reached there and its window is
    held to the same tolerance as the others; only a constant plane would
    meet the floor, which no window of a real signal gives."""
    rng = np.random.RandomState(1)
    sig = (rng.randint(0, 16, (4, 4192)) / 15.0 * 32000.0).astype(np.float32)
    sig[2] = 0.0  # silent
    sig[3] = 0.0
    sig[3, 1000:1100] = 32000.0 / 15.0  # one blip
    p = jax_mfcc.SKELETON_PLUS_PARAMS
    assert dataclasses.asdict(SKELETON_PLUS_PARAMS) == dataclasses.asdict(p)
    ref = np.asarray(jax.vmap(lambda s: jax_mfcc.mfcc(s, p, xp=jnp))(jnp.asarray(sig)))
    out = mfcc_tensor(torch.from_numpy(sig), SKELETON_PLUS_PARAMS).numpy()
    assert out.shape == ref.shape == (4, 44, 13)
    # float32 cepstra up to about 40 on both sides: 1e-4 absolute
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert out[2].max() - out[2].min() > 15.0
    # the numpy path (float64) agrees on the windows with sound in every
    # frame (a silent frame's floor is float64's eps there, log -36.0)
    np.testing.assert_allclose(out[:2], np.stack([jax_mfcc.mfcc(s, p) for s in sig[:2]]),
                               atol=1e-3, rtol=0)


def test_registry_and_missing_skeleton_rom(monkeypatch, tmp_path):
    env = make("rally_native", num_envs=1, device="cpu")
    env.close()
    with pytest.raises(FileNotFoundError):
        make("skeleton_plus_native", num_envs=1, device="cpu",
             rom_path=str(tmp_path / "SkelPlus.bin"))


TINY = JaxDTConfig(num_actions=6, context_len=4, d_model=32, n_layers=1, n_heads=2,
                   dropout=0.0, max_timestep=64, compute_dtype="float32", conv_type="small")


def test_collect_trajectories_host_matches_jax():
    """A deterministic policy on both sides, action = (step + env index) %
    6 with the step in the carry (it reads neither the observation nor the
    key): every buffer equal, the states to one step of their int8 code."""
    jenv, env = _pair("rally_native")
    try:
        jbuf, jstats = jax_collect(
            jenv, jax.random.PRNGKey(0), 70,
            lambda k, obs, done, c: ((c + jnp.arange(obs.shape[0])) % 6, c + 1), jnp.int32(0))
        buf, stats = collect_trajectories_host(
            env, torch.Generator().manual_seed(0), 70,
            lambda g, obs, done, c: ((c + torch.arange(obs.shape[0])) % 6, c + 1), 0)
    finally:
        env.close()
        jenv.close()
    assert stats == jstats and stats["behavior/episodes"] >= 4
    for name in ("actions", "rtg", "timesteps", "episode_starts"):
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      np.asarray(getattr(jbuf, name)), err_msg=name)
    assert buf.state_shape == tuple(jbuf.state_shape)
    assert buf.states.dtype == torch.bfloat16 and buf.states.shape == jbuf.states.shape
    # the int8 code of each observation element: an observation within
    # OBS_ATOL of JAX's may round to the neighbouring code (1/127 apart),
    # stored in bf16 (a step of 2^-8 near 1)
    states = buf.states.float().numpy()
    ref = np.asarray(jbuf.states.astype(jnp.float32))
    assert np.abs(states - ref).max() <= 1 / 127 + 2**-8
    assert (states == ref).mean() >= 0.9999


def test_evaluate_dt_host_matches_jax_action_for_action():
    """Greedy, converted weights, 30-step episodes: the actions of every
    pool step equal JAX's (recorded from both pools' ``_host_step``), and so
    the episode statistics."""
    jenv, env = _pair("rally_native")
    jparams = JaxDT(TINY).init(jax.random.PRNGKey(3), jnp.zeros((1, 4)),
                               jnp.zeros((1, 4, 3, 84, 84)), jnp.zeros((1, 4), jnp.int32),
                               jnp.zeros((1, 4), jnp.int32))
    model = DecisionTransformer(DTConfig(**dataclasses.asdict(TINY)), device="cpu",
                                state_channels=3)
    # Under the action head's init (orthogonal at scale 0.01) one action
    # wins every context of this untrained model; under this normal(0, 1)
    # head the greedy action moves between actions 0 and 1 with the context.
    jparams = jax.tree_util.tree_map(np.array, jparams)
    head = jparams["params"]["action_head"]["kernel"]
    jparams["params"]["action_head"]["kernel"] = np.random.RandomState(3).normal(
        0, 1.0, head.shape).astype(np.float32)
    model.load_state_dict(dt_params_from_flax(jparams))
    taken = {"jax": [], "port": []}
    for name, e in (("jax", jenv), ("port", env)):
        step = e._host_step
        e._host_step = lambda a, step=step, name=name: (taken[name].append(np.array(a)),
                                                        step(a))[1]
    try:
        ref = jax_evaluate(jenv, TINY, jparams, jax.random.PRNGKey(0), 3.0, num_steps=70,
                           rtg_clip=4.0)
        out = evaluate_dt_host(env, DTConfig(**dataclasses.asdict(TINY)), model,
                               torch.Generator().manual_seed(0), 3.0, num_steps=70, rtg_clip=4.0)
    finally:
        env.close()
        jenv.close()
    np.testing.assert_array_equal(np.stack(taken["port"]), np.stack(taken["jax"]))
    assert len(set(np.concatenate(taken["port"]).tolist())) >= 2  # not one constant action
    assert out == ref and out["eval/episodes"] >= 4
    assert model.training  # the caller's mode comes back
