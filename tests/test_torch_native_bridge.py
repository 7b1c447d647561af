"""The port's two raw native bridges against the JAX package on the CPU:
``NativeMinecraft2d`` (the C++ gridworld pool, rendered on the device) and
``AtariPool`` (the raw 2600 pool) on ``native/homebrew/rally.bin``, the
JAX tests' checks (``tests/test_native_bridge.py``,
``tests/test_atari_bridge.py``) made on both packages, and the gridworld
library built from its source without ``make``."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.envs.atari_bridge import AtariPool as JaxAtariPool
from mmtrl_tpu.envs.native_bridge import NativeMinecraft2d as JaxNativeMinecraft2d
from mmtrl_tpu.ops.mfcc import SKELETON_PLUS_PARAMS as JAX_PARAMS
from mmtrl_tpu.ops.mfcc import mfcc as jax_mfcc
from mmtrl_tpu_torch.envs import atari_bridge, native_bridge
from mmtrl_tpu_torch.envs.atari_bridge import RESET_SWITCH, RIGHT, UP, AtariPool
from mmtrl_tpu_torch.envs.homebrew_native import RALLY_ROM
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d, MinecraftState
from mmtrl_tpu_torch.envs.native_bridge import NativeMinecraft2d
from mmtrl_tpu_torch.ops.mfcc import SKELETON_PLUS_PARAMS, mfcc_tensor

N_ENVS = 8
# The render: one float32 einsum of a one-hot against the bank on both
# sides, summed in other orders (tests/test_native_bridge.py's 1e-5).
OBS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gridworld_pair():
    jenv, env = JaxNativeMinecraft2d(N_ENVS, seed=3), NativeMinecraft2d(N_ENVS, seed=3,
                                                                        device="cpu")
    yield jenv, env
    env.close()
    jenv.close()


def test_the_gridworld_library_builds_from_its_source(tmp_path, monkeypatch):
    """``compile_library`` with the Makefile's flags into a fresh path, no
    ``make``: the result loads and makes a pool."""
    monkeypatch.setattr(native_bridge, "LIB_PATH", tmp_path / "build" / "libmmtrl_envpool.so")
    path = native_bridge.build_native()
    assert path == str(tmp_path / "build" / "libmmtrl_envpool.so")
    assert not list((tmp_path / "build").glob("*.tmp.*"))
    lib = ctypes.CDLL(path)
    lib.mmtrl_make.restype = ctypes.c_int64
    lib.mmtrl_make.argtypes = [ctypes.c_int32, ctypes.c_uint64]
    lib.mmtrl_num_envs.restype = ctypes.c_int32
    lib.mmtrl_num_envs.argtypes = [ctypes.c_int64]
    handle = lib.mmtrl_make(3, 0)
    assert lib.mmtrl_num_envs(handle) == 3
    lib.mmtrl_close.argtypes = [ctypes.c_int64]
    lib.mmtrl_close(handle)


def test_gridworld_shapes_bounds_and_spaces(gridworld_pair):
    jenv, env = gridworld_pair
    obs, jobs = env.reset(), jenv.reset()
    assert obs.shape == jobs.shape == (N_ENVS, 2, 84, 84) and obs.dtype == torch.float32
    assert -1.0 <= float(obs.min()) and float(obs.max()) <= 1.0
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=OBS_ATOL)
    assert env.observation_space.shape == jenv.observation_space.shape == (2, 84, 84)
    assert env.action_space.n == jenv.action_space.n == 4
    silent = NativeMinecraft2d(2, use_audio=False, device="cpu")
    try:
        assert silent.reset().shape == (2, 1, 84, 84)
        assert silent.observation_space.shape == (1, 84, 84)
    finally:
        silent.close()


def test_gridworld_steps_as_jax_does(gridworld_pair):
    """200 steps under the same random actions: tiles, audio index, reward
    and done equal to JAX's pool, the observation within ``OBS_ATOL`` of
    JAX's device render; every episode ends on a target (+-10) or at 30
    steps (-1 a step)."""
    jenv, env = gridworld_pair
    (tiles, audio), (jtiles, jaudio) = env._host_reset(), jenv._host_reset()
    np.testing.assert_array_equal(tiles, jtiles)
    np.testing.assert_array_equal(audio, jaudio)
    rng = np.random.RandomState(0)
    lengths, ended = np.zeros(N_ENVS, int), 0
    for t in range(200):
        actions = rng.randint(0, 4, N_ENVS).astype(np.int32)
        if t % 2:  # the public step, on tensors
            obs, rewards, dones = env.step(torch.from_numpy(actions))
            jobs, jrewards, jdones = jenv.step(jnp.asarray(actions))
            assert rewards.dtype == torch.float32 and dones.dtype == torch.bool
            np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=OBS_ATOL)
            rewards, dones = rewards.numpy(), dones.numpy()
            np.testing.assert_array_equal(rewards, np.asarray(jrewards))
            np.testing.assert_array_equal(dones, np.asarray(jdones))
        else:  # the host arrays
            out, jout = env._host_step(actions), jenv._host_step(actions)
            for x, y in zip(out, jout):
                np.testing.assert_array_equal(x, y)
            rewards, dones = out[2], out[3].astype(bool)
        assert set(rewards.tolist()) <= {-1.0, 10.0, -10.0}
        lengths += 1
        for i in np.flatnonzero(dones):
            assert rewards[i] in (10.0, -10.0) or lengths[i] >= 30
            lengths[i] = 0
            ended += 1
    assert lengths.max() <= 30 and ended >= N_ENVS


def test_gridworld_render_is_the_device_envs(gridworld_pair):
    """The render of the pool's tile maps equals the device ``Minecraft2d``'s
    render of the same configurations, frame and audio plane."""
    _, env = gridworld_pair
    tiles, audio = env._host_reset()
    obs = env._render(tiles, audio)
    maps = tiles.reshape(N_ENVS, 5, 5)

    def loc(tile):
        return torch.tensor(np.stack([np.argwhere(m == tile)[0] for m in maps]))

    device_env = Minecraft2d(device="cpu")
    state = MinecraftState(agent=loc(1), good=loc(2), bad=loc(3), gem=loc(4),
                           gem_type=torch.zeros(N_ENVS, dtype=torch.long),
                           t=torch.zeros(N_ENVS, dtype=torch.long))
    assert torch.equal(device_env._tile_map(state), torch.from_numpy(tiles).long())
    ref = device_env._obs(state)
    np.testing.assert_allclose(obs[:, 0].numpy(), ref[:, 0].numpy(), rtol=0, atol=OBS_ATOL)
    assert torch.equal(obs[:, 1], device_env._audio[torch.from_numpy(audio).long()])


@pytest.fixture
def atari_pair():
    jpool, pool = JaxAtariPool(RALLY_ROM, 4, seed=0), AtariPool(RALLY_ROM, 4, seed=0)
    yield jpool, pool
    pool.close()
    jpool.close()


def test_atari_pool_matches_jax_bit_for_bit(atari_pair):
    """30 steps of joystick play, then RESET_SWITCH pressed and play on:
    frames, audio and RAM equal to JAX's pool at every step; frames show
    the game, the audio is heard."""
    jpool, pool = atari_pair
    assert pool.frame_shape == jpool.frame_shape == (192, 160)
    assert pool.audio_len == jpool.audio_len == 524
    assert (UP, RIGHT, RESET_SWITCH) == (0x01, 0x08, 0x20)
    plan = [UP if (i // 5) % 2 else RIGHT for i in range(30)] + [RESET_SWITCH] * 3 + [UP] * 10
    heard = 0.0
    for a in plan:
        actions = np.full(4, a, np.uint8)
        (frames, audio), (jframes, jaudio) = pool.step(actions), jpool.step(actions)
        assert frames.dtype == np.uint8 and audio.dtype == np.float32
        assert frames.shape == (4, 192, 160) and audio.shape == (4, 2, 524)
        np.testing.assert_array_equal(frames, jframes)
        np.testing.assert_array_equal(audio, jaudio)
        np.testing.assert_array_equal(pool.ram(), jpool.ram())
        heard += float(audio.sum())
    assert (frames > 0).mean() > 0.01 and heard > 0.0
    assert pool.ram().shape == (4, 128) and pool.ram().dtype == np.uint8


def test_atari_pool_feeds_the_streaming_mfcc(atari_pair):
    """One audio window through the port's ``mfcc_tensor`` and JAX's
    ``mfcc``: 13 cepstra a frame, finite, within 1e-4 (the float32
    cepstra, up to about 40; tests/test_torch_native.py's MFCC
    tolerance)."""
    jpool, pool = atari_pair
    for _ in range(20):
        _, audio = pool.step(np.full(4, UP, np.uint8))
    window = audio[0, 0] * 32000.0
    feats = mfcc_tensor(torch.from_numpy(window)[None], SKELETON_PLUS_PARAMS)[0]
    ref = np.asarray(jax_mfcc(jnp.asarray(window), JAX_PARAMS, xp=jnp))
    assert feats.shape == ref.shape and feats.shape[1] == 13
    assert torch.isfinite(feats).all()
    np.testing.assert_allclose(feats.numpy(), ref, atol=1e-4, rtol=0)


def test_a_missing_rom_raises_in_both(tmp_path):
    missing = str(tmp_path / "none.bin")
    with pytest.raises(FileNotFoundError, match="none.bin"):
        JaxAtariPool(missing, 2)
    with pytest.raises(FileNotFoundError, match="none.bin"):
        atari_bridge.AtariPool(missing, 2)
