"""``utils/video.py`` and ``utils/visualize.py`` against the JAX package's:
``obs_to_frames`` bit for bit; ``write_gif``'s file (the port's own GIF
encoder, no PIL) decoded by PIL against JAX's PIL-written file (frame
count, each frame's delay, the loop, every pixel; runs of equal frames,
which PIL merges); ``record_episode`` under JAX's draws (the envs'
replayable sampler hooks fed from JAX's key chain) with a greedy agent
carrying JAX's weights, on Doorpuzzle and CartPole, frames equal;
``save_episode_gif`` and ``visualize_env``."""

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

import jax
import jax.numpy as jnp
from mmtrl_tpu.envs.classic import CartPole as JaxCartPole
from mmtrl_tpu.envs.doorpuzzle import Doorpuzzle as JaxDoorpuzzle
from mmtrl_tpu.models import MLPActorCritic as JaxMLPActorCritic
from mmtrl_tpu.models import MultimodalRecurrentAgent as JaxAgent
from mmtrl_tpu.utils import video as jax_video
from mmtrl_tpu.utils import visualize as jax_visualize
from mmtrl_tpu_torch.convert import agent_params_from_flax
from mmtrl_tpu_torch.envs.classic.cartpole import CartPole
from mmtrl_tpu_torch.envs.doorpuzzle import Doorpuzzle
from mmtrl_tpu_torch.models.agents import MLPActorCritic, MultimodalRecurrentAgent
from mmtrl_tpu_torch.scripts import ppo, train
from mmtrl_tpu_torch.utils import video, visualize
from test_torch_classic import Replay as ClassicReplay
from test_torch_classic import reset_values
from test_torch_doorpuzzle import Replay as DoorReplay
from test_torch_doorpuzzle import _jax_draws, _reset_draw


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


def decode(path):
    """What PIL reads from a GIF: frames as RGB arrays, each frame's
    duration, the loop count."""
    im = Image.open(path)
    frames = [(np.asarray(f.convert("RGB")).copy(), f.info.get("duration"))
              for f in ImageSequence.Iterator(im)]
    return frames, im.info.get("loop"), im.n_frames


def assert_same_gif(ours, ref, levels=0):
    """The same frame count, delays and loop; the pixels equal, or within
    ``levels`` grey levels."""
    a, b = decode(ours), decode(ref)
    assert a[1] == b[1] == 0 and a[2] == b[2] == len(a[0]) == len(b[0])
    for (fa, da), (fb, db) in zip(a[0], b[0]):
        assert da == db
        np.testing.assert_allclose(fa.astype(int), fb.astype(int), rtol=0, atol=levels)
    info = video.read_gif_header(ours)
    assert info["frames"] == a[2] and info["loop"] == 0
    assert info["delays_ms"] == [d for _, d in a[0]]


def test_obs_to_frames_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    cases = [rng.uniform(-1.3, 1.3, (9, 2, 84, 84)).astype(np.float32),  # clipped at +-1
             rng.uniform(-1, 1, (5, 20, 30)),
             rng.normal(size=(7, 4)).astype(np.float32),
             rng.normal(size=(6, 3, 1)),
             np.full((4, 17), 2.5, np.float32),  # a constant vector: zero range
             rng.normal(size=(3, 130))]  # wider than 64: one pixel a dimension
    for obs in cases:
        ours, ref = video.obs_to_frames(obs), jax_video.obs_to_frames(obs)
        assert ours.dtype == np.uint8 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("fps,size", [(15, (168, 168)), (8, None), (30, (100, 61)),
                                      (120, (168, 168))])
def test_write_gif_decodes_to_what_jax_writes(fps, size, in_tmp):
    """Random frames (the LZW table fills and clears), runs of equal frames
    (PIL merges them and sums their delays: five of 66 ms come out as
    130, 130 and 60), a lone frame, all frames equal; at 120 fps a frame's
    8 ms truncates to a delay of 0, which neither writer stores."""
    rng = np.random.default_rng(1)
    levels = (rng.integers(0, 4, (12, 84, 84)) * 85).astype(np.uint8)
    runs = np.concatenate([levels[:1], levels[:1], levels[1:2], levels[1:2], levels[2:3]])
    cases = {"noise": rng.integers(0, 256, (3, 84, 84)).astype(np.uint8), "levels": levels,
             "runs": runs, "lone": levels[:1], "same": np.repeat(levels[:1], 6, axis=0),
             "tall": rng.integers(0, 256, (2, 30, 7)).astype(np.uint8)}
    for name, frames in cases.items():
        ours = video.write_gif(frames, f"port/{name}.gif", fps=fps, size=size)
        ref = jax_video.write_gif(frames, f"jax/{name}.gif", fps=fps, size=size)
        assert_same_gif(ours, ref)
    if (fps, size) == (15, (168, 168)):
        assert [d for _, d in decode("port/runs.gif")[0]] == [130, 130, 60]
        assert decode("port/same.gif")[2] == 1


def test_save_episode_gif_and_the_panel_match_jax(in_tmp):
    frames = np.random.default_rng(2).uniform(-1.2, 1.2, (6, 84, 84))
    frames[3] = frames[2]
    assert_same_gif(visualize.save_episode_gif(frames, "port.gif"),
                    jax_visualize.save_episode_gif(frames, "jax.gif"))
    pytest.importorskip("matplotlib")
    obs = frames[:2]
    for module in (visualize, jax_visualize):
        fig = module.visualize_env(obs, attention_history=[0.5, 0.25], out_path=f"{module.__name__}.png")
        assert len(fig.axes) == 3  # video, audio, attention
    import matplotlib.pyplot as plt

    plt.close("all")


def _episode_keys(key, n, num_steps):
    """JAX ``record_episode``'s key chain: the reset's keys, then each
    step's ``v_step`` keys."""
    key, k_reset = jax.random.split(key)
    reset_keys, step_keys = jax.random.split(k_reset, n), []
    for _ in range(num_steps):
        key, _, k_step = jax.random.split(key, 3)
        step_keys.append(jax.random.split(k_step, n))
    return reset_keys, step_keys


def _second_halves(keys):
    return jax.vmap(lambda k: jax.random.split(k)[1])(keys)


def test_record_episode_on_doorpuzzle_matches_jax():
    """A greedy casl agent (small towers, JAX's weights) for 64 steps of
    Doorpuzzle, its slips and resets replayed from JAX's keys: the same
    observations, so the same frames bit for bit; the episodes end and
    restart inside the window."""
    steps = 64
    jenv = JaxDoorpuzzle()
    jmodel = JaxAgent(num_actions=jenv.num_actions, conv_type="small", attn_type="casl")
    obs_shape = jenv.observation_space.shape
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((1, 1) + obs_shape),
                                  jnp.zeros((1, 1), bool), jmodel.initial_carry(1))

    def jax_policy(p, obs, done, carry, key):
        logits, _, carry = jmodel.apply(p, obs[None], done[None], carry)
        return jnp.argmax(logits[0], axis=-1), carry

    key = jax.random.PRNGKey(777)
    ref = jax_video.record_episode(jenv, jax_policy, params, key, steps, jmodel.initial_carry(1))
    reset_keys, step_keys = _episode_keys(key, 1, steps)
    draw = _jax_draws(jenv)
    slips, resets = DoorReplay(), DoorReplay()
    key_type, cell = _reset_draw(jenv, reset_keys)
    resets.draws.append((torch.from_numpy(np.array(key_type)).long(),
                         torch.from_numpy(np.array(cell)).long()))
    for keys in step_keys:
        slip, reset = draw(keys)
        slips.draws.append(slip)
        resets.draws.append(reset)
    env = Doorpuzzle(device="cpu", sampler=resets, slip_sampler=slips)
    model = MultimodalRecurrentAgent(env.num_actions, conv_type="small", attn_type="casl",
                                     device="cpu")
    model.load_state_dict(agent_params_from_flax(jax.device_get(params)))
    ours = video.record_episode(env, train.recurrent_video_policy, model, torch.Generator(),
                                steps, model.initial_carry(1))
    assert not slips.draws and len(resets.draws) == 0
    assert ours.shape == ref.shape == (steps,) + obs_shape
    np.testing.assert_array_equal(video.obs_to_frames(ours), jax_video.obs_to_frames(ref))
    assert len({f.tobytes() for f in video.obs_to_frames(ours)}) > 4


def test_record_episode_on_cartpole_matches_jax():
    """A greedy MLP (JAX's weights) for 256 steps of CartPole, the resets
    replayed from JAX's keys: the states within the classic envs' 1e-6 a
    step (XLA's float32 sin and cos are an ulp from torch's), the greedy
    actions and so the episodes alike, the frames equal."""
    steps = 256
    jenv = JaxCartPole()
    jmodel = JaxMLPActorCritic(num_actions=2)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 4)))

    def jax_policy(p, obs, done, carry, key):
        logits, _ = jmodel.apply(p, obs)
        return jnp.argmax(logits, axis=-1), carry

    key = jax.random.PRNGKey(8)
    ref = jax_video.record_episode(jenv, jax_policy, params, key, steps)
    reset_keys, step_keys = _episode_keys(key, 1, steps)
    reset_of = jax.jit(jax.vmap(lambda k: jenv._reset(k)[1]))
    draws = [reset_values(reset_of(reset_keys))]
    draws += [reset_values(reset_of(_second_halves(keys))) for keys in step_keys]
    env = CartPole(device="cpu", sampler=ClassicReplay(draws))
    model = MLPActorCritic(2, 4, device="cpu")
    model.load_state_dict(agent_params_from_flax(jax.device_get(params)))
    ours = video.record_episode(env, ppo.video_policy, model, torch.Generator(), steps)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * max(np.abs(ref).max(), 1))
    np.testing.assert_array_equal(video.obs_to_frames(ours), jax_video.obs_to_frames(ref))
    # episodes end (the pole past 0.21 rad) and restart near 0 inside the window
    assert (np.abs(np.diff(ours[:, 2])) > 0.15).sum() >= 2
