"""Parity of the port's Minecraft2d (mmtrl_tpu_torch/envs) with the JAX env on
the CPU: constants, observations for the same entities, and rewards, dones
and auto-resets over a scripted action sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.envs import assets as jassets
from mmtrl_tpu.envs.minecraft2d import Minecraft2d as JaxMinecraft2d
from mmtrl_tpu_torch.envs import assets, spaces
from mmtrl_tpu_torch.envs.minecraft2d import MAX_ITER, Minecraft2d

OBS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op thread pool on top of that oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(env, keys):
    """(cells (n, 4), gem_type (n,)) that the JAX env's reset makes from keys."""
    s = jax.vmap(env._reset)(keys)[1]
    cells = np.stack(
        [np.asarray(loc[:, 0] * 5 + loc[:, 1]) for loc in (s.agent, s.good, s.bad, s.gem)],
        axis=1,
    )
    return torch.tensor(cells).long(), torch.tensor(np.asarray(s.gem_type)).long()


class Replay:
    """A reset sampler that hands out recorded draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, n, generator=None):
        cells, gem_type = self.draws.pop(0)
        assert cells.shape == (n, 4)
        return cells, gem_type


def test_render_bank_matches_jax():
    # Held in observation units (x 2/255): OpenCV's resize weights are
    # reproduced to ~1e-7, which is ~5e-5 on the 0..255 pixel scale.
    np.testing.assert_allclose(
        assets.minecraft_render_bank() * (2 / 255),
        jassets.minecraft_render_bank() * (2 / 255),
        atol=OBS_ATOL, rtol=0,
    )


def test_audio_planes_match_jax():
    np.testing.assert_allclose(
        assets.audio_planes(), jassets.audio_planes(), atol=OBS_ATOL, rtol=0
    )


def test_resize_matrices_are_row_stochastic():
    from mmtrl_tpu_torch.ops.mfcc import bicubic_resize_matrix

    np.testing.assert_allclose(
        assets.cubic_resize_matrix(104, 84).sum(1), 1.0, atol=1e-6
    )
    for n_in, n_out in ((99, 84), (13, 84)):
        np.testing.assert_allclose(bicubic_resize_matrix(n_in, n_out).sum(1), 1.0, atol=1e-12)


@pytest.mark.parametrize("use_audio", [True, False])
def test_observations_match_jax(use_audio):
    jenv = JaxMinecraft2d(use_audio=use_audio)
    keys = jax.random.split(jax.random.PRNGKey(3), 32)
    draw = _jax_draws(jenv, keys)
    obs_jax, _ = jax.vmap(jenv._reset)(keys)
    env = Minecraft2d(use_audio=use_audio, device="cpu", sampler=Replay([draw]))
    obs, state = env.reset(32)
    assert obs.shape == (32, 2 if use_audio else 1, 84, 84) and obs.dtype == torch.float32
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_jax), atol=OBS_ATOL, rtol=0)


def test_gem_audio_heard_only_within_range():
    # agent at (2, 2); gem adjacent (d^2 = 1), diagonal (2) or two away (4)
    cells = torch.tensor([[12, 0, 4, 13], [12, 0, 4, 18], [12, 0, 4, 22], [12, 0, 4, 22]])
    gem_type = torch.tensor([0, 1, 0, 1])
    env = Minecraft2d(device="cpu", sampler=Replay([(cells, gem_type)]))
    obs, _ = env.reset(4)
    planes = torch.from_numpy(assets.audio_planes())
    for i, plane in enumerate([0, 1, 2, 2]):
        assert torch.equal(obs[i, 1], planes[plane])


def test_scripted_steps_match_jax():
    """Rewards and dones match exactly, observations to OBS_ATOL, over 70
    steps of 8 envs, auto-resets included (the port replays the JAX draws)."""
    n, steps = 8, 70
    jenv = JaxMinecraft2d()
    k0, key = jax.random.split(jax.random.PRNGKey(11))
    init_keys = jax.random.split(k0, n)
    actions = np.random.RandomState(5).randint(0, 4, (steps, n))
    step_keys = []
    draws = [_jax_draws(jenv, init_keys)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        ks = jax.random.split(k, n)
        step_keys.append(ks)
        draws.append(_jax_draws(jenv, jax.vmap(lambda x: jax.random.split(x)[1])(ks)))

    obs_j, state_j = jenv.v_reset(init_keys)
    env = Minecraft2d(device="cpu", sampler=Replay(draws))
    obs, state = env.reset(n)
    v_step = jax.jit(jenv.v_step)
    n_done = 0
    for t in range(steps):
        obs_j, state_j, rew_j, done_j, _ = v_step(step_keys[t], state_j, jnp.asarray(actions[t]))
        obs, state, rew, done, info = env.step(state, torch.from_numpy(actions[t]).long())
        np.testing.assert_array_equal(rew.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=OBS_ATOL, rtol=0)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(state_j.t))
        np.testing.assert_array_equal(state.agent.numpy(), np.asarray(state_j.agent))
        assert "final_obs" in info
        n_done += int(done.sum())
    assert n_done >= n  # every env ended at least one episode (MAX_ITER = 30)


def test_time_limit_and_reward_values():
    # agent (0,0), good (4,4), bad (4,3), gem (0,4): UP clamps, no target is reached
    cells = torch.tensor([[0, 24, 23, 4]])
    env = Minecraft2d(device="cpu", sampler=Replay([(cells, torch.tensor([0]))] * (MAX_ITER + 1)))
    obs, state = env.reset(1)
    for t in range(MAX_ITER):
        obs, state, rew, done, _ = env.step(state, torch.tensor([0]))
        assert rew.item() == -1.0
        assert bool(done) == (t == MAX_ITER - 1)


@pytest.mark.parametrize("gem_type,reward", [(0, 10.0), (1, -10.0)])
def test_good_target_reward_depends_on_gem(gem_type, reward):
    # agent (0,0) -> RIGHT reaches good (0,1)
    cells = torch.tensor([[0, 1, 24, 12]])
    env = Minecraft2d(device="cpu", sampler=Replay([(cells, torch.tensor([gem_type]))] * 2))
    _, state = env.reset(1)
    _, _, rew, done, info = env.step(state, torch.tensor([2]))
    assert rew.item() == reward and bool(done) and bool(info["at_good"])


def test_reset_draws_distinct_cells():
    env = Minecraft2d(device="cpu")
    g = torch.Generator().manual_seed(0)
    cells, gem_type = env.draw_reset(512, g)
    assert cells.shape == (512, 4) and cells.min() >= 0 and cells.max() < 25
    assert all(len(set(row.tolist())) == 4 for row in cells)
    assert set(gem_type.tolist()) == {0, 1}
    again = env.draw_reset(512, torch.Generator().manual_seed(0))
    assert torch.equal(cells, again[0]) and torch.equal(gem_type, again[1])


def test_spaces():
    env = Minecraft2d(device="cpu")
    assert env.num_actions == 4 and env.name == "minecraft"
    assert env.observation_space.shape == (2, 84, 84)
    assert env.action_space.contains(3) and not env.action_space.contains(4)
    assert spaces.Box(0.0, 4.0, (2,)).contains(np.array([0.0, 4.0]))
