"""The port's trajectory data (mmtrl_tpu_torch/algos/dt/data.py) against the
JAX package's on the CPU: returns-to-go, the window gather and its mask bit
for bit from the indices JAX draws, and the collector's invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.dt.data import TrajectoryBuffer as JaxTrajectoryBuffer
from mmtrl_tpu.algos.dt.data import returns_to_go as jax_returns_to_go
from mmtrl_tpu_torch.algos.dt.data import (
    TrajectoryBuffer,
    collect_trajectories,
    returns_to_go,
)
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d

STATE_SHAPE = (2, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op thread pool on top of that oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_returns_to_go_golden():
    rewards = torch.tensor([[1.0], [2.0], [3.0], [4.0], [5.0]])
    dones = torch.tensor([[0.0], [0.0], [1.0], [0.0], [0.0]])
    # Episode 1: steps 0-2 -> rtg 6, 5, 3; episode 2: steps 3-4 -> rtg 9, 5
    assert returns_to_go(rewards, dones)[:, 0].tolist() == [6, 5, 3, 9, 5]


def test_returns_to_go_matches_jax():
    rng = np.random.RandomState(0)
    rewards = rng.choice([-1.0, 10.0, -10.0], size=(40, 5)).astype(np.float32)
    dones = rng.rand(40, 5) < 0.15
    ref = np.asarray(jax_returns_to_go(jnp.asarray(rewards), jnp.asarray(dones)))
    out = returns_to_go(torch.from_numpy(rewards), torch.from_numpy(dones))
    np.testing.assert_array_equal(out.numpy(), ref)  # the same float32 sums in order


def _buffers(seed, N=3, T=50):
    """The same stream-major data as a JAX and a port buffer: episodes of
    random lengths, so windows cross episode boundaries."""
    rng = np.random.RandomState(seed)
    ts = np.zeros((N, T), np.int32)
    for n in range(N):
        t = rng.randint(0, 5)
        for i in range(T):
            ts[n, i] = t
            t = 0 if rng.rand() < 0.15 else t + 1
    states = rng.uniform(-1, 1, (N, T, int(np.prod(STATE_SHAPE)))).astype(np.float32)
    actions = rng.randint(0, 4, (N, T)).astype(np.int32)
    rtg = rng.uniform(-30, 10, (N, T)).astype(np.float32)
    jbuf = JaxTrajectoryBuffer(
        states=jnp.asarray(states), actions=jnp.asarray(actions), rtg=jnp.asarray(rtg),
        timesteps=jnp.asarray(ts), episode_starts=jnp.asarray(ts == 0),
        state_shape=STATE_SHAPE,
    )
    tbuf = TrajectoryBuffer(
        states=torch.from_numpy(states), actions=torch.from_numpy(actions).long(),
        rtg=torch.from_numpy(rtg), timesteps=torch.from_numpy(ts).long(),
        episode_starts=torch.from_numpy(ts == 0), state_shape=STATE_SHAPE,
    )
    return jbuf, tbuf


@pytest.mark.parametrize("seed,B,K", [(0, 16, 6), (1, 32, 30), (2, 8, 1)])
def test_gather_windows_matches_jax_sample(seed, B, K):
    jbuf, tbuf = _buffers(seed)
    key = jax.random.PRNGKey(seed)
    ref = jbuf.sample(key, B, K)
    # the draws of data.py's sample, from the same key
    k_t, k_n = jax.random.split(key)
    t_end = jax.random.randint(k_t, (B,), K - 1, jbuf.horizon)
    n_idx = jax.random.randint(k_n, (B,), 0, jbuf.num_streams)
    out = tbuf.gather_windows(torch.from_numpy(np.asarray(t_end)).long(),
                              torch.from_numpy(np.asarray(n_idx)).long(), K)
    assert out[1].shape == (B, K) + STATE_SHAPE
    assert 0 < int(out[4].sum()) <= B * K
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_gather_masks_positions_from_an_earlier_episode():
    # tests/test_dt.py's boundary probe: an episode of 6 steps, then one of 4
    T, K = 10, 4
    ts = torch.tensor([[0, 1, 2, 3, 4, 5, 0, 1, 2, 3]])
    buf = TrajectoryBuffer(
        states=torch.arange(T, dtype=torch.float32).reshape(1, T, 1),
        actions=torch.zeros((1, T), dtype=torch.long), rtg=torch.zeros((1, T)),
        timesteps=ts, episode_starts=ts == 0, state_shape=(1,),
    )
    t_end = torch.arange(K - 1, T)
    _, states, _, _, mask = buf.gather_windows(t_end, torch.zeros_like(t_end), K)
    t_idx = t_end[:, None] + torch.arange(K) - (K - 1)
    crosses = (t_idx < 6) & (t_end[:, None] >= 6)
    assert torch.equal(mask, ~crosses)
    assert torch.equal(states[..., 0], torch.where(mask, t_idx.float(), 0.0))


def test_draw_windows_ranges_and_seeding():
    _, tbuf = _buffers(3)
    draws = [tbuf.draw_windows(torch.Generator().manual_seed(5), 500, 7) for _ in range(2)]
    t_end, n_idx = draws[0]
    assert torch.equal(t_end, draws[1][0]) and torch.equal(n_idx, draws[1][1])
    assert int(t_end.min()) == 6 and int(t_end.max()) == tbuf.horizon - 1
    assert set(n_idx.tolist()) == set(range(tbuf.num_streams))


def test_collect_trajectories_shapes_and_invariants():
    env = Minecraft2d(device="cpu")
    buf = collect_trajectories(env, 40, 3, generator=torch.Generator().manual_seed(0))
    # stored flat and stream-major (N, T, F), in bf16 by default
    assert buf.states.shape == (3, 40, 2 * 84 * 84) and buf.states.dtype == torch.bfloat16
    assert buf.state_shape == (2, 84, 84)
    assert buf.actions.shape == buf.rtg.shape == buf.timesteps.shape == (3, 40)
    assert torch.equal(buf.episode_starts, buf.timesteps == 0)
    assert bool(buf.episode_starts[:, 0].all())
    assert int(buf.actions.min()) >= 0 and int(buf.actions.max()) < env.num_actions
    # within an episode the timestep counts up and every non-final step
    # earns -1, so the return-to-go drops by exactly that reward
    cont = ~buf.episode_starts[:, 1:]
    assert torch.equal(buf.timesteps[:, 1:][cont], buf.timesteps[:, :-1][cont] + 1)
    assert torch.equal((buf.rtg[:, :-1] - buf.rtg[:, 1:])[cont], torch.full_like(buf.rtg[:, 1:][cont], -1.0))
    assert int(buf.timesteps.max()) < 30 and bool(buf.episode_starts[:, 1:].any())
    assert float(buf.rtg.abs().max()) <= 40.0  # 30 steps * |-1| + 10
    rtg, states, actions, ts, mask = buf.sample(torch.Generator().manual_seed(1), 4, 5)
    assert states.shape == (4, 5, 2, 84, 84) and mask.dtype == torch.bool
