"""The port's value learning against the JAX package's on the CPU, on the
same seeded numpy inputs and converted weights: the replay ring,
``linear_epsilon``, both Q networks, ``categorical_projection``,
``dqn_td_update`` and ``c51_td_update`` (two updates each: loss, mean Q,
the new parameters and the Adam state), and pool steps of the cartridge
host loop's ``step_fn`` on RALLY, JAX's draws replayed into the port: the
stores, the updates and the target syncs fall on the same pool steps."""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmtrl_tpu.algos.offpolicy.c51 import c51_td_update as jax_c51_td_update
from mmtrl_tpu.algos.offpolicy.c51 import categorical_projection as jax_projection
from mmtrl_tpu.algos.offpolicy.common import linear_epsilon as jax_linear_epsilon
from mmtrl_tpu.algos.offpolicy.dqn import DQNConfig as JaxDQNConfig
from mmtrl_tpu.algos.offpolicy.dqn import DQNTrainState as JaxDQNTrainState
from mmtrl_tpu.algos.offpolicy.dqn import dqn_td_update as jax_dqn_td_update
from mmtrl_tpu.algos.offpolicy.hostloop_dqn import make_dqn_hostloop as jax_make_dqn_hostloop
from mmtrl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from mmtrl_tpu.data.quant import dequant_audio_u8 as jax_dequant
from mmtrl_tpu.envs.homebrew_native import make_native_env as jax_make_native_env
from mmtrl_tpu.models.agents import DistributionalQNetwork as JaxDistributionalQNetwork
from mmtrl_tpu.models.agents import QNetwork as JaxQNetwork
from mmtrl_tpu_torch.algos.hostpool import HostPool
from mmtrl_tpu_torch.algos.offpolicy import (
    DQNConfig,
    c51_td_update,
    categorical_projection,
    create_dqn_state,
    dqn_td_update,
    linear_epsilon,
)
from mmtrl_tpu_torch.algos.offpolicy.hostloop_dqn import StepDraws, make_dqn_hostloop
from mmtrl_tpu_torch.convert import _leaf, agent_params_from_flax, dqn_payload_from_flax
from mmtrl_tpu_torch.data.buffers import ReplayBuffer
from mmtrl_tpu_torch.envs.homebrew_native import make_native_env
from mmtrl_tpu_torch.models.agents import DistributionalQNetwork, QNetwork

# float32 on both sides, the same operations: convolutions and products
# summed in other orders.  Outputs within 1e-5 of their largest.
OUT_TOL_OF_MAX = 1e-5
OBS = (3, 84, 84)
A, B = 6, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_of_max(out, ref, tol, what=""):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=what)


# ---- replay ring and schedule -----------------------------------------------
def test_replay_ring_wraps_and_samples_injected_indices():
    example = dict(obs=np.zeros((2, 3), np.int8), action=np.int32(0), reward=np.float32(0))
    jbuf = JaxReplayBuffer.create(jax.tree_util.tree_map(jnp.asarray, example), 7)
    buf = ReplayBuffer.create({k: torch.as_tensor(v) for k, v in example.items()}, 7)
    assert buf.capacity == jbuf.capacity == 7
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(3)
    for step in range(4):  # 12 transitions through a ring of 7
        batch = dict(obs=rng.randint(-127, 128, (3, 2, 3)).astype(np.int8),
                     action=rng.randint(0, 6, 3).astype(np.int32),
                     reward=rng.randn(3).astype(np.float32))
        jbuf = jbuf.add_batch(jax.tree_util.tree_map(jnp.asarray, batch), 3)
        buf.add_batch({k: torch.as_tensor(v) for k, v in batch.items()}, 3)
        assert (buf.pos, buf.size) == (int(jbuf.pos), int(jbuf.size))
        for k in example:
            np.testing.assert_array_equal(buf.data[k].numpy(), np.asarray(jbuf.data[k]))
        key, k_sample = jax.random.split(key)
        idx = jax.random.randint(k_sample, (5,), 0, jnp.maximum(jbuf.size, 1))
        ref, out = jbuf.sample(k_sample, 5), buf.sample(None, 5, _t(idx))
        for k in example:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    assert (buf.pos, buf.size) == (5, 7)
    drawn = buf.sample(torch.Generator().manual_seed(0), 64)
    assert drawn["obs"].shape == (64, 2, 3) and drawn["action"].dtype == torch.int32


def test_linear_epsilon_matches_jax():
    """Against the function compiled, as the JAX loops run it."""
    schedule = jax.jit(jax_linear_epsilon, static_argnums=(0, 1, 2))
    for args in ((1.0, 0.01, 100000.0), (1.0, 0.05, 250000.0), (1.0, 0.05, 20.0),
                 (0.5, 0.5, 10.0)):
        for step in (0, 1, 8, 14, 30, 777, 99992, 100000, 250008, 10**6):
            out = linear_epsilon(*args, step)
            ref = np.asarray(schedule(*args, jnp.int32(step)))
            assert out.dtype == ref.dtype == np.float32 and out == ref, (args, step)


# ---- the Q networks ---------------------------------------------------------
def _init(jmodel, obs, seed):
    return jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(obs)))


@pytest.mark.parametrize("kind,obs_shape", [("dqn", OBS), ("c51", OBS), ("dqn", (4,)),
                                            ("c51", (4,))])
def test_q_networks_match_jax(kind, obs_shape):
    rng = np.random.RandomState(1)
    obs = rng.uniform(-1, 1, (3,) + obs_shape).astype(np.float32)
    if kind == "dqn":
        jmodel, model = JaxQNetwork(A, input_scale=2.0), QNetwork(A, 2.0, obs_shape, "cpu")
    else:
        jmodel = JaxDistributionalQNetwork(A, n_atoms=11, input_scale=2.0)
        model = DistributionalQNetwork(A, 11, 2.0, obs_shape, "cpu")
    params = _init(jmodel, obs, 0)
    model.load_state_dict(agent_params_from_flax(params), strict=True)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(obs)))
    out = model(_t(obs))
    assert out.shape == ref.shape == ((3, A) if kind == "dqn" else (3, A, 11))
    _close_of_max(out, ref, OUT_TOL_OF_MAX, kind)
    if kind == "c51":
        np.testing.assert_allclose(out.sum(-1).detach().numpy(), 1.0, atol=1e-6)


# ---- the TD updates ---------------------------------------------------------
# In float64 on both sides (JAX under ``enable_x64``): in float32 a ReLU or
# max whose input lies within rounding of zero can switch between the two
# implementations, and Adam (eps 1e-8) turns the near-zero gradients it
# leaves into whole steps of the learning rate, so float32 parameters part
# by up to a step in a few elements.  In float64 both updates, parameters
# and moments, hold within 1e-9 of each tensor's largest value, and every
# scalar within 1e-9 relative.
F64_TOL = 1e-9


def _batch(seed):
    rng = np.random.RandomState(seed)
    return dict(obs=rng.uniform(-1, 1, (B,) + OBS),
                action=rng.randint(0, A, B).astype(np.int32),
                reward=rng.choice([0.0, 1.0, -1.0, 12.0], B),
                next_obs=rng.uniform(-1, 1, (B,) + OBS),
                done=(rng.rand(B) < 0.3).astype(np.float64))


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _payload64(jts, names):
    """``dqn_payload_from_flax`` without its float32 cast: the same layout
    (``convert._leaf``), the float64 values kept."""
    def state_dict(tree):
        out = {}

        def walk(node, prefix):
            for key, value in node.items():
                if isinstance(value, Mapping):
                    walk(value, f"{prefix}{key}.")
                else:
                    name, array = _leaf(key, np.asarray(value, np.float64))
                    out[prefix + name] = torch.tensor(array)

        walk(tree["params"], "")
        return out

    adam = jts.opt_state[0]  # optax.adam: (ScaleByAdamState, EmptyState)
    mu, nu = state_dict(adam.mu), state_dict(adam.nu)
    return {"model": state_dict(jts.params), "target": state_dict(jts.target_params),
            "opt_state": {"count": torch.tensor(int(adam.count), dtype=torch.int32),
                          "mu": [mu[n] for n in names], "nu": [nu[n] for n in names]}}


def _pair(jmodel, model, adam_eps):
    """The JAX train state (the target from another init) and the port's,
    on the same float64 weights."""
    obs = np.zeros((1,) + OBS, np.float32)
    jts = JaxDQNTrainState.create(apply_fn=jmodel.apply, params=_f64(_init(jmodel, obs, 0)),
                                  target_params=_f64(_init(jmodel, obs, 1)),
                                  tx=optax.adam(1e-3, eps=adam_eps))
    ts = create_dqn_state(model.double(), 1e-3, adam_eps)
    names = [n for n, _ in model.named_parameters()]
    payload = dqn_payload_from_flax(jax.device_get(jts), names)
    assert set(payload["model"]) == set(names) and set(payload["target"]) == set(names)
    ts.load_payload(_payload64(jax.device_get(jts), names))
    assert ts.opt_state.mu[0].dtype == torch.float64
    return jts, ts


def _compare_states(ts, jts, tol):
    names = [n for n, _ in ts.model.named_parameters()]
    ref = _payload64(jax.device_get(jts), names)
    assert int(ts.opt_state.count) == int(ref["opt_state"]["count"])
    for name, p in ts.model.named_parameters():
        _close_of_max(p, ref["model"][name], tol, name)
    for name, t in ts.target.state_dict().items():
        _close_of_max(t, ref["target"][name], tol, f"target {name}")
    for key in ("mu", "nu"):
        for name, m, r in zip(names, getattr(ts.opt_state, key), ref["opt_state"][key]):
            _close_of_max(m, r, tol, f"{key} {name}")


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def test_dqn_td_update_matches_jax():
    with jax.enable_x64(True):
        jmodel = JaxQNetwork(A, input_scale=1.0)
        jts, ts = _pair(jmodel, QNetwork(A, 1.0, OBS, "cpu"), 1e-8)
        update = jax.jit(lambda ts, b: jax_dqn_td_update(jmodel, 0.99, ts, b))
        for seed in (2, 3):
            batch = _batch(seed)
            jts, jloss, jq, jtd = update(jts, jax.tree_util.tree_map(jnp.asarray, batch))
            ts, loss, q, td = dqn_td_update(0.99, ts, _port_batch(batch))
            assert loss.dtype == torch.float64
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=F64_TOL)
            np.testing.assert_allclose(q.item(), float(jq), rtol=F64_TOL)
            _close_of_max(td, jtd, F64_TOL, "|td|")
            _compare_states(ts, jts, F64_TOL)


def test_categorical_projection_matches_jax():
    """Rewards that put b on an atom (the mass stays whole there), below
    v_min and above v_max (clipped to the end atoms), and in between, on
    JAX's support (``torch.linspace`` rounds 39 of its 51 points the other
    way, by one float32 step)."""
    atoms_np = np.asarray(jnp.linspace(-10.0, 10.0, 51))
    atoms = _t(atoms_np)
    np.testing.assert_allclose(torch.linspace(-10.0, 10.0, 51).numpy(), atoms_np, atol=1e-6)
    rng = np.random.RandomState(4)
    reward = np.array([0.0, 0.4, -100.0, 100.0, 0.13, 2.0, -2.2, 7.77], np.float32)
    done = np.array([1, 1, 0, 0, 0, 1, 0, 0], np.float32)
    pmf = rng.dirichlet(np.ones(51), len(reward)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda r, d, p: jax_projection(
        r, d, p, jnp.asarray(atoms_np), 0.99, atoms_np[0], atoms_np[-1], 51))(
        jnp.asarray(reward), jnp.asarray(done), jnp.asarray(pmf)))
    out = categorical_projection(_t(reward), _t(done), _t(pmf), atoms, 0.99).numpy()
    # an atom sums up to 51 float32 terms in another order (clipped rows:
    # all of them, to about 1): within 1e-6
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-6)
    # done, so Tz = r: b = 25 and 30, integral; all the mass on that atom
    for row, atom in ((0, 25), (5, 30)):
        assert np.flatnonzero(out[row]).tolist() == [atom]
    assert out[2, 0] == pytest.approx(1.0, abs=1e-6) and out[3, 50] == pytest.approx(1.0, abs=1e-6)
    again = categorical_projection(_t(reward), _t(done), _t(pmf), atoms, 0.99).numpy()
    np.testing.assert_array_equal(out, again)


def test_c51_td_update_matches_jax():
    with jax.enable_x64(True):
        jmodel = JaxDistributionalQNetwork(A, n_atoms=51, input_scale=1.0)
        model = DistributionalQNetwork(A, 51, 1.0, OBS, "cpu")
        jts, ts = _pair(jmodel, model, 0.01 / B)
        jatoms = jnp.linspace(-10.0, 10.0, 51, dtype=jnp.float64)
        atoms = torch.linspace(-10.0, 10.0, 51, dtype=torch.float64)
        update = jax.jit(lambda ts, b: jax_c51_td_update(jmodel, jatoms, 0.99, ts, b))
        for seed in (5, 6):
            batch = _batch(seed)
            jts, jloss, jq = update(jts, jax.tree_util.tree_map(jnp.asarray, batch))
            ts, loss, q = c51_td_update(atoms, 0.99, ts, _port_batch(batch))
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=F64_TOL)
            np.testing.assert_allclose(q.item(), float(jq), rtol=F64_TOL)
            _compare_states(ts, jts, F64_TOL)


# ---- the host loop's pool step ----------------------------------------------
HOST_CFG = dict(total_timesteps=40, learning_rate=1e-3, num_envs=2, buffer_size=8, gamma=0.99,
                tau=1.0, target_network_frequency=3, batch_size=4, start_e=1.0, end_e=0.05,
                exploration_fraction=0.5, learning_starts=4, train_frequency=2)
POOL_STEPS = 8
# float32 losses of the pool steps' updates: the first from equal weights
# on equal batches (summation order only), the second after the first's
# Adam step (a few elements a step apart, above) -- within 1e-4.
LOSS_RTOL = 1e-4


def test_hostloop_step_fn_cadence_matches_jax():
    """Eight pool steps of RALLY (2 envs, a ring of 8 that wraps): stores
    from the second call, updates on pool steps 4 and 6 (past 4 stored
    transitions, every 2nd), target syncs on 0, 3 and 6, all where JAX's
    ``step_fn`` does them; the actions, the ring's contents and the losses
    agree.  Both take JAX's observation, so the ring's int8 codes are
    equal (the two ``_obs`` agree within 2.3e-6, tests/test_torch_native.py,
    which can still move a code across a rounding boundary)."""
    jenv = jax_make_native_env("rally_native", num_envs=2, seed=3, episode_steps=30)
    env = make_native_env("rally_native", num_envs=2, seed=3, episode_steps=30, device="cpu")
    try:
        jmodel = JaxQNetwork(env.num_actions, input_scale=1.0)
        jinit, jstep, _ = jax_make_dqn_hostloop(jenv, jmodel, JaxDQNConfig(**HOST_CFG))
        jrunner = jax.jit(jinit)(jax.random.PRNGKey(0))
        jstep = jax.jit(jstep)
        jobs = jax.jit(lambda f, a: jenv._obs(f, jax_dequant(a)))
        model = QNetwork(env.num_actions, 1.0, OBS, "cpu")
        model.load_state_dict(agent_params_from_flax(jax.device_get(jrunner.train_state.params)))
        loop = make_dqn_hostloop(env, model, DQNConfig(**HOST_CFG))
        runner = loop.init_runner(torch.Generator())
        pool = HostPool(env)
        reward, action = np.zeros(2, np.float32), np.zeros(2, np.int64)
        trained, synced = [], []
        for k in range(POOL_STEPS):
            store = k > 0
            _, k_eps, k_rand, k_sample = jax.random.split(jrunner.key, 4)
            jrunner, jaction, jm = jstep(jrunner, pool.frames, pool.audio_u8, reward, pool.done,
                                         action.astype(np.int32), np.bool_(store))
            idx = jax.random.randint(k_sample, (4,), 0, jnp.maximum(jrunner.buffer.size, 1))
            draws = StepDraws(_t(jax.random.randint(k_rand, (2,), 0, env.num_actions)),
                              _t(jax.random.uniform(k_eps, (2,))), _t(idx))
            obs = _t(jobs(pool.frames, pool.audio_u8))
            runner, paction, m = loop.step_fn(runner, obs, reward, pool.done, action, store, draws)
            assert paction.tolist() == np.asarray(jaction).tolist(), k
            assert m["epsilon"] == float(jm["epsilon"])
            assert (runner.buffer.pos, runner.buffer.size) == (int(jrunner.buffer.pos),
                                                               int(jrunner.buffer.size))
            assert runner.global_step == int(jrunner.global_step)
            for key, data in runner.buffer.data.items():
                np.testing.assert_array_equal(data.numpy(), np.asarray(jrunner.buffer.data[key]))
            ts, jts = runner.train_state, jax.device_get(jrunner.train_state)
            assert int(ts.step) == int(jts.step)
            if m["trained"]:
                trained.append(k)
                np.testing.assert_allclose(m["td_loss"].item(), float(jm["td_loss"]),
                                           rtol=LOSS_RTOL)
            else:
                assert float(jm["td_loss"]) == 0.0
            # after a sync the target equals the parameters, on each side
            target, jtarget = ts.target.state_dict(), agent_params_from_flax(jts.target_params)
            params, jparams = ts.model.state_dict(), agent_params_from_flax(jts.params)
            same = all(torch.equal(target[n], params[n]) for n in params)
            assert same == all(torch.equal(jtarget[n], jparams[n]) for n in jparams)
            if m["synced"]:
                synced.append(k)
                assert same
            action = paction.numpy()
            reward, _, _ = pool.step(action)
        assert trained == [4, 6] and synced == [0, 3, 6]
        assert runner.buffer.pos == 6 and runner.buffer.size == 8  # 14 stored, wrapped
    finally:
        env.close()
        jenv.close()
