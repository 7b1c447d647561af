"""The port's gymnasium host bridge (``envs/gym_bridge.py``) against the JAX
package's on the CPU, from the same seeds and the same numpy actions:

- ``_host_reset``/``_host_step`` on Pendulum-v1 and HalfCheetah-v4 equal,
  array for array, through Pendulum's time limit;
- the batched surface ``reset``/``step`` on CPU tensors equal to JAX's
  ``v_reset``/``v_step`` under ``jax.jit``;
- under ``wrap="ppo_continuous"`` (gymnasium's own wrapper stack) the
  normalized and the raw rewards equal;
- the truncation contract at HalfCheetah's 1,000 steps;
- ``make_any`` taking the registry first, a ``dm_control/`` id, and the
  errors: no gymnasium, a card that is not there;
- the entry points on gymnasium ids through ``main`` (``--cuda False``):
  ``ppo``/``rpo_continuous_action --env-id HalfCheetah-v4`` and the fused
  DDPG loop on a host pool.

Everything here is bit for bit: both pools step the same gymnasium envs."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("gymnasium")

from mmtrl_tpu.envs.gym_bridge import GymPool as JaxGymPool  # noqa: E402
from mmtrl_tpu_torch.core.config import cli  # noqa: E402
from mmtrl_tpu_torch.envs.classic import CartPole, Pendulum  # noqa: E402
from mmtrl_tpu_torch.envs.gym_bridge import GymPool, make_any  # noqa: E402
from mmtrl_tpu_torch.scripts import (  # noqa: E402
    ddpg_continuous_action,
    ppo_continuous_action,
    rpo_continuous_action,
)

N = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    return tmp_path


def _pools(env_id, num_envs=N, seed=3, **kw):
    return GymPool(env_id, num_envs, seed=seed, device="cpu", **kw), JaxGymPool(
        env_id, num_envs, seed=seed, **kw)


def _actions(pool, steps, seed=0):
    sp = pool.action_space
    return np.random.default_rng(seed).uniform(sp.low, sp.high,
                                               (steps, pool.num_envs) + sp.shape).astype(np.float32)


@pytest.mark.parametrize("env_id,steps", [("Pendulum-v1", 210), ("HalfCheetah-v4", 40)])
def test_host_surface_matches_jax(env_id, steps):
    """Reset and each step's six arrays equal, dtypes included; Pendulum
    crosses its 200-step time limit (done and truncated set, the obs the
    fresh episode's, final_obs the last one's)."""
    pool, jpool = _pools(env_id)
    assert pool.observation_space.shape == jpool.observation_space.shape
    np.testing.assert_array_equal(pool.action_space.low, jpool.action_space.low)
    np.testing.assert_array_equal(pool.action_space.high, jpool.action_space.high)
    np.testing.assert_array_equal(pool._host_reset(), jpool._host_reset())
    truncated = 0
    for a in _actions(pool, steps):
        out, ref = pool._host_step(a), jpool._host_step(a)
        for x, y in zip(out, ref):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        truncated += int(out[5].sum())
        if out[5].any():
            i = int(np.argmax(out[5]))
            assert not np.array_equal(out[0][i], out[1][i])
    assert truncated == (N if env_id == "Pendulum-v1" else 0)
    pool.close()
    jpool.close()


def test_batched_surface_matches_jax_v_step_under_jit():
    """``reset``/``step`` on CPU tensors against JAX's jitted ``v_reset`` and
    ``v_step`` (the ordered io_callback), 205 steps of Pendulum: obs, the
    counter, reward, done and ``info`` (final_obs, raw_reward, truncated)
    equal."""
    pool, jpool = _pools("Pendulum-v1")
    obs, state = pool.reset(N, torch.Generator())
    jobs, jstate = jax.jit(jpool.v_reset)(jax.random.split(jax.random.PRNGKey(0), N))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    assert state.dtype == torch.int32 and not state.any()
    v_step = jax.jit(jpool.v_step)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    dones = 0
    for a in _actions(pool, 205, seed=1):
        obs, state, r, d, info = pool.step(state, torch.from_numpy(a))
        jobs, jstate, jr, jd, jinfo = v_step(keys, jstate, jnp.asarray(a))
        for x, y in [(obs, jobs), (state, jstate), (r, jr), (d, jd)] + [
                (info[k], jinfo[k]) for k in ("final_obs", "raw_reward", "truncated")]:
            assert x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert d.dtype == info["truncated"].dtype == torch.bool
        dones += int(d.sum())
    assert dones == N and int(state[0]) == 205
    with pytest.raises(ValueError, match="cannot reset"):
        pool.reset(N + 1)
    pool.close()
    jpool.close()


def test_reference_wrap_stack_matches_jax():
    """``wrap="ppo_continuous"``: clipped, normalized observations within
    +-10, the normalized reward (NormalizeReward, clipped) and the raw
    reward equal to JAX's, and the two rewards apart."""
    pool, jpool = _pools("Pendulum-v1", wrap="ppo_continuous", gamma=0.9)
    np.testing.assert_array_equal(pool._host_reset(), jpool._host_reset())
    apart = False
    # the wrapped action space is unbounded: torques in [-6, 6), past the
    # limit of 2, which ClipAction clips
    for a in np.random.default_rng(2).uniform(-6, 6, (60, N, 1)).astype(np.float32):
        out, ref = pool._host_step(a), jpool._host_step(a)
        for x, y in zip(out, ref):
            np.testing.assert_array_equal(x, y)
        assert np.abs(out[0]).max() <= 10.0
        apart |= bool(np.abs(out[2] - out[3]).max() > 1e-3)
    assert apart
    pool.close()
    jpool.close()


def test_truncation_contract_at_halfcheetah_time_limit():
    """HalfCheetah never terminates: its episode ends at step 1,000 by
    truncation, the returned obs the fresh episode's first and final_obs
    the last one, apart; the counter goes on."""
    pool = GymPool("HalfCheetah-v4", 1, seed=0, device="cpu")
    obs, state = pool.reset(1)
    first = obs.clone()
    a = torch.zeros(1, 6)
    for t in range(1, 1001):
        obs, state, r, d, info = pool.step(state, a)
        assert bool(d[0]) == (t == 1000) == bool(info["truncated"][0])
    assert float((obs[0] - info["final_obs"][0]).abs().max()) > 1e-3
    assert not torch.equal(obs, first)  # the auto-reset goes on in the env's own stream
    assert int(state[0]) == 1000
    pool.close()


def test_make_any_prefers_the_registry():
    env, bridge = make_any("CartPole-v1", device="cpu")
    assert not bridge and isinstance(env, CartPole)
    env, bridge = make_any("Pendulum-v1", num_envs=3, device="cpu")
    assert not bridge and isinstance(env, Pendulum)
    env, bridge = make_any("HalfCheetah-v4", num_envs=3, seed=2, device="cpu")
    assert bridge and isinstance(env, GymPool)
    assert env.num_envs == 3 and env.name == "HalfCheetah-v4"
    assert env.observation_space.shape == (17,) and env.action_space.shape == (6,)
    env.close()


def test_dm_control_id_matches_jax():
    pytest.importorskip("dm_control")
    pool, jpool = _pools("dm_control/cartpole-balance")
    assert pool.observation_space.shape == (5,) and pool.action_space.shape == (1,)
    np.testing.assert_array_equal(pool._host_reset(), jpool._host_reset())
    for a in _actions(pool, 10):
        for x, y in zip(pool._host_step(a), jpool._host_step(a)):
            np.testing.assert_array_equal(x, y)
    pool.close()
    jpool.close()


def test_missing_gymnasium_and_missing_card_raise(monkeypatch):
    """No fallback: without gymnasium the pool raises naming it; asked for
    the card (the default) without one, it raises too."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GymPool("Pendulum-v1", 1)
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ModuleNotFoundError, match="gymnasium") as err:
        GymPool("Pendulum-v1", 1, device="cpu")
    assert err.value.name == "gymnasium"


@pytest.mark.parametrize("module", [ppo_continuous_action, rpo_continuous_action])
def test_continuous_ppo_on_a_mujoco_id(module, in_tmp):
    """``--env-id HalfCheetah-v4`` through ``main``: the fused continuous PPO
    loop on a pool of 2 host envs under gymnasium's wrapper stack, 2
    updates; the raw rewards feed the statistics."""
    out = module.main(cli(module.Args, [
        "--cuda", "False", "--env-id", "HalfCheetah-v4", "--num-envs", "2", "--num-steps", "32",
        "--num-minibatches", "2", "--update-epochs", "1", "--total-timesteps", "128"]))
    assert [r["global_step"] for r in out["history"]] == [64, 128]
    assert all(np.isfinite(v) for r in out["history"] for k, v in r.items()
               if k.startswith("losses/"))
    import gymnasium

    env = ppo_continuous_action.make_env(cli(ppo_continuous_action.Args, [
        "--cuda", "False", "--env-id", "HalfCheetah-v4", "--num-envs", "2"]), torch.device("cpu"))
    assert isinstance(env, GymPool) and env.num_envs == 2
    assert isinstance(env._envs[0], gymnasium.wrappers.TransformReward)  # the reference stack
    env.close()
    # neither normalizer: bare sub-envs, --clip-action unread, as in JAX's script
    bare = ppo_continuous_action.make_env(cli(ppo_continuous_action.Args, [
        "--cuda", "False", "--env-id", "HalfCheetah-v4", "--norm-obs", "False",
        "--norm-reward", "False", "--clip-action", "True"]), torch.device("cpu"))
    names, e = [], bare._envs[0]
    while isinstance(e, gymnasium.Wrapper):  # gym.make's own: TimeLimit, OrderEnforcing, ...
        names.append(type(e).__name__)
        e = e.env
    assert not {"ClipAction", "NormalizeObservation", "NormalizeReward"} & set(names)
    bare.close()


def test_fused_ddpg_on_a_host_pool(in_tmp):
    """DDPG's fused loop (no ``--host-loop``) on ``--env-id Hopper-v4``: the
    pool's ``reset``/``step`` inside ``train_iteration``, the terminations
    stored as done, and the greedy evaluation on the same pool."""
    out = ddpg_continuous_action.main(cli(ddpg_continuous_action.Args, [
        "--cuda", "False", "--env-id", "Hopper-v4", "--total-timesteps", "256",
        "--learning-starts", "128", "--batch-size", "16", "--steps-per-iteration", "128"]))
    assert out["global_step"] == 256 and len(out["history"]) == 2
    assert np.isfinite(out["history"][-1]["losses/qf1_loss"])
    buf = out["runner"].buffer
    assert buf.size == 256 and float(buf.data["done"].sum()) > 0  # Hopper falls
    assert out["eval_episodes"] > 0
