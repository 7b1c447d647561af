"""The port's continuous-control slice against the JAX package on the CPU,
on the same seeded numpy inputs, JAX's draws replayed into the port:

- Pendulum step by step from JAX's states, auto-reset and truncation
  included, and its reset draw;
- ``ClipAction``, ``NormalizeObservation`` and ``NormalizeReward`` alone
  and stacked, against JAX's wrappers stepped under ``vmap``: per-env
  statistics and returns across an auto-reset;
- the four distribution helpers, the squashed normal into saturation;
- ``ContinuousActorCritic``, ``QFunction``, ``DeterministicActor`` and
  ``SquashedGaussianActor`` on converted weights;
- one ``make_continuous_ppo`` update with and without RPO, JAX's rollout
  rebuilt from its own keys and its permutations and RPO uniforms
  replayed;
- one fused DDPG, TD3 and SAC iteration that crosses ``learning_starts``
  and both cadences, JAX's draws replayed as ``ContinuousDraws``.

Tolerances are stated where they are used.  XLA's float32 ``sin`` and
``cos`` differ from torch's by an ulp in about 5% of inputs and its
``tanh`` by up to 2.4e-7 in about half, so nothing here is bit for bit
but the replayed draws, the flags and the counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.offpolicy.ddpg import DDPGConfig as JaxDDPGConfig
from mmtrl_tpu.algos.offpolicy.ddpg import make_ddpg as jax_make_ddpg
from mmtrl_tpu.algos.offpolicy.sac import SACConfig as JaxSACConfig
from mmtrl_tpu.algos.offpolicy.sac import make_sac as jax_make_sac
from mmtrl_tpu.algos.offpolicy.td3 import TD3Config as JaxTD3Config
from mmtrl_tpu.algos.offpolicy.td3 import make_td3 as jax_make_td3
from mmtrl_tpu.algos.ppo.core import PPOConfig as JaxPPOConfig
from mmtrl_tpu.algos.ppo.core import make_continuous_ppo as jax_make_continuous_ppo
from mmtrl_tpu.envs import wrappers as jax_wrappers
from mmtrl_tpu.envs.classic import Pendulum as JaxPendulum
from mmtrl_tpu.models import distributions as jax_dist
from mmtrl_tpu.models.agents import ContinuousActorCritic as JaxContinuousActorCritic
from mmtrl_tpu.models.agents import DeterministicActor as JaxDeterministicActor
from mmtrl_tpu.models.agents import QFunction as JaxQFunction
from mmtrl_tpu.models.agents import SquashedGaussianActor as JaxSquashedGaussianActor
from mmtrl_tpu_torch.algos.offpolicy import (
    ContinuousDraws,
    DDPGConfig,
    SACConfig,
    TD3Config,
    make_ddpg,
    make_sac,
    make_td3,
)
from mmtrl_tpu_torch.algos.ppo import PPOConfig, RunnerState, make_continuous_ppo
from mmtrl_tpu_torch.convert import (
    actor_critic_payload_from_flax,
    agent_params_from_flax,
    ppo_opt_state_from_flax,
)
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.classic import Pendulum
from mmtrl_tpu_torch.envs.classic.pendulum import PendulumState
from mmtrl_tpu_torch.envs.wrappers import (
    ClipAction,
    NormalizeObservation,
    NormalizeReward,
    NormObsState,
    NormRewardState,
    RunningStat,
)
from mmtrl_tpu_torch.models import distributions as dist
from mmtrl_tpu_torch.models.agents import (
    ContinuousActorCritic,
    DeterministicActor,
    QFunction,
    SquashedGaussianActor,
)

N = 16
# One Pendulum step from the same float32 state: XLA's and torch's float32
# sin and cos differ by an ulp in about 5% of inputs, which the step
# carries into theta_dot (times 0.75), theta and the observation.
STEP_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref, atol, what=""):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=atol, err_msg=what)


def reset_values(state) -> np.ndarray:
    """(n, 2) float32: the theta and theta_dot that a Pendulum reset draws."""
    return np.stack([np.asarray(state.theta), np.asarray(state.theta_dot)], axis=-1)


class Replay:
    """A reset sampler that hands out recorded draws in order."""

    def __init__(self, draws=()):
        self.draws = list(draws)

    def __call__(self, n, generator=None):
        out = self.draws.pop(0)
        assert out.shape[0] == n
        return _t(out)


def port_state(jstate):
    """The port's (wrapped) Pendulum state of a JAX batched state."""
    if isinstance(jstate, jax_wrappers.NormRewardState):
        return NormRewardState(inner=port_state(jstate.inner), rms=port_stat(jstate.rms),
                               ret=_t(jstate.ret))
    if isinstance(jstate, jax_wrappers.NormObsState):
        return NormObsState(inner=port_state(jstate.inner), rms=port_stat(jstate.rms))
    return PendulumState(theta=_t(jstate.theta), theta_dot=_t(jstate.theta_dot),
                         t=_t(jstate.t).long())


def port_stat(jstat):
    return RunningStat(mean=_t(jstat.mean), var=_t(jstat.var), count=_t(jstat.count))


@jax.jit
def _step_reset_states(keys):
    return jax.vmap(lambda k: JaxPendulum()._reset(jax.random.split(k)[1])[1])(keys)


def step_resets(keys):
    """The reset values each env's auto-reset draws in a JAX ``v_step``
    with ``keys``: ``Environment.step`` splits its key, the second half
    resets."""
    return reset_values(_step_reset_states(keys))


# ---- the env ------------------------------------------------------------------
def test_pendulum_steps_match_jax():
    """60 steps of 16 envs under random torques in [-3, 3] (beyond the
    limit of 2, so the clip acts), each from JAX's state: observation,
    final observation, state within STEP_ATOL, reward within 1e-5 of
    costs up to 16.3 (two float32 roundings of it), done, ``truncated``
    (equal to done) and the auto-reset from JAX's draws equal.  Four envs
    start 3 steps before the time limit."""
    jenv, replay = JaxPendulum(), Replay()
    env = make("Pendulum-v1", device="cpu", sampler=replay)
    assert type(env) is Pendulum and env.name == jenv.name
    assert env.observation_space.shape == jenv.observation_space.shape == (3,)
    assert env.action_space.shape == jenv.action_space.shape == (1,)
    assert (env.action_space.low, env.action_space.high) == (-2.0, 2.0)
    with pytest.raises(AttributeError):  # a Box has no ``n``, in JAX too
        env.num_actions
    reset = jax.jit(jax.vmap(jenv._reset))
    step = jax.jit(jax.vmap(jenv.step))
    _, jstate = reset(jax.random.split(jax.random.PRNGKey(0), N))
    jstate = jstate.replace(t=jstate.t.at[:4].set(jenv.max_steps - 3))
    rng = np.random.RandomState(1)
    dones = 0
    for k in range(60):
        keys = jax.random.split(jax.random.PRNGKey(100 + k), N)
        replay.draws.append(step_resets(keys))
        action = rng.uniform(-3, 3, (N, 1)).astype(np.float32)
        jobs, jnext, jr, jd, jinfo = step(keys, jstate, jnp.asarray(action))
        obs, state, r, d, info = env.step(port_state(jstate), _t(action))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(info["truncated"].numpy(), np.asarray(jinfo["truncated"]))
        np.testing.assert_array_equal(d.numpy(), info["truncated"].numpy())
        _close(r, jr, 1e-5, "reward")
        _close(info["final_obs"], jinfo["final_obs"], STEP_ATOL, "final_obs")
        _close(obs, jobs, STEP_ATOL, "obs")
        for f in ("theta", "theta_dot"):
            _close(getattr(state, f), getattr(jnext, f), STEP_ATOL, f)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jnext.t))
        dones += int(d.sum())
        jstate = jnext
    assert dones == 4


def test_pendulum_angle_wraps_as_a_floor_mod():
    """Angles far below -pi and above pi: the cost's ``_angle_normalize``
    is ``jnp.mod``'s floor-mod (``torch.remainder``), where ``fmod`` would
    leave negative angles below -pi."""
    jenv, env = JaxPendulum(), Pendulum(device="cpu")
    theta = np.array([-20.0, -7.0, -3.2, -np.pi, 0.0, 3.2, 7.0, 20.0], np.float32)
    theta_dot = np.linspace(-8, 8, theta.size).astype(np.float32)
    jstate = jax.vmap(lambda th, w: jenv._reset(jax.random.PRNGKey(0))[1].replace(
        theta=th, theta_dot=w))(jnp.asarray(theta), jnp.asarray(theta_dot))
    action = np.full((theta.size, 1), 0.5, np.float32)
    _, _, jr, _, _ = jax.jit(jax.vmap(jenv._step_env))(
        jax.random.split(jax.random.PRNGKey(1), theta.size), jstate, jnp.asarray(action))
    _, _, r, _, _ = env._step_env(port_state(jstate), _t(action))
    _close(r, jr, 1e-5, "reward")
    assert float(r.min()) >= -(np.pi**2 + 0.1 * 64 + 0.001 * 0.25) - 1e-4


def test_pendulum_reset_draw_and_devices():
    env = Pendulum(device="cpu")
    obs, state = env.reset(4096, torch.Generator().manual_seed(0))
    assert obs.shape == (4096, 3) and obs.dtype == torch.float32 and state.t.eq(0).all()
    assert float(state.theta.min()) >= -np.pi and float(state.theta.max()) < np.pi
    assert float(state.theta.abs().max()) > 3.1
    assert float(state.theta_dot.abs().max()) <= 1.0 and float(state.theta_dot.abs().max()) > 0.99
    _close(obs[:, :2].norm(dim=-1), np.ones(4096), 1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Pendulum()


# ---- the wrappers -------------------------------------------------------------
STACKS = {
    "clip": (lambda e: jax_wrappers.ClipAction(e), lambda e: ClipAction(e)),
    "norm_obs": (lambda e: jax_wrappers.NormalizeObservation(e),
                 lambda e: NormalizeObservation(e)),
    "norm_reward": (lambda e: jax_wrappers.NormalizeReward(e, gamma=0.9),
                    lambda e: NormalizeReward(e, gamma=0.9)),
    "all": (lambda e: jax_wrappers.NormalizeReward(jax_wrappers.NormalizeObservation(
        jax_wrappers.ClipAction(e))),
        lambda e: NormalizeReward(NormalizeObservation(ClipAction(e)))),
}


def _stats_of(state):
    """{path: RunningStat or ret} of a (port or JAX) wrapped state."""
    out, prefix = {}, ""
    while hasattr(state, "inner"):
        if hasattr(state, "rms"):
            out[prefix + "rms"] = state.rms
        if hasattr(state, "ret"):
            out[prefix + "ret"] = state.ret
        state, prefix = state.inner, prefix + "inner."
    return out


@pytest.mark.parametrize("stack", list(STACKS))
def test_wrappers_match_jax_vmapped(stack):
    """30 steps of 16 envs, 4 of them through an auto-reset at step 3,
    each step from JAX's state: the observation (normalized within 1e-5
    of values clipped at 10), the reward within 1e-5 relative plus 1e-6,
    ``raw_reward``, done, and every env's own statistics (mean, var,
    count) and discounted return within 2e-6 relative plus 1e-6 of JAX's
    vmapped ones, which are not the pooled ones."""
    jax_wrap, port_wrap = STACKS[stack]
    jinner, replay = JaxPendulum(), Replay()
    jenv = jax_wrap(jinner)
    env = port_wrap(Pendulum(device="cpu", sampler=replay))
    reset = jax.jit(jax.vmap(jenv.reset))
    step = jax.jit(jax.vmap(jenv.step))
    keys0 = jax.random.split(jax.random.PRNGKey(0), N)
    replay.draws.append(reset_values(jax.vmap(jinner._reset)(keys0)[1]))
    jobs, jstate = reset(keys0)
    obs, state = env.reset(N)
    _close(obs, jobs, 1e-5, "reset obs")
    for path, jstat in _stats_of(jstate).items():
        assert path in _stats_of(state)
    rng = np.random.RandomState(2)
    inner = jstate
    while hasattr(inner, "inner"):
        inner = inner.inner
    inner_t = inner.t.at[:4].set(jinner.max_steps - 3)

    def set_t(s):
        if hasattr(s, "inner"):
            return s.replace(inner=set_t(s.inner))
        return s.replace(t=inner_t)

    jstate, dones = set_t(jstate), 0
    for k in range(30):
        keys = jax.random.split(jax.random.PRNGKey(200 + k), N)
        replay.draws.append(step_resets(keys))
        action = rng.uniform(-3, 3, (N, 1)).astype(np.float32)
        jobs, jnext, jr, jd, jinfo = step(keys, jstate, jnp.asarray(action))
        obs, nxt, r, d, info = env.step(port_state(jstate), _t(action))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        dones += int(d.sum())
        _close(obs, jobs, 1e-5, "obs")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
        assert set(info) == set(jinfo)
        if "raw_reward" in jinfo:
            np.testing.assert_allclose(info["raw_reward"].numpy(), np.asarray(jinfo["raw_reward"]),
                                       rtol=1e-5, atol=1e-6)
        ours, theirs = _stats_of(nxt), _stats_of(jnext)
        assert set(ours) == set(theirs)
        for path, jstat in theirs.items():
            if path.endswith("ret"):
                np.testing.assert_allclose(ours[path].numpy(), np.asarray(jstat), rtol=2e-6,
                                           atol=1e-6, err_msg=path)
                continue
            for f in ("mean", "var", "count"):
                got, want = getattr(ours[path], f).numpy(), np.asarray(getattr(jstat, f))
                assert got.shape == want.shape, (path, f, got.shape, want.shape)
                np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6, err_msg=f"{path}.{f}")
        jstate = jnext
    for path, stat in _stats_of(nxt).items():  # per env: the rows differ
        assert float(stat.std(dim=0).max() if path.endswith("ret")
                     else stat.mean.std(dim=0).max()) > 0.01, path
    assert dones == 4


def test_running_stat_update_each_is_a_batch_of_one_per_row():
    """``update_each`` gives each row the statistics ``update(x[None])``
    gives it alone."""
    rng = np.random.RandomState(3)
    x = _t(rng.randn(5, 3).astype(np.float32))
    each = RunningStat.create_each(5, (3,), "cpu").update_each(x).update_each(2 * x)
    for i in range(5):
        one = RunningStat.create((3,), "cpu").update(x[i:i + 1]).update(2 * x[i:i + 1])
        assert torch.equal(each.mean[i], one.mean) and torch.equal(each.var[i], one.var)
        assert torch.equal(each.count[i], one.count)


# ---- the distribution helpers ---------------------------------------------------
def test_normal_helpers_match_jax():
    """``normal_sample`` on JAX's normals, ``normal_log_prob`` and
    ``normal_entropy``: float32, the same terms in the same order, within
    1e-6 relative plus 1e-6 (the float32 constant log(2 pi) / 2 may round
    apart by an ulp)."""
    rng = np.random.RandomState(4)
    mean = rng.randn(64, 3).astype(np.float32)
    log_std = rng.uniform(-3, 1, (64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jsample = jax_dist.normal_sample(key, jnp.asarray(mean), jnp.asarray(log_std))
    noise = jax.random.normal(key, mean.shape)
    sample = dist.normal_sample(None, _t(mean), _t(log_std), noise=_t(noise))
    np.testing.assert_allclose(sample.numpy(), np.asarray(jsample), rtol=1e-6, atol=1e-6)
    action = rng.randn(64, 3).astype(np.float32) * 2
    np.testing.assert_allclose(
        dist.normal_log_prob(_t(mean), _t(log_std), _t(action)).numpy(),
        np.asarray(jax_dist.normal_log_prob(jnp.asarray(mean), jnp.asarray(log_std),
                                            jnp.asarray(action))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dist.normal_entropy(_t(log_std)).numpy(),
                               np.asarray(jax_dist.normal_entropy(jnp.asarray(log_std))),
                               rtol=1e-6, atol=1e-6)
    drawn = dist.normal_sample(torch.Generator().manual_seed(0), _t(mean), _t(log_std))
    assert drawn.shape == (64, 3) and not torch.equal(drawn, sample)


# The squashed normal's log-density subtracts log(scale (1 - tanh(x)^2) +
# 1e-6).  XLA's float32 tanh differs from torch's by up to TANH_ATOL (seen:
# 2.4e-7, in about half of all inputs).  Where 1 - tanh^2 is a few ulps of
# 1 (|x| past about 8) that moves a dim's term by up to the log of the
# ratio of its argument at the two ends of tanh(x) +- (TANH_ATOL + one
# float32 ulp of 1): up to 0.9 at scale 2, 4e-4 at |x| = 4.  That is the
# tolerance this forces, dim by dim; the rest of the density agrees within
# 1e-5 relative plus 1e-5.
TANH_ATOL = 2.4e-7


def squash_logp_atol(x: np.ndarray, scale: float) -> np.ndarray:
    """The bound above, summed over the action dims of each row of x."""
    y = np.abs(np.tanh(x.astype(np.float64)))
    half = TANH_ATOL + 2.0**-24
    lo, hi = np.maximum(y - half, 0.0), np.minimum(y + half, 1.0)
    return np.log((scale * (1 - lo**2) + 1e-6) / (scale * (1 - hi**2) + 1e-6)).sum(axis=-1)


def test_squashed_normal_matches_jax_into_saturation():
    """SAC's sampler on JAX's normals over means from -12 to 12, so that
    about a third of the samples saturate tanh: the action and the
    squashed mean within 2 scale-ulps of tanh (1e-6), the log-probability
    within ``squash_logp_atol``; and the parts really do come apart in
    saturation (the bound is not slack)."""
    mean = np.linspace(-12, 12, 4096, dtype=np.float32).reshape(2048, 2)
    log_std = np.full_like(mean, -1.0)
    key = jax.random.PRNGKey(9)
    scale, bias = np.float32(2.0), np.float32(0.25)
    ja, jlogp, jsq = jax.jit(jax_dist.squashed_normal_sample_log_prob)(
        key, jnp.asarray(mean), jnp.asarray(log_std), scale, bias)
    noise = jax.random.normal(key, mean.shape)
    a, logp, sq = dist.squashed_normal_sample_log_prob(
        None, _t(mean), _t(log_std), torch.tensor(scale), torch.tensor(bias), noise=_t(noise))
    _close(a, ja, 1e-6, "action")
    _close(sq, jsq, 1e-6, "squashed mean")
    x = mean + np.exp(log_std) * np.asarray(noise)
    bound = squash_logp_atol(x, float(scale))
    err = np.abs(logp.numpy() - np.asarray(jlogp))
    assert (np.abs(x) > 8).any(axis=-1).mean() > 0.3
    assert np.all(err <= bound + 1e-5 * (1 + np.abs(np.asarray(jlogp))))
    assert err.max() > 0.5  # XLA's and torch's tanh part in saturation
    calm = (np.abs(x) < 2).all(axis=-1)
    np.testing.assert_allclose(logp.numpy()[calm], np.asarray(jlogp)[calm], rtol=1e-5, atol=1e-5)


# ---- the models -----------------------------------------------------------------
MODELS = {
    "ContinuousActorCritic": (lambda: JaxContinuousActorCritic(action_dim=2),
                              lambda: ContinuousActorCritic(2, 5, device="cpu"), 1),
    "QFunction": (lambda: JaxQFunction(), lambda: QFunction(5, 2, device="cpu"), 2),
    "DeterministicActor": (
        lambda: JaxDeterministicActor(action_dim=2, action_scale=(2.0, 0.5),
                                      action_bias=(0.0, 0.25)),
        lambda: DeterministicActor(5, 2, (2.0, 0.5), (0.0, 0.25), device="cpu"), 1),
    "SquashedGaussianActor": (
        lambda: JaxSquashedGaussianActor(action_dim=2, action_scale=(1.0, 1.0),
                                         action_bias=(0.0, 0.0)),
        lambda: SquashedGaussianActor(5, 2, device="cpu"), 1),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Converted weights (``strict=True``): every output within 1e-5 of its
    largest (float32, products summed in other orders; tanh within an
    ulp or two); and the port's own init has flax's shapes."""
    jax_build, build, n_inputs = MODELS[name]
    rng = np.random.RandomState(5)
    inputs = [rng.randn(32, 5).astype(np.float32), rng.randn(32, 2).astype(np.float32)]
    jmodel = jax_build()

    def init_apply(key, *xs):  # one compile, not two
        params = jmodel.init(key, *xs)
        return params, jmodel.apply(params, *xs)

    params, ref = jax.device_get(jax.jit(init_apply)(jax.random.PRNGKey(0),
                                                     *map(jnp.asarray, inputs[:n_inputs])))
    model = build()
    model.load_state_dict(agent_params_from_flax(params), strict=True)
    out = model(*map(_t, inputs[:n_inputs]))
    ref, out = (ref, out) if isinstance(ref, tuple) else ((ref,), (out,))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == np.asarray(r).shape
        _close(o, r, 1e-5 * max(float(np.abs(np.asarray(r)).max()), 1.0), name)
    if name == "ContinuousActorCritic":
        assert torch.equal(model.log_std, torch.zeros(2))  # flax's zeros init
        assert out[1].shape == (32, 2)  # broadcast to the mean's shape


# ---- continuous PPO ---------------------------------------------------------------
def _jax_ppo_draws(key, cfg, action_dim):
    """JAX's permutations and RPO uniforms from the update's key chain:
    per epoch ``key, k_perm = split(key)``, then per minibatch ``key,
    k_rpo = split(key)``; and the key left."""
    perms, noise = [], []
    for _ in range(cfg.update_epochs):
        key, k_perm = jax.random.split(key)
        perms.append(_t(jax.random.permutation(k_perm, cfg.batch_size)))
        for _ in range(cfg.num_minibatches):
            key, k_rpo = jax.random.split(key)
            noise.append(_t(jax.random.uniform(k_rpo, (cfg.minibatch_size, action_dim),
                                               minval=-cfg.rpo_alpha, maxval=cfg.rpo_alpha)))
    return perms, noise, key


PPO_CFG = dict(total_timesteps=128, learning_rate=3e-4, num_envs=4, num_steps=16,
               num_minibatches=2, update_epochs=2, ent_coef=0.0, clip_rewards=False)


def _jax_ppo_env():
    return jax_wrappers.NormalizeReward(jax_wrappers.NormalizeObservation(
        jax_wrappers.ClipAction(JaxPendulum())))


@pytest.fixture(scope="module")
def jax_ppo_rollout():
    """JAX's initial runner state and the rollout of its first
    train_iteration, rebuilt from its own key splits: the same for PPO and
    RPO (``rpo_alpha`` acts in the update only), so built once.  Returns
    (rs0, data, obs, done, key left)."""
    jenv, jmodel = _jax_ppo_env(), JaxContinuousActorCritic(action_dim=1)
    jinit, _ = jax_make_continuous_ppo(jenv, jmodel, JaxPPOConfig(**PPO_CFG))
    jrs0 = jax.jit(jinit)(jax.random.PRNGKey(0))

    def step(carry, _):
        params, key, obs, env_state, done = carry
        key, k_act, k_step = jax.random.split(key, 3)
        mean, log_std, value = jmodel.apply(params, obs)
        action = jax_dist.normal_sample(k_act, mean, log_std)
        logprob = jax_dist.normal_log_prob(mean, log_std, action)
        next_obs, env_state, reward, next_done, _ = jenv.v_step(
            jax.random.split(k_step, 4), env_state, action)
        return (params, key, next_obs, env_state, next_done), (obs, action, logprob, reward,
                                                               done, value)

    (_, key, obs, _, done), data = jax.jit(lambda c: jax.lax.scan(step, c, None, length=16))(
        (jrs0.train_state.params, jrs0.key, jrs0.obs, jrs0.env_state, jrs0.done))
    return jrs0, data, obs, done, key


@pytest.mark.parametrize("rpo_alpha", [0.0, 0.5], ids=["ppo", "rpo"])
def test_make_continuous_ppo_update_matches_jax(rpo_alpha, jax_ppo_rollout):
    """One train_iteration of continuous PPO on Pendulum under the
    scripts' wrapper stack (4 envs x 16 steps, 2 minibatches, 2 epochs,
    ent_coef 0): JAX's rollout rebuilt from its own key splits (the
    stored actions unclipped, beyond the torque limit in places), then the
    port's update on it with JAX's permutations and, for RPO, its
    per-minibatch uniforms.  Float32 Adam steps on gradients summed in
    other orders: parameters (``log_std`` included) within 1e-5 relative
    plus 1e-7, the metrics within 1e-4 relative plus 1e-7 (as the
    discrete PPO tests hold them)."""
    jcfg = JaxPPOConfig(**PPO_CFG, rpo_alpha=rpo_alpha)
    _, jtrain = jax_make_continuous_ppo(_jax_ppo_env(), JaxContinuousActorCritic(action_dim=1),
                                        jcfg)
    jrs0, data, obs, done, key = jax_ppo_rollout
    jrs1, jm = jax.device_get(jax.jit(jtrain)(jrs0))
    np.testing.assert_array_equal(np.asarray(obs), np.asarray(jrs1.obs))
    assert float(jnp.abs(data[1]).max()) > 2.0  # an unclipped action is stored
    perms, noise, key = _jax_ppo_draws(key, jcfg, 1)
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jrs1.key))

    model = ContinuousActorCritic(1, 3, device="cpu")
    model.load_state_dict(agent_params_from_flax(jax.device_get(jrs0.train_state.params)))
    names = [n for n, _ in model.named_parameters()]
    assert "log_std" in names
    rs = RunnerState(model=model, opt_state=ppo_opt_state_from_flax(
        jax.device_get(jrs0.train_state.opt_state), names), env_state=None, obs=_t(obs),
        done=_t(done), carry=(), stats=None, generator=None)
    ppo = make_continuous_ppo(Pendulum(device="cpu"), model,
                              PPOConfig(**dataclasses.asdict(jcfg)))
    rs, metrics = ppo.update_from_rollout(rs, tuple(_t(x) for x in data), perms,
                                          rpo_noise=noise if rpo_alpha else None)
    assert int(rs.step) == int(jrs1.train_state.step) == 4
    ref = agent_params_from_flax(jrs1.train_state.params)
    for name, p in rs.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)


# ---- DDPG, TD3 and SAC: one fused iteration, JAX's draws replayed --------------
# 24 steps of 1 env through a ring of 16 (it wraps): uniform actions while
# fewer than 12 steps are stored (steps 1-12), updates once more than 12
# are (steps 13-24, 12 of them) at batch 8; the actor (and DDPG's and
# TD3's Polyak sync) every 2nd step, SAC's target sync every 3rd.  The env
# starts 4 steps before Pendulum's time limit, so a truncated transition
# is stored as not done.  (JAX's three ``init_runner``s take one env: they
# initialise the critic on the (num_envs, obs) batch beside a (1, A)
# action, which concatenates only for num_envs = 1; the port's run any.)
OFF = dict(total_timesteps=48, num_envs=1, buffer_size=16, gamma=0.99, tau=0.05, batch_size=8,
           learning_starts=12, policy_frequency=2, steps_per_iteration=24)
ALGOS = {
    "ddpg": (JaxDDPGConfig, jax_make_ddpg, DDPGConfig, make_ddpg, 5,
             dict(learning_rate=1e-3)),
    "td3": (JaxTD3Config, jax_make_td3, TD3Config, make_td3, 6, dict(learning_rate=1e-3)),
    "sac": (JaxSACConfig, jax_make_sac, SACConfig, make_sac, 7,
            dict(q_lr=1e-3, policy_lr=1e-3, target_network_frequency=3)),
}
# Float32 on both sides from equal weights: the 256-wide products sum in
# other orders and Adam divides each gradient by its own running scale, so
# an element whose gradient lies within rounding of zero takes another
# fraction of its step.  After 12 critic and 6-12 actor steps at lr 1e-3
# the parameters agree within 2e-6 absolute (2.2e-7 seen); losses within 1e-4 relative
# plus 1e-6; exploring actions within 1e-5.
OFF_PARAM_ATOL = 2e-6


def jax_continuous_draws(kind, jrunner, cfg):
    """Per step of JAX's ``train_iteration``: the port's ``ContinuousDraws``
    and the reset values of its env step, from JAX's key chain (DDPG
    ``split(key, 5)``: key, noise, uniform action, env step, sample; TD3
    adds the smoothing key, SAC the next-action and policy keys, the
    latter folded with the pass number)."""
    n, B, cap = cfg["num_envs"], cfg["batch_size"], cfg["buffer_size"]
    key, draws, resets = jrunner.key, [], []
    low, high = -2.0, 2.0
    for k in range(cfg["steps_per_iteration"]):
        keys = jax.random.split(key, ALGOS[kind][4])
        key, k_noise, k_rand, k_step, k_sample = keys[:5]
        resets.append(step_resets(jax.random.split(k_step, n)))
        size = min((k + 1) * n, cap)
        train = (k + 1) * n > cfg["learning_starts"]
        d = dict(explore_noise=_t(jax.random.normal(k_noise, (n, 1))),
                 random_action=_t(jax.random.uniform(k_rand, (n, 1), minval=low, maxval=high)))
        if train:
            d["sample_idx"] = _t(jax.random.randint(k_sample, (B,), 0, max(size, 1))).long()
            if kind in ("td3", "sac"):
                d["target_noise"] = _t(jax.random.normal(keys[5], (B, 1)))
            if kind == "sac":
                d["actor_noise"] = [_t(jax.random.normal(jax.random.fold_in(keys[6], i), (B, 1)))
                                    for i in range(cfg["policy_frequency"])]
        draws.append(ContinuousDraws(**d))
    return draws, resets


def _networks(kind):
    """(actor, critics) of the port, JAX's shapes: obs 3, action 1."""
    if kind == "sac":
        actor = SquashedGaussianActor(3, 1, device="cpu")
    else:
        actor = DeterministicActor(3, 1, (2.0,), (0.0,), device="cpu")
    return actor, [QFunction(3, 1, device="cpu") for _ in range(1 if kind == "ddpg" else 2)]


@pytest.mark.parametrize("kind", list(ALGOS))
def test_fused_actor_critic_iteration_matches_jax(kind):
    """One iteration of 24 steps from JAX's initial state: the same warmup
    and exploring actions, stores (the truncation bootstrapped through),
    12 critic updates, the actor (SAC: 2 passes and alpha each) on steps
    14, 16, ..., 24, the Polyak syncs on their cadences, and the same
    last-step metrics."""
    jcfg_cls, jmake, cfg_cls, make_algo, _, extra = ALGOS[kind]
    cfg = dict(OFF, **extra)
    jenv, replay = JaxPendulum(), Replay()
    env = Pendulum(device="cpu", sampler=replay)
    if kind == "sac":
        jactor = JaxSquashedGaussianActor(action_dim=1, action_scale=(2.0,), action_bias=(0.0,))
    else:
        jactor = JaxDeterministicActor(action_dim=1, action_scale=(2.0,), action_bias=(0.0,))
    jinit, jtrain = jmake(jenv, jactor, JaxQFunction(), jcfg_cls(**cfg))
    jrunner = jax.jit(jinit)(jax.random.PRNGKey(3))
    env_state = jrunner.env_state.replace(t=jrunner.env_state.t.at[0].set(jenv.max_steps - 4))
    jrunner = jrunner.replace(env_state=env_state)
    k_env = jax.random.split(jax.random.PRNGKey(3), 4 if kind == "ddpg" else 5)[1]
    replay.draws.append(reset_values(jax.vmap(jenv._reset)(jax.random.split(k_env, 1))[1]))

    actor, critics = _networks(kind)
    algo = make_algo(env, actor, *critics, cfg_cls(**cfg))
    runner = algo.init_runner(torch.Generator())
    runner.env_state.t[0] = jenv.max_steps - 4
    names = lambda m: [n for n, _ in m.named_parameters()]  # noqa: E731
    runner.train_state.load_payload(actor_critic_payload_from_flax(
        jax.device_get(jrunner.train_state), names(actor), names(critics[0])))
    np.testing.assert_array_equal(runner.obs.numpy(), np.asarray(jrunner.obs))
    draws, resets = jax_continuous_draws(kind, jrunner, cfg)
    replay.draws.extend(resets)
    jrunner, jm = jax.device_get(jax.jit(jtrain)(jrunner))
    runner, m = algo.train_iteration(runner, draws)

    assert runner.global_step == int(jrunner.global_step) == 24
    buf, jbuf = runner.buffer, jrunner.buffer
    assert (buf.pos, buf.size) == (int(jbuf.pos), int(jbuf.size)) == (8, 16)
    np.testing.assert_array_equal(buf.data["done"].numpy(), np.asarray(jbuf.data["done"]))
    assert float(buf.data["done"].sum()) == 0.0  # Pendulum only truncates
    for k in ("obs", "next_obs", "reward"):
        np.testing.assert_allclose(buf.data[k].numpy(), np.asarray(jbuf.data[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(buf.data["action"].numpy(), np.asarray(jbuf.data["action"]),
                               rtol=0, atol=1e-5)
    _close(runner.obs, jrunner.obs, 1e-5, "obs")

    ts = runner.train_state
    ref = actor_critic_payload_from_flax(jrunner.train_state, names(actor), names(critics[0]))
    pairs = [("actor", ts.actor, ref["actor"])] + [
        (f"critic{i}", c, r) for i, (c, r) in enumerate(zip(ts.critics, ref["critics"]))]
    for label, net, want in pairs:
        assert int(net.step) == int(want["opt_state"]["count"])
        for part in ("model", "target"):
            module = getattr(net, part)
            if module is None:
                assert want[part] is None
                continue
            for name, p in module.state_dict().items():
                np.testing.assert_allclose(p.numpy(), want[part][name].numpy(), rtol=0,
                                           atol=OFF_PARAM_ATOL, err_msg=f"{label} {part} {name}")
    assert int(ts.critics[0].step) == 12
    assert int(ts.actor.step) == (12 if kind == "sac" else 6)
    if kind == "sac":
        np.testing.assert_allclose(ts.log_alpha.item(), ref["log_alpha"].item(), rtol=1e-5)
        assert ts.log_alpha.item() != np.log(0.2)
        assert int(ts.alpha_opt_state.count) == int(ref["alpha_opt_state"]["count"]) == 12
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(jm["losses/actor_loss"]) != 0.0  # step 24 runs the actor
