"""The native cartridge pools inside the port's fused loops against the JAX
package on the CPU: the pool's ``reset``/``step`` against JAX's
``v_reset``/``v_step`` (which reach the pool through ``io_callback``) on
RALLY and on BRICK with sticky actions, Pong's pool refusing the batched
step as JAX's does, one ``make_recurrent_ppo`` rollout + update on a RALLY
pool against JAX's jitted ``train_iteration`` (JAX's action uniforms and
permutation replayed), ``evaluate_policy`` and ``evaluate_actions`` on the
pool, ``skeleton_plus_ppo --backend native`` through ``main`` with a save
and a resume that starts from the saved observation, and ``evaluate
--env-id skeleton_plus_native`` building its pool."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from mmtrl_tpu.algos.ppo import make_recurrent_ppo as jax_make_recurrent_ppo
from mmtrl_tpu.envs.homebrew_native import make_native_env as jax_make_native_env
from mmtrl_tpu.envs.pong_ma import NativePong2P as JaxNativePong2P
from mmtrl_tpu.models import MultimodalRecurrentAgent as JaxAgent
from mmtrl_tpu.utils.evaluate import evaluate_actions as jax_evaluate_actions
from mmtrl_tpu.utils.evaluate import evaluate_policy as jax_evaluate_policy
from mmtrl_tpu_torch.algos.ppo import PPOConfig, core, make_recurrent_ppo
from mmtrl_tpu_torch.convert import agent_params_from_flax, ppo_opt_state_from_flax
from mmtrl_tpu_torch.core import checkpoint
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.homebrew_native import make_native_env
from mmtrl_tpu_torch.envs.pong_ma import NativePong2P
from mmtrl_tpu_torch.envs.registry import registry
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
from mmtrl_tpu_torch.models.distributions import gumbel_argmax
from mmtrl_tpu_torch.scripts import evaluate, skeleton_plus_ppo
from mmtrl_tpu_torch.utils.evaluate import evaluate_actions, evaluate_policy

# The observation: tests/test_torch_native.py's tolerance (the MFCC planes'
# float32 FFT, log and projections in other orders, each plane divided by
# its own range; measured 2.3e-6 at most).
OBS_ATOL = 2e-5
STEPS = 40
N_ENVS, N_STEPS = 2, 8
TINY_PPO = dict(num_envs=N_ENVS, num_steps=N_STEPS, num_minibatches=1, update_epochs=1,
                total_timesteps=N_ENVS * N_STEPS, clip_rewards=False)
AGENT = dict(num_actions=6, conv_type="small", attn_type="casl", input_scale=1.0)
# tests/test_torch_ppo.py's tolerances: parameters (float32 on both sides,
# summation order), Adam's moments relative to each tensor's largest, the
# metrics.
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
METRIC_RTOL = 1e-4
# Against JAX's whole iteration, whose rollout is JAX's own: the two
# rollouts' observations differ by up to OBS_ATOL, and Adam moves a
# parameter by about the learning rate (2.5e-4) whatever its gradient's
# size, so where a gradient is near zero that difference decides.
# tests/test_torch_skeleton_plus.py's tolerance for the same case: 1e-6,
# 0.4% of a step (measured 4.3e-7 on one actor weight).
FUSED_PARAM_ATOL = 1e-6
INIT_KEY = 4  # JAX's runner key whose 16 action draws take all six actions


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(env_id, **kw):
    """JAX's pool and the port's on the CPU, one seed, a 30-step cap."""
    kw = dict(num_envs=N_ENVS, seed=5, episode_steps=30, **kw)
    return jax_make_native_env(env_id, **kw), make_native_env(env_id, device="cpu", **kw)


@pytest.mark.parametrize("env_id,sticky", [("rally_native", 0.0), ("brick_native", 0.25)])
def test_pool_reset_and_step_match_jax(env_id, sticky):
    """40 steps under the same actions: the state counter, reward, done,
    kills and life equal to JAX's ``v_step`` (jitted, through
    ``io_callback``), the observation within ``OBS_ATOL``; no ``final_obs``
    (the pool resets its done envs itself) and nothing drawn from the
    run's generator."""
    jenv, env = _pair(env_id, repeat_action_probability=sticky)
    try:
        g = torch.Generator().manual_seed(3)
        g_state = g.get_state()
        jobs, jstate = jenv.v_reset(jax.random.split(jax.random.PRNGKey(0), N_ENVS))
        obs, state = env.reset(N_ENVS, g)
        assert state.dtype == torch.int32 and torch.equal(state, torch.zeros(N_ENVS, dtype=torch.int32))
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=OBS_ATOL)
        v_step = jax.jit(lambda s, a: jenv.v_step(None, s, a))
        actions = np.random.RandomState(0).randint(0, 6, (STEPS, N_ENVS))
        dones = 0
        for t in range(STEPS):
            jobs, jstate, jreward, jdone, jinfo = v_step(jstate, jnp.asarray(actions[t], jnp.int32))
            obs, state, reward, done, info = env.step(state, torch.from_numpy(actions[t]), g)
            assert (state.dtype, reward.dtype, done.dtype) == (torch.int32, torch.float32,
                                                               torch.bool)
            np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
            np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
            np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
            assert set(info) == set(jinfo) == {"kills", "life"}
            for k in info:
                assert info[k].dtype == torch.int32
                np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]))
            np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=OBS_ATOL,
                                       err_msg=f"step {t}")
            dones += int(done.sum())
        assert int(state[0]) == STEPS and dones >= N_ENVS  # the cap ended episodes
        assert torch.equal(g.get_state(), g_state)
        with pytest.raises(ValueError, match="a pool of 2 envs"):
            env.reset(N_ENVS + 1)
    finally:
        env.close()
        jenv.close()


def test_pong_pool_resets_but_refuses_the_batched_step_as_jax_does():
    """JAX's ``NativePong2P`` inherits ``v_reset``, which runs (slot
    observations, a joint-env counter), and ``v_step``, whose callback
    returns (2n,) slot arrays for the (n,) shapes it declares: it fails.
    The port's ``reset`` gives the same, its ``step`` raises before the
    pool steps."""
    jenv, env = JaxNativePong2P(2, seed=0), NativePong2P(2, seed=0, device="cpu")
    try:
        jobs, jstate = jenv.v_reset(None)
        obs, state = env.reset(2)
        assert obs.shape == jobs.shape == (4, 3, 84, 84) and state.shape == jstate.shape == (2,)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=OBS_ATOL)
        with pytest.raises(Exception, match="Incorrect output shape"):
            jenv.v_step(None, jstate, jnp.zeros(4, jnp.int32))
        ram = env.ram()
        with pytest.raises(RuntimeError, match="no slot surface"):
            env.step(state, torch.zeros(4, dtype=torch.long))
        np.testing.assert_array_equal(env.ram(), ram)  # the pool did not step
    finally:
        env.close()
        jenv.close()


def _port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    assert fields.pop("rpo_alpha") == 0.0
    return PPOConfig(**fields)


def _assert_update(rs, metrics, jrs, jmetrics, jbefore, param_atol, what):
    """The port's updated runner against JAX's: every weight moved and
    within tolerance, Adam's count and moments, the metrics."""
    ts = jax.device_get(jrs.train_state)
    ref = agent_params_from_flax(ts.params)
    before = agent_params_from_flax(jax.device_get(jbefore.train_state.params))
    names = [n for n, _ in rs.model.named_parameters()]
    for name, p in rs.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=PARAM_RTOL,
                                   atol=param_atol, err_msg=f"{what}: {name}")
        assert not torch.equal(ref[name], before[name]), name
    ref_opt = ppo_opt_state_from_flax(ts.opt_state, names)
    assert int(rs.opt_state.count) == int(ref_opt.count) == 1
    for moments, refs in ((rs.opt_state.mu, ref_opt.mu), (rs.opt_state.nu, ref_opt.nu)):
        for name, m, r in zip(names, moments, refs):
            np.testing.assert_allclose(m.numpy(), r.numpy(), rtol=MOMENT_RTOL,
                                       atol=MOMENT_ATOL_OF_MAX * float(r.abs().max()),
                                       err_msg=f"{what}: {name}")
    jmetrics = jax.device_get(jmetrics)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=f"{what}: {k}")


def test_fused_rollout_and_update_on_a_rally_pool_match_jax(monkeypatch):
    """JAX's ``make_recurrent_ppo`` on its RALLY pool: ``init_runner`` and one
    jitted ``train_iteration`` (8 pool steps through the ordered
    ``io_callback``, then the update).  The port's loop takes its own pool
    unchanged: ``init_runner``, ``rollout`` with its actions sampled from
    JAX's uniforms by the same Gumbel argmax, and ``update_from_rollout``
    with JAX's permutation.  The post-rollout observation, counter, done and
    episode statistics against JAX's; the update against JAX's
    ``update_from_rollout`` of the port's own rollout (the same inputs), and
    against JAX's whole iteration."""
    jcfg = JaxPPOConfig(**TINY_PPO)
    jenv, env = _pair("rally_native")
    try:
        jmodel = JaxAgent(**AGENT)
        parts = jax_make_recurrent_ppo(jenv, jmodel, jcfg)
        jrs0 = jax.jit(parts[0])(jax.random.PRNGKey(INIT_KEY))
        jrs, jmetrics = jax.jit(parts[1])(jrs0)

        key, uniforms = jrs0.key, []
        for _ in range(N_STEPS):
            key, k_act, _ = jax.random.split(key, 3)
            uniforms.append(_t(jax.random.uniform(k_act, (N_ENVS, AGENT["num_actions"]))))
        perm = _t(jax.random.permutation(jax.random.split(key)[1], N_ENVS))
        taken = []

        def replayed_sample(generator, logits):
            action = gumbel_argmax(logits, uniforms.pop(0))
            taken.append(action)
            return action

        monkeypatch.setattr(core, "categorical_sample", replayed_sample)
        model = MultimodalRecurrentAgent(**AGENT, audio_channels=2, device="cpu")
        model.load_state_dict(agent_params_from_flax(jax.device_get(jrs0.train_state.params)))
        ppo = make_recurrent_ppo(env, model, _port_cfg(jcfg))
        rs = ppo.init_runner(torch.Generator().manual_seed(0))
        np.testing.assert_allclose(rs.obs.numpy(), np.asarray(jrs0.obs), rtol=0, atol=OBS_ATOL)
        initial_carry = rs.carry
        rs, rollout = ppo.rollout(rs)
    finally:
        env.close()
        jenv.close()
    assert not uniforms and rs.env_state.dtype == torch.int32
    # every action drawn, as ROADMAP C.20 asks of an update check
    assert sorted(set(torch.cat(taken).tolist())) == list(range(AGENT["num_actions"]))
    np.testing.assert_allclose(rs.obs.numpy(), np.asarray(jrs.obs), rtol=0, atol=OBS_ATOL)
    np.testing.assert_array_equal(rs.env_state.numpy(), np.asarray(jrs.env_state))
    np.testing.assert_array_equal(rs.done.numpy(), np.asarray(jrs.done))
    for f in ("episode_returns", "episode_lengths", "returned_episode_returns", "episode_count"):
        np.testing.assert_array_equal(getattr(rs.stats, f).numpy(),
                                      np.asarray(getattr(jrs.stats, f)), err_msg=f)

    def jnp_of(tree):
        return tuple(jnp.asarray(x.numpy()) for x in tree)

    jrs_mid = jrs0.replace(obs=jnp.asarray(rs.obs.numpy()), done=jnp.asarray(rs.done.numpy()),
                           carry=jnp_of(rs.carry), key=key)
    jrollout = jnp_of(rollout[:1]) + (jnp.asarray(rollout[1].numpy(), jnp.int32),) + jnp_of(
        rollout[2:])
    same = jax.jit(parts.update_from_rollout)(jrs_mid, jnp_of(initial_carry), jrollout)
    rs, metrics = ppo.update_from_rollout(rs, initial_carry, rollout, perms=[perm])
    _assert_update(rs, metrics, *same, jrs0, PARAM_ATOL, "the port's rollout")
    _assert_update(rs, metrics, jrs, jmetrics, jrs0, FUSED_PARAM_ATOL, "JAX's iteration")


def test_evaluate_policy_and_evaluate_actions_on_the_pool_match_jax():
    """Greedy ``evaluate_policy`` of the recurrent agent, 64 pool steps of 2
    envs, against JAX's jitted one; ``evaluate_actions`` asked for 16 envs
    on a pool of 2 takes the pool's size, as JAX's does (JAX
    ``utils/evaluate.py:80``), under a fixed linear policy on the frame."""
    jenv, env = _pair("rally_native")
    try:
        jmodel = JaxAgent(**AGENT)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((1, N_ENVS, 3, 84, 84)),
                                      jnp.zeros((1, N_ENVS), bool), jmodel.initial_carry(N_ENVS))
        model = MultimodalRecurrentAgent(**AGENT, audio_channels=2, device="cpu")
        model.load_state_dict(agent_params_from_flax(jax.device_get(params)))
        ref = jax.jit(lambda k: jax_evaluate_policy(
            jenv, jmodel.apply, params, k, num_envs=N_ENVS, num_steps=64, recurrent=True,
            initial_carry=jmodel.initial_carry(N_ENVS)))(jax.random.PRNGKey(1))
        out = evaluate_policy(env, model, torch.Generator().manual_seed(1), num_envs=N_ENVS,
                              num_steps=64, recurrent=True,
                              initial_carry=model.initial_carry(N_ENVS, "cpu"))
        assert set(out) == set(ref)
        assert int(out["eval/episodes"]) == int(ref["eval/episodes"]) >= N_ENVS
        for k in ("eval/episodic_return", "eval/episodic_length"):
            np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-6, err_msg=k)

        w = np.random.RandomState(4).randn(6, 84 * 84).astype(np.float32)
        ref = jax.jit(lambda k: jax_evaluate_actions(
            jenv, lambda p, obs, key: jnp.argmax(obs[:, 0].reshape(-1, 84 * 84) @ w.T, -1),
            None, k, num_envs=16, num_steps=40))(jax.random.PRNGKey(0))
        out = evaluate_actions(env, lambda obs: (obs[:, 0].reshape(-1, 84 * 84)
                                                 @ torch.from_numpy(w).T).argmax(-1),
                               torch.Generator().manual_seed(0), num_envs=16, num_steps=40)
        assert int(out["eval/episodes"]) == int(ref["eval/episodes"]) >= N_ENVS
        for k in ("eval/episodic_return", "eval/episodic_length"):
            np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-6, err_msg=k)
    finally:
        env.close()
        jenv.close()


TINY_MAIN = ["--cuda", "False", "--backend", "native", "--env-id", "rally_native",
             "--conv-size", "small", "--num-envs", "2", "--num-steps", "8",
             "--num-minibatches", "1", "--update-epochs", "1", "--save-dir", "ck"]


@pytest.fixture(scope="module")
def pool_run(tmp_path_factory):
    """``skeleton_plus_ppo --backend native --env-id rally_native`` without
    ``--host-loop``: one update of the fused loop, saved."""
    tmp = tmp_path_factory.mktemp("pool_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setenv("MMTRL_RUN_ROOT", str(tmp / "runs"))
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            first = skeleton_plus_ppo.main(cli(skeleton_plus_ppo.Args, TINY_MAIN + [
                "--total-timesteps", "16", "--save-interval", "1"]))
        finally:
            torch.set_num_threads(n)
    return tmp, first, str(tmp / "ck" / first["run_name"])


def test_skeleton_plus_ppo_trains_the_pool_and_resumes_from_the_saved_observation(
        pool_run, monkeypatch):
    """The saved run's runner is the pool's (an int32 counter, its
    observations).  A second update resumed from the save starts from the
    saved observation and counter, not from the pool's fresh reset
    (ROADMAP C.21, as JAX's runner restores its whole state,
    ``algos/ppo/runner.py:77-90``)."""
    tmp, first, ckpt = pool_run
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp / "runs"))
    runner = first["runner"]
    assert [r["update"] for r in first["history"]] == [1]
    assert runner.env_state.dtype == torch.int32 and int(runner.env_state[0]) == N_STEPS
    assert tuple(runner.obs.shape) == (N_ENVS, 3, 84, 84)
    assert all(np.isfinite(v) for k, v in first["history"][0].items() if k.startswith("losses/"))
    saved = checkpoint.load_run(ckpt)

    seen = {}
    plain = skeleton_plus_ppo.make_recurrent_ppo

    def recording(env, model, cfg):
        algo = plain(env, model, cfg)

        def init_runner(generator):
            rs = algo.init_runner(generator)
            seen["pool_reset_obs"] = rs.obs.clone()
            return rs

        def train_iteration(rs):
            seen.setdefault("first_obs", rs.obs.clone())
            seen.setdefault("first_state", rs.env_state.clone())
            return algo.train_iteration(rs)

        return dataclasses.replace(algo, init_runner=init_runner, train_iteration=train_iteration)

    monkeypatch.setattr(skeleton_plus_ppo, "make_recurrent_ppo", recording)
    resumed = skeleton_plus_ppo.main(cli(skeleton_plus_ppo.Args, TINY_MAIN + [
        "--total-timesteps", "32", "--load-from", ckpt]))
    assert resumed["initial_update"] == 2 and [r["update"] for r in resumed["history"]] == [2]
    assert torch.equal(seen["first_obs"], saved["obs"])
    assert not torch.equal(seen["first_obs"], seen["pool_reset_obs"])
    assert torch.equal(seen["first_state"], saved["env_state"])
    assert int(resumed["runner"].env_state[0]) == 2 * N_STEPS


def test_evaluate_on_skeleton_plus_native_builds_the_pool_of_num_envs(pool_run, monkeypatch):
    """``evaluate --env-id skeleton_plus_native`` builds the ROM's pool with
    ``--num-envs``, as JAX's script does, evaluates the checkpoint's agent on
    it and closes it.  SkelPlus.bin is not in the repository, so the
    registry's entry is swapped for RALLY's pool here."""
    tmp, _, ckpt = pool_run
    monkeypatch.chdir(tmp)
    pools = []

    def rally_pool(**kw):
        pools.append(make_native_env("rally_native", seed=5, episode_steps=30, **kw))
        return pools[-1]

    monkeypatch.setitem(registry, "skeleton_plus_native", rally_pool)
    res = evaluate.main(cli(evaluate.Args, [
        "--cuda", "False", "--load-from", ckpt, "--script", "skeleton_plus_ppo",
        "--env-id", "skeleton_plus_native", "--attn-type", "casl", "--input-scale", "1",
        "--conv-size", "small", "--num-envs", "3", "--num-steps", "40"]))
    assert len(pools) == 1 and pools[0].num_envs == 3 and pools[0]._handle == 0  # closed
    assert res["eval/episodes"] >= 3 and np.isfinite(res["eval/episodic_return"])
