"""Whole updates of the port's feedforward PPO, PPO + RND and PPG (on
Minecraft2d, and on procmaze with its int8 aux store) against the JAX
package's on the CPU, from the same state and converted weights.

The JAX algorithms expose only ``train_iteration`` (a PPG cycle for PPG),
so each test rebuilds JAX's rollout from JAX's own ``model.apply``,
``categorical_sample`` and ``env.v_step`` under the same key splits,
asserts that it ends where JAX's ``train_iteration`` did (obs, env state,
episode statistics), and feeds it and JAX's other draws (permutations, the
RND predictor's mask uniforms) to the port."""

from collections.abc import Mapping
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from mmtrl_tpu.algos.ppo import make_ppo as jax_make_ppo
from mmtrl_tpu.algos.ppo.core import _maybe_clip as jax_maybe_clip
from mmtrl_tpu.algos.ppo.ppg import PPGAgent as JaxPPGAgent
from mmtrl_tpu.algos.ppo.ppg import PPGConfig as JaxPPGConfig
from mmtrl_tpu.algos.ppo.ppg import make_ppg as jax_make_ppg
from mmtrl_tpu.algos.ppo.rnd import RNDAgent as JaxRNDAgent
from mmtrl_tpu.algos.ppo.rnd import RNDConfig as JaxRNDConfig
from mmtrl_tpu.algos.ppo.rnd import RNDNetwork as JaxRNDNetwork
from mmtrl_tpu.algos.ppo.rnd import make_rnd_ppo as jax_make_rnd_ppo
from mmtrl_tpu.envs.minecraft2d import Minecraft2d as JaxMinecraft2d
from mmtrl_tpu.envs.procmaze import ProcMaze as JaxProcMaze
from mmtrl_tpu.models import CNNAgent as JaxCNNAgent
from mmtrl_tpu.models import distributions as jax_dist
from mmtrl_tpu_torch.algos.ppo import PPOConfig, RunnerState, make_ppo
from mmtrl_tpu_torch.algos.ppo.core import grads_of
from mmtrl_tpu_torch.algos.ppo.ppg import PPGAgent, PPGConfig, make_ppg
from mmtrl_tpu_torch.algos.ppo.rnd import (
    RNDAgent,
    RNDConfig,
    RNDNetwork,
    RNDRunner,
    make_rnd_ppo,
)
from mmtrl_tpu_torch.convert import agent_params_from_flax, ppo_opt_state_from_flax
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
from mmtrl_tpu_torch.envs.procmaze import ProcMaze
from mmtrl_tpu_torch.envs.wrappers import RunningStat
from mmtrl_tpu_torch.models.agents import CNNAgent

N_ENVS, N_STEPS = 4, 4
BATCH = N_ENVS * N_STEPS
# The tolerances of test_torch_ppo.py's update tests.  Parameters after the
# update's Adam steps (lr 2.5e-4): float32 gradients summed in other
# orders; with eps 1e-5 an update's sensitivity to its gradient is
# bounded, so the parameters agree far inside the learning rate.
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7
# Moments: mu and nu are the gradients' running averages, so they carry the
# gradients' own float32 differences, relative to each tensor's largest.
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-7
# Running statistics: float32 sums of the same T x N observations in
# another order.
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref, rtol, atol_of_max=0.0, what="", atol=0.0):
    """|out - ref| <= rtol * |ref| + atol_of_max * max|ref| + atol, elementwise."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    atol += atol_of_max * float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol, err_msg=what)


def _load(module, params):
    module.load_state_dict(agent_params_from_flax(jax.device_get(params)), strict=True)
    return module


def _to_flax(template, module):
    """The flax tree shaped like ``template`` holding ``module``'s weights
    (the inverse of ``agent_params_from_flax``)."""
    sd = module.state_dict()

    def walk(tree, prefix):
        out = {}
        for key, value in tree.items():
            if isinstance(value, Mapping):
                out[key] = walk(value, f"{prefix}{key}.")
                continue
            w = sd[prefix + ("bias" if key == "bias" else "weight")].numpy()
            if key == "kernel":
                w = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)
            out[key] = jnp.asarray(w)
        return out

    return {"params": walk(template["params"], "")}


def _compare_params(module, ref_params, opt_state, ref_opt_state, what,
                    param_atol=PARAM_ATOL, moment_atol_of_max=MOMENT_ATOL_OF_MAX):
    names = [n for n, _ in module.named_parameters()]
    ref = agent_params_from_flax(jax.device_get(ref_params))
    for name, p in module.named_parameters():
        _close(p, ref[name], PARAM_RTOL, what=f"{what} {name}", atol=param_atol)
    ref_opt = ppo_opt_state_from_flax(jax.device_get(ref_opt_state), names)
    assert int(opt_state.count) == int(ref_opt.count), what
    for moments, refs in ((opt_state.mu, ref_opt.mu), (opt_state.nu, ref_opt.nu)):
        for name, m, r in zip(names, moments, refs):
            _close(m, r, MOMENT_RTOL, moment_atol_of_max, f"{what} {name}")


def _compare_metrics(metrics, jmetrics, rtol=METRIC_RTOL):
    jmetrics = jax.device_get(jmetrics)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        _close(metrics[k], v, rtol, what=k, atol=METRIC_ATOL)


def _assert_same_end(end, jrs):
    """The rebuilt rollout ended where JAX's train_iteration did."""
    obs, env_state, done, stats = end
    np.testing.assert_array_equal(np.asarray(obs), np.asarray(jrs.obs))
    np.testing.assert_array_equal(np.asarray(done), np.asarray(jrs.done))
    for tree, ref in ((env_state, jrs.env_state), (stats, jrs.stats)):
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _split_perms(key, epochs, n):
    """JAX's per-epoch ``key, k_perm = split(key); permutation(k_perm, n)``."""
    perms = []
    for _ in range(epochs):
        key, k_perm = jax.random.split(key)
        perms.append(_t(jax.random.permutation(k_perm, n)))
    return key, perms


def _skip_rollout_keys(key, steps):
    for _ in range(steps):
        key = jax.random.split(key, 3)[0]
    return key


def _feedforward_rollout(env, apply, cfg, clip):
    """JAX's ``_rollout_step`` of make_ppo (and make_ppg) as a jitted scan
    of ``apply(params, obs)``: (key, obs, env_state, done, stats) -> the
    end state and (obs, actions, logprobs, rewards, dones, values)."""

    def step(carry, _):
        params, key, obs, env_state, done, stats = carry
        key, k_act, k_step = jax.random.split(key, 3)
        logits, value = apply(params, obs)[:2]
        action = jax_dist.categorical_sample(k_act, logits)
        logprob = jax_dist.categorical_log_prob(logits, action)
        next_obs, env_state, reward, next_done, info = env.v_step(
            jax.random.split(k_step, cfg.num_envs), env_state, action)
        stats = stats.update(info.get("raw_reward", reward), next_done)
        return ((params, key, next_obs, env_state, next_done, stats),
                (obs, action, logprob, clip(reward), done, value))

    @jax.jit
    def run(params, key, obs, env_state, done, stats):
        (_, key, obs, env_state, done, stats), data = jax.lax.scan(
            step, (params, key, obs, env_state, done, stats), None, length=cfg.num_steps)
        return (key, obs, env_state, done, stats), data

    return run


def _torch_rollout(data):
    obs, actions, logprobs, rewards, dones, values = (_t(x) for x in data)
    return obs, actions.long(), logprobs, rewards, dones, values


# ---- feedforward PPO --------------------------------------------------------
def test_make_ppo_update_matches_jax():
    """One train_iteration of the feedforward CNN agent (small towers, input
    scale 1): JAX's rollout rebuilt, then the port's update on it with
    JAX's two permutations of all 16 rows."""
    jcfg = JaxPPOConfig(num_envs=N_ENVS, num_steps=N_STEPS, num_minibatches=2, update_epochs=2,
                        total_timesteps=3 * BATCH, clip_rewards=True)
    jmodel = JaxCNNAgent(num_actions=4, conv_type="small", input_scale=1.0)
    env = JaxMinecraft2d()
    init_runner, train_iteration = jax_make_ppo(env, jmodel, jcfg)
    jrs0 = init_runner(jax.random.PRNGKey(0))
    jrs1, jmetrics = jax.jit(train_iteration)(jrs0)

    run = _feedforward_rollout(env, jmodel.apply, jcfg, lambda r: jax_maybe_clip(jcfg, r))
    (key, obs, env_state, done, stats), data = run(
        jrs0.train_state.params, jrs0.key, jrs0.obs, jrs0.env_state, jrs0.done, jrs0.stats)
    _assert_same_end((obs, env_state, done, stats), jrs1)
    key, perms = _split_perms(key, jcfg.update_epochs, BATCH)
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jrs1.key))

    fields = dataclasses.asdict(jcfg)
    assert fields.pop("rpo_alpha") == 0.0  # read only by the continuous variant
    cfg = PPOConfig(**fields)
    model = _load(CNNAgent(4, "small", input_scale=1.0, device="cpu"), jrs0.train_state.params)
    names = [n for n, _ in model.named_parameters()]
    rs = RunnerState(model=model,
                     opt_state=ppo_opt_state_from_flax(jax.device_get(jrs0.train_state.opt_state),
                                                       names),
                     env_state=None, obs=_t(obs), done=_t(done), carry=(), stats=None,
                     generator=None)
    ppo = make_ppo(Minecraft2d(device="cpu"), model, cfg)
    rs, metrics = ppo.update_from_rollout(rs, _torch_rollout(data), perms)
    assert int(jrs1.train_state.step) == 4
    _compare_params(rs.model, jrs1.train_state.params, rs.opt_state, jrs1.train_state.opt_state,
                    "policy")
    _compare_metrics(metrics, jmetrics)


# ---- PPO + RND --------------------------------------------------------------
def _rnd_rollout(env, jmodel, cfg):
    """JAX's RND ``_rollout_step``, the intrinsic reward from the runner's
    (pre-rollout) observation statistics, target and predictor."""
    target, predictor = JaxRNDNetwork(predictor=False), JaxRNDNetwork(predictor=True)

    def step(carry, _):
        rs, key, obs, env_state, done, stats = carry
        key, k_act, k_step = jax.random.split(key, 3)
        logits, v_ext, v_int = jmodel.apply(rs.train_state.params, obs)
        action = jax_dist.categorical_sample(k_act, logits)
        logprob = jax_dist.categorical_log_prob(logits, action)
        next_obs, env_state, reward, next_done, _ = env.v_step(
            jax.random.split(k_step, cfg.num_envs), env_state, action)
        norm = jnp.clip(rs.obs_stat.normalize(next_obs), -5.0, 5.0)
        int_rew = ((target.apply(rs.target_params, norm)
                    - predictor.apply(rs.predictor_state.params, norm)) ** 2).sum(-1) / 2.0
        stats = stats.update(reward, next_done)
        return ((rs, key, next_obs, env_state, next_done, stats),
                (obs, action, logprob, reward, int_rew, done, v_ext, v_int, next_obs))

    @jax.jit
    def run(rs):
        (_, key, obs, env_state, done, stats), data = jax.lax.scan(
            step, (rs, rs.key, rs.obs, rs.env_state, rs.done, rs.stats), None,
            length=cfg.num_steps)
        return (key, obs, env_state, done, stats), data

    return run


def _rnd_runner_from_jax(jrs, env, cfg):
    """The port's runner holding a JAX RNDRunner's state (after its rollout
    for obs and done)."""
    shape = env.observation_space.shape
    model = _load(RNDAgent(4, shape, device="cpu"), jrs.train_state.params)
    target = _load(RNDNetwork(shape, device="cpu"), jrs.target_params)
    predictor = _load(RNDNetwork(shape, predictor=True, device="cpu"),
                      jrs.predictor_state.params)
    opt = [ppo_opt_state_from_flax(jax.device_get(ts.opt_state),
                                   [n for n, _ in m.named_parameters()])
           for ts, m in ((jrs.train_state, model), (jrs.predictor_state, predictor))]
    stat = lambda s: RunningStat(_t(s.mean), _t(s.var), _t(s.count))  # noqa: E731
    return RNDRunner(model=model, opt_state=opt[0], predictor=predictor,
                     predictor_opt_state=opt[1], target=target, env_state=None,
                     obs=_t(jrs.obs), done=_t(jrs.done), obs_stat=stat(jrs.obs_stat),
                     reward_stat=stat(jrs.reward_stat), forward_filter=_t(jrs.forward_filter),
                     stats=None, generator=None)


def test_rnd_update_matches_jax():
    """The SECOND train_iteration, from JAX's state after the first: the
    policy's learning rate is annealed to 2/3 of the peak there, the
    predictor's plain Adam keeps the peak, unclipped (so this test fails
    if the predictor's optimizer clips or anneals).  JAX's permutations and
    mask uniforms are replayed."""
    jcfg = JaxRNDConfig(num_envs=N_ENVS, num_steps=N_STEPS, num_minibatches=2, update_epochs=2,
                        total_timesteps=3 * BATCH, clip_rewards=True)
    jmodel = JaxRNDAgent(num_actions=4)
    env = JaxMinecraft2d()
    init_runner, train_iteration = jax_make_rnd_ppo(env, jmodel, jcfg)
    train_iteration = jax.jit(train_iteration)
    jrs1, _ = train_iteration(init_runner(jax.random.PRNGKey(1)))
    jrs2, jmetrics = train_iteration(jrs1)

    (key, obs, env_state, done, stats), data = _rnd_rollout(env, jmodel, jcfg)(jrs1)
    _assert_same_end((obs, env_state, done, stats), jrs2)
    mb = BATCH // jcfg.num_minibatches
    perms, masks = [], []
    for _ in range(jcfg.update_epochs):
        key, (perm,) = _split_perms(key, 1, BATCH)
        perms.append(perm)
        epoch_masks = []
        for _ in range(jcfg.num_minibatches):
            key, k_mask = jax.random.split(key)
            epoch_masks.append(_t(jax.random.uniform(k_mask, (mb,))))
        masks.append(epoch_masks)
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jrs2.key))

    port_env = Minecraft2d(device="cpu")
    rs = _rnd_runner_from_jax(jrs1.replace(obs=obs, done=done), port_env, jcfg)
    fields = dataclasses.asdict(jcfg)
    fields.pop("rpo_alpha")
    cfg = RNDConfig(**fields)
    rnd = make_rnd_ppo(port_env, rs.model, cfg, rs.target, rs.predictor)
    torch_data = tuple(_t(x) for x in data)
    torch_data = torch_data[:1] + (torch_data[1].long(),) + torch_data[2:]
    stats = rnd.statistics(rs, torch_data)
    for name, stat, ref in (("obs_stat", stats[0], jrs2.obs_stat),
                            ("reward_stat", stats[1], jrs2.reward_stat)):
        for field in ("mean", "var", "count"):
            _close(getattr(stat, field), getattr(ref, field), STAT_RTOL, what=f"{name}.{field}",
                   atol=STAT_ATOL)
    _close(stats[2], jrs2.forward_filter, STAT_RTOL, what="forward_filter", atol=STAT_ATOL)
    rs, metrics = rnd.update_from_rollout(rs, torch_data, perms, masks)

    assert int(jrs2.train_state.step) == 8 and int(jrs2.predictor_state.step) == 8
    _compare_params(rs.model, jrs2.train_state.params, rs.opt_state, jrs2.train_state.opt_state,
                    "policy")
    _compare_params(rs.predictor, jrs2.predictor_state.params, rs.predictor_opt_state,
                    jrs2.predictor_state.opt_state, "predictor")
    for name in ("obs_stat", "reward_stat", "forward_filter"):
        assert getattr(rs, name) is not None
    assert torch.equal(rs.obs_stat.var, stats[0].var) and torch.equal(rs.forward_filter, stats[2])
    _compare_metrics(metrics, jmetrics)
    # the target network never trains
    for name, p in rs.target.named_parameters():
        assert not p.requires_grad
        np.testing.assert_array_equal(
            p.detach().numpy(), agent_params_from_flax(jax.device_get(jrs2.target_params))[name])


# ---- PPG --------------------------------------------------------------------
# A PPG cycle of two policy iterations compares the port's second rollout
# and everything after it, which start from the port's own weights: 1e-7
# from JAX's after the first iteration (float32 order).  The cycle
# magnifies such differences (max-pool windows switch, and Adam turns a
# switched gradient into a step of up to the learning rate): the test
# runs JAX's own cycle again from starting weights moved by 1e-7 (normal
# noise) and requires that it, too, moves by more than JAX_SPREAD_FLOOR
# (it moves by 1.1e-3 on this config, CPU).  So the two-iteration cycle is
# held to CHAINED on the parameters (the port reads 6.6e-6), with the
# moments and metrics at the matching share; the one-iteration cycle, whose
# every input is JAX's, to the update tests' tolerances above.  A float32
# aux store (no bf16 rounding) moves the parameters by 5.6e-4 on this
# config, outside both.
CHAINED = dict(param_atol=5e-5, moment_atol_of_max=5e-2)
CHAINED_METRIC_RTOL = 1e-2
JAX_SPREAD_FLOOR = 10 * PARAM_ATOL


@pytest.mark.parametrize("n_iteration", [1, 2])
def test_ppg_cycle_matches_jax(n_iteration):
    """One PPG cycle (4 envs x 4 steps a rollout, 2 aux epochs over all
    stored rows): each policy iteration's rollout rebuilt in JAX from the
    port's current weights under JAX's keys, JAX's policy and aux
    permutations replayed.  The aux store is bfloat16, which rounds the
    [-1, 1] observations as JAX's store does."""
    jcfg = JaxPPGConfig(num_envs=N_ENVS, num_steps=N_STEPS, num_minibatches=2,
                        n_iteration=n_iteration, e_policy=1, e_auxiliary=2, num_aux_minibatches=2,
                        total_timesteps=3 * BATCH * n_iteration)
    jmodel = JaxPPGAgent(num_actions=4)
    env = JaxMinecraft2d()
    init_runner, ppg_cycle = jax_make_ppg(env, jmodel, jcfg)
    jrs0 = init_runner(jax.random.PRNGKey(2))
    jrs1, jmetrics = jax.jit(ppg_cycle)(jrs0)

    # JAX's key chain: per iteration the rollout's splits, then one split
    # per policy epoch; then one per aux epoch
    key, starts, perms = jrs0.key, [], []
    for _ in range(n_iteration):
        starts.append(key)
        key, epoch_perms = _split_perms(_skip_rollout_keys(key, N_STEPS), jcfg.e_policy, BATCH)
        perms.append(epoch_perms)
    key, aux_perms = _split_perms(key, jcfg.e_auxiliary, BATCH * n_iteration)
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jrs1.key))

    run = _feedforward_rollout(env, jmodel.apply, jcfg, lambda r: r)
    state = {"i": 0, "end": (jrs0.obs, jrs0.env_state, jrs0.done, jrs0.stats)}

    def rollout(rs):
        obs, env_state, done, stats = state["end"]
        params = _to_flax(jrs0.train_state.params, rs.model)
        (_, obs, env_state, done, stats), data = run(params, starts[state["i"]], obs, env_state,
                                                     done, stats)
        state["i"] += 1
        state["end"] = (obs, env_state, done, stats)
        return dataclasses.replace(rs, obs=_t(obs), done=_t(done)), _torch_rollout(data)

    fields = dataclasses.asdict(jcfg)
    fields.pop("rpo_alpha")
    cfg = PPGConfig(**fields)
    assert cfg.aux_store_dtype == "bfloat16"
    model = _load(PPGAgent(4, (2, 84, 84), device="cpu"), jrs0.train_state.params)
    names = [n for n, _ in model.named_parameters()]
    rs = RunnerState(model=model,
                     opt_state=ppo_opt_state_from_flax(jax.device_get(jrs0.train_state.opt_state),
                                                       names),
                     env_state=None, obs=_t(jrs0.obs), done=_t(jrs0.done), carry=(), stats=None,
                     generator=None)
    ppg = make_ppg(Minecraft2d(device="cpu"), model, cfg)
    rs, metrics = ppg.train_iteration(rs, rollout, perms, aux_perms)

    assert state["i"] == n_iteration
    _assert_same_end(state["end"], jrs1)
    assert int(jrs1.train_state.step) == cfg.opt_steps_per_update == n_iteration * 2 + 2 * 2
    chained = n_iteration > 1
    if chained:
        leaves, tree = jax.tree_util.tree_flatten(jrs0.train_state.params)
        keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
        moved = jax.tree_util.tree_unflatten(
            tree, [x + 1e-7 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
        jrs_moved, _ = jax.jit(ppg_cycle)(jrs0.replace(
            train_state=jrs0.train_state.replace(params=moved)))
        spread = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
            jax.tree_util.tree_leaves(jrs_moved.train_state.params),
            jax.tree_util.tree_leaves(jrs1.train_state.params)))
        assert spread > JAX_SPREAD_FLOOR, spread
    _compare_params(rs.model, jrs1.train_state.params, rs.opt_state, jrs1.train_state.opt_state,
                    "ppg", **(CHAINED if chained else {}))
    _compare_metrics(metrics, jmetrics, CHAINED_METRIC_RTOL if chained else METRIC_RTOL)


def test_ppg_cycle_with_int8_store_on_procmaze_matches_jax():
    """One PPG cycle on procmaze (4 envs x 4 steps, one policy iteration, one
    aux epoch), JAX's rollout rebuilt under its keys and its permutations
    replayed, with the int8 aux store of ``scripts/ppg.py``'s procmaze
    default: every stored observation comes back exact through
    ``.float()``.  On procmaze's piecewise-constant {-1, +1} planes even
    one policy iteration is chaotic in the weights (many positions share
    each pre-activation, so a ReLU or max-pool window within rounding of
    a switch moves a whole region's gradient, and Adam turns that into a
    step of up to the learning rate): JAX's own cycle from weights moved by
    1e-7 moves by 1.3e-6 here, and with two aux epochs by 5.9e-5 (CPU).  So
    the test asserts that spread and holds the port to
    test_ppg_cycle_matches_jax's CHAINED tolerances, by that test's own
    rule.  It takes one aux epoch: with two, JAX's own spread (5.9e-5)
    exceeds CHAINED's 5e-5 itself, and the port reads 6.9e-5."""
    jcfg = JaxPPGConfig(num_envs=N_ENVS, num_steps=N_STEPS, num_minibatches=2, n_iteration=1,
                        e_policy=1, e_auxiliary=1, num_aux_minibatches=2,
                        total_timesteps=3 * BATCH, aux_store_dtype="int8")
    jmodel = JaxPPGAgent(num_actions=4)
    # the bank's first 200 levels: XLA compiles the 1,000-level bank, 33 MB
    # of constants in every jitted function, far more slowly
    env = JaxProcMaze(num_levels=200, total_levels=200)
    init_runner, ppg_cycle = jax_make_ppg(env, jmodel, jcfg)
    jrs0 = jax.jit(init_runner)(jax.random.PRNGKey(2))  # eager: 12 s on procmaze
    cycle = jax.jit(ppg_cycle)
    jrs1, jmetrics = cycle(jrs0)

    key, perms = _split_perms(_skip_rollout_keys(jrs0.key, N_STEPS), 1, BATCH)
    key, aux_perms = _split_perms(key, jcfg.e_auxiliary, BATCH)
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jrs1.key))

    run = _feedforward_rollout(env, jmodel.apply, jcfg, lambda r: r)
    end = []

    def rollout(rs):
        (_, obs, env_state, done, stats), data = run(
            _to_flax(jrs0.train_state.params, rs.model), jrs0.key, jrs0.obs, jrs0.env_state,
            jrs0.done, jrs0.stats)
        end.append((obs, env_state, done, stats))
        data = _torch_rollout(data)
        assert torch.equal(data[0].to(torch.int8).float(), data[0])  # the ±1 planes
        return dataclasses.replace(rs, obs=_t(obs), done=_t(done)), data

    fields = dataclasses.asdict(jcfg)
    fields.pop("rpo_alpha")
    cfg = PPGConfig(**fields)
    model = _load(PPGAgent(4, (3, 84, 84), device="cpu"), jrs0.train_state.params)
    names = [n for n, _ in model.named_parameters()]
    rs = RunnerState(model=model,
                     opt_state=ppo_opt_state_from_flax(jax.device_get(jrs0.train_state.opt_state),
                                                       names),
                     env_state=None, obs=_t(jrs0.obs), done=_t(jrs0.done), carry=(), stats=None,
                     generator=None)
    port_env = ProcMaze(num_levels=200, total_levels=200, device="cpu")
    rs, metrics = make_ppg(port_env, model, cfg).train_iteration(
        rs, rollout, [perms], aux_perms)
    _assert_same_end(end[0], jrs1)
    assert int(jrs1.train_state.step) == cfg.opt_steps_per_update == 2 + 2
    leaves, tree = jax.tree_util.tree_flatten(jrs0.train_state.params)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    moved = jax.tree_util.tree_unflatten(
        tree, [x + 1e-7 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    jrs_moved, _ = cycle(jrs0.replace(train_state=jrs0.train_state.replace(params=moved)))
    spread = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(jrs_moved.train_state.params),
        jax.tree_util.tree_leaves(jrs1.train_state.params)))
    assert spread > JAX_SPREAD_FLOOR, spread
    _compare_params(rs.model, jrs1.train_state.params, rs.opt_state, jrs1.train_state.opt_state,
                    "ppg int8", **CHAINED)
    _compare_metrics(metrics, jmetrics, CHAINED_METRIC_RTOL)


def test_grads_of_raises_on_a_parameter_the_loss_misses_unless_allowed():
    """A parameter cut off the graph is an error; only PPG's policy phase,
    whose loss does not reach the aux head, asks for zeros instead."""
    used, missed = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    with pytest.raises(RuntimeError, match="not have been used"):
        grads_of((2.0 * used).sum(), [used, missed])
    grads = grads_of((2.0 * used).sum(), [used, missed], allow_unused=True)
    assert torch.equal(grads[0], torch.full((3,), 2.0))
    assert torch.equal(grads[1], torch.zeros(2))
