"""The port's discrete classic-control zoo against the JAX package on the
CPU, on the same seeded numpy inputs, JAX's draws replayed into the port:

- CartPole, Acrobot and MountainCar step by step from the same states,
  auto-reset and ``truncated`` included;
- ``SumTree`` and ``PrioritizedReplayBuffer`` fed the same uniforms and
  writes with repeated leaves;
- the PER-weighted ``dqn_td_update`` on converted weights (float64);
- one ``make_dqn`` iteration with and without PER and one ``make_c51``
  iteration, compared on runner state and metrics;
- ``MLPActorCritic``, a ``make_ppo`` update on CartPole and
  ``evaluate_actions``.

Tolerances, each stated where it is used: the envs' float32 ``sin`` and
``cos`` differ by an ulp between XLA and torch in about 5% of inputs, so
states agree within a few ulps a step, not bit for bit; the sum-tree's
leaves and descent are bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmtrl_tpu.algos.offpolicy.c51 import C51Config as JaxC51Config
from mmtrl_tpu.algos.offpolicy.c51 import make_c51 as jax_make_c51
from mmtrl_tpu.algos.offpolicy.dqn import DQNConfig as JaxDQNConfig
from mmtrl_tpu.algos.offpolicy.dqn import DQNTrainState as JaxDQNTrainState
from mmtrl_tpu.algos.offpolicy.dqn import dqn_td_update as jax_dqn_td_update
from mmtrl_tpu.algos.offpolicy.dqn import make_dqn as jax_make_dqn
from mmtrl_tpu.algos.ppo.core import PPOConfig as JaxPPOConfig
from mmtrl_tpu.algos.ppo.core import make_ppo as jax_make_ppo
from mmtrl_tpu.data.buffers import PrioritizedReplayBuffer as JaxPER
from mmtrl_tpu.data.buffers import SumTree as JaxSumTree
from mmtrl_tpu.envs.classic import Acrobot as JaxAcrobot
from mmtrl_tpu.envs.classic import CartPole as JaxCartPole
from mmtrl_tpu.envs.classic import MountainCar as JaxMountainCar
from mmtrl_tpu.models.agents import DistributionalQNetwork as JaxDistributionalQNetwork
from mmtrl_tpu.models.agents import MLPActorCritic as JaxMLPActorCritic
from mmtrl_tpu.models.agents import QNetwork as JaxQNetwork
from mmtrl_tpu.utils.evaluate import evaluate_actions as jax_evaluate_actions
from mmtrl_tpu_torch.algos.offpolicy import StepDraws
from mmtrl_tpu_torch.algos.offpolicy.c51 import C51Config, make_c51
from mmtrl_tpu_torch.algos.offpolicy.dqn import (
    DQNConfig,
    argmax_q,
    create_dqn_state,
    dqn_td_update,
    make_dqn,
    per_beta,
)
from mmtrl_tpu_torch.algos.ppo import PPOConfig, make_ppo
from mmtrl_tpu_torch.convert import (
    _leaf,
    agent_params_from_flax,
    dqn_payload_from_flax,
    ppo_opt_state_from_flax,
)
from mmtrl_tpu_torch.data.buffers import PrioritizedReplayBuffer, SumTree, last_occurrence
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.classic import Acrobot, CartPole, MountainCar
from mmtrl_tpu_torch.envs.classic.acrobot import AcrobotState
from mmtrl_tpu_torch.envs.classic.cartpole import CartPoleState
from mmtrl_tpu_torch.envs.classic.mountain_car import MountainCarState
from mmtrl_tpu_torch.models.agents import DistributionalQNetwork, MLPActorCritic, QNetwork
from mmtrl_tpu_torch.utils.evaluate import evaluate_actions

ENVS = {"CartPole-v1": (JaxCartPole, CartPole), "Acrobot-v1": (JaxAcrobot, Acrobot),
        "MountainCar-v0": (JaxMountainCar, MountainCar)}
# One step from the same float32 state: XLA's and torch's float32 sin and
# cos differ by an ulp in about 5% of inputs, which the step carries into
# every state variable; Acrobot's four RK4 stages add up to 2.4e-7.  Within
# 1e-6 absolute (the states are O(1); velocities up to 9 pi).
STEP_ATOL = 1e-6
N = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def reset_values(state) -> np.ndarray:
    """(n, k) float32 state values that a classic env's reset draws."""
    if hasattr(state, "joint"):
        return np.asarray(state.joint)
    if hasattr(state, "position"):
        return np.asarray(state.position)[:, None]
    return np.stack([np.asarray(getattr(state, f)) for f in ("x", "x_dot", "theta",
                                                              "theta_dot")], axis=-1)


class Replay:
    """A reset sampler that hands out recorded draws in order."""

    def __init__(self, draws=()):
        self.draws = list(draws)

    def __call__(self, n, generator=None):
        out = self.draws.pop(0)
        assert out.shape[0] == n
        return _t(out)


def port_state(env, jstate):
    """The port's env state of a JAX batched state (the step count as
    long, the rest float32)."""
    cls = {CartPole: CartPoleState, Acrobot: AcrobotState,
           MountainCar: MountainCarState}[type(env)]
    return cls(**{f.name: _t(np.asarray(getattr(jstate, f.name))).to(
        torch.long if f.name == "t" else torch.float32) for f in dataclasses.fields(cls)})


def _close_of_max(out, ref, tol, what=""):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=what)


# ---- the envs -----------------------------------------------------------------
@pytest.mark.parametrize("env_id", list(ENVS))
def test_env_steps_match_jax(env_id):
    """60 steps of 16 envs under random actions, each step from JAX's state
    (so a step's error is its own): observation, final observation, reward,
    done and ``truncated`` as JAX's, the auto-reset from JAX's reset draws.
    Each env starts near the time limit in some rows so that truncation
    happens; CartPole terminates on its own."""
    jax_cls, cls = ENVS[env_id]
    jenv, replay = jax_cls(), Replay()
    env = make(env_id, device="cpu", sampler=replay)
    assert type(env) is cls and env.name == jenv.name and env.num_actions == jenv.num_actions
    assert env.observation_space.shape == jenv.observation_space.shape
    reset = jax.jit(jax.vmap(jenv._reset))
    step = jax.jit(jax.vmap(lambda k, s, a: jenv.step(k, s, a)))
    _, jstate = reset(jax.random.split(jax.random.PRNGKey(0), N))
    jstate = jstate.replace(t=jstate.t.at[:4].set(jenv.max_steps - 3))
    rng = np.random.RandomState(1)
    seen = {"done": 0, "truncated": 0, "terminated": 0}
    for k in range(60):
        keys = jax.random.split(jax.random.PRNGKey(100 + k), N)
        reset_keys = jax.vmap(lambda key: jax.random.split(key)[1])(keys)
        replay.draws.append(reset_values(reset(reset_keys)[1]))
        action = rng.randint(0, env.num_actions, N)
        jobs, jnext, jr, jd, jinfo = step(keys, jstate, jnp.asarray(action, jnp.int32))
        obs, state, r, d, info = env.step(port_state(env, jstate), _t(action))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(info["truncated"].numpy(), np.asarray(jinfo["truncated"]))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_allclose(info["final_obs"].numpy(), np.asarray(jinfo["final_obs"]),
                                   rtol=0, atol=STEP_ATOL)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=STEP_ATOL)
        for f in dataclasses.fields(state):
            np.testing.assert_allclose(getattr(state, f.name).numpy(),
                                       np.asarray(getattr(jnext, f.name)), rtol=0, atol=STEP_ATOL)
        seen["done"] += int(d.sum())
        seen["truncated"] += int(info["truncated"].sum())
        seen["terminated"] += int((d & ~info["truncated"]).sum())
        jstate = jnext
    assert seen["truncated"] >= 4
    if env_id == "CartPole-v1":
        assert seen["terminated"] > 0


def test_env_reset_draws_and_devices():
    """The default reset draws from the generator in the JAX range; entry
    points default to the card and raise without one."""
    env = CartPole(device="cpu")
    obs, state = env.reset(64, torch.Generator().manual_seed(0))
    assert obs.shape == (64, 4) and obs.dtype == torch.float32
    assert float(obs.abs().max()) <= 0.05 and state.t.eq(0).all()
    _, s = MountainCar(device="cpu").reset(64, torch.Generator().manual_seed(0))
    assert float(s.position.min()) >= -0.6 and float(s.position.max()) <= -0.4
    assert s.velocity.eq(0).all()
    _, s = Acrobot(device="cpu").reset(64, torch.Generator().manual_seed(0))
    assert s.joint.shape == (64, 4) and float(s.joint.abs().max()) <= 0.1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CartPole()


def test_acrobot_stays_close_over_a_few_free_steps():
    """Acrobot's RK4 in float32 is chaotic over an episode: from the same
    state and actions, 10 steps run freely on each side stay within 1e-5 (the
    per-step 1e-6 grows about 1.5x a step)."""
    jenv, env = JaxAcrobot(), Acrobot(device="cpu")
    _, jstate = jax.vmap(jenv._reset)(jax.random.split(jax.random.PRNGKey(5), N))
    state = port_state(env, jstate)
    step = jax.jit(jax.vmap(jenv._step_env))
    rng = np.random.RandomState(2)
    for _ in range(10):
        a = rng.randint(0, 3, N)
        _, jstate, *_ = step(jax.random.split(jax.random.PRNGKey(0), N), jstate,
                             jnp.asarray(a, jnp.int32))
        _, state, *_ = env._step_env(state, _t(a))
    np.testing.assert_allclose(state.joint.numpy(), np.asarray(jstate.joint), rtol=0, atol=1e-5)


# ---- the sum-tree and PER -----------------------------------------------------
def test_last_occurrence_keeps_the_last_duplicate():
    idx = torch.tensor([3, 1, 3, 2, 1, 3])
    vals = torch.tensor([10.0, 11.0, 12.0, 13.0, 14.0, 15.0])
    assert last_occurrence(idx, vals).tolist() == [15.0, 14.0, 15.0, 13.0, 14.0, 15.0]


def test_sum_tree_matches_jax_bit_for_bit():
    """Six writes of 12 leaves with repeated indices into a tree of 16 (the
    last duplicate wins, as in JAX on the CPU), each followed by a
    stratified descent from JAX's uniforms: nodes and leaf indices equal."""
    rng = np.random.RandomState(0)
    cap = 16
    jtree, tree = JaxSumTree.create(cap), SumTree.create(cap)
    update = jax.jit(JaxSumTree.update)
    sample = jax.jit(JaxSumTree.sample, static_argnums=2)
    for r in range(6):
        idx = rng.randint(0, cap, 12).astype(np.int32)
        idx[3] = idx[7] = idx[10]
        vals = rng.uniform(0, 3, 12).astype(np.float32)
        jtree = update(jtree, jnp.asarray(idx), jnp.asarray(vals))
        tree.update(_t(idx).long(), _t(vals))
        np.testing.assert_array_equal(tree.nodes.numpy(), np.asarray(jtree.nodes))
        last = max(j for j in range(12) if idx[j] == idx[10])
        assert tree.nodes[idx[10] + cap] == vals[last]  # the last duplicate
        key = jax.random.PRNGKey(r)
        u = jax.random.uniform(key, (8,))
        ref = np.asarray(sample(jtree, key, 8))
        np.testing.assert_array_equal(tree.sample(None, 8, _t(u)).numpy(), ref)
    drawn = tree.sample(torch.Generator().manual_seed(0), 64)
    assert drawn.shape == (64,) and int(drawn.min()) >= 0 and int(drawn.max()) < cap


def test_prioritized_buffer_matches_jax():
    """A PER buffer of capacity 12 (rounded up to 16; the uniform ring
    would hold 12) fed 3 envs a write for 8 writes (it wraps), sampled at
    batch 8 from JAX's uniforms and given new priorities for the sampled
    leaves, repeats included: leaf indices, the tree and ``max_priority``
    bit for bit (``p ** alpha`` through float64 is XLA's float32 power on
    these inputs; the module docstring of ``data/buffers.py`` says where
    the two can part), the batch equal and the importance-sampling weights
    within 2e-7 relative (float32 ``pow`` of another library)."""
    rng = np.random.RandomState(3)
    example = dict(obs=np.zeros(4, np.float32), action=np.int32(0))
    jbuf = JaxPER.create(jax.tree_util.tree_map(jnp.asarray, example), 12, alpha=0.6)
    buf = PrioritizedReplayBuffer.create({k: torch.as_tensor(v) for k, v in example.items()},
                                         12, alpha=0.6)
    assert buf.buffer.capacity == jbuf.buffer.capacity == 16
    add = jax.jit(lambda b, x: b.add_batch(x, 3))
    sample = jax.jit(lambda b, k, beta: b.sample(k, 8, beta))
    update = jax.jit(lambda b, i, p: b.update_priorities(i, p))
    for r in range(8):
        batch = dict(obs=rng.randn(3, 4).astype(np.float32),
                     action=rng.randint(0, 2, 3).astype(np.int32))
        jbuf = add(jbuf, jax.tree_util.tree_map(jnp.asarray, batch))
        buf.add_batch({k: _t(v) for k, v in batch.items()}, 3)
        assert (buf.buffer.pos, buf.buffer.size) == (int(jbuf.buffer.pos), int(jbuf.buffer.size))
        key = jax.random.PRNGKey(10 + r)
        beta = np.float32(0.4 + 0.075 * r)
        jb, jidx, jw = sample(jbuf, key, jnp.float32(beta))
        b, idx, w = buf.sample(None, 8, float(beta), _t(jax.random.uniform(key, (8,))))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        for k in example:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=2e-7, atol=0)
        prio = rng.exponential(1.0, 8).astype(np.float32)
        prio[1] = 0.0  # floored at 1e-6
        jidx = np.asarray(jidx).copy()
        jidx[5] = jidx[2]  # a repeated leaf: the later priority stands
        jbuf = update(jbuf, jnp.asarray(jidx), jnp.asarray(prio))
        buf.update_priorities(_t(jidx).long(), _t(prio))
        np.testing.assert_array_equal(buf.tree.nodes.numpy(), np.asarray(jbuf.tree.nodes))
        assert float(buf.max_priority) == float(jbuf.max_priority)
    for k in example:
        np.testing.assert_array_equal(buf.buffer.data[k].numpy(), np.asarray(jbuf.buffer.data[k]))


def test_per_beta_matches_jax():
    """The annealed beta of JAX's compiled step (its expression in
    ``make_dqn``), bit for bit at every 7th step of two runs and past
    their ends."""
    for total, start in ((500_000, 0.4), (64, 0.25)):
        cfg = DQNConfig(total_timesteps=total, per_beta_start=start)
        jbeta = jax.jit(jax.vmap(lambda gs: jnp.clip(
            cfg.per_beta_start + (1.0 - cfg.per_beta_start) * gs.astype(jnp.float32)
            / cfg.total_timesteps, cfg.per_beta_start, 1.0)))
        steps = np.arange(0, 2 * total, 7, dtype=np.int32)
        ref = np.asarray(jbeta(jnp.asarray(steps)))
        assert [per_beta(cfg, int(gs)) for gs in steps] == ref.tolist()


# ---- the weighted TD update ----------------------------------------------------
def _state_dict64(params):
    """``convert.agent_params_from_flax`` keeping float64 (it casts to
    float32)."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
            else:
                name, array = _leaf(key, np.asarray(value, np.float64))
                out[prefix + name] = torch.tensor(array)

    walk(params["params"], "")
    return out


# float64 on both sides (JAX under enable_x64), as tests/test_torch_offpolicy.py
# holds the unweighted update: parameters and moments within 1e-9 of each
# tensor's largest, scalars within 1e-9 relative.
F64_TOL = 1e-9


def test_weighted_dqn_td_update_matches_jax():
    A, B = 2, 16
    with jax.enable_x64(True):
        jmodel = JaxQNetwork(A)
        model = QNetwork(A, obs_shape=(4,), device="cpu").double()
        init = jax.jit(jmodel.init)
        f64 = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)  # noqa: E731
        zeros = jnp.zeros((1, 4))
        jts = JaxDQNTrainState.create(apply_fn=jmodel.apply,
                                      params=f64(init(jax.random.PRNGKey(0), zeros)),
                                      target_params=f64(init(jax.random.PRNGKey(1), zeros)),
                                      tx=optax.adam(1e-3))
        ts = create_dqn_state(model, 1e-3)
        names = [n for n, _ in model.named_parameters()]
        payload = dqn_payload_from_flax(jax.device_get(jts), names)
        payload["model"] = _state_dict64(jts.params)
        payload["target"] = _state_dict64(jts.target_params)
        ts.load_payload(payload)
        update = jax.jit(lambda ts, b, w: jax_dqn_td_update(jmodel, 0.99, ts, b, w))
        for seed in (7, 8):
            rng = np.random.RandomState(seed)
            batch = dict(obs=rng.randn(B, 4), action=rng.randint(0, A, B).astype(np.int32),
                         reward=rng.choice([0.0, 1.0], B), next_obs=rng.randn(B, 4),
                         done=(rng.rand(B) < 0.3).astype(np.float64))
            weights = rng.uniform(0.1, 1.0, B)
            jts, jloss, jq, jtd = update(jts, jax.tree_util.tree_map(jnp.asarray, batch),
                                         jnp.asarray(weights))
            ts, loss, q, td = dqn_td_update(0.99, ts, {k: _t(v) for k, v in batch.items()},
                                            _t(weights))
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=F64_TOL)
            np.testing.assert_allclose(q.item(), float(jq), rtol=F64_TOL)
            _close_of_max(td, jtd, F64_TOL, "|td|")
            ref = _state_dict64(jax.device_get(jts.params))
            for name, p in ts.model.named_parameters():
                _close_of_max(p, ref[name], F64_TOL, name)
        # an unweighted update is not the weighted one
        _, l1, _, _ = dqn_td_update(0.99, ts, {k: _t(v) for k, v in batch.items()})
        assert abs(l1.item() - loss.item()) > 1e-3


# ---- one fused iteration, JAX's draws replayed -------------------------------
# 2 envs x 16 steps (32 transitions) through a ring of 16 (PER: 16 too);
# updates past 8 stored transitions every 2nd step at batch 8; a target
# sync every 5th step; epsilon decays over the first 32 steps.
FUSED = dict(total_timesteps=64, learning_rate=1e-3, num_envs=2, buffer_size=16, gamma=0.99,
             target_network_frequency=5, batch_size=8, start_e=1.0, end_e=0.05,
             exploration_fraction=0.5, learning_starts=8, train_frequency=2,
             steps_per_iteration=16)
# Float32 on both sides from equal weights: the Q networks' products sum in
# other orders, and Adam divides each gradient by its own running scale, so
# an element whose gradient lies within rounding of zero takes a different
# fraction of its step.  After the iteration's 4-6 Adam steps (lr 1e-3) the
# parameters agree within 1e-5 absolute, a hundredth of one step (1.9e-6
# seen); the losses within 1e-4 relative; observations within STEP_ATOL.
FUSED_PARAM_ATOL = 1e-5
FUSED_LOSS_RTOL = 1e-4


def jax_step_draws(jenv, jrunner, num_actions, cfg, per: bool):
    """Per step of JAX's ``train_iteration``: the port's ``StepDraws`` and
    the reset values its env step draws, from JAX's key chain
    (``split(key, 5)``: key, eps, action, env step, sample)."""
    reset = jax.jit(jax.vmap(lambda k: jenv._reset(jax.random.split(k)[1])[1]))
    key, size = jrunner.key, 0
    cap = (jrunner.buffer.buffer if per else jrunner.buffer).capacity
    draws, resets = [], []
    for _ in range(cfg["steps_per_iteration"]):
        key, k_eps, k_act, k_step, k_sample = jax.random.split(key, 5)
        n = cfg["num_envs"]
        resets.append(reset_values(reset(jax.random.split(k_step, n))))
        size = min(size + n, cap)
        if per:
            sample = jax.random.uniform(k_sample, (cfg["batch_size"],))
        else:
            sample = jax.random.randint(k_sample, (cfg["batch_size"],), 0, max(size, 1))
        draws.append(StepDraws(_t(jax.random.randint(k_act, (n,), 0, num_actions, jnp.int32)),
                               _t(jax.random.uniform(k_eps, (n,))), _t(sample)))
    return draws, resets


def _fused_pair(kind: str, per: bool = False, **changes):
    cfg = dict(FUSED, **changes)
    jenv, replay = JaxCartPole(), Replay()
    env = CartPole(device="cpu", sampler=replay)
    if kind == "dqn":
        jmodel, model = JaxQNetwork(2), QNetwork(2, obs_shape=(4,), device="cpu")
        jinit, jtrain = jax_make_dqn(jenv, jmodel, JaxDQNConfig(**cfg, prioritized_replay=per))
        algo = make_dqn(env, model, DQNConfig(**cfg, prioritized_replay=per))
    else:
        jmodel = JaxDistributionalQNetwork(2, n_atoms=11)
        model = DistributionalQNetwork(2, n_atoms=11, obs_shape=(4,), device="cpu")
        c51 = dict(cfg, n_atoms=11, v_min=-10.0, v_max=10.0)
        jinit, jtrain = jax_make_c51(jenv, jmodel, JaxC51Config(**c51))
        algo = make_c51(env, model, C51Config(**c51))
    jrunner = jax.jit(jinit)(jax.random.PRNGKey(4))
    k_env = jax.random.split(jax.random.PRNGKey(4), 3)[1]
    replay.draws.append(reset_values(jax.jit(jax.vmap(jenv._reset))(
        jax.random.split(k_env, cfg["num_envs"]))[1]))
    runner = algo.init_runner(torch.Generator())
    names = [n for n, _ in model.named_parameters()]
    runner.train_state.load_payload(dqn_payload_from_flax(jax.device_get(jrunner.train_state),
                                                          names))
    np.testing.assert_array_equal(runner.obs.numpy(), np.asarray(jrunner.obs))
    draws, resets = jax_step_draws(jenv, jrunner, 2, cfg, per)
    replay.draws.extend(resets)
    jrunner, jm = jax.jit(jtrain)(jrunner)
    runner, m = algo.train_iteration(runner, draws)
    return jax.device_get(jrunner), jax.device_get(jm), runner, m, cfg


def _compare_runners(jrunner, runner, per: bool):
    assert runner.global_step == int(jrunner.global_step)
    jbuf = jrunner.buffer.buffer if per else jrunner.buffer
    buf = runner.buffer.buffer if per else runner.buffer
    assert (buf.pos, buf.size) == (int(jbuf.pos), int(jbuf.size))
    for k in ("action", "done", "reward"):
        np.testing.assert_array_equal(buf.data[k].numpy(), np.asarray(jbuf.data[k]))
    for k in ("obs", "next_obs"):
        np.testing.assert_allclose(buf.data[k].numpy(), np.asarray(jbuf.data[k]), rtol=0,
                                   atol=STEP_ATOL)
    np.testing.assert_allclose(runner.obs.numpy(), np.asarray(jrunner.obs), rtol=0, atol=STEP_ATOL)
    ts, jts = runner.train_state, jrunner.train_state
    assert int(ts.step) == int(jts.step)
    for label, module, tree in (("params", ts.model, jts.params),
                                ("target", ts.target, jts.target_params)):
        ref = agent_params_from_flax(tree)
        for name, p in module.state_dict().items():
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0,
                                       atol=FUSED_PARAM_ATOL, err_msg=f"{label} {name}")
    stats, jstats = runner.stats, jrunner.stats
    for f in ("returned_episode_returns", "episode_lengths", "episode_count", "sum_returns"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), np.asarray(getattr(jstats, f)))


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_make_dqn_iteration_matches_jax(per):
    """One iteration of 16 steps: the same actions (random and greedy),
    stores (with ``final_obs`` and truncation handling), updates on steps
    6, 8, ..., 16 (6 of them), target syncs on steps 5, 10 and 15 and the
    same last-step metrics; under PER the tree within float32 rounding of
    JAX's (its leaves come from each side's |TD error|) and the same
    largest priority."""
    jrunner, jm, runner, m, _ = _fused_pair("dqn", per)
    _compare_runners(jrunner, runner, per)
    assert int(runner.train_state.step) == 6
    np.testing.assert_allclose(m["losses/td_loss"].item(), float(jm["losses/td_loss"]),
                               rtol=FUSED_LOSS_RTOL)
    np.testing.assert_allclose(m["losses/q_values"].item(), float(jm["losses/q_values"]),
                               rtol=FUSED_LOSS_RTOL)
    assert float(jm["losses/td_loss"]) != 0.0
    if per:
        np.testing.assert_allclose(runner.buffer.tree.nodes.numpy(),
                                   np.asarray(jrunner.buffer.tree.nodes), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(runner.buffer.max_priority),
                                   float(jrunner.buffer.max_priority), rtol=1e-5)


def test_make_c51_iteration_matches_jax_with_a_zero_loss_last_step():
    """One C51 iteration training every 3rd step (steps 6, 9, 12 and 15):
    the last step (16) does not train, so both report a loss and a mean Q
    of exactly 0 (reference behaviour, ROADMAP C.14), and the runner agrees
    as in the DQN case."""
    jrunner, jm, runner, m, _ = _fused_pair("c51", train_frequency=3)
    _compare_runners(jrunner, runner, False)
    assert int(runner.train_state.step) == 4
    assert float(jm["losses/loss"]) == m["losses/loss"].item() == 0.0
    assert float(jm["losses/q_values"]) == m["losses/q_values"].item() == 0.0


def test_dqn_last_step_loss_cadence_at_the_defaults():
    """At the defaults (1 env, 512 steps an iteration, training every 10th
    step) iteration k ends on step 512 k, which trains only when k is a
    multiple of 5: ``losses/td_loss`` is 0 in four iterations of five."""
    cfg = DQNConfig()
    trains = [(512 * k // cfg.num_envs) % cfg.train_frequency == 0 for k in range(1, 11)]
    assert trains == [k % 5 == 0 for k in range(1, 11)]


# ---- PPO on CartPole ------------------------------------------------------------
def test_mlp_actor_critic_matches_jax():
    rng = np.random.RandomState(0)
    obs = rng.randn(32, 6).astype(np.float32)
    jmodel = JaxMLPActorCritic(num_actions=3)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(obs)))
    model = MLPActorCritic(3, 6, device="cpu")
    model.load_state_dict(agent_params_from_flax(params), strict=True)
    jlogits, jvalue = jmodel.apply(params, jnp.asarray(obs))
    logits, value = model(_t(obs))
    assert logits.shape == (32, 3) and value.shape == (32,)
    # float32, the same products in other summation orders
    _close_of_max(logits, jlogits, 1e-6, "logits")
    _close_of_max(value, jvalue, 1e-6, "value")
    # the port's own init: orthogonal trunks, heads at gains 0.01 and 1
    fresh = MLPActorCritic(3, 6, device="cpu")
    w = fresh.actor_out.weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), 1e-4 * np.eye(3), atol=1e-9)


def test_make_ppo_update_on_cartpole_matches_jax():
    """One train_iteration of PPO on CartPole (4 envs x 16 steps, 2
    minibatches, 2 epochs, raw rewards): JAX's rollout rebuilt from its own
    key splits, then the port's update on it with JAX's two permutations.
    Float32 Adam steps on gradients summed in other orders: parameters
    within 1e-5 relative plus 1e-7, the metrics within 1e-4 relative plus
    1e-7 (tests/test_torch_ppo_family_updates.py's tolerances)."""
    from mmtrl_tpu.models import distributions as jax_dist
    from mmtrl_tpu_torch.algos.ppo import RunnerState

    jcfg = JaxPPOConfig(total_timesteps=128, num_envs=4, num_steps=16, num_minibatches=2,
                        update_epochs=2, clip_rewards=False)
    jenv, jmodel = JaxCartPole(), JaxMLPActorCritic(num_actions=2)
    jinit, jtrain = jax_make_ppo(jenv, jmodel, jcfg)
    jrs0 = jax.jit(jinit)(jax.random.PRNGKey(0))
    jrs1, jm = jax.device_get(jax.jit(jtrain)(jrs0))

    def step(carry, _):
        params, key, obs, env_state, done = carry
        key, k_act, k_step = jax.random.split(key, 3)
        logits, value = jmodel.apply(params, obs)
        action = jax_dist.categorical_sample(k_act, logits)
        logprob = jax_dist.categorical_log_prob(logits, action)
        next_obs, env_state, reward, next_done, _ = jenv.v_step(
            jax.random.split(k_step, 4), env_state, action)
        return (params, key, next_obs, env_state, next_done), (obs, action, logprob, reward,
                                                               done, value)

    (_, key, obs, _, done), data = jax.jit(lambda c: jax.lax.scan(step, c, None, length=16))(
        (jrs0.train_state.params, jrs0.key, jrs0.obs, jrs0.env_state, jrs0.done))
    np.testing.assert_array_equal(np.asarray(obs), np.asarray(jrs1.obs))
    perms = []
    for _ in range(2):
        key, k_perm = jax.random.split(key)
        perms.append(_t(jax.random.permutation(k_perm, 64)))
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jrs1.key))

    fields = dataclasses.asdict(jcfg)
    fields.pop("rpo_alpha")
    model = MLPActorCritic(2, 4, device="cpu")
    model.load_state_dict(agent_params_from_flax(jax.device_get(jrs0.train_state.params)))
    names = [n for n, _ in model.named_parameters()]
    rs = RunnerState(model=model, opt_state=ppo_opt_state_from_flax(
        jax.device_get(jrs0.train_state.opt_state), names), env_state=None, obs=_t(obs),
        done=_t(done), carry=(), stats=None, generator=None)
    o, a, lp, r, d, v = (_t(x) for x in data)
    ppo = make_ppo(CartPole(device="cpu"), model, PPOConfig(**fields))
    rs, metrics = ppo.update_from_rollout(rs, (o, a.long(), lp, r, d, v), perms)
    assert int(rs.step) == int(jrs1.train_state.step) == 4
    ref = agent_params_from_flax(jrs1.train_state.params)
    for name, p in rs.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)


def test_evaluate_actions_matches_jax():
    """``evaluate_actions`` of a random-weight Q network's argmax on
    CartPole, 4 envs x 120 steps, JAX's reset draws replayed: the same
    episode count, mean return and mean length."""
    jenv, replay = JaxCartPole(), Replay()
    env = CartPole(device="cpu", sampler=replay)
    jmodel = JaxQNetwork(2)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 4))))
    model = QNetwork(2, obs_shape=(4,), device="cpu")
    model.load_state_dict(agent_params_from_flax(params))
    key = jax.random.PRNGKey(6)
    ref = jax.jit(lambda p, k: jax_evaluate_actions(
        jenv, lambda p, o, _: jnp.argmax(jmodel.apply(p, o), -1), p, k, num_envs=4,
        num_steps=120))(params, key)
    @jax.jit
    def reset_draws(key):
        """The initial reset's and each step's reset draws (JAX's key
        splits: reset; then per step key, act, step; per env step, reset)."""
        key, k_reset = jax.random.split(key)

        def step(key, _):
            key, _, k_step = jax.random.split(key, 3)
            keys = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(k_step, 4))
            return key, jax.vmap(jenv._reset)(keys)[1]

        _, states = jax.lax.scan(step, key, None, length=120)
        return jax.vmap(jenv._reset)(jax.random.split(k_reset, 4))[1], states

    first, states = jax.device_get(reset_draws(key))
    replay.draws.append(reset_values(first))
    replay.draws.extend(reset_values(jax.tree_util.tree_map(lambda x: x[k], states))
                        for k in range(120))
    out = evaluate_actions(env, lambda o: argmax_q(model, o), None, num_envs=4, num_steps=120)
    assert int(out["eval/episodes"]) == int(ref["eval/episodes"]) > 4
    np.testing.assert_allclose(float(out["eval/episodic_return"]),
                               float(ref["eval/episodic_return"]), rtol=1e-6)
    np.testing.assert_allclose(float(out["eval/episodic_length"]),
                               float(ref["eval/episodic_length"]), rtol=1e-6)
