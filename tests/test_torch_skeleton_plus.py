"""The port's Skeleton+ device simulator against the JAX package's on the
CPU: the assets bit for bit, ``_obs``, a scripted rollout of two envs
under JAX's own draws (state and reward exactly, the observation within
1e-5), and one recurrent PPO update on the simulator's rollout at TINY
widths.  JAX's draws are computed from the same key splits its env makes
and fed to the port through the simulator's three sampler hooks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from mmtrl_tpu.algos.ppo import make_recurrent_ppo as jax_make_recurrent_ppo
from mmtrl_tpu.envs import skeleton_assets as jax_assets
from mmtrl_tpu.envs.skeleton_plus import SkeletonPlusSim as JaxSim
from mmtrl_tpu.envs.skeleton_plus import SkeletonState as JaxState
from mmtrl_tpu.models import distributions as jax_dist
from mmtrl_tpu.models.agents import MultimodalRecurrentAgent as JaxAgent
from mmtrl_tpu_torch.algos.ppo import PPOConfig, make_recurrent_ppo
from mmtrl_tpu_torch.convert import agent_params_from_flax
from mmtrl_tpu_torch.envs import make, skeleton_assets
from mmtrl_tpu_torch.envs.skeleton_plus import (
    FIRE,
    FIRE_RANGE,
    FORWARD,
    NOOP,
    SIZE,
    TURN_LEFT,
    TURN_RIGHT,
    SkeletonPlusSim,
    SkeletonState,
)
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
from mmtrl_tpu_torch.models.distributions import categorical_log_prob, gumbel_argmax

# Observations in [-1, 1], float32 on both sides.  The frame is the same
# additions in the same order; the audio planes carry the MFCC's float32
# differences (other FFT plans, the log, the projections' summation order:
# about 1e-5 of cepstra up to 40, tests/test_torch_native.py) through the
# fixed normalisation, which divides by the statistics' range of about 60.
# Measured 4.5e-6.
OBS_ATOL = 1e-5
FIELDS = [f.name for f in dataclasses.fields(SkeletonState)]
JAX_ENV = JaxSim()
N_OPEN = int(JAX_ENV._open.shape[0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- JAX's draws ------------------------------------------------------------
def _noise(key):
    kl, kr = jax.random.split(key)
    w = jax_assets.WINDOW
    return jnp.stack([jax.random.normal(kl, (w,)), jax.random.normal(kr, (w,))])


def _reset_draws(key):
    """``SkeletonPlusSim._reset``'s draws from its key."""
    k1, k2, k3 = jax.random.split(key, 3)
    cells = jax.random.choice(k1, JAX_ENV._open, shape=(2,), replace=False)
    return cells, jax.random.randint(k2, (), 0, 4, dtype=jnp.int32), _noise(k3)


def _step_draws(key):
    """``Environment.step``'s draws from one env's key: the transition's,
    then the auto-reset's."""
    key_step, key_reset = jax.random.split(key)
    _, k_fire, k_respawn, k_obs = jax.random.split(key_step, 4)
    roll = jax.random.uniform(k_fire)
    respawn = jax.random.randint(k_respawn, (), 0, N_OPEN)
    return (roll, respawn, _noise(k_obs)) + _reset_draws(key_reset)


RESET_DRAWS = jax.jit(jax.vmap(_reset_draws))
STEP_DRAWS = jax.jit(jax.vmap(_step_draws))
V_STEP = jax.jit(JAX_ENV.v_step)


class Replay:
    """The port's three sampler hooks, fed from queues of JAX's draws in
    the order the port calls them."""

    def __init__(self):
        self.resets, self.steps, self.noises = [], [], []

    def attach(self, env: SkeletonPlusSim) -> SkeletonPlusSim:
        env.reset_sampler = lambda n, g: self.resets.pop(0)
        env.step_sampler = lambda n, g: self.steps.pop(0)
        env.noise_sampler = lambda n, g: self.noises.pop(0)
        return env

    def push_reset(self, keys):
        cells, facing, noise = RESET_DRAWS(keys)
        self.resets.append((_t(cells), _t(facing)))
        self.noises.append(_t(noise))

    def push_step(self, keys):
        roll, respawn, noise, cells, facing, reset_noise = STEP_DRAWS(keys)
        self.steps.append((_t(roll), _t(respawn)))
        self.noises += [_t(noise), _t(reset_noise)]
        self.resets.append((_t(cells), _t(facing)))


def _assert_state(state, jstate, what=""):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=f"{what} {name}")


# ---- assets -----------------------------------------------------------------
@pytest.mark.parametrize("name", ["maze", "open_cells", "cell_tables", "render_layers",
                                  "footstep_window", "mfcc_resize_ops", "silence_mfcc_stats"])
def test_assets_equal_jax(name):
    out, ref = getattr(skeleton_assets, name)(), getattr(jax_assets, name)()
    out, ref = (x if isinstance(x, tuple) else (x,) for x in (out, ref))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        if isinstance(r, np.ndarray):
            assert o.dtype == r.dtype and o.shape == r.shape
        np.testing.assert_array_equal(o, r)


# ---- observation ------------------------------------------------------------
def _states(rows):
    """(port state, JAX state) of rows (agent (r, c), facing, skeleton (r, c),
    skel_hits, kills, life, t)."""
    cols = list(zip(*rows))
    agent = [r * SIZE + c for r, c in cols[0]]
    skeleton = [r * SIZE + c for r, c in cols[2]]
    values = dict(agent=agent, facing=cols[1], skeleton=skeleton, skel_hits=cols[3],
                  kills=cols[4], life=cols[5], t=cols[6], phase=[0] * len(rows))
    port = SkeletonState(**{k: torch.tensor(v, dtype=torch.long) for k, v in values.items()})
    return port, JaxState(**{k: jnp.asarray(v, jnp.int32) for k, v in values.items()})


def test_obs_matches_jax():
    """Skeleton ahead in sight, behind, to either side, far off and on the
    agent's own cell (the gains' norm floor): frame and both MFCC planes."""
    state, jstate = _states([
        ((1, 1), 1, (1, 4), 0, 0, 3, 0),  # ahead, visible
        ((1, 5), 1, (1, 2), 0, 0, 3, 0),  # behind
        ((3, 1), 0, (5, 1), 0, 0, 3, 0),  # facing N, skeleton S
        ((1, 1), 2, (9, 9), 0, 0, 3, 0),  # far
        ((5, 5), 3, (5, 5), 0, 0, 3, 0),  # same cell
        ((9, 3), 1, (7, 3), 0, 0, 3, 0),  # facing E, skeleton N: left
    ])
    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    ref = np.asarray(jax.jit(jax.vmap(JAX_ENV._obs))(jstate, keys))
    noise = _t(jax.jit(jax.vmap(_noise))(keys))
    obs = SkeletonPlusSim(device="cpu")._obs(state, noise).numpy()
    assert obs.shape == ref.shape == (6, 3, 84, 84) and obs.dtype == np.float32
    # the frame: the same additions; compiled, XLA fuses the rescale's
    # multiply and subtract into one rounding, so one float32 step apart
    np.testing.assert_allclose(obs[:, 0], ref[:, 0], rtol=0, atol=2 ** -23)
    np.testing.assert_allclose(obs, ref, rtol=0, atol=OBS_ATOL)
    assert obs[0, 0].max() > obs[1, 0].max() - 1e-6  # the visible skeleton adds light
    assert float(np.abs(obs[:, 1:]).max()) <= 1.0


def _hunter(state: SkeletonState, env: SkeletonPlusSim) -> np.ndarray:
    """Fire at a skeleton in sight within range, else turn toward or step
    along the BFS path to it."""
    a, f, s = state.agent, state.facing, state.skeleton
    target = env._next[a, s]  # the next cell of the agent's path to the skeleton
    dvec = torch.stack([target // SIZE - a // SIZE, target % SIZE - a % SIZE], -1)
    want = (dvec[:, None] == env._deltas[None]).all(-1).float().argmax(-1)
    turn = torch.where((want - f) % 4 == 1, TURN_RIGHT, TURN_LEFT)
    act = torch.where(want == f, FORWARD, turn)
    act = torch.where(target == a, NOOP, act)
    shoot = env._vis[a, f, s] & (env._dist[a, s] <= FIRE_RANGE)
    return torch.where(shoot, FIRE, act).numpy()


def test_scripted_rollout_matches_jax():
    """Two envs, 60 steps of a hunting script with auto-reset, every draw
    JAX's: env 0 starts two hits from the win, env 1 twenty steps from the
    time limit, both with 30 lives.  State and reward equal exactly, the observation within
    OBS_ATOL; the rollout covers hits and misses, a kill with a respawn,
    contact, a win and the time limit."""
    state, jstate = _states([((1, 1), 1, (1, 3), 3, 4, 30, 0), ((9, 1), 0, (1, 9), 0, 1, 30, 380)])
    replay = Replay()
    env = replay.attach(SkeletonPlusSim(device="cpu"))
    key = jax.random.PRNGKey(2)
    seen = dict(hit=0, miss=0, respawn=0, contact=0, win=0, time_limit=0)
    worst = 0.0
    for t in range(60):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, 2)
        replay.push_step(keys)
        action = _hunter(state, env)
        before = state
        fired = action == FIRE  # only at a skeleton in sight and in range
        jobs, jstate, jreward, jdone, jinfo = V_STEP(keys, jstate, jnp.asarray(action, jnp.int32))
        obs, state, reward, done, info = env.step(before, torch.from_numpy(action))
        _assert_state(state, jstate, f"step {t}")
        np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        for k_ in ("kills", "life"):
            np.testing.assert_array_equal(info[k_].numpy(), np.asarray(jinfo[k_]))
        worst = max(worst, float(np.abs(obs.numpy() - np.asarray(jobs)).max()))
        kills, life, ended = info["kills"].numpy(), info["life"].numpy(), done.numpy()
        killed = kills > before.kills.numpy()
        hit = killed | (~ended & (state.skel_hits > before.skel_hits).numpy())
        seen["hit"] += int((fired & hit).sum())
        seen["miss"] += int((fired & ~hit & ~ended).sum())
        seen["respawn"] += int((killed & (kills < 5)).sum())
        seen["contact"] += int((life < before.life.numpy()).sum())
        seen["win"] += int((kills >= 5).sum())
        seen["time_limit"] += int((ended & (kills < 5) & (life > 0)).sum())
    assert worst <= OBS_ATOL, worst
    assert all(seen.values()), seen
    assert not (replay.resets or replay.steps or replay.noises)


def test_registry_spaces_and_default_draws():
    env = make("SkeletonPlus", device="cpu")
    assert isinstance(env, SkeletonPlusSim) and env.name == "skeleton_plus"
    assert env.observation_space.shape == (3, 84, 84) and env.num_actions == 5
    g = torch.Generator().manual_seed(0)
    obs, state = env.reset(64, g)
    assert obs.shape == (64, 3, 84, 84) and float(obs.abs().max()) <= 1.0
    assert bool((state.agent != state.skeleton).all())
    assert bool((~env._wall_map[state.agent]).all() and (~env._wall_map[state.skeleton]).all())
    assert set(state.facing.tolist()) == {0, 1, 2, 3}
    obs2, state2, reward, done, _ = env.step(state, torch.full((64,), FIRE), g)
    assert obs2.shape == obs.shape and reward.dtype == torch.float32
    # the draws come from the generator: the same seed gives the same step
    g2 = torch.Generator().manual_seed(0)
    _, s2 = env.reset(64, g2)
    o3, s3, r3, _, _ = env.step(s2, torch.full((64,), FIRE), g2)
    assert torch.equal(o3, obs2) and torch.equal(s3.skeleton, state2.skeleton)


# ---- one recurrent PPO update on the simulator ------------------------------
N_ENVS, N_STEPS = 2, 4
TINY_PPO = dict(num_envs=N_ENVS, num_steps=N_STEPS, num_minibatches=2, update_epochs=1,
                total_timesteps=2 * N_ENVS * N_STEPS, clip_rewards=False)
AGENT = dict(num_actions=5, conv_type="small", attn_type="casl", input_scale=1.0)
# The two rollouts' observations differ by up to OBS_ATOL (the MFCC's
# float32), and the gradients carry that on top of their summation order;
# Adam moves a parameter by about the learning rate (2.5e-4) a step
# whatever its gradient's size, so where a gradient is near zero its
# direction decides.  Parameters within 1e-6 (0.4% of a step; measured
# 1.6e-7), the metrics within 1e-4 of each.
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
METRIC_RTOL = 1e-4


def test_ppo_update_on_the_sim_matches_jax():
    """JAX's ``make_recurrent_ppo`` on its simulator: init, a 4-step
    rollout under its own key chain (``_rollout_step``) and
    ``update_from_rollout``.  The port rolls its simulator on JAX's draws,
    samples its actions from JAX's uniforms by the same Gumbel argmax, and
    updates with JAX's permutations."""
    cfg = JaxPPOConfig(**TINY_PPO)
    jmodel = JaxAgent(**AGENT)
    parts = jax_make_recurrent_ppo(JAX_ENV, jmodel, cfg)
    jrs = jax.jit(parts[0])(jax.random.PRNGKey(0))
    _, k_env, _ = jax.random.split(jax.random.PRNGKey(0), 3)

    replay = Replay()
    replay.push_reset(jax.random.split(k_env, N_ENVS))
    env = replay.attach(SkeletonPlusSim(device="cpu"))
    jfields = dataclasses.asdict(cfg)
    assert jfields.pop("rpo_alpha") == 0.0
    port_cfg = PPOConfig(**jfields)
    model = MultimodalRecurrentAgent(**AGENT, audio_channels=2, device="cpu")
    model.load_state_dict(agent_params_from_flax(jax.device_get(jrs.train_state.params)))
    ppo = make_recurrent_ppo(env, model, port_cfg)
    rs = ppo.init_runner(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(rs.obs.numpy(), np.asarray(jrs.obs), rtol=0, atol=OBS_ATOL)

    policy = jax.jit(lambda p, o, d, c: jmodel.apply(p, o[None], d[None], c))
    initial_carry, jinitial = rs.carry, jrs.carry
    rollout, jrollout = [], []
    for t in range(N_STEPS):
        key, k_act, k_step = jax.random.split(jrs.key, 3)
        logits, value, carry = policy(jrs.train_state.params, jrs.obs, jrs.done, jrs.carry)
        u = jax.random.uniform(k_act, logits[0].shape)
        action = jax_dist.categorical_sample(k_act, logits[0])
        keys = jax.random.split(k_step, N_ENVS)
        replay.push_step(keys)
        jobs, jstate, jreward, jdone, _ = V_STEP(keys, jrs.env_state, action)
        jrollout.append((jrs.obs, action, jax_dist.categorical_log_prob(logits[0], action),
                         jreward, jrs.done, value[0]))
        jrs = jrs.replace(env_state=jstate, obs=jobs, done=jdone, carry=carry, key=key)

        with torch.no_grad():
            plogits, pvalue, pcarry = rs.model(rs.obs[None], rs.done[None], rs.carry)
        paction = gumbel_argmax(plogits[0], _t(u))
        assert paction.tolist() == np.asarray(action).tolist()
        obs, state, reward, done, _ = env.step(rs.env_state, paction)
        _assert_state(state, jstate, f"step {t}")
        np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
        rollout.append((rs.obs, paction, categorical_log_prob(plogits[0], paction), reward,
                        rs.done, pvalue[0]))
        rs = dataclasses.replace(rs, env_state=state, obs=obs, done=done, carry=pcarry)

    jrollout = tuple(jnp.stack(x) for x in zip(*jrollout))
    jrs_out, jmetrics = jax.jit(parts.update_from_rollout)(jrs, jinitial, jrollout)
    perms = [_t(jax.random.permutation(jax.random.split(jrs.key)[1], N_ENVS))]
    rollout = tuple(torch.stack(x) for x in zip(*rollout))
    rs, metrics = ppo.update_from_rollout(rs, initial_carry, rollout, perms=perms)

    ref = agent_params_from_flax(jax.device_get(jrs_out.train_state.params))
    before = agent_params_from_flax(jax.device_get(jrs.train_state.params))
    moved = 0
    for name, p in rs.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        moved += int(not torch.equal(ref[name], before[name]))
    assert moved > 0
    assert int(rs.opt_state.count) == int(jrs_out.train_state.step) == 2
    jmetrics = jax.device_get(jmetrics)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=k)
