"""Parity of the port's two-agent Minecraft2d
(mmtrl_tpu_torch/envs/minecraft2d_ma.py) and of ``scripts.ppo_ma_minecraft``
with the JAX package on the CPU.  The JAX package has no test of this env,
so the scripted episode pins each of its behaviours: the slot layout and
the indicator signs, the tile writes' order, per-agent rewards and audio,
the shared done and the joint auto-reset."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from mmtrl_tpu.algos.ppo import make_ppo as jax_make_ppo
from mmtrl_tpu.algos.ppo.core import _maybe_clip as jax_maybe_clip
from mmtrl_tpu.envs.minecraft2d_ma import MAState as JaxMAState
from mmtrl_tpu.envs.minecraft2d_ma import MultiAgentMinecraft2d as JaxMA
from mmtrl_tpu.models import CNNAgent as JaxCNNAgent
from mmtrl_tpu_torch.algos.ppo import PPOConfig, RunnerState, make_ppo
from mmtrl_tpu_torch.convert import ppo_opt_state_from_flax
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.assets import T_AGENT, T_GOOD, audio_planes
from mmtrl_tpu_torch.envs.doorpuzzle import Doorpuzzle
from mmtrl_tpu_torch.envs.minecraft2d import MAX_ITER
from mmtrl_tpu_torch.envs.minecraft2d_ma import MAState, MultiAgentMinecraft2d
from mmtrl_tpu_torch.envs.pong_ma import NativePong2P
from mmtrl_tpu_torch.models.agents import CNNAgent
from mmtrl_tpu_torch.scripts import ppo_ma_minecraft
from test_torch_envs import OBS_ATOL
from torch_run_checks import check_run_outputs
from test_torch_ppo_family_updates import (
    _assert_same_end,
    _compare_metrics,
    _compare_params,
    _feedforward_rollout,
    _load,
    _split_perms,
    _t,
    _torch_rollout,
)

REPO = Path(__file__).resolve().parent.parent
UP, DOWN, RIGHT, LEFT = 0, 1, 2, 3
N_JOINT = 4
# CNNAgent's outputs, within this share of the largest (test_torch_ppo_family.py)
OUT_TOL_OF_MAX = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_env():
    return JaxMA()


class Replay:
    """A reset sampler that hands out recorded draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, n, generator=None):
        cells, gem_type = self.draws.pop(0)
        assert cells.shape == (n, 5)
        return cells, gem_type


def _jax_draws(jenv):
    """slot keys -> (cells (n, 5), gem_type (n,)): the resets JAX's
    ``v_step`` draws under them, one per joint env (``keys[::2]``, each split
    into the transition's and the reset's)."""
    @jax.jit
    def draw(keys):
        s = jax.vmap(lambda k: jenv._reset(jax.random.split(k)[1])[1])(keys[::2])
        locs = jnp.concatenate([s.agents, s.good[:, None], s.bad[:, None], s.gem[:, None]], 1)
        return locs[..., 0] * 5 + locs[..., 1], s.gem_type

    return lambda keys: tuple(torch.tensor(np.asarray(x)).long() for x in draw(keys))


def _scripted_start():
    """(JAX state, actions of the first steps) of 4 joint envs:
    0. agent 0 (next to the gem, which it alone hears) steps onto good,
       agent 1 onto bad, in the same step (gem gold: +10 and -10);
    1. both agents on one cell step together onto the gem (iron), which
       both hear (d^2 = 0);
    2. both step onto good at once (gem iron: -10 each);
    3. in a corner, UP into the wall, 3 steps before MAX_ITER."""
    rc = lambda *cells: jnp.asarray(cells, jnp.int32)  # noqa: E731
    state = JaxMAState(
        agents=rc([[2, 1], [3, 4]], [[1, 0], [1, 0]], [[2, 3], [3, 2]], [[0, 0], [0, 1]]),
        good=rc([2, 2], [4, 4], [3, 3], [4, 4]),
        bad=rc([2, 4], [4, 0], [0, 4], [4, 3]),
        gem=rc([1, 1], [1, 1], [4, 4], [2, 2]),
        gem_type=rc(0, 1, 1, 0),
        t=rc(0, 0, 0, MAX_ITER - 3),
    )
    first = np.array([RIGHT, UP, RIGHT, RIGHT, DOWN, RIGHT, UP, UP])
    return state, first


def test_scripted_steps_match_jax(jax_env):
    """40 steps of 4 joint envs (8 slots) from a scripted start under JAX's
    reset draws: state, rewards and dones equal, obs within OBS_ATOL, every
    step.  Pins the slot order (slot 2j agent 0, 2j + 1 agent 1), the
    indicator planes, per-agent rewards and audio, the tile order where
    entities share a cell, simultaneous targets, MAX_ITER and the joint
    auto-reset."""
    steps, n = 40, 2 * N_JOINT
    state_j, first = _scripted_start()
    key = jax.random.PRNGKey(4)
    draw, step_keys, draws = _jax_draws(jax_env), [], []
    for _ in range(steps):
        key, k = jax.random.split(key)
        step_keys.append(jax.random.split(k, n))
        draws.append(draw(step_keys[-1]))
    env = MultiAgentMinecraft2d(device="cpu", sampler=Replay(draws))
    state = MAState(**{f.name: _t(getattr(state_j, f.name)).long()
                       for f in dataclasses.fields(MAState)})
    obs_j = jax.vmap(jax_env._obs)(state_j).reshape(n, 3, 84, 84)
    obs = env._obs(state)
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=OBS_ATOL, rtol=0)
    planes = torch.from_numpy(audio_planes())
    assert torch.equal(obs[:, 2, 0, 0], torch.tensor([-1.0, 1.0] * N_JOINT))
    assert torch.equal(obs[0, 2], -torch.ones(84, 84)) and torch.equal(obs[1, 2],
                                                                      torch.ones(84, 84))
    # each slot's audio is its own agent's: in joint env 0 agent 0 hears the
    # gold gem (d^2 = 1), agent 1 noise; in env 1 both hear the iron one
    for slot, plane in ((0, 0), (1, 2), (2, 1), (3, 1), (6, 2), (7, 2)):
        assert torch.equal(obs[slot, 1], planes[plane]), slot

    v_step = jax.jit(jax_env.v_step)
    rng = np.random.RandomState(1)
    dones = 0
    for t in range(steps):
        action = first if t == 0 else rng.randint(0, 4, n)
        if t in (1, 2):  # joint env 3 keeps bumping into the top wall
            action[6:] = UP
        obs_j, state_j, rew_j, done_j, info_j = v_step(step_keys[t], state_j,
                                                       jnp.asarray(action, jnp.int32))
        obs, state, rew, done, info = env.step(state, torch.from_numpy(action).long())
        assert info == info_j == {}
        np.testing.assert_array_equal(rew.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        for f in dataclasses.fields(MAState):
            np.testing.assert_array_equal(getattr(state, f.name).numpy(),
                                          np.asarray(getattr(state_j, f.name)), err_msg=f.name)
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=OBS_ATOL, rtol=0)
        assert torch.equal(obs[:, 2, 0, 0], torch.tensor([-1.0, 1.0] * N_JOINT))
        assert torch.equal(done[0::2], done[1::2])  # shared by the two agents
        if t == 0:
            # rewards are each agent's: +10 good / -10 bad (gold), -1 on the
            # gem, -10 each on good (iron); envs 0 and 2 end, 1 and 3 run on
            assert rew.tolist() == [10.0, -10.0, -1.0, -1.0, -10.0, -10.0, -1.0, -1.0]
            assert done.tolist() == [True, True, False, False, True, True, False, False]
        if t == 0 or t == 1:
            assert int(state.t[3]) == MAX_ITER - 2 + t
        if t == 2:
            assert done[6:].tolist() == [True, True] and rew[6:].tolist() == [-1.0, -1.0]
        dones += int(done[0::2].sum())
    assert dones >= 2 * N_JOINT and not env.sampler.draws


def test_tile_writes_keep_jax_order(jax_env):
    """Where entities share a cell the later write wins: gem, bad, good,
    agent 0, agent 1.  An agent on the gem shows an agent; the gem under
    good shows good."""
    state_j = JaxMAState(
        agents=jnp.asarray([[[1, 1], [3, 3]], [[0, 0], [0, 0]]], jnp.int32),
        good=jnp.asarray([[0, 4], [2, 2]], jnp.int32),
        bad=jnp.asarray([[4, 0], [4, 4]], jnp.int32),
        gem=jnp.asarray([[1, 1], [2, 2]], jnp.int32),
        gem_type=jnp.asarray([0, 1], jnp.int32),
        t=jnp.zeros(2, jnp.int32),
    )
    env = MultiAgentMinecraft2d(device="cpu")
    state = MAState(**{f.name: _t(getattr(state_j, f.name)).long()
                       for f in dataclasses.fields(MAState)})
    tiles = env._tile_map(state)
    assert int(tiles[0, 6]) == T_AGENT and int(tiles[1, 12]) == T_GOOD
    np.testing.assert_allclose(
        env._obs(state).numpy(),
        np.asarray(jax.vmap(jax_env._obs)(state_j)).reshape(4, 3, 84, 84), atol=OBS_ATOL, rtol=0)


def test_reset_slot_layout_and_registry():
    env = make("minecraft_ma", device="cpu")
    assert isinstance(env, MultiAgentMinecraft2d) and env.name == "minecraft_ma"
    obs, state = env.reset(6, torch.Generator().manual_seed(0))
    assert obs.shape == (6, 3, 84, 84) and state.agents.shape == (3, 2, 2)
    cells = state.agents[:, :, 0] * 5 + state.agents[:, :, 1]
    locs = torch.cat([cells, *(s[:, None, 0] * 5 + s[:, None, 1]
                               for s in (state.good, state.bad, state.gem))], 1)
    assert all(len(set(row.tolist())) == 5 for row in locs)  # 5 distinct cells
    with pytest.raises(ValueError, match="whole joint envs"):
        env.reset(5)
    for env_id in ("doorpuzzle", "Doorpuzzle"):
        assert type(make(env_id, device="cpu")) is Doorpuzzle
    pong = make("pong_ma_native", num_envs=1, device="cpu")
    assert type(pong) is NativePong2P
    pong.close()
    with pytest.raises(KeyError):
        make("no_such_env")


def test_cnn_agent_matches_jax_on_ma_observations(jax_env):
    """``CNNAgent`` at 3 input channels (the indicator plane), big tower and
    input scale 255 as ``ppo_ma_minecraft`` builds it, on the env's slot
    observations, with converted weights."""
    obs, _ = jax_env.v_reset(jax.random.split(jax.random.PRNGKey(0), 8))
    jmodel = JaxCNNAgent(num_actions=4)
    params, (logits_j, value_j) = jax.jit(
        lambda k, o: (lambda p: (p, jmodel.apply(p, o)))(jmodel.init(k, o)))(
            jax.random.PRNGKey(1), obs)
    model = _load(CNNAgent(4, in_channels=3, device="cpu"), params)
    logits, value = model(_t(obs))
    for out, ref in ((logits, logits_j), (value, value_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=OUT_TOL_OF_MAX * float(np.abs(ref).max()))


def test_make_ppo_update_on_ma_rollout_matches_jax(jax_env):
    """One train_iteration of parameter-sharing PPO (2 joint envs = 4 slots
    x 4 steps, the small tower, input scale 1): JAX's rollout over the slot
    batch rebuilt under its keys, then the port's update on it with JAX's
    two permutations of the 16 rows, under test_make_ppo_update_matches_jax's
    tolerances."""
    slots, steps = 4, 4
    jcfg = JaxPPOConfig(num_envs=slots, num_steps=steps, num_minibatches=2, update_epochs=2,
                        total_timesteps=3 * slots * steps, clip_rewards=True)
    jmodel = JaxCNNAgent(num_actions=4, conv_type="small", input_scale=1.0)
    init_runner, train_iteration = jax_make_ppo(jax_env, jmodel, jcfg)
    jrs0 = jax.jit(init_runner)(jax.random.PRNGKey(0))
    jrs1, jmetrics = jax.jit(train_iteration)(jrs0)

    run = _feedforward_rollout(jax_env, jmodel.apply, jcfg, lambda r: jax_maybe_clip(jcfg, r))
    (key, obs, env_state, done, stats), data = run(
        jrs0.train_state.params, jrs0.key, jrs0.obs, jrs0.env_state, jrs0.done, jrs0.stats)
    _assert_same_end((obs, env_state, done, stats), jrs1)
    key, perms = _split_perms(key, jcfg.update_epochs, slots * steps)
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jrs1.key))
    assert np.asarray(data[0]).shape == (steps, slots, 3, 84, 84)

    fields = dataclasses.asdict(jcfg)
    fields.pop("rpo_alpha")
    cfg = PPOConfig(**fields)
    model = _load(CNNAgent(4, "small", input_scale=1.0, in_channels=3, device="cpu"),
                  jrs0.train_state.params)
    names = [n for n, _ in model.named_parameters()]
    rs = RunnerState(model=model,
                     opt_state=ppo_opt_state_from_flax(jax.device_get(jrs0.train_state.opt_state),
                                                       names),
                     env_state=None, obs=_t(obs), done=_t(done), carry=(), stats=None,
                     generator=None)
    ppo = make_ppo(MultiAgentMinecraft2d(device="cpu"), model, cfg)
    rs, metrics = ppo.update_from_rollout(rs, _torch_rollout(data), perms)
    assert int(jrs1.train_state.step) == 4
    _compare_params(rs.model, jrs1.train_state.params, rs.opt_state, jrs1.train_state.opt_state,
                    "ma policy")
    _compare_metrics(metrics, jmetrics)


def _jax_script(name):
    """A JAX script module, imported as its directory's siblings import it."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(REPO / "scripts"))


def test_cli_matches_the_jax_cli(monkeypatch):
    monkeypatch.setenv("MMTRL_NO_COMPILE_CACHE", "1")  # the JAX cli's own cache
    from mmtrl_tpu.core.config import cli as jax_cli

    argv = ["--num-envs", "8", "--num-steps", "64", "--seed", "3", "--clip-rewards", "no"]
    port = dataclasses.asdict(cli(ppo_ma_minecraft.Args, argv))
    ref = dataclasses.asdict(jax_cli(_jax_script("ppo_ma_minecraft").Args, argv))
    assert set(ref) - set(port) <= {"platform"}
    assert set(port) - set(ref) <= {"cuda", "torch_deterministic"}
    assert {k: port[k] for k in ref if k in port} == {k: v for k, v in ref.items() if k in port}
    assert cli(ppo_ma_minecraft.Args, []).num_envs == 4


def test_main_counts_slot_steps_and_tracks(tmp_path, monkeypatch):
    """``main`` on the CPU at 2 joint envs x 8 steps: each update is 2 x 2 x 8
    = 32 slot-steps, the agent sees 3 channels, and every parameter trains;
    with ``--track`` the run journals and mirrors its metrics."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    args = cli(ppo_ma_minecraft.Args, ["--cuda", "False", "--num-envs", "2", "--num-steps", "8",
                                       "--total-timesteps", "64", "--save-interval", "2"])
    algo, cfg, _ = ppo_ma_minecraft.build(args)
    start = [p.detach().clone() for p in algo.init_runner(torch.Generator()).model.parameters()]
    assert cfg.num_envs == 4 and cfg.batch_size == 32 and cfg.num_updates == 2
    out = ppo_ma_minecraft.main(args)
    assert [r["global_step"] for r in out["history"]] == [32, 64] == [32, out["global_step"]]
    assert out["runner"].obs.shape == (4, 3, 84, 84)
    assert out["runner"].model.network.Conv_0.weight.shape[1] == 3
    assert all(not torch.equal(a, b) for a, b in zip(start, out["runner"].model.parameters()))
    assert (tmp_path / "saved_agents" / out["run_name"]).exists()
    # --track, which raised until the journal and wandb_local were ported
    tracked = ppo_ma_minecraft.main(cli(ppo_ma_minecraft.Args, [
        "--cuda", "False", "--num-envs", "2", "--num-steps", "8", "--total-timesteps", "32",
        "--track"]))
    check_run_outputs(tmp_path, tracked["run_name"], track=True)
