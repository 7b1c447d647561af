"""Parity of the port's ProcMaze (mmtrl_tpu_torch/envs/procmaze.py) and of
``scripts.ppg`` on it with the JAX package on the CPU: the level bank bit for
bit, scripted episodes under JAX's level draws, the train window, the greedy
train/held-out evaluation and the entry point's procmaze branch.  (One PPG
cycle on procmaze with the int8 aux store is held against JAX's in
test_torch_ppo_family_updates.py, beside the cycle tests whose machinery it
shares.)"""

from collections import deque
import copy
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.ppo.ppg import PPGAgent as JaxPPGAgent
from mmtrl_tpu.envs.procmaze import ProcMaze as JaxProcMaze
from mmtrl_tpu.utils.evaluate import evaluate_policy as jax_evaluate_policy
from mmtrl_tpu_torch.algos.ppo.ppg import PPGAgent
from mmtrl_tpu_torch.convert import agent_params_from_flax
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.procmaze import GRID, ProcMaze, ProcMazeState, level_bank
from mmtrl_tpu_torch.scripts import ppg
from mmtrl_tpu_torch.utils.evaluate import evaluate_policy

# PPGAgent's outputs, within this share of the largest (as in
# test_torch_ppo_family.py): float32 convolutions summed in other orders.
LOGIT_TOL_OF_MAX = 1e-5
DELTAS = ((-1, 0), (1, 0), (0, -1), (0, 1))  # up, down, left, right
BANK = ("_walls", "_starts", "_goals", "_wall_px", "_cell_px")  # JAX's env's arrays


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_env():
    """JAX's env with the default bank (seed 1234, 1,000 levels), built once."""
    return JaxProcMaze()


@pytest.fixture(scope="module")
def jax_env_200():
    """JAX's env on the default bank's first 200 levels (the generator draws
    level by level, so they are the 1,000-level bank's first 200): a jitted
    function closes over the bank as constants, and XLA compiles 33 MB of
    them far more slowly than 6.6 MB."""
    return JaxProcMaze(num_levels=200, total_levels=200)


def _window(jenv, start_level, num_levels, max_steps=256, bank=None):
    """JAX's env over another level window of the same bank, without
    generating it again; ``bank`` (the five arrays) replaces its own."""
    env = copy.copy(jenv)
    env.start_level, env.num_levels, env.max_steps = start_level, num_levels, max_steps
    for name, array in zip(BANK, bank or ()):
        setattr(env, name, array)
    return env


class Replay:
    """A reset sampler that hands out recorded level draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, n, generator=None):
        level = self.draws.pop(0)
        assert level.shape == (n,)
        return level


def _draws_only(jenv):
    """``jenv`` with 1 x 1 pixel planes: its resets draw the same levels,
    and a jitted draw does not carry the bank's planes as constants."""
    return _window(jenv, jenv.start_level, jenv.num_levels, jenv.max_steps,
                   (jenv._walls, jenv._starts, jenv._goals,
                    jnp.zeros((jenv._wall_px.shape[0], 1, 1)), jnp.zeros((GRID * GRID, 1, 1))))


def _reset_levels(jenv):
    """keys -> the levels JAX's ``step`` resets to under them (one per env):
    each key splits into the transition's and the reset's."""
    jenv = _draws_only(jenv)
    draw = jax.jit(jax.vmap(lambda k: jenv._reset(jax.random.split(k)[1])[1].level))
    return lambda keys: torch.tensor(np.asarray(draw(keys))).long()


def _bfs_path(walls, start, goal):
    """JAX's test BFS (tests/test_procmaze.py): the actions of a shortest
    path from ``start`` to ``goal``."""
    parent = {start: None}
    q = deque([start])
    while q:
        cur = q.popleft()
        if cur == goal:
            break
        for a, (dr, dc) in enumerate(DELTAS):
            nxt = (cur[0] + dr, cur[1] + dc)
            if (0 <= nxt[0] < GRID and 0 <= nxt[1] < GRID and not walls[nxt]
                    and nxt not in parent):
                parent[nxt] = (cur, a)
                q.append(nxt)
    path, node = [], goal
    while parent[node] is not None:
        node, a = parent[node]
        path.append((node, a))
    return path[::-1]  # (cell, action taken from it)


@pytest.mark.parametrize("seed,total_levels", [(1234, 1000), (7, 60)])
def test_level_bank_matches_jax_bit_for_bit(seed, total_levels, jax_env):
    """Walls, starts, goals, the wall planes and the cell planes."""
    jenv = jax_env if (seed, total_levels) == (1234, 1000) else JaxProcMaze(
        num_levels=10, total_levels=total_levels, seed=seed)
    bank = level_bank(seed, total_levels)
    env = ProcMaze(num_levels=10, total_levels=total_levels, seed=seed, device="cpu")
    for name, ours, port in (("walls", bank.walls, env._walls),
                             ("starts", bank.starts, env._starts),
                             ("goals", bank.goals, env._goals),
                             ("wall_px", bank.wall_px, env._wall_px),
                             ("cell_px", bank.cell_px, env._cell_px)):
        ref = np.asarray(getattr(jenv, f"_{name}"))
        assert ours.shape == ref.shape and ours.dtype == ref.dtype, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
        np.testing.assert_array_equal(port.numpy(), ref, err_msg=name)
    assert bank.wall_px.nbytes == total_levels * 84 * 84 * 4


def test_scripted_episodes_match_jax(jax_env_200):
    """8 envs, max_steps 16, 40 steps under JAX's level draws.  Envs 0-3
    start 3, 5, 7 and 9 steps from their goal (the same state on both
    sides) and follow the BFS path, to the goal and then, after the
    auto-reset, into the time limit; envs 4-7 take random actions and bump
    into walls.  Obs, state, reward, done and info are equal exactly."""
    n, steps, max_steps = 8, 40, 16
    jenv = _window(jax_env_200, 0, 200, max_steps)
    key, k0 = jax.random.split(jax.random.PRNGKey(5))
    obs_j, state_j = jenv.v_reset(jax.random.split(k0, n))
    walls = np.asarray(jenv._walls)
    goals = np.asarray(jenv._goals)
    levels = np.asarray(state_j.level)
    pos = np.asarray(state_j.pos).copy()
    for i, k in enumerate((3, 5, 7, 9)):
        path = _bfs_path(walls[levels[i]], tuple(pos[i]), tuple(goals[levels[i]]))
        assert len(path) > k
        pos[i] = path[-k][0]
    state_j = state_j.replace(pos=jnp.asarray(pos))
    obs_j = jax.vmap(jenv._obs)(state_j)

    step_keys, draws, reset_levels = [], [], _reset_levels(jenv)
    for _ in range(steps):
        key, k = jax.random.split(key)
        step_keys.append(jax.random.split(k, n))
        draws.append(reset_levels(step_keys[-1]))
    env = ProcMaze(max_steps=max_steps, device="cpu", sampler=Replay(draws))
    state = ProcMazeState(**{name: torch.tensor(np.asarray(getattr(state_j, name))).long()
                             for name in ("level", "pos", "t")})
    obs = env._obs(state)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(obs_j))

    v_step = jax.jit(jenv.v_step)
    rng = np.random.RandomState(0)
    solved = timeouts = bumps = 0
    for t in range(steps):
        cur, lv, prev_pos = np.asarray(state_j.pos), np.asarray(state_j.level), state.pos
        action = rng.randint(0, 4, n)
        for i in range(4):
            action[i] = _bfs_path(walls[lv[i]], tuple(cur[i]), tuple(goals[lv[i]]))[0][1]
        obs_j, state_j, rew_j, done_j, info_j = v_step(step_keys[t], state_j,
                                                       jnp.asarray(action, jnp.int32))
        obs, state, rew, done, info = env.step(state, torch.from_numpy(action).long())
        np.testing.assert_array_equal(obs.numpy(), np.asarray(obs_j))
        for name in ("level", "pos", "t"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          np.asarray(getattr(state_j, name)), err_msg=name)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(rew_j))
        assert rew.dtype == torch.float32
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        assert set(info) == set(info_j) == {"level", "solved", "final_obs"}
        for name in info:
            np.testing.assert_array_equal(info[name].numpy(), np.asarray(info_j[name]),
                                          err_msg=name)
        bumps += int(((state.pos == prev_pos).all(dim=-1) & ~done)[4:].sum())
        solved += int(info["solved"].sum())
        timeouts += int((done & ~info["solved"]).sum())
    assert solved >= 4 and timeouts >= 4 and bumps >= 10, (solved, timeouts, bumps)
    assert not env.sampler.draws  # one reset draw a step, every draw used


def test_train_window_draws_only_inside_it():
    """``start_level + uniform[0, num_levels)``; ``num_levels=0`` means every
    level from ``start_level`` on, as in JAX."""
    g = torch.Generator().manual_seed(0)
    for start, num, window in ((10, 5, (10, 15)), (900, 0, (900, 1000)), (0, 200, (0, 200))):
        env = make("procmaze", num_levels=num, start_level=start, device="cpu")
        assert (env.start_level, env.num_levels) == (window[0], window[1] - window[0])
        levels = env.reset(2000, g)[1].level
        assert int(levels.min()) == window[0] and int(levels.max()) == window[1] - 1
        assert env.name == f"procmaze[{window[0]}:{window[1]}]"
    with pytest.raises(ValueError, match="inside the 1000 generated"):
        ProcMaze(num_levels=10, start_level=995, device="cpu")


EVAL_ENVS, EVAL_STEPS, EVAL_MAX_STEPS = 8, 32, 12


@pytest.fixture(scope="module")
def jax_greedy(jax_env):
    """JAX's agent, its weights, its greedy ``evaluate_policy`` on procmaze
    as ``scripts/ppg.py`` calls it, jitted once for every window (the
    window's first level is an argument), and the logits each step saw,
    recorded from inside the scan."""
    jmodel = JaxPPGAgent(num_actions=4)
    logits_seen = []

    def apply2(p, o):
        logits, value = jmodel.apply(p, o)[:2]
        jax.debug.callback(lambda x: logits_seen.append(np.asarray(x)), logits, ordered=True)
        return logits, value

    @jax.jit
    def run(params, key, start_level, bank):  # the bank an argument, not constants
        env = _window(jax_env, start_level, 200, EVAL_MAX_STEPS, bank)
        return jax_evaluate_policy(env, apply2, params, key, num_envs=EVAL_ENVS,
                                   num_steps=EVAL_STEPS)

    bank = tuple(getattr(jax_env, name) for name in BANK)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(7), jnp.zeros((1, 3, 84, 84)))
    return (jmodel, params, lambda params, key, start: run(params, key, start, bank),
            logits_seen)


def _jax_reset_draws(jenv, key, num_envs, num_steps):
    """The levels JAX's ``evaluate_policy`` resets to under ``key``: the
    first reset's, then one per env each step (its key chain replayed)."""
    key, k_reset = jax.random.split(key)
    draws = [torch.tensor(np.asarray(jax.vmap(_draws_only(jenv)._reset)(
        jax.random.split(k_reset, num_envs))[1].level)).long()]
    reset_levels = _reset_levels(jenv)
    for _ in range(num_steps):
        key, _, k_step = jax.random.split(key, 3)
        draws.append(reset_levels(jax.random.split(k_step, num_envs)))
    return draws


@pytest.mark.parametrize("start_level", [0, 800], ids=["train", "held_out"])
def test_greedy_evaluation_matches_jax(start_level, jax_env, jax_greedy):
    """Greedy ``evaluate_policy`` with converted weights on the train window
    [0, 200) and the held-out one [800, 1000) (8 envs x 32 steps, max_steps
    12): JAX's level draws replayed, the logits and the actions equal at
    every step, and JAX's ``eval/episodic_return`` and ``eval/episodes``.
    Equal actions need each step's top two logits further apart than the
    logits' tolerance; the test says where not."""
    jmodel, params, run, logits_j = jax_greedy
    key = jax.random.PRNGKey(start_level + 1000)
    logits_j.clear()
    ref = jax.device_get(run(params, key, start_level))
    assert len(logits_j) == EVAL_STEPS and int(ref["eval/episodes"]) >= 2 * EVAL_ENVS

    model = PPGAgent(4, (3, 84, 84), device="cpu")
    model.load_state_dict(agent_params_from_flax(jax.device_get(params)), strict=True)
    seen = []

    def recorded(obs):
        out = model(obs)
        seen.append(out[0])
        return out

    draws = _jax_reset_draws(_window(jax_env, start_level, 200, EVAL_MAX_STEPS), key,
                             EVAL_ENVS, EVAL_STEPS)
    assert all(start_level <= int(d.min()) and int(d.max()) < start_level + 200 for d in draws)
    env = ProcMaze(num_levels=200, start_level=start_level, max_steps=EVAL_MAX_STEPS,
                   device="cpu", sampler=Replay(draws))
    out = evaluate_policy(env, recorded, None, num_envs=EVAL_ENVS, num_steps=EVAL_STEPS)
    assert len(seen) == EVAL_STEPS and not env.sampler.draws
    tol = LOGIT_TOL_OF_MAX * float(np.abs(np.stack(logits_j)).max())
    for t, (logits, ref_logits) in enumerate(zip(seen, logits_j)):
        top2 = np.sort(ref_logits, axis=-1)[:, -2:]
        gap = float((top2[:, 1] - top2[:, 0]).min())
        assert gap > 2 * tol, (f"step {t}: JAX's top two logits are {gap} apart, within "
                               f"twice the tolerance {tol}: the greedy actions may differ")
        np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=0, atol=tol)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), ref_logits.argmax(-1))
    assert int(out["eval/episodes"]) == int(ref["eval/episodes"])
    np.testing.assert_allclose(float(out["eval/episodic_return"]),
                               float(ref["eval/episodic_return"]), rtol=1e-6)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    yield tmp_path


# scripts/ppg.py's procmaze smoke test (tests/test_scripts_smoke.py) cut to
# one cycle of its two 2 x 16-step rollouts, its greedy evaluation from 64 x
# 512 steps to 64 x 4
PPG_PROCMAZE_ARGV = ["--cuda", "False", "--env-id", "procmaze", "--total-timesteps", "64",
                     "--num-envs", "2", "--num-steps", "16", "--n-iteration", "2",
                     "--num-minibatches", "2", "--num-aux-minibatches", "2",
                     "--e-auxiliary", "1", "--print-interval", "10",
                     "--eval-rollout-steps", "4"]


def _scalars(run_dir):
    """{tag: [(step, value)]} over every event file of a run, and the files'
    count (TFRecord framing: u64 length, its CRC, the Event, its CRC)."""
    from tensorboard.compat.proto import event_pb2

    out, files = {}, sorted(run_dir.iterdir())
    for path in files:
        data, i = path.read_bytes(), 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i:i + 8])
            event = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 16 + n
            for v in event.summary.value:
                out.setdefault(v.tag, []).append((event.step, v.simple_value))
    return out, len(files)


def test_ppg_procmaze_entry_point(in_tmp, capsys):
    """``main`` trains on the window, stores its aux rows as int8 ('auto'),
    evaluates the train and the held-out window, prints both and logs both
    scalars at the final global step, in a file beside the run's own."""
    args = cli(ppg.Args, PPG_PROCMAZE_ARGV + ["--num-levels", "4"])
    assert ppg.ppg_config_from(args).aux_store_dtype == "int8"
    assert ppg.ppg_config_from(cli(ppg.Args, [])).aux_store_dtype == "bfloat16"
    assert ppg.ppg_config_from(cli(ppg.Args, ["--env-id", "procmaze", "--aux-store-dtype",
                                              "float32"])).aux_store_dtype == "float32"
    out = ppg.main(args)
    assert set(out["generalization"]) == {"train", "test"}
    printed = capsys.readouterr().out
    for tag in ("train", "test"):
        assert f"procmaze {tag} levels: return={out['generalization'][tag]:.2f} over" in printed
    scalars, files = _scalars(in_tmp / "runs" / out["run_name"])
    assert files == 2
    for tag, key in (("charts/heldout_return", "test"), ("charts/train_eval_return", "train")):
        assert scalars[tag] == [(out["global_step"], pytest.approx(out["generalization"][key]))]
    assert out["global_step"] == 64 and "hyperparameters/text_summary" in scalars


def test_ppg_procmaze_overlapping_the_held_out_window_exits_as_jax(in_tmp):
    """After training, as JAX's does (one cycle of 2 x 4 steps here)."""
    with pytest.raises(SystemExit) as e:
        ppg.main(cli(ppg.Args, PPG_PROCMAZE_ARGV + ["--start-level", "798", "--num-levels", "4",
                                                    "--num-steps", "4", "--total-timesteps",
                                                    "16"]))
    assert str(e.value) == ("train levels [798,802) overlap the held-out window [800,1000) "
                            "— shrink --num-levels/--start-level")
