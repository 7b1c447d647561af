"""Parity of the port's Doorpuzzle (mmtrl_tpu_torch/envs/doorpuzzle.py and
its render assets) with the JAX package on the CPU, and the online PPO
entry points on ``--env-id doorpuzzle``.  JAX's slips and resets cannot come
from a torch generator, so the env's ``slip_sampler`` and ``sampler`` hooks
replay the draws JAX makes under the same keys."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.envs import assets as jassets
from mmtrl_tpu.envs.doorpuzzle import NOISE_TRANS as JAX_NOISE_TRANS
from mmtrl_tpu.envs.doorpuzzle import Doorpuzzle as JaxDoorpuzzle
from mmtrl_tpu.envs.doorpuzzle import DoorpuzzleState as JaxState
from mmtrl_tpu_torch.core import checkpoint
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import assets, make
from mmtrl_tpu_torch.envs.doorpuzzle import (
    KEY_CELLS,
    MAX_ITER,
    Doorpuzzle,
    DoorpuzzleState,
)
from mmtrl_tpu_torch.scripts import (
    evaluate,
    minecraft_cnn,
    minecraft_lstm,
    minecraft_lstm_attention,
    minecraft_lstm_google,
    ppg,
    ppo_rnd,
    train,
)
from test_torch_envs import OBS_ATOL

STEPS = 240
N_ENVS = 8
UP, DOWN, RIGHT, LEFT = 0, 1, 2, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_render_bank_and_base_frame_equal_jax():
    """The bank and the base frame JAX builds with OpenCV, bit for bit; the
    base is zero, so the port's frame leaves it out."""
    assert assets.DP_GRAY == jassets.DP_GRAY and assets.DP_N_TILES == jassets.DP_N_TILES
    bank = assets.doorpuzzle_render_bank()
    assert bank.dtype == np.float32 and bank.shape == (25, 7, 84, 84)
    assert np.array_equal(bank, jassets.doorpuzzle_render_bank())
    base = assets.doorpuzzle_base_frame()
    assert base.dtype == np.float32 and base.shape == (84, 84)
    assert np.array_equal(base, jassets.doorpuzzle_base_frame())
    assert not base.any()


def test_nearest_resize_matrix_by_hand():
    """104 -> 84: output pixel i takes source floor(i * 104 / 84), exact at
    the multiples of 21 (26, 52, 78), never a half-pixel centre (which would
    take round((i + 0.5) * 104 / 84 - 0.5): 25 at i = 21); 5 -> 3 takes
    0, 1, 3."""
    w = assets.nearest_resize_matrix(104, 84)
    assert w.shape == (84, 104) and w.dtype == np.float32
    assert np.array_equal(w.sum(axis=1), np.ones(84, np.float32))
    src = w.argmax(axis=1)
    hand = {0: 0, 1: 1, 4: 4, 5: 6, 20: 24, 21: 26, 22: 27, 41: 50, 42: 52, 63: 78,
            82: 101, 83: 102}
    assert {i: int(src[i]) for i in hand} == hand
    assert (np.diff(src) >= 1).all() and (np.diff(src) <= 2).all()
    assert np.array_equal(assets.nearest_resize_matrix(5, 3),
                          np.eye(5, dtype=np.float32)[[0, 1, 3]])


class Replay:
    """A hook that hands out recorded draws in order."""

    def __init__(self):
        self.draws = []

    def __call__(self, n, generator=None):
        out = self.draws.pop(0)
        assert (out[0] if isinstance(out, tuple) else out).shape == (n,)
        return out


def _jax_draws(jenv):
    """keys (n,) -> (slip (n,), (key_type (n,), key cell (n,))): what JAX's
    ``v_step`` draws under them, the transition from the first half of each
    key's split, the reset from the second."""
    p = jnp.array([JAX_NOISE_TRANS / 2, 1.0 - JAX_NOISE_TRANS, JAX_NOISE_TRANS / 2])

    @jax.jit
    def draw(keys):
        k_step, k_reset = jax.vmap(jax.random.split)(keys).transpose(1, 0, 2)
        slip = jax.vmap(lambda k: jax.random.choice(k, 3, p=p))(k_step)
        return slip, _reset_draw(jenv, k_reset)

    def torch_draw(keys):
        slip, (key_type, cell) = draw(keys)
        return _t(slip), (_t(key_type), _t(cell))

    return torch_draw


def _reset_draw(jenv, keys):
    s = jax.vmap(lambda k: jenv._reset(k)[1])(keys)
    return s.key_type, s.key_loc[:, 0] * 5 + s.key_loc[:, 1]


def _t(x):
    return torch.from_numpy(np.array(x)).long()


def _policy(state_j, rng):
    """Toward the key, then toward the door of its type (every fourth env
    the other door), one move in three random: the episodes reach both
    doors, with and without the key."""
    agent, key, key_type, has_key = (np.asarray(x) for x in (
        state_j.agent, state_j.key_loc, state_j.key_type, state_j.has_key))
    door1 = (key_type == 1) ^ (np.arange(len(agent)) % 4 == 3)
    goal = np.where(has_key[:, None], np.where(door1[:, None], [[0, 4]], [[4, 0]]), key)
    dr, dc = (goal - agent).T
    action = np.where(dr < 0, UP, np.where(dr > 0, DOWN, np.where(dc > 0, RIGHT, LEFT)))
    return np.where(rng.rand(len(action)) < 1 / 3, rng.randint(0, 4, len(action)), action)


@pytest.mark.parametrize("hard_mode,use_audio", [(False, True), (True, True), (False, False)])
def test_env_matches_jax_under_its_draws(hard_mode, use_audio):
    """240 steps of 8 envs under JAX's slips and resets: state, reward, done
    and info equal every step, the observation and the pre-reset
    observation within OBS_ATOL; episodes end at the right door with the
    key (reward 1), at a door without it, and at MAX_ITER."""
    jenv = JaxDoorpuzzle(hard_mode=hard_mode, use_audio=use_audio)
    draw = _jax_draws(jenv)
    slips, resets = Replay(), Replay()
    env = Doorpuzzle(hard_mode=hard_mode, use_audio=use_audio, device="cpu", sampler=resets,
                     slip_sampler=slips)
    key = jax.random.PRNGKey(11 + hard_mode)
    key, k = jax.random.split(key)
    keys = jax.random.split(k, N_ENVS)
    obs_j, state_j = jax.jit(jenv.v_reset)(keys)
    resets.draws.append(tuple(_t(x) for x in jax.jit(lambda k: _reset_draw(jenv, k))(keys)))
    obs, state = env.reset(N_ENVS)
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=OBS_ATOL, rtol=0)

    v_step = jax.jit(jenv.v_step)
    rng = np.random.RandomState(3)
    successes = wrong_door = timeouts = 0
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, N_ENVS)
        slip, reset = draw(keys)
        slips.draws.append(slip)
        resets.draws.append(reset)
        action = _policy(state_j, rng)
        t_before = np.asarray(state_j.t)
        obs_j, state_j, rew_j, done_j, info_j = v_step(keys, state_j,
                                                       jnp.asarray(action, jnp.int32))
        obs, state, rew, done, info = env.step(state, torch.from_numpy(action).long())
        for f in dataclasses.fields(DoorpuzzleState):
            np.testing.assert_array_equal(getattr(state, f.name).numpy(),
                                          np.asarray(getattr(state_j, f.name)), err_msg=f.name)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        assert set(info) == set(info_j) == {"has_key", "success", "final_obs"}
        for k_ in ("has_key", "success"):
            np.testing.assert_array_equal(info[k_].numpy(), np.asarray(info_j[k_]))
        for ours, ref in ((obs, obs_j), (info["final_obs"], info_j["final_obs"])):
            assert ours.shape == (N_ENVS, 1 + use_audio, 84, 84)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=OBS_ATOL, rtol=0)
        done = done.numpy()
        successes += int(rew.sum())
        timeouts += int((done & (t_before + 1 >= MAX_ITER)).sum())
        wrong_door += int((done & (rew.numpy() == 0) & (t_before + 1 < MAX_ITER)).sum())
    assert not slips.draws and not resets.draws
    assert successes >= 10 and wrong_door >= 3 and timeouts >= 1, (successes, wrong_door,
                                                                    timeouts)


def test_tile_order_and_audio():
    """Where two entities share a cell the later write wins: key, door 1,
    door 2, agent (an agent on a door shows the agent); the key is drawn
    as background once held, and heard only within d^2 <= 2 before."""
    state_j = JaxState(
        agent=jnp.asarray([[0, 4], [1, 1], [2, 3]], jnp.int32),
        key_loc=jnp.asarray([[2, 2], [2, 2], [2, 2]], jnp.int32),
        key_type=jnp.asarray([1, 2, 1], jnp.int32),
        has_key=jnp.asarray([False, False, True]),
        t=jnp.zeros(3, jnp.int32),
    )
    env = Doorpuzzle(device="cpu")
    state = DoorpuzzleState(**{f.name: _t(getattr(state_j, f.name))
                               for f in dataclasses.fields(DoorpuzzleState)})
    state.has_key = state.has_key.bool()
    tiles = env._tile_map(state)
    assert tiles[0, 4] == assets.DP_AGENT and tiles[1, 4] == assets.DP_T1
    assert tiles[1, 12] == assets.DP_KEY2 and tiles[2, 12] == assets.DP_BG
    obs = env._obs(state)
    planes = torch.from_numpy(assets.audio_planes())
    # d^2 = 8 (noise), 2 (key 2's plane), 1 but held (noise)
    for i, plane in enumerate((2, 1, 2)):
        assert torch.equal(obs[i, 1], planes[plane])
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax.vmap(JaxDoorpuzzle()._obs)(state_j)),
                               atol=OBS_ATOL, rtol=0)


def test_draws_from_a_torch_generator():
    """The default hooks: slips 0.1 / 0.8 / 0.1 within 0.02; hard-mode keys
    on every allowed cell and no other; key types 1 and 2."""
    g = torch.Generator().manual_seed(0)
    env = Doorpuzzle(hard_mode=True, device="cpu")
    freq = torch.bincount(env.draw_slip(100_000, g), minlength=3).double() / 100_000
    assert torch.allclose(freq, torch.tensor([0.1, 0.8, 0.1], dtype=torch.float64), atol=0.02)
    key_type, cell = env.draw_reset(4096, g)
    assert set(cell.tolist()) == set(KEY_CELLS) and len(KEY_CELLS) == 22
    assert set(key_type.tolist()) == {1, 2}
    _, cell = Doorpuzzle(device="cpu").draw_reset(16, g)
    assert (cell == 12).all()


def test_registry_and_spaces():
    for env_id in ("doorpuzzle", "Doorpuzzle"):
        env = make(env_id, device="cpu")
        assert type(env) is Doorpuzzle and env.name == "doorpuzzle"
    jenv = JaxDoorpuzzle()
    assert env.observation_space.shape == jenv.observation_space.shape == (2, 84, 84)
    assert env.num_actions == jenv.num_actions == 4
    assert make("doorpuzzle", use_audio=False, device="cpu").observation_space.shape == (1, 84,
                                                                                         84)


# ---- the online PPO entry points on --env-id doorpuzzle ---------------------
TINY = ["--cuda", "False", "--env-id", "doorpuzzle", "--num-envs", "2", "--num-steps", "4",
        "--num-minibatches", "1", "--update-epochs", "1"]
SMALL = ["--conv-size", "small"]
ENTRY_POINTS = {
    # name: (script, argv, observation channels)
    "train": (train, SMALL + ["--attn-type", "casl", "--total-timesteps", "16"], 2),
    "minecraft_lstm": (minecraft_lstm, SMALL + ["--total-timesteps", "16"], 2),
    "minecraft_lstm_old": (minecraft_lstm, SMALL + ["--agent", "old", "--total-timesteps", "16"],
                           1),
    "minecraft_lstm_attention": (minecraft_lstm_attention, SMALL + ["--total-timesteps", "16"],
                                 2),
    "minecraft_lstm_google": (minecraft_lstm_google, ["--total-timesteps", "16"], 2),
    "minecraft_cnn": (minecraft_cnn, SMALL + ["--total-timesteps", "16"], 2),
    "ppo_rnd": (ppo_rnd, ["--total-timesteps", "16"], 2),
    "ppg": (ppg, ["--n-iteration", "2", "--e-auxiliary", "1", "--num-aux-minibatches", "1",
                  "--total-timesteps", "16"], 2),
}


@pytest.mark.parametrize("name", [*ENTRY_POINTS, "evaluate"])
def test_entry_points_run_on_doorpuzzle(name, tmp_path, monkeypatch):
    """Each online PPO entry point through ``main`` on ``--env-id
    doorpuzzle`` at a tiny budget: the runs step Doorpuzzle, log finite
    losses and end at the asked env steps; PPG stores its aux observations
    in bfloat16 off procmaze; ``evaluate`` rolls a saved ``train`` run."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    script, argv, channels = ENTRY_POINTS["train" if name == "evaluate" else name]
    args = cli(script.Args, TINY + argv + ["--save-interval", "1"])
    if script is ppg:
        assert ppg.ppg_config_from(args).aux_store_dtype == "bfloat16"
    out = script.main(args)
    runner = out["runner"]
    assert out["global_step"] == 16
    assert isinstance(runner.env_state, DoorpuzzleState)
    assert runner.obs.shape == (2, channels, 84, 84)
    assert all(math.isfinite(v) for row in out["history"] for k, v in row.items()
               if k.startswith("losses/"))
    ckpt = str(tmp_path / "saved_agents" / out["run_name"])
    assert checkpoint.load_run(ckpt)["model"]
    if name == "evaluate":
        res = evaluate.main(cli(evaluate.Args, [
            "--cuda", "False", "--load-from", ckpt, "--env-id", "doorpuzzle", "--script",
            "train", "--attn-type", "casl", "--conv-size", "small", "--num-envs", "3",
            "--num-steps", "64"]))
        assert res["eval/episodes"] >= 3 and math.isfinite(res["eval/episodic_return"])
