"""Parity of the port's two-player PONG (mmtrl_tpu_torch/envs/pong_ma.py)
with the JAX package on the CPU, one recurrent PPO update of ppo_ma_pong's
agent on a slot rollout of it against JAX's, and ``scripts.ppo_ma_pong``
through the slot-aware host loop: a save, a ``--load-from`` resume equal to
the same update resumed from the runner in memory, and the greedy
evaluation."""

import dataclasses

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from mmtrl_tpu.algos.ppo import make_recurrent_ppo as jax_make_recurrent_ppo
from mmtrl_tpu.algos.ppo.hostloop import _SpecEnv as JaxSpecEnv
from mmtrl_tpu.data.quant import dequant_audio_u8 as jax_dequant
from mmtrl_tpu.envs.pong_ma import NativePong2P as JaxPong2P
from mmtrl_tpu.models import distributions as jax_dist
from mmtrl_tpu.models.agents import MultimodalRecurrentAgent as JaxAgent
from mmtrl_tpu_torch.algos.hostpool import HostPool, slot_count
from mmtrl_tpu_torch.algos.ppo import RunnerState, hostloop, make_recurrent_ppo
from mmtrl_tpu_torch.core import checkpoint
from mmtrl_tpu_torch.convert import agent_params_from_flax, ppo_opt_state_from_flax
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.data.quant import dequant_audio_u8, quant_audio_u8
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.pong_ma import NUM_AGENTS, NativePong2P
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
from mmtrl_tpu_torch.scripts import ppo_ma_pong
from test_torch_native import OBS_ATOL
from test_torch_ppo import _compare, _t
from torch_run_checks import check_run_outputs

N_JOINT = 3
STEPS = 200
NOOP, UP, DOWN = 0, 3, 4
# zero-page taps of native/homebrew/pong.asm
ZP_BALLY, ZP_PAD0Y, ZP_PAD1Y = 0x04, 0x07, 0x08
# 2 joint envs = 4 slots x 8 steps a rollout, one minibatch, one epoch
TINY = ["--cuda", "False", "--num-envs", "2", "--num-steps", "8", "--num-minibatches", "1",
        "--update-epochs", "1", "--episode-steps", "20"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tracker(ram: np.ndarray, pad_zp: int) -> np.ndarray:
    """Move the paddle's centre toward the ball's (tests/test_pong_ma.py)."""
    return np.where(ram[:, ZP_BALLY].astype(int) + 2 < ram[:, pad_zp].astype(int) + 8, UP,
                    DOWN).astype(np.int32)


def test_pong_matches_jax_under_tracker_play():
    """3 joint envs, sticky actions at 0.25, 200 steps: in env 0 player 1
    tracks the ball against an idle player 0, in env 1 player 0 tracks
    against a random player 1, in env 2 both track.  Every host array equal
    (frames, audio, zero-sum slot rewards, done flags, own and opponent
    scores, RAM), the slot observations from the u8 audio code within
    test_torch_native's tolerance, player 1's frame player 0's mirrored."""
    kw = dict(num_envs=N_JOINT, seed=7, frameskip=8, episode_steps=80,
              repeat_action_probability=0.25)
    jenv, env = JaxPong2P(**kw), NativePong2P(device="cpu", **kw)
    try:
        assert env.name == jenv.name == "pong_ma_native"
        assert (env.num_joint, env.num_slots) == (jenv.num_joint, jenv.num_slots) == (3, 6)
        assert env.num_actions == jenv.num_actions == 6
        jax_obs = jax.jit(jenv._obs)
        (jf, ja), (f, a) = jenv._host_reset(), env._host_reset()
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(a, ja)
        rng = np.random.RandomState(0)
        worst, dones, points = 0.0, 0, np.zeros(2 * N_JOINT, np.int64)
        for _ in range(STEPS):
            ram = env.ram()
            np.testing.assert_array_equal(ram, jenv.ram())
            p0, p1 = _tracker(ram, ZP_PAD0Y), _tracker(ram, ZP_PAD1Y)
            p0[0], p1[1] = NOOP, rng.randint(0, 6)
            actions = np.stack([p0, p1], axis=1).reshape(-1)

            code = quant_audio_u8(a)
            obs = env._obs(f, dequant_audio_u8(torch.from_numpy(code)))
            ref = np.asarray(jax_obs(jnp.asarray(jf), jax_dequant(jnp.asarray(code))))
            assert obs.shape == ref.shape == (2 * N_JOINT, 3, 84, 84)
            worst = max(worst, float(np.abs(obs.numpy() - ref).max()))
            assert torch.equal(obs[1::2, 0], obs[0::2, 0].flip(-1))
            assert torch.equal(obs[1::2, 1:], obs[0::2, 1:])

            jout, out = jenv._host_step(actions), env._host_step(actions)
            for x, y in zip(out, jout, strict=True):
                np.testing.assert_array_equal(x, y)
            f, a, kd, ld, done, win, own, opp = out
            jf, ja = jout[:2]
            assert kd.shape == done.shape == own.shape == (2 * N_JOINT,)
            assert (kd.reshape(-1, 2).sum(axis=1) == 0).all()  # zero-sum
            assert np.array_equal(own.reshape(-1, 2)[:, ::-1].reshape(-1), opp)
            assert np.array_equal(done[0::2], done[1::2])
            reward = env._reward(kd, ld, win)
            np.testing.assert_array_equal(reward, np.asarray(jenv._reward(kd, ld, win)))
            points += np.maximum(kd, 0)
            dones += int(done[0::2].sum())
        np.testing.assert_array_equal(env._sticky_prev, jenv._sticky_prev)
        assert worst <= OBS_ATOL, worst
        # the trackers score against the idle and the random player; the
        # 80-step cap ends episodes in every joint env
        assert points[1] >= 2 and points[2] >= 2 and dones >= N_JOINT, (points, dones)
    finally:
        env.close()
        jenv.close()


# The update's rollout: 2 joint envs = 4 slots x 4 steps, two minibatches of
# 2 slots, two epochs.  Under the trackers' play below the first point falls
# at step 68 (player 1 of env 0 against its idle player 0) and a cap of 70
# steps ends every episode at step 69, so the window of steps 67-70 holds a
# zero-sum slot reward and a done that resets the LSTM mid-rollout.
UPDATE_ARGS = ["--cuda", "False", "--num-envs", "2", "--num-steps", "4",
               "--num-minibatches", "2", "--update-epochs", "2", "--total-timesteps", "48",
               "--episode-steps", "70"]
UPDATE_WARMUP = 67


def _slot_rollout(env, steps):
    """The pool from reset: ``UPDATE_WARMUP`` steps of the trackers (player 0
    of env 0 idle), then ``steps`` of random actions of all six, recorded as
    the host loop records them: (slot observations, actions, slot rewards,
    preceding done flags), and the observation and done flags after them.
    The actions are drawn as test_torch_ppo's rollout draws them, so each
    logit has a gradient of its own.  With the trackers' three actions
    alone, the bias of the untaken action 5 gets only the softmax's small
    share, whose float32 rounding Adam scales toward a step: there the
    port's float32 update read 2.8e-7 and JAX's 7.1e-8 from the port's
    float64 one (3.5e-7 apart; every other parameter within 3e-8)."""
    pool = HostPool(env)
    rng = np.random.RandomState(1)
    record = []
    for t in range(UPDATE_WARMUP + steps):
        ram = env.ram()
        p0, p1 = _tracker(ram, ZP_PAD0Y), _tracker(ram, ZP_PAD1Y)
        p0[0] = NOOP
        actions = np.stack([p0, p1], axis=1).reshape(-1)
        if t >= UPDATE_WARMUP:
            actions = rng.randint(0, 6, actions.shape).astype(np.int32)
        obs, done = pool.obs(), pool.done_tensor()
        reward, _, _ = pool.step(actions)
        if t >= UPDATE_WARMUP:
            record.append((obs.numpy(), actions, reward.astype(np.float32), done.numpy()))
    obs, actions, rewards, dones = (np.stack(x) for x in zip(*record))
    return obs, actions, rewards, dones, pool.obs().numpy(), pool.done_tensor().numpy()


def test_recurrent_update_on_a_slot_rollout_matches_jax():
    """One ``update_from_rollout`` of ppo_ma_pong's agent (small towers,
    casl, input scale 1, two audio channels) and config (rows = slots,
    rewards unclipped) on a fixed 4-slot rollout of the pool, as each host
    loop builds it over its ``_SpecEnv``: the port's, from JAX's weights and
    Adam state converted and with JAX's permutations of the slots, against
    JAX's, under test_torch_ppo's recurrent-update tolerances."""
    args = cli(ppo_ma_pong.Args, UPDATE_ARGS)
    cfg = ppo_ma_pong.ppo_config_from(args, num_envs=args.num_envs * NUM_AGENTS)
    assert (cfg.num_envs, cfg.num_steps, cfg.clip_rewards) == (4, 4, False)
    jcfg = JaxPPOConfig(**dataclasses.asdict(cfg))
    kw = dict(num_envs=args.num_envs, seed=7, frameskip=args.frameskip,
              episode_steps=args.episode_steps)
    env, jenv = NativePong2P(device="cpu", **kw), JaxPong2P(**kw)
    try:
        obs, actions, rewards, dones, obs_after, done_after = _slot_rollout(env, cfg.num_steps)
        jmodel = JaxAgent(num_actions=jenv.num_actions, conv_type=args.conv_size,
                          attn_type=args.attn_type, fusion_type=args.fusion_type,
                          input_scale=1.0)
        jparts = jax_make_recurrent_ppo(JaxSpecEnv(jenv), jmodel, jcfg)
        model = MultimodalRecurrentAgent(
            num_actions=env.num_actions, conv_type=args.conv_size, attn_type=args.attn_type,
            fusion_type=args.fusion_type, input_scale=1.0,
            audio_channels=env.observation_space.shape[0] - 1, device="cpu")
        ppo = make_recurrent_ppo(hostloop._SpecEnv(env), model, cfg)
    finally:
        env.close()
        jenv.close()
    assert obs.shape == (4, 4, 3, 84, 84)
    assert (rewards != 0).any() and (rewards.reshape(4, 2, 2).sum(axis=-1) == 0).all()
    assert dones[1:].any() and not dones[0].any()

    jrs = jax.jit(jparts[0])(jax.random.PRNGKey(3))
    rng = np.random.RandomState(5)
    carry0 = tuple((rng.randn(4, 128) * 0.3).astype(np.float32) for _ in range(2))
    params = jrs.train_state.params
    logits, values, carry = jax.jit(jmodel.apply)(
        params, jnp.asarray(obs), jnp.asarray(dones), tuple(map(jnp.asarray, carry0)))
    logprobs = jax_dist.categorical_log_prob(logits, jnp.asarray(actions))
    rollout = (obs, actions.astype(np.int32), np.asarray(logprobs),
               np.asarray(jparts.maybe_clip(jnp.asarray(rewards))), dones, np.asarray(values))
    jrs = jrs.replace(obs=jnp.asarray(obs_after), done=jnp.asarray(done_after), carry=carry)
    jrs_out, jmetrics = jax.jit(jparts.update_from_rollout)(
        jrs, tuple(map(jnp.asarray, carry0)), tuple(map(jnp.asarray, rollout)))

    model.load_state_dict(agent_params_from_flax(jax.device_get(params)))
    names = [n for n, _ in model.named_parameters()]
    rs = RunnerState(model=model,
                     opt_state=ppo_opt_state_from_flax(jax.device_get(jrs.train_state.opt_state),
                                                       names),
                     env_state=None, obs=_t(obs_after), done=_t(done_after),
                     carry=tuple(_t(c) for c in carry), stats=None, generator=None)
    key, perms = jrs.key, []
    for _ in range(cfg.update_epochs):
        key, k_perm = jax.random.split(key)
        perms.append(_t(jax.random.permutation(k_perm, cfg.num_envs)))
    port_rollout = tuple(_t(x) for x in rollout)
    port_rollout = port_rollout[:1] + (port_rollout[1].long(),) + port_rollout[2:]
    rs, metrics = ppo.update_from_rollout(rs, tuple(map(_t, carry0)), port_rollout, perms=perms)
    assert int(jrs_out.train_state.step) == 4
    _compare(rs, metrics, jrs_out, jmetrics)


def test_registry_and_slots():
    env = make("pong_ma_native", num_envs=2, device="cpu")
    try:
        assert type(env) is NativePong2P and env.name == "pong_ma_native"
        assert (env.num_envs, env.num_slots, slot_count(env)) == (2, 4, 4)
        assert env.observation_space.shape == (3, 84, 84)
        frames, audio = env._host_reset()
        assert frames.shape[0] == audio.shape[0] == 2  # per joint env
        assert env._obs(frames, audio).shape == (4, 3, 84, 84)
    finally:
        env.close()
    rally = make("rally_native", num_envs=2, device="cpu")
    try:
        assert slot_count(rally) == 2  # a one-player pool: its envs
    finally:
        rally.close()


@pytest.fixture(scope="module")
def pong_runs(tmp_path_factory):
    """Two ppo_ma_pong updates saved; then the third resumed from the save
    and, with the same flags, from the runner left in memory (the loop's
    ``load_run`` handed its payload), each with a greedy evaluation."""
    tmp = tmp_path_factory.mktemp("pong")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setenv("MMTRL_RUN_ROOT", str(tmp / "runs"))
        first = ppo_ma_pong.main(cli(ppo_ma_pong.Args, TINY + [
            "--total-timesteps", "64", "--save-interval", "2", "--save-dir", "ck"]))
        ckpt = str(tmp / "ck" / first["run_name"])
        resume = TINY + ["--total-timesteps", "96", "--eval-steps", "48", "--load-from"]
        resumed = ppo_ma_pong.main(cli(ppo_ma_pong.Args, resume + [ckpt]))
        mp.setattr(hostloop, "load_run", lambda path, map_location: first["runner"].payload())
        in_memory = ppo_ma_pong.main(cli(ppo_ma_pong.Args, resume + ["memory"]))
    return first, ckpt, resumed, in_memory


def test_ppo_ma_pong_saves_resumes_and_evaluates(pong_runs):
    """The host loop sizes the rollout, the done flags and the evaluation by
    slots: 4 slots x 8 steps an update; the resume from disk equals the
    one from memory bit for bit (weights, Adam state, generator, losses);
    the evaluation ends episodes of every slot."""
    first, ckpt, resumed, in_memory = pong_runs
    assert [r["update"] for r in first["history"]] == [1, 2]
    assert [r["global_step"] for r in first["history"]] == [32, 64]
    for row in first["history"] + resumed["history"]:
        assert all(math.isfinite(row[k]) for k in ("losses/policy_loss", "losses/value_loss",
                                                  "losses/entropy", "wall_s", "emulator_s"))
    assert first["runner"].obs.shape == (4, 3, 84, 84) and first["runner"].done.shape == (4,)
    assert int(checkpoint.load_run(ckpt)["opt_state"]["count"]) == 2
    assert resumed["initial_update"] == in_memory["initial_update"] == 3
    assert resumed["global_step"] == 96 and int(resumed["runner"].step) == 3
    a, b = resumed["runner"], in_memory["runner"]
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters(), strict=True):
        assert torch.equal(p, q), name
    assert all(torch.equal(x, y) for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                                                 b.opt_state.mu + b.opt_state.nu, strict=True))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert resumed["history"][0]["losses/value_loss"] == in_memory["history"][0][
        "losses/value_loss"]
    # 48 greedy steps of a 20-step cap: two episodes of each of the 4 slots
    assert resumed["eval_episodes"] == 8 and math.isfinite(resumed["eval_episodic_return"])
    assert resumed["eval_episodic_return"] == in_memory["eval_episodic_return"]


def test_the_loop_checks_its_rows_and_tracks(tmp_path, monkeypatch):
    """A config sized by joint envs, not slots, is refused; with ``--track``
    the run journals and mirrors its metrics."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    args = cli(ppo_ma_pong.Args, TINY)
    env = NativePong2P(num_envs=2, device="cpu")
    try:
        cfg = ppo_ma_pong.ppo_config_from(args, num_envs=2)
        with pytest.raises(ValueError, match="4 rows"):
            hostloop.run_recurrent_ppo_hostloop(env, None, cfg, args, torch.device("cpu"))
        assert ppo_ma_pong.ppo_config_from(args, num_envs=2 * NUM_AGENTS).batch_size == 32
    finally:
        env.close()
    # --track, which raised until the journal and wandb_local were ported
    tracked = ppo_ma_pong.main(cli(ppo_ma_pong.Args, TINY + [
        "--total-timesteps", "32", "--eval-steps", "0", "--exp-name", "tracked", "--track"]))
    check_run_outputs(tmp_path, tracked["run_name"], track=True)
