"""The off-policy host loop (``algos/offpolicy/hostloop.py``) and the chunk
path of DDPG, TD3 and SAC against the JAX package on the CPU:

- ``chunk_fn`` on one recorded chunk of gymnasium Pendulum transitions that
  crosses ``learning_starts`` and both cadences, against JAX's jitted
  ``parts.chunk_fn``, from converted weights with JAX's key draws replayed;
- the chunk path equal bit for bit to the fused ``train_iteration`` on the
  transitions and draws of that iteration;
- ``run_offpolicy_hostloop`` against JAX's on gymnasium Pendulum-v1 (SAC,
  one env, the warmup, an episode end and 64 updates), JAX's exploration
  and update draws replayed: global steps, returns, the evaluation and the
  replay buffer;
- a resume from the loop's save against an unbroken run;
- ``ddpg``/``td3``/``sac_continuous_action --host-loop`` through ``main``.

Float32 on both sides: the updates agree as test_torch_continuous.py's
fused iteration does, the buffers through the actions the actors chose."""

import copy
import os
import types

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("gymnasium")

from mmtrl_tpu.algos.offpolicy import hostloop as jax_hostloop  # noqa: E402
from mmtrl_tpu.algos.offpolicy.ddpg import DDPGConfig as JaxDDPGConfig  # noqa: E402
from mmtrl_tpu.algos.offpolicy.ddpg import make_ddpg as jax_make_ddpg  # noqa: E402
from mmtrl_tpu.algos.offpolicy.sac import SACConfig as JaxSACConfig  # noqa: E402
from mmtrl_tpu.algos.offpolicy.sac import make_sac as jax_make_sac  # noqa: E402
from mmtrl_tpu.algos.offpolicy.td3 import TD3Config as JaxTD3Config  # noqa: E402
from mmtrl_tpu.algos.offpolicy.td3 import make_td3 as jax_make_td3  # noqa: E402
from mmtrl_tpu.core.checkpoint import load_run as jax_load_run  # noqa: E402
from mmtrl_tpu.envs.gym_bridge import GymPool as JaxGymPool  # noqa: E402
from mmtrl_tpu.models.agents import DeterministicActor as JaxDeterministicActor  # noqa: E402
from mmtrl_tpu.models.agents import QFunction as JaxQFunction  # noqa: E402
from mmtrl_tpu.models.agents import SquashedGaussianActor as JaxSquashedGaussianActor  # noqa: E402
from mmtrl_tpu_torch.algos.offpolicy import hostloop  # noqa: E402
from mmtrl_tpu_torch.algos.offpolicy.ddpg import (  # noqa: E402
    ContinuousDraws,
    DDPGConfig,
    make_ddpg,
)
from mmtrl_tpu_torch.algos.offpolicy.hostloop import (  # noqa: E402
    HostLoopDraws,
    SpecEnv,
    run_offpolicy_hostloop,
)
from mmtrl_tpu_torch.algos.offpolicy.sac import SACConfig, make_sac  # noqa: E402
from mmtrl_tpu_torch.algos.offpolicy.td3 import TD3Config, make_td3  # noqa: E402
from mmtrl_tpu_torch.core.checkpoint import save_run  # noqa: E402
from mmtrl_tpu_torch.core.config import cli  # noqa: E402
from mmtrl_tpu_torch.convert import actor_critic_payload_from_flax  # noqa: E402
from mmtrl_tpu_torch.envs.classic import Pendulum  # noqa: E402
from mmtrl_tpu_torch.envs.gym_bridge import GymPool  # noqa: E402
from mmtrl_tpu_torch.models.agents import (  # noqa: E402
    DeterministicActor,
    QFunction,
    SquashedGaussianActor,
)
from mmtrl_tpu_torch.scripts import (  # noqa: E402
    ddpg_continuous_action,
    sac_continuous_action,
    td3_continuous_action,
)

# The chunk: 24 steps of 1 env (JAX's init_runner takes one env) into a
# ring of 16 (it wraps), updates once more than 12 are stored (steps
# 13-24) at batch 8; the actor and DDPG's and TD3's Polyak sync every 2nd
# step, SAC's target sync every 3rd (test_torch_continuous.py's OFF).
OFF = dict(total_timesteps=48, num_envs=1, buffer_size=16, gamma=0.99, tau=0.05, batch_size=8,
           learning_starts=12, policy_frequency=2, steps_per_iteration=24)
CHUNK = 24
# kind: (JAX config, JAX factory, config, factory, keys an insert_update takes, config extras)
ALGOS = {
    "ddpg": (JaxDDPGConfig, jax_make_ddpg, DDPGConfig, make_ddpg, 1, dict(learning_rate=1e-3)),
    "td3": (JaxTD3Config, jax_make_td3, TD3Config, make_td3, 2, dict(learning_rate=1e-3)),
    "sac": (JaxSACConfig, jax_make_sac, SACConfig, make_sac, 3,
            dict(q_lr=1e-3, policy_lr=1e-3, target_network_frequency=3)),
}
# Float32 on both sides from equal weights (test_torch_continuous.py's
# OFF_PARAM_ATOL discussion): 12 critic and 6-12 actor steps at lr 1e-3.
CHUNK_PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # JAX's loop journals to runs_manifest.jsonl here
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    return tmp_path


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_models(kind):
    scale = dict(action_dim=1, action_scale=(2.0,), action_bias=(0.0,))
    actor = (JaxSquashedGaussianActor if kind == "sac" else JaxDeterministicActor)(**scale)
    return actor, JaxQFunction()


def _networks(kind):
    """(actor, critics) of the port, Pendulum's shapes: obs 3, action 1."""
    if kind == "sac":
        actor = SquashedGaussianActor(3, 1, device="cpu")
    else:
        actor = DeterministicActor(3, 1, (2.0,), (0.0,), device="cpu")
    return actor, [QFunction(3, 1, device="cpu") for _ in range(1 if kind == "ddpg" else 2)]


def _names(m):
    return [n for n, _ in m.named_parameters()]


def jax_update_draws(kind, key, gs0, steps, n, cfg):
    """Per step of JAX's ``chunk_fn`` from the runner's ``key`` at global step
    ``gs0`` (an empty buffer at 0): the port's ``ContinuousDraws`` of the
    update (``split(key, k + 1)``: the next key, then DDPG's sample key;
    TD3's smoothing key; SAC's next-action and policy keys, the latter
    folded with the pass number), and the key after the chunk."""
    nk = ALGOS[kind][4]
    B, cap = cfg["batch_size"], cfg["buffer_size"]
    draws = []
    for t in range(steps):
        keys = jax.random.split(key, nk + 1)
        key = keys[0]
        gs = gs0 + (t + 1) * n
        d = dict(explore_noise=None, random_action=None)
        if gs > cfg["learning_starts"]:
            d["sample_idx"] = _t(jax.random.randint(keys[1], (B,), 0, min(gs, cap))).long()
            if kind != "ddpg":
                d["target_noise"] = _t(jax.random.normal(keys[2], (B, 1)))
            if kind == "sac":
                d["actor_noise"] = [_t(jax.random.normal(jax.random.fold_in(keys[3], i), (B, 1)))
                                    for i in range(cfg["policy_frequency"])]
        draws.append(ContinuousDraws(**d))
    return draws, key


def recorded_chunk(steps=CHUNK, n=1, seed=5):
    """(chunk, n, ...) transitions of gymnasium Pendulum under uniform
    torques, stored as the host loop stores them (a truncation is not
    done; next_obs the true post-transition observation)."""
    pool = GymPool("Pendulum-v1", n, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    obs = pool._host_reset()
    out = {k: [] for k in ("obs", "action", "reward", "next_obs", "done")}
    for _ in range(steps):
        a = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
        nobs, final_obs, r, _, d, trunc = pool._host_step(a)
        for k, v in zip(out, (obs, a, r, np.where(d[:, None], final_obs, nobs),
                              (d.astype(bool) & ~trunc.astype(bool)).astype(np.float32))):
            out[k].append(v)
        obs = nobs
    pool.close()
    return {k: np.stack(v) for k, v in out.items()}


def _assert_state_close(ts, ref, atol, what=""):
    pairs = [("actor", ts.actor, ref["actor"])] + [
        (f"critic{i}", c, r) for i, (c, r) in enumerate(zip(ts.critics, ref["critics"]))]
    for label, net, want in pairs:
        assert int(net.step) == int(want["opt_state"]["count"]), label
        for part in ("model", "target"):
            module = getattr(net, part)
            if module is None:
                assert want[part] is None
                continue
            for name, p in module.state_dict().items():
                np.testing.assert_allclose(p.numpy(), want[part][name].numpy(), rtol=0,
                                           atol=atol, err_msg=f"{what} {label} {part} {name}")
    if ref["log_alpha"] is not None:
        np.testing.assert_allclose(ts.log_alpha.item(), ref["log_alpha"].item(), rtol=1e-5)


@pytest.mark.parametrize("kind", list(ALGOS))
def test_chunk_fn_matches_jax(kind):
    """One 24-step chunk from JAX's initial state: the buffer (wrapped),
    12 critic updates, the actor (SAC: 2 passes and alpha each) on its
    cadence, the Polyak syncs, the last step's metrics; the port's
    ``chunk_fn`` within 1e-6 of JAX's."""
    jcfg_cls, jmake, cfg_cls, make_algo, _, extra = ALGOS[kind]
    cfg = dict(OFF, **extra)
    jpool = JaxGymPool("Pendulum-v1", 1)
    jparts = jmake(jax_hostloop.SpecEnv(jpool, 1), *_jax_models(kind), jcfg_cls(**cfg))
    jrunner = jax.jit(jparts[0])(jax.random.PRNGKey(3))
    pool = GymPool("Pendulum-v1", 1, device="cpu")
    actor, critics = _networks(kind)
    algo = make_algo(SpecEnv(pool, 1, torch.device("cpu")), actor, *critics, cfg_cls(**cfg))
    runner = algo.init_runner(torch.Generator())
    runner.train_state.load_payload(actor_critic_payload_from_flax(
        jax.device_get(jrunner.train_state), _names(actor), _names(critics[0])))

    chunk = recorded_chunk()
    draws, _ = jax_update_draws(kind, jrunner.key, 0, CHUNK, 1, cfg)
    jrunner, jm = jax.device_get(jax.jit(jparts.chunk_fn)(jrunner, chunk))
    runner, m = algo.chunk_fn(runner, {k: torch.from_numpy(v) for k, v in chunk.items()}, draws)

    assert runner.global_step == int(jrunner.global_step) == CHUNK
    buf, jbuf = runner.buffer, jrunner.buffer
    assert (buf.pos, buf.size) == (int(jbuf.pos), int(jbuf.size)) == (8, 16)
    for k, v in buf.data.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbuf.data[k]), err_msg=k)
    ts = runner.train_state
    _assert_state_close(ts, actor_critic_payload_from_flax(
        jrunner.train_state, _names(actor), _names(critics[0])), CHUNK_PARAM_ATOL)
    assert int(ts.critics[0].step) == 12 and int(ts.actor.step) == (12 if kind == "sac" else 6)
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(jm["losses/actor_loss"]) != 0.0  # step 24 runs the actor
    pool.close()
    jpool.close()


@pytest.mark.parametrize("kind", list(ALGOS))
def test_chunk_path_equals_fused_path(kind):
    """The fused ``train_iteration`` (2 envs, 64 steps, updates from step
    21) and ``chunk_fn`` on its stored transitions, from copies of one
    initial state under the same update draws: every buffer entry,
    parameter, target, Adam moment and metric equal bit for bit."""
    _, _, cfg_cls, make_algo, _, extra = ALGOS[kind]
    cfg = cfg_cls(**dict(OFF, **extra, num_envs=2, buffer_size=128, steps_per_iteration=64,
                         learning_starts=40))
    n, steps, B = 2, 64, cfg.batch_size
    g = torch.Generator().manual_seed(11)
    draws = []
    for t in range(steps):
        train = (t + 1) * n > cfg.learning_starts
        draws.append(ContinuousDraws(
            torch.randn(n, 1, generator=g), torch.rand(n, 1, generator=g) * 4 - 2,
            torch.randint(0, (t + 1) * n, (B,), generator=g) if train else None,
            torch.randn(B, 1, generator=g) if train else None,
            [torch.randn(B, 1, generator=g) for _ in range(2)] if train else None))
    actor, critics = _networks(kind)
    runs = []
    for _ in range(2):
        a, cs = copy.deepcopy(actor), copy.deepcopy(critics)
        algo = make_algo(Pendulum(device="cpu"), a, *cs, cfg)
        runs.append((algo, algo.init_runner(torch.Generator().manual_seed(4))))
    (fused_algo, fused), (chunk_algo, chunked) = runs
    fused, fm = fused_algo.train_iteration(fused, draws)
    stored = {k: v[:steps * n].reshape((steps, n) + v.shape[1:]).clone()
              for k, v in fused.buffer.data.items()}
    chunked, cm = chunk_algo.chunk_fn(chunked, stored, draws)

    assert fused.global_step == chunked.global_step == steps * n
    mine, theirs = chunked.payload(), fused.payload()
    for field in ("train_state", "buffer", "global_step"):
        assert _equal(mine[field], theirs[field]), field
    assert {k: float(v) for k, v in fm.items()} == {k: float(v) for k, v in cm.items()}
    assert float(fm["losses/actor_loss"]) != 0.0


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


# The whole loop: SAC on gymnasium Pendulum-v1, one env, 8 chunks of 32:
# uniform warmup for 192 steps, the episode end at step 200, 64 updates at
# batch 16 from a ring of 256, an evaluation of 2 episodes.
LOOP = dict(total_timesteps=256, num_envs=1, buffer_size=256, batch_size=16,
            learning_starts=192, steps_per_iteration=32, q_lr=1e-3, policy_lr=1e-3,
            policy_frequency=2)
LOOP_ARGS = dict(env_id="Pendulum-v1", exp_name="hostloop", seed=2, chunk_size=32,
                 print_interval=1, save_interval=8, save_dir="ck", load_from="", track=False,
                 capture_video=False)
# The two loops' actors act on observations that drift apart by float32
# rounding through 64 updates: the buffers within 1e-4, returns within 1e-4
# of their size.
LOOP_ATOL = 1e-4


class _NoEvents:
    """Stands in for JAX's ``MetricsWriter``, whose TensorBoard import takes
    about 15 s here; the comparison reads no event file."""

    def __init__(self, *args, **kwargs):
        pass

    def scalar(self, *args):
        pass

    def scalars(self, *args):
        pass

    def sps(self, global_step):
        return 0.0

    def close(self):
        pass


def test_hostloop_matches_jax(in_tmp, monkeypatch):
    """``run_offpolicy_hostloop`` against JAX's from JAX's initial weights
    (a port checkpoint made of them, through ``--load-from``), JAX's
    exploration normals and update draws replayed: the same global step
    and chunks, the same episode's return, the greedy evaluation, and the
    replay buffer (JAX's from its save)."""
    monkeypatch.setattr(jax_hostloop, "MetricsWriter", _NoEvents)
    cfg = dict(LOOP)
    jargs = types.SimpleNamespace(**LOOP_ARGS)
    jres = jax_hostloop.run_offpolicy_hostloop(
        jax_make_sac, JaxGymPool("Pendulum-v1", 1, seed=jargs.seed), *_jax_models("sac"),
        JaxSACConfig(**cfg), jargs, run_name="jax", eval_episodes=2)
    jsaved = jax_load_run(str(in_tmp / "ck" / "jax"))

    jparts = jax_make_sac(jax_hostloop.SpecEnv(JaxGymPool("Pendulum-v1", 1), 1),
                          *_jax_models("sac"), JaxSACConfig(**cfg))
    jinit = jax.jit(jparts[0])(jax.random.PRNGKey(jargs.seed))
    actor, critics = _networks("sac")
    algo = make_sac(SpecEnv(GymPool("Pendulum-v1", 1, device="cpu"), 1, torch.device("cpu")),
                    actor, *critics, SACConfig(**cfg))
    start = algo.init_runner(torch.Generator())
    start.train_state.load_payload(actor_critic_payload_from_flax(
        jax.device_get(jinit.train_state), _names(actor), _names(critics[0])))
    save_run(start.payload(), "start", "ck")

    act_key = [jax.random.PRNGKey(jargs.seed + 1)]

    def explore_noise():
        act_key[0], sub = jax.random.split(act_key[0])
        return _t(jax.random.normal(sub, (1, 1)))

    chunk_state = [jinit.key, 0]

    def chunk():
        draws, chunk_state[0] = jax_update_draws("sac", chunk_state[0], chunk_state[1], 32, 1, cfg)
        chunk_state[1] += 32
        return draws

    args = types.SimpleNamespace(**dict(LOOP_ARGS, load_from=os.path.join("ck", "start")))
    res = run_offpolicy_hostloop(make_sac, GymPool("Pendulum-v1", 1, seed=args.seed, device="cpu"),
                                 actor, critics, SACConfig(**cfg), args, torch.device("cpu"),
                                 run_name="port", eval_episodes=2,
                                 draws=HostLoopDraws(explore_noise, chunk))

    assert res["global_step"] == jres["global_step"] == 256 and res["chunks"] == 8
    assert res["episodes"] == 1
    np.testing.assert_allclose(res["episodic_return"], jres["episodic_return"], rtol=LOOP_ATOL)
    np.testing.assert_allclose(res["eval_episodic_return"], jres["eval_episodic_return"],
                               rtol=LOOP_ATOL)
    buf = res["runner"].buffer
    assert (buf.pos, buf.size) == (int(jsaved["buffer"]["pos"]), int(jsaved["buffer"]["size"]))
    for k, v in buf.data.items():
        want = np.asarray(jsaved["buffer"]["data"][k])
        if k == "obs":  # the warmup's 192 steps: the same actions, bit for bit
            np.testing.assert_array_equal(v[:192].numpy(), want[:192])
        np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=LOOP_ATOL, err_msg=k)
    ts = res["runner"].train_state
    assert int(ts.critics[0].step) == int(jsaved["train_state"]["qf1"]["step"]) == 64


RESUME = dict(total_timesteps=192, num_envs=2, buffer_size=512, batch_size=16,
              learning_starts=128, steps_per_iteration=32)


def test_hostloop_resume_against_an_unbroken_run(in_tmp, monkeypatch):
    """SAC on 2 envs, chunks of 16 steps (32 transitions): a run of 192
    steps saved at its end, resumed through ``--load-from`` for 64 more,
    against an unbroken run of 256.  The resume restores the unbroken run's
    state at 192 bit for bit (networks, Adam, buffer, generator); after it,
    as in JAX, the host envs restart from their seeds, so the two go on
    with other transitions but the same cadence: the stored rows before
    192 equal, the counts of updates equal."""
    saves = []
    plain_save = hostloop.save_run

    def recording_save(payload, run_name, save_dir):
        # on the CPU the payload's tensors are the runner's own, which the
        # run goes on writing
        saves.append((run_name, payload["global_step"], copy.deepcopy(payload)))
        return plain_save(payload, run_name, save_dir)

    monkeypatch.setattr(hostloop, "save_run", recording_save)

    def run(total, run_name, save_interval, load_from=""):
        args = types.SimpleNamespace(**dict(LOOP_ARGS, chunk_size=16, save_interval=save_interval,
                                            load_from=load_from))
        torch.manual_seed(0)  # one initial state for the three runs
        actor, critics = _networks("sac")
        return run_offpolicy_hostloop(
            make_sac, GymPool("Pendulum-v1", 2, seed=args.seed, device="cpu"), actor, critics,
            SACConfig(**dict(RESUME, total_timesteps=total)), args, torch.device("cpu"),
            run_name=run_name, eval_episodes=1)

    first = run(192, "first", 6)
    unbroken = run(256, "unbroken", 6)
    resumed = run(256, "resumed", 0, load_from=os.path.join("ck", "first"))

    at_192 = {name: p for name, gs, p in saves if gs == 192}
    assert _equal(at_192["first"], at_192["unbroken"])
    assert resumed["global_step"] == unbroken["global_step"] == 256
    assert resumed["chunks"] == 2 and unbroken["chunks"] == 8
    rb, ub = resumed["runner"].buffer, unbroken["runner"].buffer
    assert rb.size == ub.size == 256
    for k in rb.data:
        assert torch.equal(rb.data[k][:192], ub.data[k][:192]), k
    assert not torch.equal(rb.data["obs"][192:256], ub.data["obs"][192:256])
    rts, uts = resumed["runner"].train_state, unbroken["runner"].train_state
    assert [int(c.step) for c in rts.critics] == [int(c.step) for c in uts.critics] == [64, 64]
    assert int(rts.actor.step) == int(uts.actor.step) == 64


@pytest.mark.parametrize("module,extra", [
    (ddpg_continuous_action, []),
    (td3_continuous_action, ["--policy-noise", "0.3"]),
    (sac_continuous_action, ["--autotune", "False"]),
])
def test_host_loop_entry_points(module, extra, in_tmp):
    """``--host-loop`` through ``main`` on the CPU: a ``GymPool`` even for
    the registry's Pendulum-v1, 4 chunks of 32 steps of 2 envs, updates
    from the third, a save and the 20-episode greedy evaluation."""
    out = module.main(cli(module.Args, [
        "--cuda", "False", "--host-loop", "--num-envs", "2", "--total-timesteps", "256",
        "--learning-starts", "128", "--batch-size", "16", "--buffer-size", "512",
        "--chunk-size", "32", "--steps-per-iteration", "64", "--save-interval", "2",
        "--save-dir", "ck"] + extra))
    assert out["global_step"] == 256 and out["chunks"] == 4
    ts = out["runner"].train_state
    assert all(int(c.step) == 64 for c in ts.critics)
    assert np.isfinite(out["eval_episodic_return"])
    assert os.path.exists(os.path.join("ck", out["run_name"]))


def test_spec_env_is_never_stepped():
    spec = SpecEnv(GymPool("Pendulum-v1", 1, device="cpu"), 3, torch.device("cpu"))
    obs, state = spec.reset(3)
    assert obs.shape == (3, 3) and not obs.any() and state.dtype == torch.int32
    with pytest.raises(NotImplementedError, match="never steps"):
        spec.step(state, torch.zeros(3, 1))
    env, _ = ddpg_continuous_action.env_and_device(cli(ddpg_continuous_action.Args, [
        "--cuda", "False", "--host-loop"]))
    assert isinstance(env, GymPool) and env.name == "Pendulum-v1"  # a registry id, on the host
    env.close()
