"""The port's cartridge and Skeleton+ entry points on the CPU (``--cuda
False``, tiny budgets): ``rally_ppo`` and ``brick_ppo`` through the host
loop with a save and a ``--load-from`` resume, ``dt_rom`` collecting with
that checkpoint and training a plain and an MoE DT, ``dqn_rom`` with a save
and a resume, ``c51_rom``, ``dt_rom`` collecting with their Q checkpoints,
``skeleton_plus_ppo`` on the device simulator and ``evaluate`` on its
checkpoint, the CLIs against the JAX scripts', the branches that need a
missing ROM, and ``td3`` with ``--track`` on a gymnasium id."""

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

from torch_run_checks import check_run_outputs

from mmtrl_tpu_torch.core import checkpoint
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.scripts import (
    brick_ppo,
    c51_rom,
    dqn_rom,
    dt_rom,
    evaluate,
    rally_ppo,
    skeleton_plus_ppo,
    td3_continuous_action,
)

REPO = Path(__file__).resolve().parent.parent
# 2 envs x 8 steps a rollout, one minibatch, one epoch, small towers
TINY_PPO = ["--cuda", "False", "--conv-size", "small", "--num-envs", "2", "--num-steps", "8",
            "--num-minibatches", "1", "--update-epochs", "1", "--eval-steps", "0"]
# tests/test_dt_rom.py's sizes
TINY_DT = ["--cuda", "False", "--env-id", "rally_native", "--episode-steps", "60",
           "--collect-envs", "2", "--collect-steps", "240", "--context-len", "4",
           "--d-model", "32", "--n-layers", "1", "--n-heads", "2", "--batch-size", "4",
           "--total-steps", "6", "--steps-per-dispatch", "3", "--warmup-steps", "2",
           "--max-timestep", "64", "--eval-steps", "140", "--target-return", "3",
           "--print-interval", "3"]
# 2 pool envs, 30 pool steps: updates from pool step 8, every 2nd, target
# syncs every 5th; a ring of 32 that wraps
TINY_Q = ["--cuda", "False", "--num-envs", "2", "--episode-steps", "40", "--buffer-size", "32",
          "--learning-starts", "16", "--batch-size", "4", "--train-frequency", "2",
          "--target-network-frequency", "5", "--total-timesteps", "60", "--eval-steps", "0",
          "--print-interval", "1"]


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    monkeypatch.delenv("MMTRL_SKELETON_ROM", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rally_run(tmp_path_factory):
    """Two rally_ppo updates saved, then a third resumed from the save (in a
    directory of their own, shared by the tests that read them)."""
    tmp = tmp_path_factory.mktemp("rally")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setenv("MMTRL_RUN_ROOT", str(tmp / "runs"))
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            first = rally_ppo.main(cli(rally_ppo.Args, TINY_PPO + [
                "--total-timesteps", "32", "--save-interval", "2", "--save-dir", "ck"]))
            ckpt = str(tmp / "ck" / first["run_name"])
            resumed = rally_ppo.main(cli(rally_ppo.Args, TINY_PPO + [
                "--total-timesteps", "48", "--load-from", ckpt, "--eval-steps", "160"]))
        finally:
            torch.set_num_threads(n)
    return first, ckpt, resumed


def test_rally_ppo_saves_and_resumes(rally_run):
    first, ckpt, resumed = rally_run
    assert [r["update"] for r in first["history"]] == [1, 2] and first["global_step"] == 32
    for row in first["history"] + resumed["history"]:
        assert all(math.isfinite(row[k]) for k in ("losses/policy_loss", "losses/value_loss",
                                                  "losses/entropy", "wall_s", "emulator_s"))
        assert row["rollout_s"] + row["update_s"] == pytest.approx(row["wall_s"])
    payload = checkpoint.load_run(ckpt)
    assert int(payload["opt_state"]["count"]) == 2  # 2 updates x 1 epoch x 1 minibatch
    assert resumed["initial_update"] == 3 and [r["update"] for r in resumed["history"]] == [3]
    assert resumed["global_step"] == 48 and int(resumed["runner"].step) == 3
    saved = [p for p in payload["model"].values()]
    now = [p.detach() for p in resumed["runner"].model.state_dict().values()]
    assert any(not torch.equal(a, b) for a, b in zip(saved, now))
    # the greedy evaluation after training: 160 pool steps end RALLY episodes
    assert resumed["eval_episodes"] >= 1 and math.isfinite(resumed["eval_episodic_return"])


def test_brick_ppo_runs_one_update():
    out = brick_ppo.main(cli(brick_ppo.Args, TINY_PPO + ["--total-timesteps", "16"]))
    assert out["run_name"].startswith("brick_native__brick_ppo__")
    assert [r["update"] for r in out["history"]] == [1]
    assert math.isfinite(out["history"][0]["losses/value_loss"])


@pytest.mark.parametrize("extra", [[], ["--moe-experts", "4", "--moe-dispatch", "gather"]])
def test_dt_rom_collects_with_the_ppo_checkpoint_and_trains(rally_run, extra):
    _, ckpt, _ = rally_run
    out = dt_rom.main(cli(dt_rom.Args, TINY_DT + ["--policy-from", ckpt, "--save-interval", "6",
                                                  "--save-dir", "dt"] + extra))
    assert out["behavior/episodes"] >= 2  # 60-step cap, 120 pool steps x 2 envs
    assert out["eval/episodes"] >= 1 and math.isfinite(out["eval/episodic_return"])
    assert out["train_steps"] == 6 and math.isfinite(out["dt/loss"])
    assert ("dt/moe_aux" in out) == bool(extra)
    if extra:
        assert math.isfinite(out["dt/moe_aux"])
    saved = checkpoint.load_run(next(p for p in (Path("dt")).iterdir()))
    assert any(".moe.experts_w1" in k for k in saved["model"]) == bool(extra)


def test_dt_rom_random_behaviour_and_the_episode_cap_guard():
    out = dt_rom.main(cli(dt_rom.Args, TINY_DT + ["--total-steps", "3"]))
    assert out["behavior/episodes"] >= 2 and out["train_steps"] == 3
    with pytest.raises(SystemExit, match="exceeds --max-timestep"):
        dt_rom.main(cli(dt_rom.Args, TINY_DT + ["--episode-steps", "65"]))


@pytest.mark.parametrize("module,argv,error,match", [
    (dt_rom, TINY_DT + ["--policy-from", "no_such_run", "--policy-kind", "dqn"],
     FileNotFoundError, "no_such_run"),
    (skeleton_plus_ppo, ["--cuda", "False", "--host-loop"], SystemExit,
     "--host-loop requires --backend native"),
    (dqn_rom, ["--cuda", "False", "--env-id", "skeleton_plus_native"], FileNotFoundError,
     "SkelPlus.bin"),
    # was skeleton_plus_ppo --backend native, which now runs the fused loop
    # (its missing-ROM case is the last one), then td3 on a gymnasium id,
    # which now runs on the host bridge, then that branch with --track,
    # which now journals: the case runs (no error) and checks the journal
    (td3_continuous_action, ["--cuda", "False", "--env-id", "Humanoid-v4", "--track",
                             "--total-timesteps", "64", "--learning-starts", "32",
                             "--batch-size", "8", "--steps-per-iteration", "32"], None, None),
    (skeleton_plus_ppo, ["--cuda", "False", "--backend", "native", "--host-loop"],
     FileNotFoundError, "SkelPlus.bin"),
    (dt_rom, ["--cuda", "False", "--max-timestep", "2048"], FileNotFoundError, "SkelPlus.bin"),
    (skeleton_plus_ppo, ["--cuda", "False", "--backend", "native"], FileNotFoundError,
     "SkelPlus.bin"),
    (evaluate, ["--cuda", "False", "--load-from", "x", "--env-id", "skeleton_plus_native"],
     FileNotFoundError, "SkelPlus.bin"),
])
def test_guards_the_missing_skeleton_rom_and_td3_tracks_on_a_gymnasium_id(
        module, argv, error, match, in_tmp):
    """The cases with an error raise it; td3 on a gymnasium id with
    ``--track`` (the case without) runs, journals and mirrors its metrics."""
    if error is None:
        out = module.main(cli(module.Args, argv))
        check_run_outputs(in_tmp, out["run_name"], track=True)
        return
    with pytest.raises(error, match=match):
        module.main(cli(module.Args, argv))


@pytest.fixture(scope="module")
def dqn_run(tmp_path_factory):
    """dqn_rom saved, then resumed from the save with a greedy evaluation."""
    tmp = tmp_path_factory.mktemp("dqn")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setenv("MMTRL_RUN_ROOT", str(tmp / "runs"))
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            first = dqn_rom.main(cli(dqn_rom.Args, TINY_Q + ["--save-interval", "1",
                                                            "--save-dir", "ck"]))
            ckpt = str(tmp / "ck" / first["run_name"])
            resumed = dqn_rom.main(cli(dqn_rom.Args, TINY_Q + [
                "--total-timesteps", "20", "--load-from", ckpt, "--eval-steps", "10"]))
        finally:
            torch.set_num_threads(n)
    return first, ckpt, resumed


def test_dqn_rom_saves_resumes_and_evaluates(dqn_run):
    first, ckpt, resumed = dqn_run
    assert first["run_name"].startswith("rally_native__dqn_rom__")
    # 30 pool steps; updates on pool steps 10, 12, ..., 28 (past 16 stored
    # transitions), syncs on 0, 5, ..., 25
    assert (first["global_step"], first["pool_steps"]) == (60, 30)
    assert (first["updates"], first["target_syncs"]) == (10, 6)
    assert math.isfinite(first["td_loss"]) and first["emulator_s"] > 0
    payload = checkpoint.load_run(ckpt)
    assert set(payload) == {"model", "target", "opt_state"}
    assert int(payload["opt_state"]["count"]) == 10
    # the last sync (pool step 25) came before the last updates
    assert any(not torch.equal(payload["model"][k], payload["target"][k])
               for k in payload["model"])
    ts = resumed["runner"].train_state
    # the resume restores the train state and refills a cold ring: in 10
    # pool steps no even one has more than 16 transitions stored
    assert int(ts.step) == 10 and resumed["updates"] == 0
    assert all(torch.equal(p, payload["model"][k]) for k, p in ts.model.state_dict().items())
    assert resumed["eval_pool_steps"] == 140 and resumed["eval_episodes"] >= 2
    assert math.isfinite(resumed["eval_episodic_return"])


def test_c51_rom_runs_and_dt_rom_collects_with_both_q_checkpoints(dqn_run, tmp_path):
    out = c51_rom.main(cli(c51_rom.Args, TINY_Q + ["--save-interval", "1", "--save-dir", "ck"]))
    assert (out["updates"], out["target_syncs"]) == (10, 6) and math.isfinite(out["td_loss"])
    ts = out["runner"].train_state
    assert ts.adam_eps == 0.01 / 4 and ts.learning_rate == 2.5e-4
    c51_ckpt = str(tmp_path / "ck" / out["run_name"])
    for kind, ckpt in (("dqn", dqn_run[1]), ("c51", c51_ckpt)):
        dt = dt_rom.main(cli(dt_rom.Args, TINY_DT + ["--policy-from", ckpt, "--policy-kind", kind,
                                                     "--total-steps", "3"]))
        assert dt["behavior/episodes"] >= 2 and dt["train_steps"] == 3
        assert math.isfinite(dt["dt/loss"]) and dt["eval/episodes"] >= 1


def test_skeleton_plus_ppo_on_the_sim_and_evaluate():
    """The default backend on the device simulator (casl, two audio
    channels), saved, then evaluated greedily through ``scripts.evaluate``."""
    out = skeleton_plus_ppo.main(cli(skeleton_plus_ppo.Args, TINY_PPO + [
        "--total-timesteps", "32", "--save-interval", "2", "--save-dir", "ck"]))
    assert out["run_name"].startswith("skeleton_plus__skeleton_plus_ppo__")
    assert [r["update"] for r in out["history"]] == [1, 2]
    assert math.isfinite(out["history"][-1]["losses/value_loss"])
    model = out["runner"].model
    assert model.audio_net.Conv_0.weight.shape[1] == 2 and model.input_scale == 1.0
    res = evaluate.main(cli(evaluate.Args, [
        "--cuda", "False", "--load-from", str(Path("ck") / out["run_name"]),
        "--script", "skeleton_plus_ppo", "--env-id", "skeleton_plus", "--attn-type", "casl",
        "--conv-size", "small", "--input-scale", "1", "--num-envs", "2", "--num-steps", "40"]))
    assert res["eval/episodes"] >= 2 and math.isfinite(res["eval/episodic_return"])


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


@pytest.mark.parametrize("name,argv", [
    ("rally_ppo", ["--num-envs", "8", "--reward-mode", "win", "--repeat-action-probability",
                   "0.25", "--eval-steps", "0"]),
    ("brick_ppo", ["--frameskip", "4", "--host-loop", "--seed", "3"]),
    ("skeleton_plus_ppo", ["--backend", "native", "--host-loop", "--rom-path", "x.bin"]),
    ("skeleton_plus_ppo", ["--num-envs", "4", "--attn-type", "new", "--num-steps", "64",
                           "--rom-path", "x.bin"]),
    ("dqn_rom", ["--env-id", "brick_native", "--buffer-size", "5000", "--tau", "0.5",
                 "--load-from", "ck"]),
    ("c51_rom", ["--n-atoms", "21", "--v-min", "-5", "--learning-starts", "100"]),
    ("dt_rom", ["--env-id", "brick_native", "--moe-experts", "4", "--moe-dispatch", "gather",
                "--policy-kind", "c51", "--rtg-clip", "5", "--policy-greedy"]),
    ("ppo_ma_pong", ["--num-envs", "4", "--repeat-action-probability", "0.25",
                     "--eval-steps", "256", "--episode-steps", "300"]),
    ("ppo_ma_pong", []),
])
def test_cli_matches_the_jax_cli(name, argv, monkeypatch):
    monkeypatch.setenv("MMTRL_NO_COMPILE_CACHE", "1")  # the JAX cli's own cache
    jax_script = _jax_script(name)
    from mmtrl_tpu.core.config import cli as jax_cli

    port_args = cli(importlib.import_module(f"mmtrl_tpu_torch.scripts.{name}").Args, argv)
    jax_args = jax_cli(jax_script.Args, argv)
    port, ref = dataclasses.asdict(port_args), dataclasses.asdict(jax_args)
    assert set(ref) - set(port) <= {"platform"}
    assert set(port) - set(ref) <= {"cuda", "torch_deterministic"}
    assert {k: port[k] for k in ref if k in port} == {k: v for k, v in ref.items() if k in port}
