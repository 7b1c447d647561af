"""The port's cartridge entry points on the CPU (``--cuda False``, tiny
budgets): ``rally_ppo`` and ``brick_ppo`` through the host loop with a save
and a ``--load-from`` resume, ``dt_rom`` collecting with that checkpoint
and training a plain and an MoE DT, the CLIs against the JAX scripts', and
the branches that wait for later ports."""

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

from mmtrl_tpu_torch.core import checkpoint
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.scripts import brick_ppo, dt_rom, rally_ppo, skeleton_plus_ppo

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
    (dt_rom, TINY_DT + ["--policy-from", "ck", "--policy-kind", "dqn"], NotImplementedError,
     "ROADMAP A.6"),
    (dt_rom, TINY_DT + ["--policy-from", "ck", "--policy-kind", "c51"], NotImplementedError,
     "ROADMAP A.6"),
    (skeleton_plus_ppo, ["--cuda", "False"], NotImplementedError, "ROADMAP A.7"),
    (skeleton_plus_ppo, ["--cuda", "False", "--backend", "native"], NotImplementedError,
     "ROADMAP A.7"),
    (skeleton_plus_ppo, ["--cuda", "False", "--backend", "native", "--host-loop"],
     FileNotFoundError, "SkelPlus.bin"),
    (dt_rom, ["--cuda", "False", "--max-timestep", "2048"], FileNotFoundError, "SkelPlus.bin"),
])
def test_unported_branches_and_the_missing_skeleton_rom_raise(module, argv, error, match):
    with pytest.raises(error, match=match):
        module.main(cli(module.Args, argv))


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
    ("dt_rom", ["--env-id", "brick_native", "--moe-experts", "4", "--moe-dispatch", "gather",
                "--policy-kind", "c51", "--rtg-clip", "5", "--policy-greedy"]),
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
