"""The port's classic-control entry points on the CPU (``--cuda False``,
tiny budgets): ``dqn`` (uniform and ``--prioritized-replay``) with a save
and a ``--load-from`` resume equal bit for bit to the run continued in
memory, ``c51``, ``ppo`` on CartPole, Acrobot and MountainCar with
``evaluate --script ppo`` on its checkpoint, the CLIs against the JAX
scripts' on the same argv, and the entry points' default device."""

import dataclasses
import importlib
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

from mmtrl_tpu_torch.core import checkpoint
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.scripts import c51, dqn, evaluate, ppo

REPO = Path(__file__).resolve().parent.parent
# 32 steps an iteration; updates past 32 stored transitions every 2nd
# step at batch 8; a target sync every 8th step; a ring of 48 (PER: 64)
TINY_Q = ["--cuda", "False", "--steps-per-iteration", "32", "--learning-starts", "32",
          "--batch-size", "8", "--buffer-size", "48", "--train-frequency", "2",
          "--target-network-frequency", "8"]
# 2 envs x 16 steps a rollout, one minibatch, one epoch
TINY_PPO = ["--cuda", "False", "--num-envs", "2", "--num-steps", "16", "--num-minibatches", "1",
            "--update-epochs", "1"]


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


def _same(a, b) -> bool:
    """Two checkpoint payloads equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_dqn_saves_and_resumes_bit_for_bit(per):
    """Two iterations saved, iteration 3 continued in memory, and iteration
    3 from the checkpoint through ``--load-from``: the two runners equal
    bit for bit (network, target, Adam state, ring, PER tree and largest
    priority, env state, statistics, generator)."""
    extra = ["--prioritized-replay"] if per else []
    first = dqn.main(cli(dqn.Args, TINY_Q + extra + [
        "--total-timesteps", "64", "--save-interval", "2", "--save-dir", "ck"]))
    assert [r["iteration"] for r in first["history"]] == [1, 2] and first["global_step"] == 64
    losses = [r["losses/td_loss"] for r in first["history"]]
    assert losses[0] == 0.0 and losses[1] > 0.0  # step 64 is the first past 32 to train
    assert first["eval_episodes"] > 0 and math.isfinite(first["eval_episodic_return"])
    ckpt = str(Path("ck") / first["run_name"])
    payload = checkpoint.load_run(ckpt)
    assert payload["global_step"] == 64
    if per:
        assert payload["buffer"]["buffer"]["data"]["obs"].shape == (64, 4)  # 48 -> 64
        assert payload["buffer"]["tree"]["nodes"].shape == (128,)
        assert float(payload["buffer"]["tree"]["nodes"][1]) > 0.0
    else:
        assert payload["buffer"]["data"]["obs"].shape == (48, 4)

    args = cli(dqn.Args, TINY_Q + extra + ["--total-timesteps", "96"])
    algo, _, _, _ = dqn.build(args)
    in_memory, _ = algo.train_iteration(first["runner"])
    resumed = dqn.main(cli(dqn.Args, TINY_Q + extra + ["--total-timesteps", "96",
                                                       "--load-from", ckpt]))
    assert resumed["initial_iteration"] == 3 and resumed["global_step"] == 96
    assert _same(in_memory.payload(), resumed["runner"].payload())


def test_c51_runs_and_saves():
    out = c51.main(cli(c51.Args, TINY_Q + ["--total-timesteps", "96", "--n-atoms", "21",
                                           "--save-interval", "3", "--save-dir", "ck"]))
    assert out["run_name"].startswith("CartPole-v1__c51__1__")
    assert [r["iteration"] for r in out["history"]] == [1, 2, 3]
    assert out["history"][-1]["losses/loss"] > 0.0
    assert all(math.isfinite(r["losses/q_values"]) for r in out["history"])
    assert out["eval_episodes"] > 0
    payload = checkpoint.load_run(str(Path("ck") / out["run_name"]))
    assert payload["train_state"]["model"]["q.weight"].shape == (2 * 21, 84)


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Acrobot-v1", "MountainCar-v0"])
def test_ppo_runs_and_evaluates(env_id):
    """Two updates saved, then ``evaluate --script ppo`` on the checkpoint."""
    out = ppo.main(cli(ppo.Args, TINY_PPO + ["--env-id", env_id, "--total-timesteps", "64",
                                             "--save-interval", "2", "--save-dir", "ck"]))
    assert [r["update"] for r in out["history"]] == [1, 2] and out["global_step"] == 64
    assert all(math.isfinite(r["losses/value_loss"]) for r in out["history"])
    ckpt = str(Path("ck") / out["run_name"])
    ev = evaluate.main(cli(evaluate.Args, ["--cuda", "False", "--script", "ppo", "--env-id",
                                           env_id, "--load-from", ckpt, "--num-envs", "4",
                                           "--num-steps", "40"]))
    assert set(ev) == {"eval/episodic_return", "eval/episodic_length", "eval/episodes"}
    if env_id == "CartPole-v1":  # an untrained pole falls within 40 steps
        assert ev["eval/episodes"] >= 4 and ev["eval/episodic_return"] > 0
    model, recurrent = evaluate.build_model(
        cli(evaluate.Args, ["--script", "ppo"]), make(env_id, device="cpu"), "cpu")
    assert not recurrent
    model.load_state_dict(checkpoint.load_run(ckpt)["model"])
    assert torch.equal(model.actor_out.weight, out["runner"].model.actor_out.weight)


def _jax_script(name):
    """A JAX script module, imported as its directory's siblings import it."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                      REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.mark.parametrize("name,argv", [
    ("dqn", []),
    ("dqn", ["--prioritized-replay", "--per-alpha", "0.5", "--steps-per-iteration", "64",
             "--env-id", "Acrobot-v1"]),
    ("c51", []),
    ("c51", ["--n-atoms", "51", "--v-min", "-10", "--v-max", "10", "--num-envs", "4"]),
    ("ppo", []),
    ("ppo", ["--env-id", "MountainCar-v0", "--num-envs", "8", "--clip-rewards", "True"]),
])
def test_cli_matches_the_jax_cli(name, argv, monkeypatch):
    """Flag for flag, the defaults included; the JAX ``--platform`` has no
    counterpart and ``--cuda`` chooses the device."""
    monkeypatch.setenv("MMTRL_NO_COMPILE_CACHE", "1")  # the JAX cli's own cache
    jax_script = _jax_script(name)
    from mmtrl_tpu.core.config import cli as jax_cli

    port = dataclasses.asdict(cli(importlib.import_module(
        f"mmtrl_tpu_torch.scripts.{name}").Args, argv))
    ref = dataclasses.asdict(jax_cli(jax_script.Args, argv))
    assert set(ref) - set(port) <= {"platform"}
    assert set(port) - set(ref) <= {"cuda", "torch_deterministic"}
    assert {k: port[k] for k in ref if k in port} == {k: v for k, v in ref.items() if k in port}


@pytest.mark.parametrize("module", [dqn, c51, ppo], ids=["dqn", "c51", "ppo"])
def test_entry_points_default_to_the_card(module):
    """``--cuda`` defaults to True: without a card the run raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(cli(module.Args, ["--total-timesteps", "1"]))
