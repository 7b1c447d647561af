"""The port's continuous-control entry points on the CPU (``--cuda False``,
tiny budgets): ``ppo_continuous_action`` and ``rpo_continuous_action`` on
Pendulum under the wrapper stack, with a save; ``ddpg``, ``td3`` and
``sac_continuous_action`` with their greedy evaluations; a SAC
``--load-from`` resume equal bit for bit to the run continued in memory;
the CLIs against the JAX scripts' on the same argv; ``--track`` and
``--capture-video`` on each branch (the gymnasium ids and
``--host-loop`` among them); and the entry points' default device."""

import dataclasses
import importlib
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch
from torch_run_checks import check_run_outputs

from mmtrl_tpu_torch.core import checkpoint
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.wrappers import NormalizeReward
from mmtrl_tpu_torch.scripts import (
    ddpg_continuous_action,
    ppo_continuous_action,
    rpo_continuous_action,
    sac_continuous_action,
    td3_continuous_action,
)

REPO = Path(__file__).resolve().parent.parent
# 2 envs x 32 steps a rollout, 2 minibatches, 2 epochs
TINY_PPO = ["--cuda", "False", "--num-envs", "2", "--num-steps", "32", "--num-minibatches", "2",
            "--update-epochs", "2"]
# 32 steps an iteration; uniform actions for the first 32, then updates
# at batch 8 through a ring of 48 (it wraps in iteration 2)
TINY_AC = ["--cuda", "False", "--steps-per-iteration", "32", "--learning-starts", "32",
           "--batch-size", "8", "--buffer-size", "48"]
OFF_POLICY = {"ddpg": ddpg_continuous_action, "td3": td3_continuous_action,
              "sac": sac_continuous_action}
ALL = {"ppo": ppo_continuous_action, "rpo": rpo_continuous_action, **OFF_POLICY}


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


@pytest.mark.parametrize("name", ["ppo", "rpo"])
def test_continuous_ppo_runs_and_saves(name):
    """Two updates saved; the checkpoint holds the agent (``log_std``
    included) and each env's observation and return statistics."""
    module = ALL[name]
    out = module.main(cli(module.Args, TINY_PPO + ["--total-timesteps", "128",
                                                   "--save-interval", "2", "--save-dir", "ck"]))
    assert out["run_name"].startswith(f"Pendulum-v1__{name}_continuous_action__1__")
    assert [r["update"] for r in out["history"]] == [1, 2] and out["global_step"] == 128
    assert all(math.isfinite(v) for r in out["history"] for k, v in r.items()
               if k.startswith("losses/"))
    rs = out["runner"]
    assert isinstance(rs.model.log_std, torch.nn.Parameter) and rs.model.log_std.shape == (1,)
    assert not torch.equal(rs.model.log_std.detach(), torch.zeros(1))  # trained
    payload = checkpoint.load_run(str(Path("ck") / out["run_name"]))
    env_state = payload["env_state"]
    assert env_state["rms"]["count"].shape == (2,) and env_state["ret"].shape == (2,)
    assert env_state["inner"]["rms"]["mean"].shape == (2, 3)
    assert torch.equal(payload["model"]["log_std"], rs.model.log_std.detach())


def test_rpo_draws_its_perturbation():
    """RPO's mean noise changes the update: the same run with
    ``--rpo-alpha 0`` ends elsewhere."""
    argv = TINY_PPO + ["--total-timesteps", "64"]
    rpo = rpo_continuous_action.main(cli(rpo_continuous_action.Args, argv))
    plain = rpo_continuous_action.main(cli(rpo_continuous_action.Args,
                                           argv + ["--rpo-alpha", "0"]))
    assert rpo["runner"].model.log_std.item() != plain["runner"].model.log_std.item()


@pytest.mark.parametrize("name", list(OFF_POLICY))
def test_actor_critic_twins_run_and_evaluate(name):
    """Two iterations (32 uniform steps, then 32 updates); the losses of
    iteration 2's last step nonzero (it trains, and step 64 runs the
    actor), and the greedy evaluation of 16 envs x 1,000 steps."""
    module = OFF_POLICY[name]
    out = module.main(cli(module.Args, TINY_AC + ["--total-timesteps", "64"]))
    hist = out["history"]
    assert [r["iteration"] for r in hist] == [1, 2] and out["global_step"] == 64
    assert hist[0]["losses/actor_loss"] == 0.0 and hist[1]["losses/actor_loss"] != 0.0
    loss = "losses/qf1_loss" if name == "ddpg" else "losses/qf_loss"
    assert hist[1][loss] > 0.0 and math.isfinite(hist[1]["losses/qf1_values"])
    assert out["eval_episodes"] == 16 * 5  # Pendulum episodes are 200 steps
    assert -16.3 * 200 <= out["eval_episodic_return"] <= 0.0
    ts = out["runner"].train_state
    assert int(ts.critics[0].step) == 32 and len(ts.critics) == (1 if name == "ddpg" else 2)
    if name == "sac":
        assert ts.actor.target is None and int(ts.actor.step) == 32
        assert hist[1]["losses/alpha"] != 0.2
    else:
        assert int(ts.actor.step) == 16


def test_sac_saves_and_resumes_bit_for_bit():
    """Two iterations saved, iteration 3 continued in memory, and iteration
    3 from the checkpoint through ``--load-from``: the two runners equal
    bit for bit (actor, critics, their targets, each Adam state,
    ``log_alpha`` and its Adam state, the ring, env state, statistics,
    generator)."""
    first = sac_continuous_action.main(cli(sac_continuous_action.Args, TINY_AC + [
        "--total-timesteps", "64", "--save-interval", "2", "--save-dir", "ck"]))
    ckpt = str(Path("ck") / first["run_name"])
    payload = checkpoint.load_run(ckpt)
    assert payload["global_step"] == 64 and payload["buffer"]["data"]["obs"].shape == (48, 3)
    state = payload["train_state"]
    assert state["actor"]["target"] is None and len(state["critics"]) == 2
    assert int(state["alpha_opt_state"]["count"]) == 32

    args = cli(sac_continuous_action.Args, TINY_AC + ["--total-timesteps", "96"])
    algo, _, _, _ = sac_continuous_action.build(args)
    in_memory, _ = algo.train_iteration(first["runner"])
    resumed = sac_continuous_action.main(cli(sac_continuous_action.Args, TINY_AC + [
        "--total-timesteps", "96", "--load-from", ckpt]))
    assert resumed["initial_iteration"] == 3 and resumed["global_step"] == 96
    assert _same(in_memory.payload(), resumed["runner"].payload())


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
    ("ppo_continuous_action", []),
    ("ppo_continuous_action", ["--norm-obs", "False", "--rpo-alpha", "0.3", "--num-envs", "8"]),
    ("rpo_continuous_action", []),
    ("ddpg_continuous_action", []),
    ("td3_continuous_action", ["--policy-noise", "0.3", "--learning-starts", "100"]),
    ("sac_continuous_action", ["--autotune", "False", "--target-network-frequency", "2"]),
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


# Cases 0-5 were gymnasium ids and --host-loop, which raised naming A.7
# until the gymnasium bridge and the host loop ran; then those branches
# with --track or --capture-video, which raised until the run journal,
# wandb_local and the GIF writer were ported.  Each case, at its index, now
# checks what its flag does on its branch: --track mirrors to wandb_local/;
# --capture-video writes a GIF where the JAX script records one (the PPO
# pair, on a registry env and on a gymnasium pool) and nothing where JAX
# ignores it (DDPG, TD3, SAC, the host loop included); every run journals.
@pytest.mark.parametrize("name,argv,gifs", [
    ("ppo", ["--env-id", "HalfCheetah-v4", "--track"], ()),
    ("rpo", ["--env-id", "Hopper-v4", "--capture-video"], ("final.gif",)),
    ("ddpg", ["--env-id", "HalfCheetah-v4", "--capture-video"], ()),
    ("td3", ["--host-loop", "--track", "--chunk-size", "32"], ()),
    ("sac", ["--host-loop", "--capture-video", "--chunk-size", "32"], ()),
    ("sac", ["--env-id", "Walker2d-v4", "--track"], ()),
    ("ppo", ["--capture-video"], ("final.gif",)),
    ("ddpg", ["--track"], ()),
    ("sac", ["--capture-video"], ()),
])
def test_track_and_capture_video_on_each_branch(name, argv, gifs, in_tmp):
    module = ALL[name]
    base = TINY_PPO if name in ("ppo", "rpo") else TINY_AC
    out = module.main(cli(module.Args, base + ["--total-timesteps", "64"] + argv))
    check_run_outputs(in_tmp, out["run_name"], track="--track" in argv, gifs=gifs)


@pytest.mark.parametrize("name", list(ALL))
def test_entry_points_default_to_the_card(name):
    """``--cuda`` defaults to True: without a card the run raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    module = ALL[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(cli(module.Args, ["--total-timesteps", "1"]))


def test_wrapper_stack_follows_the_flags():
    """The normalizers wrap outermost; each flag drops its wrapper."""
    env = ppo_continuous_action.make_env(
        cli(ppo_continuous_action.Args, ["--cuda", "False"]), torch.device("cpu"))
    assert [type(e).__name__ for e in (env, env.env, env.env.env, env.env.env.env)] == [
        "NormalizeReward", "NormalizeObservation", "ClipAction", "Pendulum"]
    assert isinstance(env, NormalizeReward) and env.gamma == 0.99
    bare = ppo_continuous_action.make_env(cli(ppo_continuous_action.Args, [
        "--cuda", "False", "--clip-action", "False", "--norm-obs", "False",
        "--norm-reward", "False"]), torch.device("cpu"))
    assert type(bare).__name__ == "Pendulum"
