"""The port's entry scripts on the CPU (``--cuda False``, tiny budgets):
the PPO twins end to end (recurrent, feedforward CNN, google LSTM, RND and
PPG), their flags against the JAX scripts', checkpoints (crash-safe
overwrite, ``--load-from`` resume continuing the update counter and the
generator stream, for PPO and for RND), the evaluate twin on PPO
checkpoints, ``--track`` and ``--capture-video`` on four branches, the DT
twin collecting with a port PPO checkpoint, and the event files read back
by TensorBoard."""

import dataclasses
import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mmtrl_tpu_torch.core import checkpoint
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.doorpuzzle import Doorpuzzle
from torch_run_checks import check_run_outputs

from mmtrl_tpu_torch.scripts import (
    ddpg_continuous_action,
    dqn_rom,
    dt_minecraft,
    evaluate,
    minecraft_cnn,
    minecraft_lstm,
    minecraft_lstm_attention,
    minecraft_lstm_google,
    ppg,
    ppo_continuous_action,
    ppo_rnd,
    skeleton_plus_ppo,
    train,
)

REPO = Path(__file__).resolve().parent.parent
# 2 envs x 4 steps a rollout, one minibatch, one epoch, small towers
TINY_PPO = ["--cuda", "False", "--conv-size", "small", "--num-envs", "2", "--num-steps", "4",
            "--num-minibatches", "1", "--update-epochs", "1"]
LOSSES = ("losses/policy_loss", "losses/value_loss", "losses/entropy", "losses/approx_kl",
          "losses/clipfrac", "losses/explained_variance")


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    """Every run writes under its own temp directory; torch runs one thread
    (the suite runs in several worker processes at once)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


def _events(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return acc


@pytest.mark.parametrize("script,extra", [
    (train, ["--attn-type", "casl"]),
    (minecraft_lstm_attention, []),
    (minecraft_lstm, ["--agent", "old"]),
    (minecraft_lstm, ["--agent", "minecraft", "--attn-type", "new"]),
])
def test_ppo_twin_runs_end_to_end(script, extra, in_tmp):
    out = script.main(cli(script.Args, TINY_PPO + extra + ["--total-timesteps", "16"]))
    assert out["global_step"] == 16 and [r["update"] for r in out["history"]] == [1, 2]
    for row in out["history"]:
        assert all(math.isfinite(row[k]) for k in LOSSES if k != "losses/explained_variance")
    acc = _events(in_tmp / "runs" / out["run_name"])
    tags = set(acc.Tags()["scalars"])
    assert {"charts/episodic_return", "charts/learning_rate", "charts/SPS",
            "charts/SPS_cumulative", *LOSSES} <= tags
    assert [e.step for e in acc.Scalars("losses/value_loss")] == [8, 16]
    assert acc.Scalars("losses/value_loss")[-1].value == pytest.approx(
        out["history"][-1]["losses/value_loss"], rel=1e-6)


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(cli(train.Args, ["--total-timesteps", "8"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dt_minecraft.main(cli(dt_minecraft.Args, ["--total-steps", "1"]))


# ---- the feedforward, google, RND and PPG twins and evaluate -----------------
PPO_METRICS = set(LOSSES)
FAMILY = {
    # script: (argv, metrics each update logs)
    "minecraft_cnn": (["--conv-size", "small", "--num-envs", "2", "--num-steps", "8",
                       "--num-minibatches", "2", "--update-epochs", "2",
                       "--total-timesteps", "32"], PPO_METRICS),
    "minecraft_lstm_google": (["--num-steps", "4", "--total-timesteps", "8"], PPO_METRICS),
    "ppo_rnd": (["--num-envs", "2", "--num-steps", "8", "--num-minibatches", "2",
                 "--update-epochs", "2", "--total-timesteps", "32"],
                {"losses/policy_loss", "losses/value_loss", "losses/fwd_loss", "losses/entropy",
                 "charts/mean_int_reward"}),
    "ppg": (["--num-envs", "2", "--num-steps", "4", "--num-minibatches", "2", "--n-iteration",
             "2", "--e-auxiliary", "2", "--num-aux-minibatches", "2", "--total-timesteps", "32"],
            PPO_METRICS - {"losses/explained_variance"}
            | {"losses/aux_value_loss", "losses/kl_clone"}),
}
SCRIPTS = {"minecraft_cnn": minecraft_cnn, "minecraft_lstm_google": minecraft_lstm_google,
           "ppo_rnd": ppo_rnd, "ppg": ppg}


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_ppo_family_twin_runs_end_to_end(name, in_tmp):
    """Two updates (for PPG two cycles of two rollouts) through ``main``,
    a checkpoint, and every metric in TensorBoard at the env steps."""
    argv, metrics = FAMILY[name]
    script = SCRIPTS[name]
    out = script.main(cli(script.Args, ["--cuda", "False", "--save-interval", "2"] + argv))
    steps = out["global_step"] // 2
    assert [r["update"] for r in out["history"]] == [1, 2] and out["global_step"] == 2 * steps
    for row in out["history"]:
        assert metrics <= set(row)
        assert all(math.isfinite(row[k]) for k in metrics if k != "losses/explained_variance")
    tags = set(_events(in_tmp / "runs" / out["run_name"]).Tags()["scalars"])
    assert {"charts/episodic_return", "charts/learning_rate", *metrics} <= tags
    payload = checkpoint.load_run(str(in_tmp / "saved_agents" / out["run_name"]))
    assert int(payload["opt_state"]["count"]) == int(out["runner"].step)
    assert isinstance(payload["generator"], torch.Tensor)


@pytest.mark.parametrize("name", sorted(FAMILY) + ["evaluate"])
def test_ppo_family_twin_raises_without_cuda(name, monkeypatch):
    """Without ``--cuda False`` and without CUDA a twin raises; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = evaluate if name == "evaluate" else SCRIPTS[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(cli(module.Args, ["--load-from", "x"] if name == "evaluate" else []))


def test_evaluate_reads_cnn_and_recurrent_checkpoints(in_tmp):
    cnn = minecraft_cnn.main(cli(minecraft_cnn.Args, [
        "--cuda", "False", "--conv-size", "small", "--num-envs", "2", "--num-steps", "4",
        "--num-minibatches", "1", "--update-epochs", "1", "--total-timesteps", "8",
        "--save-interval", "1"]))
    rec = train.main(cli(train.Args, TINY_PPO + ["--attn-type", "casl", "--total-timesteps", "8",
                                                 "--save-interval", "1"]))
    for script, run, extra in (("minecraft_cnn", cnn, []), ("train", rec, ["--attn-type", "casl"])):
        argv = ["--cuda", "False", "--script", script, "--conv-size", "small", "--load-from",
                str(in_tmp / "saved_agents" / run["run_name"]), "--num-envs", "3",
                "--num-steps", "64"] + extra
        out = evaluate.main(cli(evaluate.Args, argv))
        assert set(out) == {"eval/episodic_return", "eval/episodic_length", "eval/episodes"}
        # every episode ends within 30 steps: 64 steps end at least 2 per env
        assert out["eval/episodes"] >= 6 and 1.0 <= out["eval/episodic_length"] <= 30.0
        assert out == evaluate.main(cli(evaluate.Args, argv))  # greedy and seeded
        sampled = evaluate.main(cli(evaluate.Args, argv + ["--greedy", "False"]))
        assert math.isfinite(sampled["eval/episodic_return"])
    # the recurrent checkpoint is no CNN agent: strict state dicts
    with pytest.raises(RuntimeError):
        evaluate.main(cli(evaluate.Args, ["--cuda", "False", "--script", "minecraft_cnn",
                                          "--conv-size", "small", "--load-from",
                                          str(in_tmp / "saved_agents" / rec["run_name"])]))


def test_rnd_load_from_resumes_the_update_counter_and_the_generator_stream(in_tmp):
    """Update 3 after a resume equals update 3 of the uninterrupted run:
    the agent, the predictor, the observation and reward statistics, the
    forward filter and the generator all come back."""
    argv = ["--cuda", "False", "--num-envs", "2", "--num-steps", "4", "--num-minibatches", "2",
            "--update-epochs", "2", "--save-dir", "ck", "--anneal-lr", "False"]
    whole = ppo_rnd.main(cli(ppo_rnd.Args, argv + ["--total-timesteps", "24"]))
    first = ppo_rnd.main(cli(ppo_rnd.Args, argv + ["--total-timesteps", "16",
                                                   "--save-interval", "2"]))
    ckpt = str(in_tmp / "ck" / first["run_name"])
    payload = checkpoint.load_run(ckpt)
    assert int(payload["opt_state"]["count"]) == int(payload["predictor_opt_state"]["count"]) == 8
    assert set(payload) >= {"predictor", "target", "obs_stat", "reward_stat", "forward_filter"}
    resumed = ppo_rnd.main(cli(ppo_rnd.Args, argv + ["--total-timesteps", "24",
                                                     "--load-from", ckpt]))
    assert resumed["initial_update"] == 3 and [r["update"] for r in resumed["history"]] == [3]
    a, b = whole["runner"], resumed["runner"]
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for module in ("model", "predictor", "target"):
        for (name, p), q in zip(getattr(a, module).named_parameters(),
                                getattr(b, module).parameters()):
            assert torch.equal(p, q), f"{module}.{name}"
    for stat in ("obs_stat", "reward_stat"):
        assert all(torch.equal(getattr(getattr(a, stat), f), getattr(getattr(b, stat), f))
                   for f in ("mean", "var", "count"))
    assert torch.equal(a.forward_filter, b.forward_filter)
    assert resumed["history"][0]["losses/fwd_loss"] == whole["history"][2]["losses/fwd_loss"]


# Cases 0 and 3 were skeleton_plus_ppo --backend native and evaluate --env-id
# skeleton_plus_native, then ddpg --host-loop and ppo_continuous_action on a
# gymnasium id, then those branches with --track or --capture-video, which
# raised until the run journal, wandb_local and the GIF writer were ported.
# Each case, at its index, now checks what its flag does on its branch:
# --track mirrors to wandb_local/; --capture-video writes GIFs where the JAX
# script records one (ppo_continuous_action) and nothing where JAX ignores
# it (minecraft_cnn); every run journals "running" and "finished".
@pytest.mark.parametrize("module,argv,gifs", [
    (ddpg_continuous_action, ["--host-loop", "--track", "--num-envs", "2",
                              "--total-timesteps", "128", "--learning-starts", "64",
                              "--batch-size", "16", "--chunk-size", "32"], ()),
    (minecraft_cnn, TINY_PPO[2:] + ["--capture-video", "--total-timesteps", "8",
                                    "--save-interval", "1"], ()),
    (dqn_rom, ["--track", "--num-envs", "2", "--episode-steps", "10", "--buffer-size", "32",
               "--learning-starts", "16", "--batch-size", "4", "--total-timesteps", "100",
               "--eval-steps", "0"], ()),
    (ppo_continuous_action, ["--env-id", "Swimmer-v4", "--capture-video", "--num-envs", "2",
                             "--num-steps", "16", "--num-minibatches", "1", "--update-epochs",
                             "1", "--total-timesteps", "32", "--save-interval", "1"],
     ("update_1.gif", "final.gif")),
])
def test_track_and_capture_video_on_each_branch(module, argv, gifs, in_tmp):
    out = module.main(cli(module.Args, ["--cuda", "False"] + argv))
    check_run_outputs(in_tmp, out["run_name"], track="--track" in argv, gifs=gifs)


def test_evaluate_ppo_on_pendulum_fails_as_the_jax_script_does(monkeypatch, in_tmp):
    """``evaluate --script ppo --env-id Pendulum-v1``: both twins build the
    env, then ``MLPActorCritic(num_actions=env.num_actions)`` on its Box
    action space, which has no ``n``: the same AttributeError, before any
    checkpoint is read (JAX ``scripts/evaluate.py:71-73``)."""
    monkeypatch.setenv("MMTRL_NO_COMPILE_CACHE", "1")  # the JAX cli's own cache
    jax_evaluate = _jax_script("evaluate")
    from mmtrl_tpu.core.config import cli as jax_cli

    argv = ["--script", "ppo", "--env-id", "Pendulum-v1", "--load-from", "missing"]
    with pytest.raises(AttributeError) as jax_error:
        jax_evaluate.main(jax_cli(jax_evaluate.Args, argv))
    with pytest.raises(AttributeError) as port_error:
        evaluate.main(cli(evaluate.Args, ["--cuda", "False"] + argv))
    assert str(port_error.value) == str(jax_error.value) == "'Box' object has no attribute 'n'"


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
    ("train", ["--attn-type", "casl", "--cuda", "False", "--track", "--num-envs", "8",
               "--target-kl", "0.02", "--anneal-lr", "false", "--seed", "3",
               "--learning-rate", "1e-3", "--save-dir", "x"]),
    ("minecraft_lstm", ["--agent", "old", "--clip-rewards", "0", "--conv-size", "small"]),
    ("dt_minecraft", ["--policy-from", "ck", "--d-model", "64", "--eval-greedy", "no",
                      "--remat", "--rtg-clip", "5"]),
    ("minecraft_cnn", ["--conv-size", "small", "--input-scale", "1", "--num-envs", "8"]),
    ("minecraft_lstm_google", ["--policy-offset", "0", "--num-steps", "64"]),
    ("ppo_rnd", ["--int-coef", "0.5", "--update-proportion", "0.5", "--clip-rewards", "no"]),
    ("ppg", ["--n-iteration", "4", "--e-auxiliary", "3", "--aux-store-dtype", "float32"]),
    ("evaluate", ["--script", "minecraft_cnn", "--load-from", "ck", "--greedy", "false",
                  "--num-envs", "4"]),
])
def test_cli_matches_the_jax_cli(name, argv, monkeypatch):
    monkeypatch.setenv("MMTRL_NO_COMPILE_CACHE", "1")  # the JAX cli's own cache
    jax_script = _jax_script(name)
    from mmtrl_tpu.core.config import cli as jax_cli

    port_args = cli(importlib.import_module(f"mmtrl_tpu_torch.scripts.{name}").Args, argv)
    jax_args = jax_cli(jax_script.Args, argv)
    port, ref = dataclasses.asdict(port_args), dataclasses.asdict(jax_args)
    # --platform chooses a JAX backend; --cuda and --torch-deterministic are
    # the port's device flags (the JAX dt_minecraft has neither)
    assert set(ref) - set(port) <= {"platform"}
    assert set(port) - set(ref) <= {"cuda", "torch_deterministic"}
    assert {k: port[k] for k in ref if k in port} == {k: v for k, v in ref.items() if k in port}


def test_save_run_overwrites_crash_safely(in_tmp, monkeypatch):
    path = checkpoint.save_run({"x": torch.ones(2), "n": 1}, "run", "ck")
    assert checkpoint.load_run(path)["n"] == 1
    # leftovers of a killed save do not block the next one
    os.makedirs(in_tmp / "ck" / "_tmp_run")
    os.makedirs(in_tmp / "ck" / "_old_run")
    checkpoint.save_run({"x": torch.zeros(2), "n": 2}, "run", "ck")
    assert sorted(os.listdir(in_tmp / "ck")) == ["run"]
    # a save killed mid-write leaves the previous checkpoint whole
    monkeypatch.setattr(checkpoint.torch, "save", lambda *a, **k: (_ for _ in ()).throw(OSError("killed")))
    with pytest.raises(OSError):
        checkpoint.save_run({"x": torch.full((2,), 7.0), "n": 3}, "run", "ck")
    payload = torch.load(Path(path) / checkpoint.FILE, weights_only=True)
    assert payload["n"] == 2 and torch.equal(payload["x"], torch.zeros(2))


def test_load_from_resumes_the_update_counter_and_the_generator_stream(in_tmp):
    # a constant learning rate: an annealed one depends on --total-timesteps,
    # which the first run cuts short
    argv = TINY_PPO + ["--attn-type", "casl", "--num-minibatches", "2", "--update-epochs", "2",
                       "--save-dir", "ck", "--anneal-lr", "False"]
    whole = train.main(cli(train.Args, argv + ["--total-timesteps", "24"]))
    first = train.main(cli(train.Args, argv + ["--total-timesteps", "16", "--save-interval", "2"]))
    ckpt = str(in_tmp / "ck" / first["run_name"])
    payload = torch.load(Path(ckpt) / checkpoint.FILE, weights_only=True)
    assert int(payload["opt_state"]["count"]) == 8  # 2 updates x 2 epochs x 2 minibatches
    resumed = train.main(cli(train.Args, argv + ["--total-timesteps", "24",
                                                 "--load-from", ckpt]))
    assert resumed["initial_update"] == 3 and [r["update"] for r in resumed["history"]] == [3]
    assert resumed["global_step"] == 24
    # update 3 after a resume is update 3 of the uninterrupted run
    a, b = whole["runner"], resumed["runner"]
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    assert resumed["history"][0]["losses/value_loss"] == whole["history"][2]["losses/value_loss"]


def test_dt_twin_collects_with_a_ppo_checkpoint(in_tmp):
    ppo = train.main(cli(train.Args, TINY_PPO + ["--attn-type", "casl", "--total-timesteps", "8",
                                                 "--save-interval", "1", "--save-dir", "ck"]))
    out = dt_minecraft.main(cli(dt_minecraft.Args, [
        "--cuda", "False", "--policy-from", str(in_tmp / "ck" / ppo["run_name"]),
        "--policy-conv-size", "small", "--policy-input-scale", "255",
        "--collect-envs", "2", "--collect-steps", "40", "--d-model", "32", "--n-layers", "2",
        "--n-heads", "2", "--context-len", "6", "--batch-size", "4", "--total-steps", "4",
        "--print-interval", "2", "--eval-envs", "2", "--eval-steps", "8", "--save-interval", "4",
    ]))
    assert out["episodes_collected"] >= 2  # every episode ends within 30 steps
    assert all(math.isfinite(out[k]) for k in ("eval/episodic_return", "collect_s", "train_s"))
    saved = [d for d in os.listdir(in_tmp / "saved_agents") if "dt_minecraft" in d]
    assert len(saved) == 1
    payload = checkpoint.load_run(str(in_tmp / "saved_agents" / saved[0]))
    assert int(payload["opt_state"]["count"]) == 4
    # a checkpoint of another width does not load: strict state dicts
    with pytest.raises(RuntimeError):
        dt_minecraft.main(cli(dt_minecraft.Args, [
            "--cuda", "False", "--policy-from", str(in_tmp / "ck" / ppo["run_name"]),
            "--policy-conv-size", "big", "--total-steps", "1", "--collect-steps", "1"]))


def test_metrics_writer_events_read_back(in_tmp):
    @dataclasses.dataclass
    class Config:
        lr: float = 2.5e-4
        env_id: str = "minecraft"

    writer = MetricsWriter("run", Config(), root="ignored")  # MMTRL_RUN_ROOT wins
    writer.scalar("charts/episodic_return", -3.25, 8)
    writer.scalars({"losses/value_loss": 0.5, "losses/entropy": 1.375}, 8)
    sps = writer.sps(16)
    writer.close()
    acc = _events(in_tmp / "runs" / "run")
    assert set(acc.Tags()["scalars"]) == {"charts/episodic_return", "losses/value_loss",
                                         "losses/entropy", "charts/SPS", "charts/SPS_cumulative"}
    assert [(e.step, e.value) for e in acc.Scalars("charts/episodic_return")] == [(8, -3.25)]
    assert acc.Scalars("losses/entropy")[0].value == 1.375
    assert acc.Scalars("charts/SPS")[0].value == pytest.approx(sps, rel=1e-6)
    text = acc.Tensors("hyperparameters/text_summary")[0].tensor_proto.string_val[0].decode()
    assert text == "|param|value|\n|-|-|\n|lr|0.00025|\n|env_id|minecraft|"
    assert acc.SummaryMetadata("hyperparameters/text_summary").plugin_data.plugin_name == "text"


def test_registry_names_what_it_has():
    assert make("Minecraft2d", device="cpu").num_actions == 4
    assert make("CartPole-v1", device="cpu").num_actions == 2
    with pytest.raises(KeyError, match="available: \\['acrobot', 'acrobot-v1', 'brick_native', "
                                      "'cartpole', 'cartpole-v1', 'doorpuzzle', 'minecraft', "
                                      "'minecraft2d', 'minecraft_ma', 'mountaincar', "
                                      "'mountaincar-v0', 'multiagentminecraft2d', 'pendulum', "
                                      "'pendulum-v1', 'pong_ma_native', 'procmaze', "
                                      "'rally_native', 'skeleton_plus', 'skeleton_plus_native', "
                                      "'skeletonplus'\\]"):
        make("no_such_env", device="cpu")
    # the JAX registry's Doorpuzzle id (pong_ma_native: test_torch_pong_ma.py)
    assert type(make("doorpuzzle", device="cpu")) is Doorpuzzle


def test_python_m_entry_imports_no_jax(in_tmp):
    code = (
        "import runpy, sys\n"
        "sys.argv = ['train'] + sys.argv[1:]\n"
        "runpy.run_module('mmtrl_tpu_torch.scripts.train', run_name='__main__')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'tensorboard', 'mmtrl_tpu')))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, *TINY_PPO, "--total-timesteps", "8", "--save-interval", "1"],
        cwd=in_tmp, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
    assert "saved run to" in r.stdout and (in_tmp / "saved_agents").is_dir()
