"""The port's run journal and its readers against the JAX package's:
``utils/wandb_local`` (the same files from the same calls, timestamps
pinned; each package's ``load_history`` reads the other's run), the
metrics writer's ``--track`` mirror, ``dt_rom --track`` writing the run
directory JAX's writes, ``utils/resume`` (``journal_run``,
``load_manifest``, ``resume_command`` and ``main``), ``utils/reproduce``,
and the host command tools (``benchmark``, ``submit_exp``,
``queue_runner``, ``docker_build``, ``add_header``).  Every test runs in
its own temp directory: the journal writes ``runs_manifest.jsonl`` and
``wandb_local/`` where it runs."""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mmtrl_tpu.core.metrics import MetricsWriter as JaxMetricsWriter
from mmtrl_tpu.utils import add_header as jax_add_header
from mmtrl_tpu.utils import benchmark as jax_benchmark
from mmtrl_tpu.utils import docker_build as jax_docker_build
from mmtrl_tpu.utils import queue_runner as jax_queue_runner
from mmtrl_tpu.utils import reproduce as jax_reproduce
from mmtrl_tpu.utils import resume as jax_resume
from mmtrl_tpu.utils import submit_exp as jax_submit_exp
from mmtrl_tpu.utils import wandb_local as jax_wandb
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.scripts import dt_rom, train
from mmtrl_tpu_torch.utils import (
    add_header,
    benchmark,
    docker_build,
    queue_runner,
    reproduce,
    resume,
    submit_exp,
    wandb_local,
)
from test_torch_rom_scripts import TINY_DT, _jax_script


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


@pytest.fixture
def frozen_clock(monkeypatch):
    """``time.time`` and ``time.strftime`` pinned: both journals stamp
    their rows and metadata with them."""
    monkeypatch.setattr(time, "time", lambda: 1_792_000_000.25)
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "2026-10-18T12:00:00")


def _files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _log_calls(module, root, config, argv):
    run = module.init("proj", "CartPole-v1__ppo__1__123", config=config, argv=argv, root=root)
    run.log({"charts/episodic_return": 12.5, "losses/value_loss": np.float32(0.25)}, step=128)
    run.log({"charts/episodic_return": 13}, step=256)
    run.log({"charts/SPS": 1e3}, step=256)
    run.finish()
    return run


@pytest.mark.parametrize("config", [
    cli(train.Args, ["--cuda", "False", "--track"]),
    argparse.Namespace(lr=2.5e-4, env_id="CartPole-v1", track=True, tags=None),
    None,
], ids=["dataclass", "namespace", "no-config"])
def test_wandb_local_writes_the_files_jax_writes(config, in_tmp, frozen_clock):
    argv = ["scripts/train.py", "--track", "--seed", "3"]
    _log_calls(wandb_local, str(in_tmp / "port"), config, argv)
    _log_calls(jax_wandb, str(in_tmp / "jax"), config, argv)
    port, ref = _files(in_tmp / "port"), _files(in_tmp / "jax")
    assert port == ref
    assert any(name.endswith("history.jsonl") for name in port)


def test_each_load_history_reads_the_other_packages_run(in_tmp):
    run = _log_calls(wandb_local, str(in_tmp), None, ["x"])
    ref = _log_calls(jax_wandb, str(in_tmp / "jax"), None, ["x"])
    for a, b in ((jax_wandb.load_history(run.dir), wandb_local.load_history(run.dir)),
                 (wandb_local.load_history(ref.dir), jax_wandb.load_history(ref.dir))):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].tolist() == [128, 256, 256]
        assert a[1].keys() == b[1].keys() == {"charts/episodic_return", "losses/value_loss",
                                             "charts/SPS"}
        for key in a[1]:
            np.testing.assert_array_equal(a[1][key], b[1][key])  # NaN where a row lacks it
    assert wandb_local.load_history(str(in_tmp / "none")) is None


def test_metrics_writer_mirrors_track_as_jax_does(in_tmp, frozen_clock, monkeypatch):
    """The same config, scalars and argv through both writers: the same
    ``wandb_local`` files; a config without ``track`` mirrors nothing."""
    monkeypatch.setattr(sys, "argv", ["scripts/ppo.py", "--track"])
    config = cli(train.Args, ["--cuda", "False", "--track", "--wandb-project-name", "p"])
    for cls, sub in ((MetricsWriter, "port"), (JaxMetricsWriter, "jax")):
        (in_tmp / sub).mkdir()
        monkeypatch.chdir(in_tmp / sub)
        writer = cls("run__a__1__9", config)
        writer.scalar("charts/episodic_return", 3.5, 64)
        writer.scalars({"losses/policy_loss": -0.125, "losses/entropy": 1.5}, 128)
        writer.close()
        cls("run__b__1__9", cli(train.Args, ["--cuda", "False"])).close()
    port, ref = _files(in_tmp / "port" / "wandb_local"), _files(in_tmp / "jax" / "wandb_local")
    assert port == ref and set(port) == {f"p/run__a__1__9/{f}" for f in (
        "config.json", "wandb-metadata.json", "history.jsonl", "summary.json")}


def test_dt_rom_track_writes_the_run_directory_jax_writes(in_tmp, monkeypatch):
    """``dt_rom --track`` at ``TINY_DT``: the port's writer mirrors to
    ``wandb_local/mmtrl/<run>/`` (dt_rom has no project flag), with the files
    and history keys of JAX's run, which mirrors through its own writer;
    without the mirror the port's run left no journal."""
    monkeypatch.setenv("MMTRL_NO_COMPILE_CACHE", "1")  # the JAX cli's own cache
    import jax

    import mmtrl_tpu.algos.dt.train as jax_dt_train
    from mmtrl_tpu.core.config import cli as jax_cli

    base = jax_dt_train.DecisionTransformer

    class JittedInit(base):
        """flax's eager init compiles op by op (about 40 s here); jitted, the
        same parameters come in one compile."""

        def init(self, key, *args, **kw):
            return jax.jit(lambda k, *a: base.init(self, k, *a, **kw))(key, *args)

    monkeypatch.setattr(jax_dt_train, "DecisionTransformer", JittedInit)
    argv = TINY_DT[2:] + ["--total-steps", "3", "--track"]
    runs = {}
    jax_script = _jax_script("dt_rom")

    for sub, run in (("port", lambda: dt_rom.main(cli(dt_rom.Args, ["--cuda", "False"] + argv))),
                     ("jax", lambda: jax_script.main(jax_cli(jax_script.Args, argv)))):
        (in_tmp / sub).mkdir()
        monkeypatch.chdir(in_tmp / sub)
        run()
        (runs[sub],) = (in_tmp / sub / "wandb_local" / "mmtrl").iterdir()
    port, ref = runs["port"], runs["jax"]
    assert port.name.split("__")[:3] == ref.name.split("__")[:3]
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in ref.iterdir())

    def history_keys(run_dir):
        with open(run_dir / "history.jsonl") as f:
            return [sorted(json.loads(line)) for line in f]

    assert history_keys(port) == history_keys(ref) and history_keys(port)
    for run_dir in (port, ref):
        with open(run_dir / "wandb-metadata.json") as f:
            assert json.load(f)["state"] == "finished"
    assert (json.loads((port / "config.json").read_text()).keys()
            - json.loads((ref / "config.json").read_text()).keys() <= {"cuda", "torch_deterministic"})


# ---- the manifest, resume and reproduce ---------------------------------------
def _journal(module):
    module.journal_run("CartPole-v1__ppo__1__100", ["scripts/ppo.py", "--seed", "1"])
    module.journal_run("CartPole-v1__ppo__1__100", ["scripts/ppo.py", "--seed", "1"], "finished")
    module.journal_run("Acrobot-v1__dqn__2__101", ["scripts/dqn.py", "--env-id", "Acrobot-v1",
                                                   "--total-timesteps", "5 000"])
    module.journal_run("Acrobot-v1__c51__2__102", ["scripts/c51.py", "--load-from", "x"])


def test_journal_and_manifest_match_jax(in_tmp, monkeypatch):
    records = {}
    for sub, module in (("port", resume), ("jax", jax_resume)):
        (in_tmp / sub).mkdir()
        monkeypatch.chdir(in_tmp / sub)
        _journal(module)
        with open(module.MANIFEST) as f:
            records[sub] = [json.loads(line) for line in f]
        assert module.load_manifest() == {r["run_name"]: r for r in records[sub]}
    strip = [[{k: v for k, v in r.items() if k != "time"} for r in records[s]]
             for s in ("port", "jax")]
    assert strip[0] == strip[1] and len(strip[0]) == 4
    assert all(isinstance(r["time"], float) for r in records["port"])


def test_resume_and_reproduce_print_what_jax_prints(in_tmp, capsys, monkeypatch):
    """One manifest (two unfinished runs, one with a checkpoint), read by
    both packages' ``resume`` (list and resume commands, ``--execute``
    with the subprocess stubbed) and ``reproduce``."""
    _journal(resume)
    (in_tmp / "saved_agents" / "Acrobot-v1__dqn__2__101").mkdir(parents=True)
    runs = resume.load_manifest()
    assert runs == jax_resume.load_manifest()
    for rec in runs.values():
        assert resume.resume_command(rec) == jax_resume.resume_command(rec)
        assert resume.find_checkpoint(rec["run_name"]) == jax_resume.find_checkpoint(rec["run_name"])
    assert "--load-from saved_agents/Acrobot-v1__dqn__2__101" in resume.resume_command(
        runs["Acrobot-v1__dqn__2__101"])
    executed = {}
    for name, module in (("port", resume), ("jax", jax_resume)):
        calls, out = [], []
        with monkeypatch.context() as m:
            m.setattr(subprocess, "run", lambda cmd, check=False, _c=calls: _c.append(cmd))
            for argv in ([], ["--list"], ["--resume"], ["--resume", "--execute"]):
                module.main(argv)
                out.append(capsys.readouterr().out)
        executed[name] = (out, calls)
    assert executed["port"] == executed["jax"]
    assert "2 unfinished runs" in executed["port"][0][0] and len(executed["port"][1]) == 2
    for name in ("Acrobot-v1__dqn__2__101", "CartPole-v1__ppo__1__100"):
        reproduce.main(["--run-name", name])
        port = capsys.readouterr().out
        jax_reproduce.main(["--run-name", name])
        assert port == capsys.readouterr().out and port.startswith(f"# reproduce {name}\n")
    for module in (reproduce, jax_reproduce):
        with pytest.raises(SystemExit, match="not in manifest"):
            module.main(["--run-name", "missing"])


# ---- the host command tools ---------------------------------------------------
def test_benchmark_commands_match_jax(monkeypatch, capsys):
    argv = ["--command", "python -m mmtrl_tpu_torch.scripts.ppo --total-timesteps 1000",
            "--env-ids", "CartPole-v1", "Acrobot-v1", "--num-seeds", "3", "--start-seed", "2"]
    port = benchmark.build_commands(benchmark.parse_args(argv))
    assert port == jax_benchmark.build_commands(jax_benchmark.parse_args(argv))
    assert len(port) == 6 and port[0].endswith("--env-id CartPole-v1 --seed 2")
    for module in (benchmark, jax_benchmark):
        ran = []
        with monkeypatch.context() as m:
            m.setattr(subprocess, "run", lambda cmd, _r=ran: (
                _r.append(cmd), argparse.Namespace(returncode=int("Acrobot" in cmd[-3])))[1])
            assert module.main(argv + ["--workers", "2"]) == 1
        assert sorted(map(tuple, ran)) == sorted(tuple(c.split()) for c in port)
    out = capsys.readouterr().out
    assert out.count("done: 3 ok, 3 failed") == 2


def test_submit_exp_queue_runner_and_add_header_match_jax(in_tmp, capsys, monkeypatch):
    argv = ["--command", "python -m mmtrl_tpu_torch.scripts.ppo", "--env-ids", "CartPole-v1",
            "Acrobot-v1", "--num-seeds", "2"]
    outs = []
    for module, extra in ((submit_exp, []), (jax_submit_exp, []),
                          (submit_exp, ["--docker-tag", "img:1"]),
                          (jax_submit_exp, ["--docker-tag", "img:1"])):
        module.main(argv + extra)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[2] == outs[3] and outs[0].count("\n") == 4
    submit_exp.main(argv + ["--exp-script", "port.sh"])
    jax_submit_exp.main(argv + ["--exp-script", "jax.sh"])
    assert Path("port.sh").read_text() == Path("jax.sh").read_text()
    assert "mmtrl_tpu_torch.utils.queue_runner" in capsys.readouterr().out
    Path("port.sh").write_text("# a comment\n\n" + Path("port.sh").read_text())
    assert (queue_runner.parse_exp_script("port.sh")
            == jax_queue_runner.parse_exp_script("port.sh")) and len(
        queue_runner.parse_exp_script("port.sh")) == 4
    for module in (queue_runner, jax_queue_runner):
        Path("q.sh").write_text(f"{sys.executable} -c pass\n{sys.executable} -c 'raise SystemExit(3)'\n")
        assert module.main(["--exp-script", "q.sh", "--workers", "2", "--poll-interval", "0.05"]) == 1
    for module, name in ((add_header, "port"), (jax_add_header, "jax")):
        Path(f"{name}.py").write_text("print(1)\n")
        Path(f"{name}.txt").write_text("x\n")
        module.main([f"{name}.py", f"{name}.py", f"{name}.txt"])
    assert Path("port.py").read_text() == Path("jax.py").read_text() == add_header.HEADER + "print(1)\n"
    assert Path("port.txt").read_text() == "x\n"
    for module in (docker_build, jax_docker_build):
        calls = []
        with monkeypatch.context() as m:
            m.setattr(subprocess, "run", lambda cmd, _c=calls: (
                _c.append(cmd), argparse.Namespace(returncode=0))[1])
            assert module.main(["--tag", "t:1", "--push"]) == 0
        assert calls == [["docker", "build", "-t", "t:1", "."], ["docker", "push", "t:1"]]
