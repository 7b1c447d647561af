"""The port's event-file reader and the tools on it against the JAX
package's: ``core/metrics.py::read_scalars`` against TensorBoard's
``EventAccumulator`` on the port writer's files, on torch
``SummaryWriter``'s and on files cut short; ``utils/plot`` (``smooth``,
``load_runs``, ``main``), ``utils/plot_individual``, ``utils/paper_plot``
(``load_journal_runs``, ``aggregate``, ``main``) and ``utils/tuner``
(``Trial``, ``_van_der_corput``, the metric read-back, the resume file,
one in-process trial of the port's ``ppo``) against JAX's on the same run
directories; ``utils/profiling``."""

import json
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mmtrl_tpu.utils import paper_plot as jax_paper_plot
from mmtrl_tpu.utils import plot as jax_plot
from mmtrl_tpu.utils import plot_individual as jax_plot_individual
from mmtrl_tpu.utils import tuner as jax_tuner
from mmtrl_tpu_torch.core.metrics import EventFileWriter, read_records, read_scalars
from mmtrl_tpu_torch.utils import paper_plot, plot, plot_individual, profiling, tuner, wandb_local

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


def _accumulated(run_dir):
    """{tag: (steps, values)} as TensorBoard's ``EventAccumulator`` reads them."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return {tag: (np.array([e.step for e in acc.Scalars(tag)]),
                  np.array([e.value for e in acc.Scalars(tag)]))
            for tag in acc.Tags()["scalars"]}


def _assert_same(ours, ref):
    assert ours.keys() == ref.keys()
    for tag in ref:
        np.testing.assert_array_equal(ours[tag][0], ref[tag][0], err_msg=tag)
        np.testing.assert_array_equal(ours[tag][1], ref[tag][1], err_msg=tag)  # NaN == NaN
        assert ours[tag][0].dtype == np.int64 and ours[tag][1].dtype == np.float64


def _port_run(run_dir, seed=0, n=40):
    """Two writers in one run (as training and evaluation write), every
    value float32-rounded as the files store it, with NaN, infinities, a
    large and a negative step and the hyperparameter text."""
    rng = np.random.default_rng(seed)
    first, second = EventFileWriter(str(run_dir)), EventFileWriter(str(run_dir))
    first.add_text("hyperparameters", "|param|value|\n|-|-|\n|lr|0.1|")
    for i in range(n):
        first.add_scalar("charts/episodic_return", float(rng.normal() * 100), i * 128)
        if i % 3 == 0:
            first.add_scalar("losses/value_loss", float(rng.random()), i * 128)
    for step, value in ((2**40, math.nan), (-5, math.inf), (7, -math.inf), (8, 1e-42)):
        second.add_scalar("charts/odd", value, step)
    first.close()
    second.close()


def test_reader_equals_event_accumulator_on_the_port_writer(in_tmp):
    _port_run(in_tmp / "run")
    ours = read_scalars(str(in_tmp / "run"))
    _assert_same(ours, _accumulated(in_tmp / "run"))
    assert set(ours) == {"charts/episodic_return", "losses/value_loss", "charts/odd"}
    assert len(ours["charts/episodic_return"][0]) == 40


def test_reader_equals_event_accumulator_on_summary_writer_files(in_tmp):
    from torch.utils.tensorboard import SummaryWriter

    writer = SummaryWriter(str(in_tmp / "run"))
    rng = np.random.default_rng(1)
    for i in range(30):
        writer.add_scalar("charts/SPS", float(rng.random() * 1e4), i)
        writer.add_scalar("charts/tensor_style", float(i), i, new_style=True)  # not a scalar
    writer.add_text("hyperparameters", "text")
    writer.add_histogram("weights", rng.normal(size=100), 3)
    writer.close()
    ours = read_scalars(str(in_tmp / "run"))
    _assert_same(ours, _accumulated(in_tmp / "run"))
    assert set(ours) == {"charts/SPS"}


def test_reader_on_a_last_record_cut_short(in_tmp):
    """A run killed mid-write: every cut through the last record (its
    length, its CRCs, its body) reads as the records before it, as
    TensorBoard reads it; a complete record with a wrong CRC raises."""
    _port_run(in_tmp / "run", n=3)
    (path,) = sorted((in_tmp / "run").glob("*tfevents*"))[:1]
    data = path.read_bytes()
    records = list(read_records(str(path)))
    last = len(data) - (12 + len(records[-1]) + 4)
    for cut in (last + 1, last + 8, last + 11, last + 12, last + 20, len(data) - 4, len(data) - 1):
        run = in_tmp / f"cut{cut}"
        run.mkdir()
        (run / path.name).write_bytes(data[:cut])
        ours = read_scalars(str(run))
        _assert_same(ours, _accumulated(run))
        assert len(list(read_records(str(run / path.name)))) == len(records) - 1
    bad = bytearray(data)
    bad[last + 14] ^= 0xFF  # a byte of the last record's body
    (in_tmp / "bad").mkdir()
    (in_tmp / "bad" / path.name).write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="corrupt record"):
        read_scalars(str(in_tmp / "bad"))


def _runs_dir(root: Path):
    """Three seeds of two experiments on two envs, a run without the
    metric and a directory whose name is not a run's."""
    for k, (env, exp, seed) in enumerate([("CartPole-v1", "ppo", 1), ("CartPole-v1", "ppo", 2),
                                           ("CartPole-v1", "dqn", 1), ("Acrobot-v1", "ppo", 1)]):
        _port_run(root / f"{env}__{exp}__{seed}__{1000 + k}", seed=k, n=20 + 5 * k)
    w = EventFileWriter(str(root / "Acrobot-v1__c51__1__2000"))
    w.add_scalar("losses/td_loss", 1.0, 1)
    w.close()
    _port_run(root / "scratch", seed=9)


def test_plot_tools_load_what_jax_loads(in_tmp):
    _runs_dir(in_tmp / "runs")
    for metric in ("charts/episodic_return", "losses/value_loss", "missing"):
        ours, ref = plot.load_runs("runs", metric), jax_plot.load_runs("runs", metric)
        assert ours.keys() == ref.keys()
        for key in ref:
            assert len(ours[key]) == len(ref[key])
            for (s, v), (rs, rv) in zip(ours[key], ref[key]):
                np.testing.assert_array_equal(s, rs)
                np.testing.assert_array_equal(v, rv)
    assert len(plot.load_runs("runs", "charts/episodic_return")[("CartPole-v1", "ppo")]) == 2
    for run_dir in sorted((in_tmp / "runs").iterdir()):
        _assert_same(plot_individual.load_run_metrics(str(run_dir)),
                     jax_plot_individual.load_run_metrics(str(run_dir)))
    values = np.random.default_rng(3).normal(size=50)
    for weight in (0.0, 0.6, 0.9, 0.99):
        np.testing.assert_array_equal(plot.smooth(values, weight), jax_plot.smooth(values, weight))


def test_paper_plot_reads_and_aggregates_what_jax_does(in_tmp):
    rng = np.random.default_rng(4)
    for k, (env, exp) in enumerate([("CartPole-v1", "ppo"), ("CartPole-v1", "ppo"),
                                    ("Acrobot-v1", "dqn")]):
        run = wandb_local.init("proj", f"{env}__{exp}__{k}__{k}", root="wandb_local")
        for i in range(25 + k):
            run.log({"charts/episodic_return": float(rng.normal())}, step=100 * i + 7 * k)
            if i % 4:
                run.log({"charts/SPS": 1000.0}, step=100 * i + 7 * k)
        run.finish()
    wandb_local.init("proj", "not_a_run", root="wandb_local").finish()
    ours = paper_plot.load_journal_runs("wandb_local", "charts/episodic_return")
    ref = jax_paper_plot.load_journal_runs("wandb_local", "charts/episodic_return")
    assert ours.keys() == ref.keys() == {("CartPole-v1", "ppo"), ("Acrobot-v1", "dqn")}
    for key in ref:
        for (s, v), (rs, rv) in zip(ours[key], ref[key], strict=True):
            np.testing.assert_array_equal(s, rs)
            np.testing.assert_array_equal(v, rv)
        for points in (200, 17):
            for a, b in zip(paper_plot.aggregate(ours[key], points),
                            jax_paper_plot.aggregate(ref[key], points)):
                np.testing.assert_array_equal(a, b)


def test_plot_mains_draw_what_jax_draws(in_tmp, capsys):
    """Each tool's ``main`` on the same runs and journal: the same figures
    by name and the same report (matplotlib, imported only here)."""
    pytest.importorskip("matplotlib")
    _runs_dir(in_tmp / "runs")
    run = wandb_local.init("proj", "Pendulum-v1__sac__1__5", root="wandb_local")
    for i in range(30):
        run.log({"charts/episodic_return": -1000.0 + i}, step=i * 64)
    run.finish()
    outputs = {}
    for name, mods in (("port", (plot, plot_individual, paper_plot)),
                       ("jax", (jax_plot, jax_plot_individual, jax_paper_plot))):
        mods[0].main(["--output", f"{name}/curves"])
        mods[1].main(["--out-dir", f"{name}/individual", "--pattern", "*__*"])
        mods[2].main(["--output", f"{name}/paper/paper.png"])
        outputs[name] = capsys.readouterr().out.replace(f"{name}/", "")
    assert outputs["port"] == outputs["jax"]
    assert sorted(str(p.relative_to("port")) for p in Path("port").rglob("*.png")) == sorted(
        str(p.relative_to("jax")) for p in Path("jax").rglob("*.png"))
    assert "3 envs" in outputs["port"]


# ---- the tuner ----------------------------------------------------------------
def _params(trial):
    return {"lr": trial.suggest_float("lr", 1e-4, 1e-2, log=True),
            "clip": trial.suggest_float("clip", 0.1, 0.3),
            "n": trial.suggest_int("n", 1, 9),
            "k": trial.suggest_int("k", 4, 4096, log=True),
            "act": trial.suggest_categorical("act", ["tanh", "relu", "gelu"])}


def test_trial_and_van_der_corput_match_jax():
    for n in range(200):
        for base in tuner._PRIMES:
            assert tuner._van_der_corput(n, base) == jax_tuner._van_der_corput(n, base)
    assert tuner._PRIMES == jax_tuner._PRIMES
    for index in range(40):
        draws = []
        for module in (tuner, jax_tuner):
            trial = module.Trial(number=index, rng_value=lambda i, t=index: module._van_der_corput(
                t + 1, module._PRIMES[i % len(module._PRIMES)]))
            draws.append((_params(trial), trial.params, trial._param_count))
        assert draws[0] == draws[1]


def test_metric_read_back_matches_jax(in_tmp):
    _runs_dir(in_tmp / "runs")
    for run_dir in sorted((in_tmp / "runs").iterdir()):
        for metric in ("charts/episodic_return", "losses/td_loss", "missing"):
            for last_n in (1, 5, 50, 1000):
                assert (tuner.read_metric_from_tensorboard(str(run_dir), metric, last_n)
                        == jax_tuner.read_metric_from_tensorboard(str(run_dir), metric, last_n))


def test_tuner_resume_skips_recorded_trials(in_tmp):
    """``resume=True`` keeps the scored trials of the storage file and
    reruns the others at their index's parameters, as JAX's tuner does."""
    storage = in_tmp / "study.log"
    lines = [{"trial": 0, "params": {"x": 1}, "score": 0.5}, {"trial": 2, "params": {"x": 3},
             "score": 0.7}, {"trial": 9, "params": {"x": 9}, "score": None}]
    storage.write_text("".join(json.dumps(r) + "\n" for r in lines) + "not json\n\n")
    results = {}
    for name, module in (("port", tuner), ("jax", jax_tuner)):
        shutil.copy(storage, in_tmp / f"{name}.log")
        ran = []

        class Stub(module.Tuner):
            def _run_script(self, argv, _ran=ran):
                _ran.append(argv)
                return 1.0 + 0.25 * len(_ran)

        results[name] = (Stub(script="unused", metric="m", target_scores={"env": (0.0, 2.0)},
                              params_fn=lambda t: {"lr": t.suggest_float("lr", 0.1, 1.0),
                                                   "total-timesteps": 8},
                              storage=str(in_tmp / f"{name}.log")).tune(4, 2, resume=True), ran)
        with open(in_tmp / f"{name}.log") as f:
            results[name] += (f.read(),)
    assert results["port"] == results["jax"]
    assert [r["trial"] for r in results["port"][0]] == [0, 2, 1, 3]


def test_one_tuner_trial_of_the_port_ppo(in_tmp):
    """One trial, one seed of ``mmtrl_tpu_torch/scripts/ppo.py`` run
    in-process on the CPU under ``runs_tuner/<study>``: the score is the
    normalized mean of the metric's last points, read back from the
    trial's event file."""
    study = tuner.Tuner(
        script=str(REPO / "mmtrl_tpu_torch" / "scripts" / "ppo.py"),
        metric="charts/episodic_return", metric_last_n_average_window=2,
        target_scores={"CartPole-v1": (0, 500)},
        params_fn=lambda trial: {"learning-rate": trial.suggest_float("lr", 1e-4, 1e-3, log=True),
                                 "cuda": False, "total-timesteps": 256, "num-envs": 2,
                                 "num-steps": 32, "num-minibatches": 2, "update-epochs": 1},
        storage=str(in_tmp / "hpopt.log"), study_name="s")
    (result,) = study.tune(num_trials=1, num_seeds=1)
    (run_dir,) = (in_tmp / "runs_tuner" / "s").iterdir()
    assert run_dir.name.startswith("CartPole-v1__tuner__1__")
    returns = read_scalars(str(run_dir))["charts/episodic_return"][1]
    assert len(returns) == 4
    assert result["score"] == pytest.approx(float(np.mean(returns[-2:])) / 500, rel=1e-12)
    assert "lr" in result["params"] and os.environ["MMTRL_RUN_ROOT"] == str(in_tmp / "runs")
    assert json.loads((in_tmp / "hpopt.log").read_text())["trial"] == 0


# ---- profiling ----------------------------------------------------------------
def test_phase_timer_and_trace(in_tmp):
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("rollout", block_on=torch.ones(2)):
            pass
    with timer.phase("update", block_on={"loss": torch.zeros(())}):
        pass

    class Writer:
        rows = []

        def scalar(self, tag, value, step):
            self.rows.append((tag, value, step))

    avgs = timer.report(Writer(), step=7)
    assert set(avgs) == {"profile/rollout_ms", "profile/update_ms"} and timer.counts["rollout"] == 3
    assert [(t, s) for t, _, s in Writer.rows] == [("profile/rollout_ms", 7), ("profile/update_ms", 7)]
    with profiling.trace(str(in_tmp / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(p.name.endswith(".pt.trace.json") for p in (in_tmp / "prof").iterdir())
