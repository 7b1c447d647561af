"""Hyperparameter tuner — the reference's cleanrl_utils/tuner.py contract;
port of ``mmtrl_tpu/utils/tuner.py``.

Same surface: ``Tuner(script=..., metric=..., params_fn=...,
metric_last_n_average_window=..., target_scores=...).tune(num_trials,
num_seeds)``.  The target script, a port entry point such as
``mmtrl_tpu_torch/scripts/ppo.py``, runs in-process via runpy (reference
:92) under ``MMTRL_RUN_ROOT=runs_tuner/<study>``; the metric is read back
from its event files through ``core/metrics.py::read_scalars`` (reference
:95-101, which reads TensorBoard's), scores are normalized against per-env
target ranges (reference :105-111) and aggregated over seeds with median
pruning.  Between trials the trial's CUDA memory is freed.

The reference drives search with Optuna; the engine here is quasi-random
search (van der Corput stratification, one prime base per parameter) + a
median pruner with the same semantics, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import runpy
import sys
from typing import Callable, Dict, Optional, Tuple

import torch

from mmtrl_tpu_torch.core.metrics import read_scalars


@dataclasses.dataclass
class Trial:
    """Minimal optuna.Trial lookalike handed to params_fn."""

    number: int
    rng_value: Callable[[int], float]  # stratified u in [0,1) per param index
    _param_count: int = 0
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    _pruned_reports: list = dataclasses.field(default_factory=list)

    def _u(self) -> float:
        u = self.rng_value(self._param_count)
        self._param_count += 1
        return u

    def suggest_float(self, name, low, high, log=False):
        import math

        u = self._u()
        if log:
            val = math.exp(math.log(low) + u * (math.log(high) - math.log(low)))
        else:
            val = low + u * (high - low)
        self.params[name] = val
        return val

    def suggest_int(self, name, low, high, log=False):
        val = int(round(self.suggest_float(name, low, high, log=log)))
        val = max(low, min(high, val))
        self.params[name] = val
        return val

    def suggest_categorical(self, name, choices):
        val = choices[int(self._u() * len(choices)) % len(choices)]
        self.params[name] = val
        return val


def _van_der_corput(n: int, base: int) -> float:
    q, denom = 0.0, 1.0
    while n:
        denom *= base
        n, rem = divmod(n, base)
        q += rem / denom
    return q


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43]


def read_metric_from_tensorboard(
    run_dir: str, metric: str, last_n: int
) -> Optional[float]:
    """Average of the metric's last n points in a run's event files."""
    scalars = read_scalars(run_dir)
    if metric not in scalars:
        return None
    values = [float(v) for v in scalars[metric][1]]
    if not values:
        return None
    return float(sum(values[-last_n:]) / len(values[-last_n:]))


class Tuner:
    def __init__(
        self,
        script: str,
        metric: str,
        params_fn: Callable,
        target_scores: Dict[str, Optional[Tuple[float, float]]],
        metric_last_n_average_window: int = 50,
        direction: str = "maximize",
        aggregation_type: str = "average",
        pruner=None,
        sampler=None,
        storage: str = "mmtrl_hpopt.log",
        study_name: str = "",
        wandb_kwargs: Optional[dict] = None,
    ):
        self.script = script
        self.metric = metric
        self.params_fn = params_fn
        self.target_scores = target_scores
        self.window = metric_last_n_average_window
        self.direction = direction
        self.aggregation_type = aggregation_type
        self.storage = storage
        storage_dir = os.path.dirname(os.path.abspath(storage))
        os.makedirs(storage_dir, exist_ok=True)
        self.study_name = study_name or "mmtrl_tuner"
        self.history: list = []

    def _run_script(self, argv: list) -> Optional[float]:
        import time

        run_root = f"runs_tuner/{self.study_name}"
        before = set(glob.glob(f"{run_root}/*"))
        start = time.time()
        old_argv = sys.argv
        sys.argv = [self.script] + argv + ["--exp-name", "tuner"]
        old_env = os.environ.get("MMTRL_RUN_ROOT")
        os.environ["MMTRL_RUN_ROOT"] = run_root
        try:
            # MetricsWriter honors MMTRL_RUN_ROOT, so the trial's TB events
            # land under run_root and the read-back below cannot race other
            # processes writing runs/ concurrently.
            runpy.run_path(self.script, run_name="__main__")
        finally:
            sys.argv = old_argv
            if old_env is None:
                os.environ.pop("MMTRL_RUN_ROOT", None)
            else:
                os.environ["MMTRL_RUN_ROOT"] = old_env
            # Trials run in-process (the reference's runpy pattern,
            # cleanrl_utils/tuner.py:92): free what the trial left on the
            # card, or a long study holds every trial's cached blocks.
            import gc

            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        candidates = sorted(
            set(glob.glob(f"{run_root}/*")) - before
            # fallback for scripts with custom writers: only THIS trial's
            # run dirs (exp-name 'tuner', created after the trial started)
            or [
                d
                for d in glob.glob("runs/*__tuner__*")
                if os.path.getmtime(d) >= start
            ],
            key=os.path.getmtime,
        )
        if not candidates:
            return None
        return read_metric_from_tensorboard(candidates[-1], self.metric, self.window)

    def _normalize(self, env_id: str, value: float) -> float:
        rng = self.target_scores.get(env_id)
        if rng is None:
            return value
        lo, hi = rng
        return (value - lo) / (hi - lo)

    def _load_completed(self) -> dict:
        """Trial records already in the storage journal, by trial index.

        Trial params are a pure function of the trial index (van der Corput
        stratification), so a study interrupted between trials can resume
        by skipping recorded indices — the remaining trials sample exactly
        the points they would have originally.
        """
        import json

        done = {}
        if os.path.exists(self.storage):
            with open(self.storage) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("score") is not None:
                        done[rec["trial"]] = rec
        return done

    def tune(self, num_trials: int, num_seeds: int, resume: bool = False) -> list:
        results = []
        skip = self._load_completed() if resume else {}
        for rec in sorted(skip.values(), key=lambda r: r["trial"]):
            self.history.append(rec["score"])
            results.append(rec)
            print(f"trial {rec['trial']}: resumed from storage, score={rec['score']:.4f}")
        for trial_idx in range(num_trials):
            if trial_idx in skip:
                continue
            trial = Trial(
                number=trial_idx,
                rng_value=lambda i, t=trial_idx: _van_der_corput(
                    t + 1, _PRIMES[i % len(_PRIMES)]
                ),
            )
            params = self.params_fn(trial)
            argv = []
            for k, v in {**params}.items():
                argv += [f"--{k.replace('_', '-')}", str(v)]
            env_scores = []
            pruned = False
            for env_id in self.target_scores:
                seed_scores = []
                for seed in range(1, num_seeds + 1):
                    value = self._run_script(
                        argv + ["--env-id", env_id, "--seed", str(seed)]
                    )
                    if value is None:
                        continue
                    seed_scores.append(self._normalize(env_id, value))
                    # median pruning within the trial
                    if self.history:
                        median = sorted(self.history)[len(self.history) // 2]
                        running = sum(seed_scores) / len(seed_scores)
                        if running < median * 0.5:
                            pruned = True
                            break
                if seed_scores:
                    env_scores.append(sum(seed_scores) / len(seed_scores))
                if pruned:
                    break
            agg = sum(env_scores) / len(env_scores) if env_scores else float("-inf")
            self.history.append(agg)
            results.append({"trial": trial_idx, "params": trial.params, "score": agg})
            with open(self.storage, "a") as f:
                # JSON lines (failed trials stored as score=null) so shell
                # consumers can parse the study journal; -inf is not a JSON
                # (or ast.literal_eval) literal.
                import json

                rec = dict(results[-1])
                if rec["score"] == float("-inf"):
                    rec["score"] = None
                f.write(json.dumps(rec) + "\n")
            print(f"trial {trial_idx}: score={agg:.4f} params={trial.params}")
        best = max(results, key=lambda r: r["score"])
        print(f"best: {best}")
        return results
