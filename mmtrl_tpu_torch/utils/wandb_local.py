"""wandb-API-compatible local experiment journal; the port's own copy of
``mmtrl_tpu/utils/wandb_local.py`` (the same files, the same layout).

The reference mirrors TensorBoard to wandb (``--track``, src/train.py:75-83)
and its resume/plot tooling consumes the wandb API (cleanrl_utils/resume.py:
50-58 reads wandb-metadata.json; plot utilities pull run histories).  This
module provides the same surface against the local filesystem:

    run = init(project, name, config, argv)
    run.log({"charts/episodic_return": 12.0}, step=1024)
    run.finish()

Layout (wandb's on-disk shape, trimmed):
    wandb_local/<project>/<run_name>/
        config.json            flattened run config
        wandb-metadata.json    {"args": argv, "program": argv[0], "state": ...}
        history.jsonl          one JSON object per log() call, with _step
        summary.json           last value per key

``utils/paper_plot.py`` reads the histories back through ``load_history``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np

ROOT = "wandb_local"


class Run:
    def __init__(self, project: str, name: str, config: Optional[Any] = None,
                 argv: Optional[Sequence[str]] = None, root: str = ROOT):
        self.dir = os.path.join(root, project, name)
        os.makedirs(self.dir, exist_ok=True)
        self.name = name
        self._summary: dict = {}
        self._history = open(os.path.join(self.dir, "history.jsonl"), "a")
        if config is not None:
            items = (dataclasses.asdict(config) if dataclasses.is_dataclass(config)
                     else dict(vars(config)))
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump(items, f, indent=1, default=str)
        meta = {
            "program": (argv or ["?"])[0],
            "args": list(argv or [])[1:],
            "startedAt": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "state": "running",
        }
        self._meta_path = os.path.join(self.dir, "wandb-metadata.json")
        with open(self._meta_path, "w") as f:
            json.dump(meta, f, indent=1)

    def log(self, values: Mapping[str, Any], step: int) -> None:
        row = {k: float(v) for k, v in values.items()}
        row["_step"] = int(step)
        row["_timestamp"] = time.time()
        self._history.write(json.dumps(row) + "\n")
        self._history.flush()
        self._summary.update(row)

    def finish(self, state: str = "finished") -> None:
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(self._summary, f, indent=1)
        with open(self._meta_path) as f:
            meta = json.load(f)
        meta["state"] = state
        with open(self._meta_path, "w") as f:
            json.dump(meta, f, indent=1)
        self._history.close()


def init(project: str, name: str, config: Optional[Any] = None,
         argv: Optional[Sequence[str]] = None, root: str = ROOT) -> Run:
    return Run(project, name, config, argv, root)


def load_history(run_dir: str):
    """(steps, {key: values}) arrays from a run's history.jsonl, or None."""
    path = os.path.join(run_dir, "history.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    if not rows:
        return None
    keys = set().union(*(r.keys() for r in rows)) - {"_step", "_timestamp"}
    steps = np.array([r["_step"] for r in rows])
    series = {k: np.array([r.get(k, np.nan) for r in rows], dtype=np.float64) for k in keys}
    return steps, series
