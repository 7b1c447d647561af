"""Crash-resume tooling, the reference's cleanrl_utils/resume.py pattern;
port of ``mmtrl_tpu/utils/resume.py``.

Every training run journals its argv into a local manifest
(``runs_manifest.jsonl`` in the working directory, the JAX package's file
and record): "running" at its start and "finished" at its end.  This tool
lists the runs whose last record is "running" and prints (or executes) the
exact command that resumes each, with ``--load-from`` pointed at its
checkpoint under ``saved_agents/``.

    python -m mmtrl_tpu_torch.utils.resume --list
    python -m mmtrl_tpu_torch.utils.resume --resume --execute
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time
from typing import List

MANIFEST = "runs_manifest.jsonl"


def journal_run(run_name: str, argv: List[str], status: str = "running") -> None:
    """Append a run record; the runners call this at start and completion."""
    with open(MANIFEST, "a") as f:
        f.write(json.dumps({"run_name": run_name, "argv": argv, "status": status,
                            "time": time.time()}) + "\n")


def load_manifest() -> dict:
    """{run_name: its last record}."""
    runs = {}
    if not os.path.exists(MANIFEST):
        return runs
    with open(MANIFEST) as f:
        for line in f:
            rec = json.loads(line)
            runs[rec["run_name"]] = rec  # last record wins
    return runs


def find_checkpoint(run_name: str, save_dir: str = "saved_agents") -> str:
    path = os.path.join(save_dir, run_name)
    return path if os.path.exists(path) else ""


def resume_command(rec: dict) -> str:
    argv = list(rec["argv"])
    ckpt = find_checkpoint(rec["run_name"])
    if ckpt and "--load-from" not in argv:
        argv += ["--load-from", ckpt]
    return f"{sys.executable} " + " ".join(shlex.quote(a) for a in argv)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--list", action="store_true", help="list unfinished runs")
    parser.add_argument("--resume", action="store_true", help="print resume commands")
    parser.add_argument("--execute", action="store_true", help="run them")
    args = parser.parse_args(argv)

    runs = load_manifest()
    crashed = [r for r in runs.values() if r["status"] == "running"]
    if args.list or not (args.resume or args.execute):
        for r in crashed:
            print(f"{r['run_name']}  (started {time.ctime(r['time'])})")
        print(f"{len(crashed)} unfinished runs")
        return
    for r in crashed:
        cmd = resume_command(r)
        print(cmd)
        if args.execute:
            subprocess.run(shlex.split(cmd), check=False)


if __name__ == "__main__":
    main()
