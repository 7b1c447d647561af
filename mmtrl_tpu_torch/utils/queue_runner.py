"""Local experiment queue — the reference's cleanrl_utils/docker_queue.py
without the docker daemon (port of
``mmtrl_tpu/utils/queue_runner.py``): parses a shell script of training commands, pins
one process per worker slot, polls and refills as they exit (the reference
pins one container per vCPU and polls container status, :50-85).

    python -m mmtrl_tpu_torch.utils.queue_runner --exp-script experiments.sh --workers 2
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import time
from typing import List, Optional


def parse_exp_script(path: str) -> List[str]:
    commands = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                commands.append(line)
    return commands


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp-script", required=True)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--poll-interval", type=float, default=2.0)
    args = parser.parse_args(argv)

    queue = parse_exp_script(args.exp_script)
    print(f"{len(queue)} commands, {args.workers} workers")
    slots: List[Optional[subprocess.Popen]] = [None] * args.workers
    failures = 0
    while queue or any(slots):
        for i, proc in enumerate(slots):
            if proc is not None and proc.poll() is not None:
                if proc.returncode != 0:
                    failures += 1
                    print(f"slot {i}: FAILED ({proc.returncode})")
                slots[i] = None
            if slots[i] is None and queue:
                cmd = queue.pop(0)
                print(f"slot {i}: {cmd}")
                slots[i] = subprocess.Popen(shlex.split(cmd))
        time.sleep(args.poll_interval)
    print(f"queue drained, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
