"""Run reproduction helper, the reference's cleanrl_utils/reproduce.py;
port of ``mmtrl_tpu/utils/reproduce.py``.

Given a run name in the runs manifest (``utils/resume.py``), prints a
self-contained recipe (git checkout, venv, install, the exact command)
that reproduces the run (reference :44-52 prints it from wandb metadata;
here the manifest and git are the source).

    python -m mmtrl_tpu_torch.utils.reproduce --run-name CartPole-v1__ppo__1__123456
"""

from __future__ import annotations

import argparse
import shlex
import subprocess

from mmtrl_tpu_torch.utils.resume import load_manifest


def git_rev() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                              text=True).stdout.strip()
    except Exception:
        return "<unknown>"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--run-name", required=True)
    args = parser.parse_args(argv)
    rec = load_manifest().get(args.run_name)
    if rec is None:
        raise SystemExit(f"run {args.run_name!r} not in manifest")
    cmd = " ".join(shlex.quote(a) for a in rec["argv"])
    print("\n".join([
        f"# reproduce {args.run_name}",
        f"git checkout {git_rev()}",
        "python -m venv .venv && source .venv/bin/activate",
        "pip install -e .",
        f"python {cmd}",
    ]))


if __name__ == "__main__":
    main()
