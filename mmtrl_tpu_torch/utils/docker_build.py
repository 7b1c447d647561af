"""Image build wrapper — the reference's cleanrl_utils/docker_build.py;
port of ``mmtrl_tpu/utils/docker_build.py``.

    python -m mmtrl_tpu_torch.utils.docker_build --tag mmtrl-tpu:latest [--push]
"""

from __future__ import annotations

import argparse
import subprocess


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tag", default="mmtrl-tpu:latest")
    parser.add_argument("--push", action="store_true")
    args = parser.parse_args(argv)
    rc = subprocess.run(["docker", "build", "-t", args.tag, "."]).returncode
    if rc == 0 and args.push:
        rc = subprocess.run(["docker", "push", args.tag]).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
