"""Docs-header inserter — the reference's cleanrl_utils/add_header.py
(port of ``mmtrl_tpu/utils/add_header.py``):
prepends a docs-site pointer comment to entry scripts that lack one.

    python -m mmtrl_tpu_torch.utils.add_header scripts/*.py
"""

from __future__ import annotations

import sys

HEADER = "# docs and experiment results: see docs/algorithms.md\n"


def main(paths) -> None:
    for path in paths:
        with open(path) as f:
            src = f.read()
        if src.startswith(HEADER) or not path.endswith(".py"):
            continue
        with open(path, "w") as f:
            f.write(HEADER + src)
        print(f"added header to {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
