"""Checkpoint / resume with the reference's save-interval/load-from
semantics; port of ``mmtrl_tpu/core/checkpoint.py``.

The reference pickles its whole run dict to ``<save_dir>/<run_name>.pkl``
(src/utils.py:23-44).  Here a run is the directory ``<save_dir>/<run_name>``
holding ``state.pt``, a ``torch.save`` of a payload of tensors, numbers,
strings, lists and dicts only, so it loads under
``torch.load(weights_only=True)`` (a generator's state is its uint8
tensor) and unpickles no Python object.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

FILE = "state.pt"


def _path(save_dir: str, run_name: str) -> str:
    return os.path.abspath(os.path.join(save_dir, run_name))


def save_run(payload: Dict[str, Any], run_name: str, save_dir: str = "saved_agents") -> str:
    """Save a payload; overwrites any previous save of the run.

    Crash-safe: the payload is written to a temp sibling directory and
    swapped in with two renames, so a kill mid-save leaves the previous
    checkpoint intact.  The ``_tmp_``/``_old_`` prefixes keep the transient
    directories out of ``<run_name>*`` globs."""
    path = _path(save_dir, run_name)
    tmp = _path(save_dir, f"_tmp_{run_name}")
    old = _path(save_dir, f"_old_{run_name}")
    os.makedirs(save_dir, exist_ok=True)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, FILE))
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)
    print(f"saved run to {path}")
    return path


def load_run(path: str, map_location: Optional[Any] = None) -> Dict[str, Any]:
    """The payload of a saved run, its tensors on ``map_location`` (where
    they were saved when None)."""
    payload = torch.load(os.path.join(os.path.abspath(path), FILE),
                         map_location=map_location, weights_only=True)
    print(f"loaded run from {path}")
    return payload
