"""The port and its scripts stand alone: no jax, flax, cv2, PIL or
mmtrl_tpu import anywhere in them, and chip_smoke.py fails without CUDA or
without the package."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cv2", "PIL", "mmtrl_tpu"}
SCRIPTS = [REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_serve.py"]
SOURCES = sorted((REPO / "mmtrl_tpu_torch").rglob("*.py")) + SCRIPTS


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_forbidden(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_importing_the_port_loads_nothing_forbidden():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES[: -len(SCRIPTS)]
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_chip_smoke_fails_without_cuda():
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
