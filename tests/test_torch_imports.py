"""The port and its scripts stand alone: no jax, flax, optax, orbax, cv2,
PIL, tensorboard or mmtrl_tpu import anywhere in them (the card machine
has none of them), each run-tooling module imports with PIL, tensorboard,
matplotlib and optuna blocked, and chip_smoke.py fails without CUDA or
without the package."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "tensorboard", "mmtrl_tpu"}
SCRIPTS = [REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_serve.py",
           REPO / "tools" / "count_classic_ops.py", REPO / "tools" / "count_level_ops.py",
           # the rank processes of tests/test_torch_parallel.py
           REPO / "tests" / "torch_parallel_worker.py"]
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


CLASSIC_MODULES = [
    "envs/classic/__init__.py", "envs/classic/_base.py", "envs/classic/cartpole.py",
    "envs/classic/acrobot.py", "envs/classic/mountain_car.py", "algos/offpolicy/runner.py",
    "scripts/dqn.py", "scripts/c51.py", "scripts/ppo.py",
    # the continuous half
    "envs/classic/pendulum.py", "envs/wrappers.py", "models/distributions.py",
    "models/agents.py", "algos/ppo/core.py", "algos/offpolicy/ddpg.py",
    "algos/offpolicy/td3.py", "algos/offpolicy/sac.py", "convert.py",
    "scripts/ppo_continuous_action.py", "scripts/rpo_continuous_action.py",
    "scripts/ddpg_continuous_action.py", "scripts/td3_continuous_action.py",
    "scripts/sac_continuous_action.py",
    # procmaze and the two-agent Minecraft2d
    "envs/procmaze.py", "envs/minecraft2d_ma.py", "scripts/ppg.py",
    "scripts/ppo_ma_minecraft.py",
    # Doorpuzzle and the two-player Pong
    "envs/doorpuzzle.py", "envs/pong_ma.py", "envs/assets.py", "envs/registry.py",
    "algos/hostpool.py", "algos/ppo/hostloop.py", "scripts/ppo_ma_pong.py",
    # the native pools in the fused loops, and the two raw bridges
    "envs/skeleton_native.py", "utils/evaluate.py", "envs/native_bridge.py",
    "envs/atari_bridge.py",
    # the gymnasium bridge, the off-policy host loop and the evaluation tools
    "envs/gym_bridge.py", "algos/offpolicy/hostloop.py", "tools/__init__.py",
    "tools/eval_pong.py", "tools/eval_rom_policy.py",
] + [f"utils/{name}.py" for name in (
    # the run tooling: the journal, its readers, video, profiling, the tuner
    "wandb_local", "resume", "reproduce", "video", "profiling", "plot", "plot_individual",
    "paper_plot", "tuner", "visualize", "benchmark", "queue_runner", "submit_exp",
    "docker_build", "add_header")] + [
    # the multi-device axes
    "core/distributed.py"] + [f"parallel/{name}.py" for name in (
        "__init__", "mesh", "collectives", "sharding", "ring_attention", "seq_composed",
        "expert", "pipeline")]
# imported only inside the functions that draw (matplotlib) or nowhere;
# the card's machine has none of them
BLOCKED = ("PIL", "tensorboard", "matplotlib", "optuna")


@pytest.mark.parametrize("name", CLASSIC_MODULES)
def test_classic_modules_are_scanned(name):
    """The later slices' modules (classic control, discrete and continuous;
    procmaze and the two-agent env; Doorpuzzle and the two-player Pong; the
    native pools' fused surface and the two raw bridges; the gymnasium
    bridge, the off-policy host loop and the tools; the run tooling; the
    multi-device axes) are
    among the scanned sources, so the two tests above cover them."""
    assert REPO / "mmtrl_tpu_torch" / name in SOURCES


@pytest.mark.parametrize("name", [m for m in CLASSIC_MODULES if m.startswith("utils/")]
                         + ["core/metrics.py", "ops/mfcc.py", "envs/wrappers.py"])
def test_run_tooling_imports_with_drawing_and_tensorboard_blocked(name):
    """Each module imports in a fresh process in which PIL, tensorboard,
    matplotlib and optuna cannot be imported, and loads none of jax or
    mmtrl_tpu."""
    module = "mmtrl_tpu_torch." + name.removesuffix(".py").replace("/", ".")
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, fullname, path=None, target=None):\n"
        f"        if fullname.split('.')[0] in {BLOCKED!r}:\n"
        "            raise ImportError(f'{fullname} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"import {module}\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


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
