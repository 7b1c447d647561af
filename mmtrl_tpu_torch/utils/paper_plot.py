"""Publication-style aggregated learning curves — the reference's
cleanrl_utils/paper_plot.py without the wandb dependency; port of
``mmtrl_tpu/utils/paper_plot.py``.

Groups runs by (env_id, exp_name), interpolates each seed's curve onto a
common step grid, and draws mean +/- std bands per environment panel with a
shared exported legend.  Runs come from local TensorBoard event files
(runs/) and/or the wandb-compatible journal (wandb_local/).

    python -m mmtrl_tpu_torch.utils.paper_plot --metric charts/episodic_return \
        --output plots/paper.png
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from mmtrl_tpu_torch.utils.plot import load_runs, smooth
from mmtrl_tpu_torch.utils.wandb_local import load_history


def load_journal_runs(
    journal_dir: str, metric: str
) -> Dict[Tuple[str, str], List[Tuple[np.ndarray, np.ndarray]]]:
    """Read wandb_local histories, grouped like plot.load_runs."""
    grouped = defaultdict(list)
    for run_dir in sorted(glob.glob(os.path.join(journal_dir, "*", "*"))):
        name = os.path.basename(run_dir)
        parts = name.split("__")
        if len(parts) < 3:
            continue
        out = load_history(run_dir)
        if out is None:
            continue
        steps, series = out
        if metric not in series:
            continue
        mask = ~np.isnan(series[metric])
        if mask.sum():
            grouped[(parts[0], parts[1])].append(
                (steps[mask], series[metric][mask])
            )
    return grouped


def aggregate(
    curves: List[Tuple[np.ndarray, np.ndarray]], num_points: int = 200
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Common-grid interpolation -> (grid, mean, std) across seeds."""
    hi = min(float(s[-1]) for s, _ in curves)
    lo = max(float(s[0]) for s, _ in curves)
    grid = np.linspace(lo, max(hi, lo + 1), num_points)
    stack = np.stack(
        [np.interp(grid, s, smooth(v)) for s, v in curves]
    )
    return grid, stack.mean(axis=0), stack.std(axis=0)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs-dir", default="runs")
    parser.add_argument("--journal-dir", default="wandb_local")
    parser.add_argument("--metric", default="charts/episodic_return")
    parser.add_argument("--output", default="plots/paper_plot.png")
    parser.add_argument("--ncols", type=int, default=3)
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grouped = defaultdict(list)
    if os.path.isdir(args.runs_dir):
        for k, v in load_runs(args.runs_dir, args.metric).items():
            grouped[k].extend(v)
    if os.path.isdir(args.journal_dir):
        for k, v in load_journal_runs(args.journal_dir, args.metric).items():
            grouped[k].extend(v)
    if not grouped:
        print("no runs found")
        return

    envs = sorted({env for env, _ in grouped})
    exps = sorted({exp for _, exp in grouped})
    ncols = min(args.ncols, len(envs))
    nrows = -(-len(envs) // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(4.2 * ncols, 3.2 * nrows), squeeze=False
    )
    colors = plt.cm.tab10.colors
    handles = {}
    for i, env in enumerate(envs):
        ax = axes[i // ncols][i % ncols]
        for j, exp in enumerate(exps):
            curves = grouped.get((env, exp))
            if not curves:
                continue
            grid, mean, std = aggregate(curves)
            (line,) = ax.plot(grid, mean, color=colors[j % 10], linewidth=1.6)
            ax.fill_between(
                grid, mean - std, mean + std, color=colors[j % 10], alpha=0.2
            )
            handles[exp] = line
        ax.set_title(env)
        ax.set_xlabel("global step")
        ax.set_ylabel(args.metric.split("/")[-1])
        ax.spines[["top", "right"]].set_visible(False)
    for k in range(len(envs), nrows * ncols):
        axes[k // ncols][k % ncols].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    fig.savefig(args.output, dpi=150)

    # separate legend export, reference plot.py:162
    legend_fig = plt.figure(figsize=(4, 0.4 * max(1, len(handles))))
    legend_fig.legend(
        handles.values(), handles.keys(), loc="center", frameon=False
    )
    legend_path = os.path.splitext(args.output)[0] + "_legend.png"
    legend_fig.savefig(legend_path, dpi=150, bbox_inches="tight")
    print(f"wrote {args.output} and {legend_path} "
          f"({len(envs)} envs, {len(exps)} experiments)")


if __name__ == "__main__":
    main()
