"""Learning-curve plotting — the reference's cleanrl_utils/plot.py without
the wandb dependency; port of ``mmtrl_tpu/utils/plot.py``.  Runs are read
from local TensorBoard event files (runs/<env>__<exp>__<seed>__<time>)
through ``core/metrics.py::read_scalars`` (no TensorBoard), EMA-smoothed
(reference's `smooth`, plot.py:118), grouped by (env_id, exp_name), and
drawn as per-env panels with a separate legend export (reference
plot.py:162).  matplotlib is imported only to draw.

    python -m mmtrl_tpu_torch.utils.plot --runs-dir runs --metric charts/episodic_return
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from mmtrl_tpu_torch.core.metrics import read_scalars


def smooth(values: np.ndarray, weight: float = 0.9) -> np.ndarray:
    """TensorBoard-style exponential moving average."""
    out = np.empty_like(values, dtype=np.float64)
    last = values[0]
    for i, v in enumerate(values):
        last = last * weight + (1 - weight) * v
        out[i] = last
    return out


def load_runs(
    runs_dir: str, metric: str
) -> Dict[Tuple[str, str], List[Tuple[np.ndarray, np.ndarray]]]:
    grouped = defaultdict(list)
    for run_dir in sorted(glob.glob(os.path.join(runs_dir, "*"))):
        name = os.path.basename(run_dir)
        parts = name.split("__")
        if len(parts) < 3:
            continue
        env_id, exp_name = parts[0], parts[1]
        scalars = read_scalars(run_dir)
        if metric not in scalars:
            continue
        steps, values = scalars[metric]
        if len(values):
            grouped[(env_id, exp_name)].append((steps, values))
    return grouped


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs-dir", default="runs")
    parser.add_argument("--metric", default="charts/episodic_return")
    parser.add_argument("--smooth-weight", type=float, default=0.9)
    parser.add_argument("--output", default="plots")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grouped = load_runs(args.runs_dir, args.metric)
    if not grouped:
        print(f"no runs with metric {args.metric} under {args.runs_dir}")
        return
    env_ids = sorted({env for env, _ in grouped})
    os.makedirs(args.output, exist_ok=True)

    ncols = min(len(env_ids), 3)
    nrows = -(-len(env_ids) // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(5 * ncols, 3.5 * nrows), squeeze=False
    )
    handles, labels = [], []
    for i, env_id in enumerate(env_ids):
        ax = axes[i // ncols][i % ncols]
        for (env, exp), runs in sorted(grouped.items()):
            if env != env_id:
                continue
            # align seeds on the shortest run
            min_len = min(len(v) for _, v in runs)
            stack = np.stack([smooth(v[:min_len], args.smooth_weight) for _, v in runs])
            steps = runs[0][0][:min_len]
            mean, std = stack.mean(0), stack.std(0)
            (line,) = ax.plot(steps, mean, label=exp)
            ax.fill_between(steps, mean - std, mean + std, alpha=0.2)
            if exp not in labels:
                handles.append(line)
                labels.append(exp)
        ax.set_title(env_id)
        ax.set_xlabel("global step")
    fig.tight_layout()
    fig.savefig(os.path.join(args.output, "curves.png"), dpi=120)
    # separate legend export, like the reference
    leg_fig = plt.figure(figsize=(4, 1 + 0.3 * len(labels)))
    leg_fig.legend(handles, labels, loc="center")
    leg_fig.savefig(os.path.join(args.output, "legend.png"), dpi=120)
    print(f"wrote {args.output}/curves.png ({len(grouped)} run groups)")


if __name__ == "__main__":
    main()
