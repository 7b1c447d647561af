"""Per-run figures — the reference's cleanrl_utils/plot_individual.py
without the wandb dependency; port of ``mmtrl_tpu/utils/plot_individual.py``:
one PNG per run, every logged metric as a subplot, raw + EMA-smoothed
overlay, read through ``core/metrics.py::read_scalars``.

    python -m mmtrl_tpu_torch.utils.plot_individual --runs-dir runs --out-dir plots/individual
"""

from __future__ import annotations

import argparse
import glob
import os

from mmtrl_tpu_torch.core.metrics import read_scalars
from mmtrl_tpu_torch.utils.plot import smooth


def load_run_metrics(run_dir: str):
    """{tag: (steps, values)} of every scalar the run logged."""
    return read_scalars(run_dir)


def plot_run(run_dir: str, out_dir: str, smooth_weight: float) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = load_run_metrics(run_dir)
    if not metrics:
        return ""
    name = os.path.basename(run_dir)
    tags = sorted(metrics)
    ncols = 3
    nrows = -(-len(tags) // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(4.2 * ncols, 2.8 * nrows), squeeze=False
    )
    for i, tag in enumerate(tags):
        ax = axes[i // ncols][i % ncols]
        steps, values = metrics[tag]
        ax.plot(steps, values, color="#9ecae1", linewidth=0.8)
        if len(values) > 2:
            ax.plot(
                steps, smooth(values, smooth_weight), color="#08519c",
                linewidth=1.6,
            )
        ax.set_title(tag, fontsize=9)
        ax.spines[["top", "right"]].set_visible(False)
    for k in range(len(tags), nrows * ncols):
        axes[k // ncols][k % ncols].axis("off")
    fig.suptitle(name, fontsize=10)
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs-dir", default="runs")
    parser.add_argument("--out-dir", default="plots/individual")
    parser.add_argument("--smooth", type=float, default=0.9)
    parser.add_argument("--pattern", default="*", help="run-name glob filter")
    args = parser.parse_args(argv)

    count = 0
    for run_dir in sorted(glob.glob(os.path.join(args.runs_dir, args.pattern))):
        if not os.path.isdir(run_dir):
            continue
        path = plot_run(run_dir, args.out_dir, args.smooth)
        if path:
            print(f"wrote {path}")
            count += 1
    print(f"{count} run figures in {args.out_dir}")


if __name__ == "__main__":
    main()
