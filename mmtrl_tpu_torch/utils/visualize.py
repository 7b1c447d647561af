"""Env/attention visualization — the CASL wrapper's visualize_env panel
(reference: src/environments/casl_environment.py:136-161): current video
frame, current audio spectrogram image, and the attention-weight time series
side by side.  Also a GIF writer standing in for gym's RecordVideo
(--capture-video) for the device-resident envs, on ``utils/video.py``'s
encoder.  Port of ``mmtrl_tpu/utils/visualize.py``; matplotlib is imported
only to draw.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from mmtrl_tpu_torch.utils.video import write_gif


def visualize_env(
    obs: np.ndarray,  # (2, 84, 84) in [-1, 1]
    attention_history: Optional[Sequence[float]] = None,
    out_path: Optional[str] = None,
):
    """Render (video, audio, attention-over-time) panel; returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = 3 if attention_history is not None else 2
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3.5))
    axes[0].imshow(np.asarray(obs[0]), cmap="gray", vmin=-1, vmax=1)
    axes[0].set_title("video")
    axes[1].imshow(np.asarray(obs[1]), cmap="viridis", vmin=-1, vmax=1)
    axes[1].set_title("audio (MFCC)")
    for ax in axes[:2]:
        ax.set_xticks([])
        ax.set_yticks([])
    if attention_history is not None:
        hist = np.asarray(attention_history)
        axes[2].plot(hist, label="video weight")
        axes[2].plot(1.0 - hist, label="audio weight")
        axes[2].set_ylim(0, 1)
        axes[2].set_title("crossmodal attention")
        axes[2].legend()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=100)
    return fig


def save_episode_gif(
    frames: np.ndarray,  # (T, H, W) in [-1, 1] (obs channel 0 over time)
    out_path: str,
    fps: int = 8,
) -> str:
    """Write an episode video as a GIF — the --capture-video equivalent for
    device-resident envs (reference wraps RecordVideo, src/train.py:53-55);
    native resolution, ``int(1000 / fps)`` ms a frame, looping."""
    frames_u8 = np.stack([((np.asarray(f) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
                          for f in frames])
    return write_gif(frames_u8, out_path, fps=fps, size=None)
