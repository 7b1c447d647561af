"""Profiling / tracing hooks; port of ``mmtrl_tpu/utils/profiling.py``.

The reference has no profiler integration, only charts/SPS counters
(SURVEY.md §5).  Here tracing is first-class: a ``torch.profiler`` trace
around a training window (CPU and, on the card, CUDA activity; written for
TensorBoard's profile plugin or Perfetto) and a lightweight phase timer
that logs per-phase wall-clock (rollout/update/eval) as TensorBoard
scalars.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


def start_trace(log_dir: str = "profiles", cuda: Optional[bool] = None):
    """A started ``torch.profiler.profile`` whose ``stop()`` writes its trace
    under ``log_dir``; CUDA activity is recorded when ``cuda`` (default:
    whenever a card is present)."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    profiler.start()
    return profiler


@contextlib.contextmanager
def trace(log_dir: str = "profiles") -> Iterator[None]:
    """Capture a trace for the enclosed block (CUDA activity too when a card
    is present).

        with profiling.trace("profiles/run1"):
            for _ in range(5):
                runner, _ = algo.train_iteration(runner)
    """
    profiler = start_trace(log_dir)
    try:
        yield
    finally:
        profiler.stop()


class PhaseTimer:
    """Accumulates wall-clock per named phase.  Work queued on the card is
    timed only when the phase waits for it: pass a tensor of the phase's
    result (or a list, tuple or dict of them) as ``block_on`` and the timer
    synchronises each one's CUDA device before it stops the clock."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if isinstance(block_on, dict):
            block_on = list(block_on.values())
        elif not isinstance(block_on, (list, tuple)):
            block_on = [block_on]
        for device in {t.device for t in block_on if isinstance(t, torch.Tensor) and t.is_cuda}:
            torch.cuda.synchronize(device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def averages(self) -> Dict[str, float]:
        return {
            f"profile/{name}_ms": 1e3 * self.totals[name] / max(self.counts[name], 1)
            for name in self.totals
        }

    def report(self, writer=None, step: Optional[int] = None) -> Dict[str, float]:
        avgs = self.averages()
        if writer is not None and step is not None:
            for tag, val in avgs.items():
                writer.scalar(tag, val, step)
        return avgs
