"""The exploration schedule of the off-policy trainers; port of
``linear_epsilon`` in ``mmtrl_tpu/algos/offpolicy/common.py``."""

from __future__ import annotations

import numpy as np


def linear_epsilon(start_e: float, end_e: float, duration: float, step: int) -> np.float32:
    """The reference's linear schedule for epsilon-greedy (cleanrl/dqn.py),
    as the compiled JAX step computes it: the float32 slope times the step
    plus ``start_e`` rounded once to float32 (XLA fuses the two into one
    multiply-add), so a uniform draw falls on the same side of it."""
    slope = float(np.float32((end_e - start_e) / duration))
    return max(np.float32(slope * step + start_e), np.float32(end_e))
