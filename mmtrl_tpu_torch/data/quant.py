"""The host loops' fixed-point codes; port of ``mmtrl_tpu/data/quant.py``.

- **obs int8, 1/127 granularity**: observations lie in [-1, 1], so
  ``round(x * 127)`` keeps them at training precision and quarters the
  host dataset.
- **audio u8, 1/15 granularity**: TIA audio volumes are 4-bit (AUDV
  0..15) and the emulator emits them as [0, 1] floats, so a 1/15 code is
  exact.

The DQN host loop's replay ring stores the int8 code.  The PPO and DT
host loops quantise each step's audio on the host and build
the observation from the dequantised code, as the JAX loops do, so their
rollouts see the same observations.
"""

from __future__ import annotations

import numpy as np
import torch

OBS_SCALE = 127.0  # int8 code for [-1, 1] observations
AUDIO_SCALE = 15.0  # u8 code for 4-bit TIA volumes in [0, 1]


def quant_obs_i8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float obs -> int8 (round half to even, as ``jnp.rint``)."""
    return torch.clamp(torch.round(x * OBS_SCALE), -127, 127).to(torch.int8)


def dequant_obs_i8(x: torch.Tensor) -> torch.Tensor:
    """int8 obs code -> float32 in [-1, 1]."""
    return x.float() / OBS_SCALE


def quant_audio_u8(audio: np.ndarray) -> np.ndarray:
    """[0, 1] host audio volumes -> u8 (exact for 4-bit TIA levels)."""
    return np.rint(audio * AUDIO_SCALE).astype(np.uint8)


def dequant_audio_u8(audio_u8: torch.Tensor) -> torch.Tensor:
    """u8 audio code -> float32 volumes in [0, 1]."""
    return audio_u8.float() / AUDIO_SCALE
