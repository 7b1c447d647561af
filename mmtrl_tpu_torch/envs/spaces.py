"""Space descriptions (gym-compatible surface); port of
``mmtrl_tpu/envs/spaces.py``, numpy only."""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int
    dtype: np.dtype = np.int32

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def contains(self, x) -> bool:
        return bool(0 <= int(x) < self.n)


@dataclasses.dataclass(frozen=True)
class Box:
    low: Union[float, np.ndarray]
    high: Union[float, np.ndarray]
    shape: Tuple[int, ...]
    dtype: np.dtype = np.float32

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(
            x.shape == self.shape and np.all(x >= self.low) and np.all(x <= self.high)
        )
