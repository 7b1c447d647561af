"""Space descriptions (gym-compatible surface); port of
``mmtrl_tpu/envs/spaces.py``.  ``sample`` draws from an explicit
``torch.Generator`` (on its device) where JAX takes a PRNG key."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch


def _device(generator: Optional[torch.Generator]) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int
    dtype: np.dtype = np.int32

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A uniform int32 in [0, n)."""
        return torch.randint(0, self.n, (), generator=generator, dtype=torch.int32,
                             device=_device(generator))

    def contains(self, x) -> bool:
        return bool(0 <= int(x) < self.n)


@dataclasses.dataclass(frozen=True)
class Box:
    low: Union[float, np.ndarray]
    high: Union[float, np.ndarray]
    shape: Tuple[int, ...]
    dtype: np.dtype = np.float32

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Uniform in [low, high) elementwise, as ``jax.random.uniform``
        with ``minval`` and ``maxval`` draws it."""
        device = _device(generator)
        dtype = torch.from_numpy(np.zeros((), self.dtype)).dtype
        lo, hi = (torch.as_tensor(np.asarray(b, self.dtype), device=device).expand(self.shape)
                  for b in (self.low, self.high))
        u = torch.rand(self.shape, generator=generator, dtype=dtype, device=device)
        return lo + (hi - lo) * u

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(
            x.shape == self.shape and np.all(x >= self.low) and np.all(x <= self.high)
        )
