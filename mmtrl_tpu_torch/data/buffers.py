"""The uniform replay ring of the off-policy host loops; port of
``ReplayBuffer`` in ``mmtrl_tpu/data/buffers.py``.

Storage is a dict of tensors with the capacity on dim 0, kept on one
device, so the write and the sample of a pool step stay there.  The ring
is written in place (JAX returns a new buffer); ``pos`` and ``size`` are
host integers, because every write adds a batch of known size.  The JAX
module's ``SumTree`` and ``PrioritizedReplayBuffer`` are not ported yet
(ROADMAP A.6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ReplayBuffer:
    data: Batch  # each (capacity, ...)
    pos: int = 0  # next write index
    size: int = 0  # valid entries

    @classmethod
    def create(cls, example: Batch, capacity: int) -> "ReplayBuffer":
        """An empty ring of ``capacity`` entries shaped, typed and placed
        as the tensors of ``example`` (one transition)."""
        return cls(data={k: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                                        device=x.device)
                         for k, x in example.items()})

    @property
    def capacity(self) -> int:
        return next(iter(self.data.values())).shape[0]

    def add_batch(self, batch: Batch, n: int) -> "ReplayBuffer":
        """Write ``n`` transitions (leading dim ``n``) at ``pos``, wrapping
        around the end by modular indices."""
        cap = self.capacity
        device = next(iter(self.data.values())).device
        idx = (self.pos + torch.arange(n, device=device)) % cap
        for k, buf in self.data.items():
            buf[idx] = batch[k].to(buf.dtype)
        self.pos = (self.pos + n) % cap
        self.size = min(self.size + n, cap)
        return self

    def sample(self, generator: Optional[torch.Generator], batch_size: int,
               indices: Optional[torch.Tensor] = None) -> Batch:
        """``batch_size`` transitions uniform over the filled entries;
        ``indices`` replaces the generator's draw, so a test can replay
        another implementation's."""
        device = next(iter(self.data.values())).device
        if indices is None:
            indices = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                                    device=device)
        return {k: buf[indices.to(device)] for k, buf in self.data.items()}
