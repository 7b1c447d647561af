"""The replay buffers of the off-policy trainers; port of
``mmtrl_tpu/data/buffers.py``: the uniform ring, the sum-tree and the
prioritized buffer on it.

Storage is a dict of tensors with the capacity on dim 0, kept on one
device, so the write and the sample of a step stay there.  The buffers are
written in place (JAX returns new ones); ``pos`` and ``size`` are host
integers, because every write adds a batch of known size.

The sum-tree's arithmetic is JAX's, in float32 and in its order, so from
the same uniforms the descent picks the same leaves bit for bit.  Two
choices keep its bits the same on every device:

- a write with repeated leaf indices (PER samples with replacement) keeps
  the LAST occurrence's value; JAX's ``.at[].set`` and torch's
  ``index_put_`` leave the winner undefined, and on the card it varies;
- ``priority ** alpha`` is taken in float64 and rounded once to float32:
  float32 ``pow`` differs by an ulp between libraries (and between the
  card and the CPU), while the float64 power rounds to the same float32
  on both.  It matches XLA's float32 ``power`` in all but about 0.07% of
  inputs, by one ulp where it does not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
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


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _pow32(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """``x ** exponent`` of float32 ``x`` and the float32 exponent,
    through float64 (module docstring)."""
    return (x.double() ** float(np.float32(exponent))).float()


def last_occurrence(idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` with each entry replaced by that of the last entry of
    ``idx`` equal to its own, so a write of repeated indices is the same
    whichever duplicate lands last."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.where(idx[:, None] == idx[None, :], pos, -1).amax(dim=1)
    return values[last]


@dataclasses.dataclass
class SumTree:
    """Flat binary sum-tree: node i has children 2i and 2i + 1, the root is
    node 1 and the leaves are ``[capacity, 2 * capacity)`` (the reference's
    SumSegmentTree, cleanrl_utils/buffers.py:98-146)."""

    nodes: torch.Tensor  # (2 * capacity,) float32

    @classmethod
    def create(cls, capacity: int, device=None) -> "SumTree":
        assert capacity == _next_pow2(capacity), "capacity must be a power of 2"
        return cls(nodes=torch.zeros(2 * capacity, dtype=torch.float32, device=device))

    @property
    def capacity(self) -> int:
        return self.nodes.shape[0] // 2

    @property
    def total(self) -> torch.Tensor:
        return self.nodes[1]

    def update(self, idx: torch.Tensor, values: torch.Tensor) -> "SumTree":
        """Set the leaves at ``idx`` (a repeated index takes its last
        value) and repair the levels above, bottom up.  Each level is
        recomputed whole, one add a level: a parent is one float32 add of
        its two children, so the nodes JAX's ancestor-only repair leaves
        alone get back their own bits, and the tree is JAX's bit for bit
        at ``log2(capacity)`` launches."""
        cap = self.capacity
        self.nodes[idx + cap] = last_occurrence(idx, values.to(self.nodes.dtype))
        width = cap // 2
        while width:
            children = self.nodes[2 * width:4 * width]
            torch.add(children[0::2], children[1::2], out=self.nodes[width:2 * width])
            width //= 2
        return self

    def sample(self, generator: Optional[torch.Generator], batch_size: int,
               uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stratified prefix-sum descent: leaf indices (batch,), the i-th
        drawn from the i-th of ``batch_size`` equal slices of the total
        mass.  ``uniforms`` (batch,) in [0, 1) replaces the generator's
        draw, so a test can replay another implementation's."""
        device = self.nodes.device
        if uniforms is None:
            uniforms = torch.rand(batch_size, generator=generator, device=device)
        bounds = torch.arange(batch_size, device=device, dtype=torch.float32) / batch_size
        mass = (bounds + uniforms.to(device, torch.float32) / batch_size) * self.total
        node = torch.ones(batch_size, dtype=torch.long, device=device)
        for _ in range(self.capacity.bit_length() - 1):
            left = 2 * node
            left_sum = self.nodes[left]
            go_right = mass >= left_sum
            node = torch.where(go_right, left + 1, left)
            mass = torch.where(go_right, mass - left_sum, mass)
        return node - self.capacity

    def get(self, idx: torch.Tensor) -> torch.Tensor:
        return self.nodes[idx + self.capacity]


@dataclasses.dataclass
class PrioritizedReplayBuffer:
    """PER (Schaul et al.) with alpha-priorities and beta-annealed
    importance-sampling weights, the reference's PrioritizedReplayBuffer
    (cleanrl_utils/buffers.py:581-700) on the sum-tree.  The capacity is
    rounded up to a power of two (10,000 becomes 16,384), so the ring wraps
    later than the uniform ring of the same ``buffer_size``."""

    buffer: ReplayBuffer
    tree: SumTree
    max_priority: torch.Tensor  # () float32, on the device
    alpha: float = 0.6

    @classmethod
    def create(cls, example: Batch, capacity: int, alpha: float = 0.6
               ) -> "PrioritizedReplayBuffer":
        capacity = _next_pow2(capacity)
        buffer = ReplayBuffer.create(example, capacity)
        device = next(iter(buffer.data.values())).device
        return cls(buffer=buffer, tree=SumTree.create(capacity, device),
                   max_priority=torch.ones((), device=device), alpha=alpha)

    def add_batch(self, batch: Batch, n: int) -> "PrioritizedReplayBuffer":
        """Write ``n`` transitions at the largest priority seen so far."""
        device = self.max_priority.device
        idx = (self.buffer.pos + torch.arange(n, device=device)) % self.buffer.capacity
        self.buffer.add_batch(batch, n)
        self.tree.update(idx, _pow32(self.max_priority, self.alpha).expand(n))
        return self

    def sample(self, generator: Optional[torch.Generator], batch_size: int, beta: float,
               uniforms: Optional[torch.Tensor] = None) -> Tuple[Batch, torch.Tensor, torch.Tensor]:
        """(batch, leaf indices, importance-sampling weights normalised by
        their largest); ``uniforms`` as in ``SumTree.sample``."""
        idx = self.tree.sample(generator, batch_size, uniforms)
        batch = self.buffer.sample(None, batch_size, idx)
        probs = self.tree.get(idx) / torch.clamp(self.tree.total, min=1e-12)
        n = float(max(self.buffer.size, 1))
        weights = (n * probs) ** (-float(np.float32(beta)))
        weights = weights / torch.clamp(weights.max(), min=1e-12)
        return batch, idx, weights

    def update_priorities(self, idx: torch.Tensor, priorities: torch.Tensor
                          ) -> "PrioritizedReplayBuffer":
        """New priorities (floored at 1e-6) for the leaves ``idx``."""
        priorities = torch.clamp(priorities, min=1e-6)
        self.tree.update(idx, _pow32(priorities, self.alpha))
        self.max_priority = torch.maximum(self.max_priority, priorities.max())
        return self
