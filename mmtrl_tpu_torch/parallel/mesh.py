"""Process mesh and placement utilities; port of ``mmtrl_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``Mesh`` of named axes and lets
XLA insert the collectives of one global program.  The port has no such
compiler: every rank of a ``torch.distributed`` world runs its own program
on its own shard, and the modules of ``parallel/`` issue the collectives
themselves (``parallel/collectives.py``) over the process group of one mesh
axis, or of several.

``make_mesh`` lays the world's ranks out row-major over the axes, as JAX
reshapes its device list, and creates the process groups of every set of
axes up front, the same on every rank (``torch.distributed`` requires every
rank to join every ``new_group`` in the same order).  Without a process
group the world is this one process: the mesh is a trivial one-rank mesh,
every collective is the identity, and the same code runs, as JAX's
``make_mesh`` on one chip.  A specification is a tuple with one entry per
tensor dimension, an axis name or None, as JAX's ``PartitionSpec``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

Axes = Union[str, Sequence[str]]
Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the mesh: the axes, their sizes, its coordinate
    on each, and the process group of each set of axes (None without a
    process group)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], Any]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def distributed(self) -> bool:
        """Whether the collectives run (the mesh was made in a process group)."""
        return next(iter(self.groups.values())) is not None

    def axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple in the mesh's order; raises on an unknown name."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(names) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def size(self, axes: Axes) -> int:
        """The number of ranks spanned by ``axes``."""
        return math.prod(self.shape[a] for a in self.axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's position among the ranks spanned by ``axes``,
        row-major over them (JAX's ``axis_index``, or for several axes the
        index of the flattened group)."""
        shape, coords = self.shape, dict(zip(self.axis_names, self.coords))
        idx = 0
        for a in self.axes(axes):
            idx = idx * shape[a] + coords[a]
        return idx

    def group(self, axes: Axes):
        """The process group of this rank's line along ``axes``."""
        return self.groups[self.axes(axes)]


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
) -> Mesh:
    """The mesh over every rank of the world (one without a process group).

    With no ``axis_sizes`` the whole world goes on the first axis and the
    other axes get size 1.  Raises ``ValueError`` when the sizes do not
    cover the world, before any group is made."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for axes {axis_names}")
    if math.prod(axis_sizes) != n:
        raise ValueError(f"mesh {axis_sizes} does not cover {n} devices")
    rank = dist.get_rank() if initialized else 0
    ranks = np.arange(n).reshape(axis_sizes)
    coords = tuple(int(c) for c in np.unravel_index(rank, axis_sizes))
    groups: Dict[Tuple[str, ...], Any] = {}
    for r in range(1, len(axis_names) + 1):
        for subset in itertools.combinations(range(len(axis_names)), r):
            key = tuple(axis_names[i] for i in subset)
            if not initialized:
                groups[key] = None
                continue
            # Move the subset's axes last: each row of the reshape is one
            # group, whose members differ only in those coordinates.
            rest = [i for i in range(len(axis_names)) if i not in subset]
            lines = ranks.transpose(rest + list(subset)).reshape(-1, math.prod(
                axis_sizes[i] for i in subset))
            mine, _ = dist.new_subgroups_by_enumeration([list(map(int, row)) for row in lines])
            groups[key] = mine
    return Mesh(axis_names, axis_sizes, coords, groups)


def data_sharding(mesh: Mesh, ndim: int = 1, axis: str = DATA_AXIS) -> Spec:
    """Dim 0 over the data axis, the rest replicated."""
    mesh.axes(axis)
    return (axis,) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> Spec:
    return ()


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def shard_along(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``, split over ``axis``."""
    n = mesh.size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible by {axis}={n}")
    return x.chunk(n, dim)[mesh.index(axis)].contiguous()


def shard_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """This rank's slice of dim 0 of every leaf, split over ``axis``."""
    return _tree_map(lambda x: shard_along(x, mesh, axis), tree)


@torch.no_grad()
def replicate(mesh: Mesh, tree, axes: Optional[Axes] = None):
    """Broadcast every leaf in place from the first rank of ``axes`` (all of
    the mesh's by default) to the others; returns ``tree``."""
    if not mesh.distributed:
        return tree
    group = mesh.group(mesh.axis_names if axes is None else axes)
    src = dist.get_global_rank(group, 0)
    _tree_map(lambda x: dist.broadcast(x.data, src, group=group), tree)
    return tree
