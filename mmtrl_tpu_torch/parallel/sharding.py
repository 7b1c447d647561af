"""Parameter sharding of the decision transformer; port of
``mmtrl_tpu/parallel/sharding.py``: tensor parallelism over ``model`` and
FSDP (ZeRO-3) over ``data``.

Specifications are in the port's layout, which transposes flax's: a
``Dense`` kernel (in, out) is a ``Linear`` weight (out, in), a ``Conv``
kernel HWIO is OIHW.  Each rule is JAX's, applied to the same leaf and the
same logical dimension.

**Tensor parallelism** (``dt_param_sharding``, JAX's ``_dt_spec``): the
attention's ``qkv`` and the MLP's ``fc`` are column-parallel (their output
features shard), the attention's ``out`` and the block's ``proj`` are
row-parallel (their input features shard), and everything else is
replicated: embeddings, LayerNorms, heads, the state encoder (its ``proj``
too), MoE experts.  JAX splits ``qkv``'s 3D output columns contiguously and
lets XLA reshard; the port's local attention needs whole heads, so each
rank takes the columns of its heads in each of q, k and v, which gives the
same result.  So ``n_heads`` and the MLP width must divide by the axis size.
``shard_dt_params`` leaves each rank its slices and switches the blocks to
their tensor-parallel forward (``models/decision_transformer.py``).

**FSDP** (``fsdp_param_sharding``, JAX's ``_fsdp_spec``): every leaf of at
least ``min_size`` elements shards over ``data`` along its largest
dimension (in flax's layout, the first on a tie) that divides by the axis
size; smaller leaves replicate.  ``shard_fsdp_params`` leaves each rank its
shards; the train step (``algos/dt/train.py``) all-gathers each before the
forward, and the all-gather's backward reduce-scatters its gradient.

Both record a ``ShardPlan`` on the model, which the train step reads: the
axis the sharded leaves split over (their squares are summed over it for
the global norm) and whether to gather them.  Shard before the optimizer
state is made: its moments take the parameters' shapes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch.convert import kernel_port_dims
from mmtrl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, Spec


@dataclasses.dataclass(frozen=True, eq=False)
class ShardPlan:
    mesh: Mesh
    axis: str  # the axis every sharded leaf splits over
    specs: Dict[str, Spec]  # the sharded leaves, by parameter name
    gather: bool  # FSDP: all-gather each sharded leaf before use

    def dim(self, name: str) -> int:
        """The dimension along which ``name`` is sharded."""
        return self.specs[name].index(self.axis)


# ---- tensor parallelism --------------------------------------------------


def _dt_spec(name: str) -> Spec:
    names = name.split(".")
    joined = "/".join(names)
    if "attn" in joined and "qkv" in joined and names[-1] == "weight":
        return (MODEL_AXIS, None)  # column-parallel, head-aligned
    if "attn" in joined and "qkv" in joined and names[-1] == "bias":
        return (MODEL_AXIS,)
    if "attn" in joined and names[-2:] == ["out", "weight"]:
        return (None, MODEL_AXIS)  # row-parallel
    if names[-2:] == ["fc", "weight"]:
        return (MODEL_AXIS, None)
    if names[-2:] == ["fc", "bias"]:
        return (MODEL_AXIS,)
    if "block" in joined and names[-2:] == ["proj", "weight"]:
        return (None, MODEL_AXIS)
    return ()


def dt_param_sharding(mesh: Mesh, model: nn.Module) -> Dict[str, Spec]:
    """The tensor-parallel specification of every parameter, by name."""
    mesh.axes(MODEL_AXIS)
    return {name: _dt_spec(name) for name, _ in model.named_parameters()}


def tp_slice(name: str, x: torch.Tensor, tp: int, index: int) -> torch.Tensor:
    """Rank ``index``'s slice of parameter ``name`` under ``tp``-way tensor
    parallelism: ``qkv``'s slice of each of q, k and v; the whole tensor for
    a replicated leaf."""
    spec = _dt_spec(name)
    if not spec:
        return x
    dim = spec.index(MODEL_AXIS)
    parts = x.chunk(3, 0) if "qkv" in name else (x,)
    for p in parts:
        if p.shape[dim] % tp:
            raise ValueError(f"{name} {tuple(x.shape)} does not split {tp} ways")
    return torch.cat([p.chunk(tp, dim)[index] for p in parts], dim).contiguous()


def _replace(model: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner), leaf, nn.Parameter(value))


@torch.no_grad()
def shard_dt_params(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Tensor parallelism over ``model``, in place: each sharded parameter
    becomes this rank's slice, and the blocks run their tensor-parallel
    forward on ``mesh``.  Requires ``n_heads`` and the MLP width to divide
    by the axis size."""
    from mmtrl_tpu_torch.models.decision_transformer import Block, CausalSelfAttention

    tp, index = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    if model.cfg.n_heads % tp:
        raise ValueError(f"n_heads {model.cfg.n_heads} does not divide by model={tp}")
    specs = {n: s for n, s in dt_param_sharding(mesh, model).items() if s}
    for name, p in list(model.named_parameters()):
        if name in specs:
            _replace(model, name, tp_slice(name, p.detach(), tp, index).clone())
    model.use_mesh(mesh)
    for module in model.modules():
        if isinstance(module, (Block, CausalSelfAttention)):
            module.tensor_parallel = True  # a block's MoE stays replicated
    model.shard_plan = ShardPlan(mesh, MODEL_AXIS, specs, gather=False)
    return model


# ---- FSDP (ZeRO-3) -----------------------------------------------------------


def fsdp_dim(flax_shape: Sequence[int], axis_size: int, min_size: int) -> Optional[int]:
    """JAX's ``_fsdp_spec`` on a shape in flax's layout: the dimension to
    shard, or None to replicate."""
    if not flax_shape or math.prod(flax_shape) < min_size:
        return None  # small tensors: replication is cheaper than gathering
    for d in sorted(range(len(flax_shape)), key=lambda d: -flax_shape[d]):
        if flax_shape[d] % axis_size == 0:
            return d
    return None


def flax_dims(module: nn.Module, leaf: str, ndim: int) -> Tuple[int, ...]:
    """For each dimension of the flax leaf, the port's: a ``Linear`` or
    ``Conv2d`` weight is the flax kernel in ``convert.py``'s layout."""
    if leaf == "weight" and isinstance(module, (nn.Linear, nn.Conv2d)):
        return kernel_port_dims(ndim)
    return tuple(range(ndim))


def fsdp_param_sharding(mesh: Mesh, model: nn.Module, axis: str = DATA_AXIS,
                        min_size: int = 2**14) -> Dict[str, Spec]:
    """The FSDP specification of every parameter, by name."""
    n = mesh.size(axis)
    specs = {}
    for owner, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            dims = flax_dims(module, leaf, p.dim())
            d = fsdp_dim([p.shape[t] for t in dims], n, min_size)
            spec = [None] * p.dim()
            if d is not None:
                spec[dims[d]] = axis
            specs[f"{owner}.{leaf}" if owner else leaf] = tuple(spec) if d is not None else ()
    return specs


@torch.no_grad()
def shard_fsdp_params(mesh: Mesh, model: nn.Module, axis: str = DATA_AXIS,
                      min_size: int = 2**14) -> nn.Module:
    """FSDP over ``model``, in place: each sharded parameter becomes this
    rank's contiguous shard along its sharded dimension."""
    n, index = mesh.size(axis), mesh.index(axis)
    specs = {k: s for k, s in fsdp_param_sharding(mesh, model, axis, min_size).items() if s}
    for name, p in list(model.named_parameters()):
        if name in specs:
            shard = p.detach().chunk(n, specs[name].index(axis))[index]
            _replace(model, name, shard.contiguous().clone())
    model.shard_plan = ShardPlan(mesh, axis, specs, gather=True)
    return model
