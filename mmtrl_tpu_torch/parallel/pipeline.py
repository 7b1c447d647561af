"""Pipeline parallelism (the ``pipe`` axis): the GPipe microbatch schedule;
port of ``mmtrl_tpu/parallel/pipeline.py``.

Layers shard over a ``pipe`` axis: each rank holds the parameters of one
stage (a contiguous slice of layers) and computes only that stage.
Microbatches stream through the ring: at tick ``t`` stage 0 takes
microbatch ``min(t, M - 1)`` (past M it recomputes the last one, which no
output keeps) while stage ``i`` works on the activations ``ppermute``d from
stage ``i - 1``; the last stage writes output slot ``t - (S - 1)`` when it
is valid.  That is JAX's (M + S - 1)-tick schedule, bubble fraction
(S - 1) / (M + S - 1).  The output is replicated by a ``psum``.

Plain tensor code, as JAX's: autograd through the ticks sends each
activation's gradient back one stage (``ppermute``'s backward), the reverse
schedule ``jax.grad`` derives.  Which rank feeds and which writes are
``torch.where`` on tensors, as JAX's ``jnp.where``, so every rank's graph
has one structure and its collectives match the other ranks', backward
too.  JAX permutes once more after the last tick and drops the result; the
port skips that exchange.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from mmtrl_tpu_torch.parallel.collectives import ppermute, psum
from mmtrl_tpu_torch.parallel.mesh import Mesh


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,  # this rank's stage
    microbatches: torch.Tensor,  # (M, mb, ...), replicated
    mesh: Mesh,
    axis_name: str = "pipe",
) -> torch.Tensor:
    """Runs ``microbatches`` through the ``pipe`` stages, this rank
    computing stage ``mesh.index(axis_name)`` with ``stage_params``.

    ``stage_fn(params, x) -> y`` applies one stage's layers to one
    microbatch and keeps its shape.  JAX's takes the parameters of every
    stage stacked and shards them itself; here each rank passes its own
    stage (``stack_stage_params`` stacks a stage's layers).  Returns the
    (M, mb, ...) outputs on every rank."""
    S, my = mesh.size(axis_name), mesh.index(axis_name)
    M = microbatches.shape[0]
    device = microbatches.device
    is_first = torch.tensor(my == 0, device=device)
    is_last = my == S - 1
    recv = torch.zeros_like(microbatches[0])
    acc = torch.zeros_like(microbatches)
    for t in range(M + S - 1):
        x = torch.where(is_first, microbatches[min(t, M - 1)], recv)
        y = stage_fn(stage_params, x)
        out_idx = t - (S - 1)
        valid = torch.tensor(is_last and 0 <= out_idx < M, device=device)
        slot = torch.tensor([min(max(out_idx, 0), M - 1)], device=device)
        acc = torch.where(valid, acc.index_copy(0, slot, y[None].to(acc.dtype)), acc)
        if t + 1 < M + S - 1:
            recv = ppermute(y, mesh, axis_name)
    # acc is zero except on the last stage; the psum replicates it.
    return psum(acc, mesh, axis_name)


def stack_stage_params(param_list: Sequence[Any]) -> Any:
    """Stacks parameter trees of one structure (dicts of tensors) along a
    new leading axis, as JAX's does."""
    first = param_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in param_list]) for k in first}
    return torch.stack(list(param_list))
