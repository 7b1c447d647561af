"""Expert parallelism (the ``expert`` axis); port of
``mmtrl_tpu/parallel/expert.py``.

The stacked expert parameters of an MoE FFN (``models/moe.py``) shard their
leading expert axis over a mesh axis: each rank holds E/n experts, runs the
dense dispatch on them with its slice of the combine weights, and one
``psum`` adds the partial outputs into the whole.  Tokens and the router
stay replicated.  The combine weights of the other ranks' experts are zero
in a rank's partial sum, so the sum is the one-device MoE up to summation
order.

``x`` and the combine weights enter through ``enter``, the conjugate of
``psum``, so their gradients sum over the ranks' experts on every rank;
each rank's expert gradients are those of its own experts.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mmtrl_tpu_torch.models.moe import moe_ffn_dense
from mmtrl_tpu_torch.parallel.collectives import enter, psum
from mmtrl_tpu_torch.parallel.mesh import Mesh, Spec, shard_along

EXPERT_AXIS = "expert"


def moe_param_specs(moe: nn.Module) -> Dict[str, Spec]:
    """The specification of each parameter of an ``MoEFFN``, by name: the
    stacked ``experts_*`` tensors shard their leading E over ``expert``, the
    router ``gate`` is replicated."""
    return {name: (EXPERT_AXIS,) + (None,) * (p.dim() - 1) if name.startswith("experts_")
            else () for name, p in moe.named_parameters()}


def expert_parallel_moe(
    x: torch.Tensor,  # (B, S, D), replicated
    combine: torch.Tensor,  # (B, S, E), replicated (moe_combine_weights)
    w1: torch.Tensor,  # (E/n, D, F): this rank's experts
    b1: torch.Tensor,  # (E/n, F)
    w2: torch.Tensor,  # (E/n, F, D)
    b2: torch.Tensor,  # (E/n, D)
    mesh: Mesh,
    axis_name: str = EXPERT_AXIS,
) -> torch.Tensor:
    """The MoE FFN with its experts sharded over ``axis_name``: rank i holds
    experts [i E/n, (i + 1) E/n).  Returns the (B, S, D) output on every
    rank.  JAX's takes the global stacks and shards them itself; here each
    rank passes its own."""
    x = enter(x, mesh, axis_name)
    local = shard_along(enter(combine, mesh, axis_name), mesh, axis_name, dim=-1)
    if local.shape[-1] != w1.shape[0]:
        raise ValueError(f"{combine.shape[-1]} experts over {mesh.size(axis_name)} ranks "
                         f"is not {w1.shape[0]} a rank")
    return psum(moe_ffn_dense(x, local, w1, b1, w2, b2), mesh, axis_name)
