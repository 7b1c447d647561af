"""Multi-device axes of the decision transformer on ``torch.distributed``;
port of ``mmtrl_tpu/parallel``.  ``mesh`` lays the ranks out and places
data, ``collectives`` holds the differentiable collectives, ``sharding``
the tensor-parallel and FSDP rules, ``ring_attention`` and
``seq_composed`` the sequence axis, ``expert`` the MoE axis and
``pipeline`` the GPipe schedule."""

from mmtrl_tpu_torch.parallel.mesh import (
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from mmtrl_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from mmtrl_tpu_torch.parallel.ring_attention import ring_attention

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch",
    "pipeline_apply",
    "stack_stage_params",
    "ring_attention",
]
