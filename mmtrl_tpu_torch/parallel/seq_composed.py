"""Composed data x sequence parallelism for the long-context DT train step;
port of ``mmtrl_tpu/parallel/seq_composed.py``.

Over a (data, seq) mesh:

- ``data``: the batch dimension shards; each rank computes its examples'
  loss terms.
- ``seq``: the K context timesteps shard contiguously, so each rank holds a
  contiguous 3 (K / n) window of the interleaved (R, s, a) tokens.
  Attention is the ring over ``seq`` (``parallel/ring_attention.py``, with
  global causal positions); every other op of the model is pointwise over
  tokens and runs unchanged on the local chunk.

The masked mean's numerator and denominator and the accuracy's hits are
summed over both axes with ``psum``, whose backward leaves each rank only
its own terms' gradient; one all-reduce over both axes then sums the
gradients, and every rank applies the same clipped AdamW.  In float32 with
dropout off, loss and updated parameters equal the one-device step on the
whole batch up to summation order.  With dropout each rank draws from its
own torch generator: JAX folds the shard's index into the key, which no
torch generator reproduces.

The model runs the ring when its ``cfg`` carries ``seq_axis="seq"`` and
``seq_axis_size`` equal to the mesh's ``seq`` size (``seq_cfg``); its
parameters are the dense model's, so a dense state dict loads into it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from mmtrl_tpu_torch.algos.dt.train import Batch, DTTrainState, make_dt_train_step
from mmtrl_tpu_torch.models.decision_transformer import DTConfig
from mmtrl_tpu_torch.parallel.mesh import Mesh, shard_along

DATA_AXIS = "data"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, SEQ_AXIS)


def make_dt_seq_train_step(model_cfg: DTConfig, mesh: Mesh) -> Callable:
    """``step(state, batch) -> (state, metrics)`` over a (data, seq) mesh:
    the batch is this rank's block (``shard_dt_batch``), the parameters are
    replicated.  ``model_cfg`` must carry ``seq_axis=SEQ_AXIS`` and
    ``seq_axis_size=mesh.shape['seq']``, and the state's model must be
    built from it; raises ``ValueError`` otherwise (JAX asserts)."""
    if model_cfg.seq_axis != SEQ_AXIS:
        raise ValueError("cfg.seq_axis must name the mesh axis")
    if model_cfg.seq_axis_size != mesh.shape[SEQ_AXIS]:
        raise ValueError(f"cfg.seq_axis_size={model_cfg.seq_axis_size} != mesh "
                         f"seq={mesh.shape[SEQ_AXIS]}")
    inner = make_dt_train_step(model_cfg, mesh, AXES)

    def step(state: DTTrainState, batch: Batch) -> Tuple[DTTrainState, Dict]:
        if (state.model.cfg.seq_axis, state.model.cfg.seq_axis_size) != (
                SEQ_AXIS, mesh.shape[SEQ_AXIS]):
            raise ValueError("the state's model is not built from the sequence-parallel cfg")
        state.model.use_mesh(mesh)
        return inner(state, batch)

    return step


def seq_cfg(cfg: DTConfig, n_seq: int) -> DTConfig:
    """The same model, attention switched to the ring over ``n_seq`` ranks."""
    return dataclasses.replace(cfg, seq_axis=SEQ_AXIS, seq_axis_size=n_seq)


def shard_dt_batch(batch: Batch, mesh: Mesh) -> Batch:
    """This rank's block of a (rtg, states, actions, timesteps, mask) batch:
    B over ``data``, K over ``seq``."""
    return tuple(shard_along(shard_along(x, mesh, DATA_AXIS, 0), mesh, SEQ_AXIS, 1)
                 for x in batch)
