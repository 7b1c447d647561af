"""Decision-transformer offline training; port of
``mmtrl_tpu/algos/dt/train.py``.

The behaviour-cloning objective of the published DT design: cross-entropy of
the action predicted at each state token against the logged action, masked
over left-padding; fused global-norm clipping and AdamW
(``ops/fused_optim.py``) under optax's warmup-cosine schedule.  A step runs
the model in ``train()`` mode, so dropout draws from the global torch RNG:
seed it with ``torch.manual_seed``.  With MoE blocks the loss adds
``moe_aux_coef`` times the blocks' mean router load-balance loss, reported
as ``dt/moe_aux``.  Attention goes through the CUDA forward and backward
kernels on the card (``ops/flash_attention.py``).

With a mesh (``parallel/mesh.py``) the step is data parallel: each rank
passes its shard of the batch over ``data`` (``parallel.shard_batch``), the
masked mean's numerator and denominator and the accuracy's hits are summed
over ``data``, and so are the gradients, in one all-reduce, before the
clipped AdamW, whose norm is global.  The result is the one-rank step on
the whole batch.  A model sharded by ``parallel/sharding.py`` adds tensor
parallelism over ``model`` (``shard_dt_params``: the blocks hold their
collectives) or FSDP over ``data`` (``shard_fsdp_params``: each sharded
parameter is all-gathered before the forward and its gradient comes back
reduce-scattered, already summed); the global norm then sums each sharded
leaf's squares over its axis and counts each replicated leaf once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.algos.dt.data import TrajectoryBuffer
from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer, DTConfig
from mmtrl_tpu_torch.ops.fused_optim import (
    ScaleByAdamState,
    fused_clip_adamw,
    init_adam_state,
)
from mmtrl_tpu_torch.parallel.collectives import all_gather, all_reduce_list, psum
from mmtrl_tpu_torch.parallel.mesh import DATA_AXIS, Axes, Mesh

Batch = Tuple[torch.Tensor, ...]  # (rtg, states, actions, timesteps, mask)
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class DTTrainConfig:
    """Field for field the JAX ``DTTrainConfig``."""

    learning_rate: float = 6e-4
    weight_decay: float = 0.1
    warmup_steps: int = 512
    total_steps: int = 20_000
    batch_size: int = 64
    max_grad_norm: float = 0.25
    beta1: float = 0.9
    beta2: float = 0.95


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float,
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` in float32: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine to
    ``end_value`` at ``decay_steps`` (which counts the warmup), flat after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = float(decay_steps - warmup_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.as_tensor(count)
        warm = count.clamp(0, warmup_steps).float()
        linear = (init_value - peak_value) * (1 - warm / warmup_steps) + peak_value
        t = torch.clamp((count - warmup_steps).float(), max=cosine_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / cosine_steps))
        decayed = peak_value * ((1 - alpha) * cosine + alpha)
        return torch.where(count < warmup_steps, linear, decayed)

    return schedule


@dataclasses.dataclass
class DTTrainState:
    """The model (its parameters are the trained weights), the optimizer
    state over ``model.parameters()`` in order, and the schedule."""

    model: DecisionTransformer
    opt_state: ScaleByAdamState
    schedule: Schedule
    train_cfg: DTTrainConfig

    @property
    def step(self) -> torch.Tensor:
        return self.opt_state.count


def create_dt_state(
    model_cfg: DTConfig,
    train_cfg: DTTrainConfig,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    state_channels: int = 2,
) -> DTTrainState:
    """A fresh train state on ``device``: the model initialised from
    ``seed``, or from a seed drawn from ``generator`` when one is given
    (the global RNG is left as it was), zero moments and the schedule."""
    device = resolve_device(device)
    if generator is not None:
        seed = int(torch.randint(2**62, (), generator=generator))
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        model = DecisionTransformer(model_cfg, device=device, state_channels=state_channels)
    schedule = warmup_cosine_decay_schedule(
        0.0, train_cfg.learning_rate, train_cfg.warmup_steps,
        train_cfg.total_steps, train_cfg.learning_rate * 0.1,
    )
    return DTTrainState(model, init_adam_state(list(model.parameters())), schedule, train_cfg)


def dt_loss(
    logits: torch.Tensor, actions: torch.Tensor, mask: torch.Tensor,
    mesh: Optional[Mesh] = None, axes: Axes = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy): the masked mean NLL of the logged actions and the
    masked share of argmax hits (first index on ties, as ``jnp.argmax``),
    both over max(mask.sum(), 1).  With a mesh the sums run over the ranks
    of ``axes`` too (``psum``: each rank's gradient keeps its own terms)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, actions[..., None].long())[..., 0]
    m = mask.float()
    hits = ((logits.argmax(dim=-1) == actions).float() * m).sum()
    num, den = (nll * m).sum(), m.sum()
    if mesh is not None:
        num, den, hits = (psum(t, mesh, axes) for t in (num, den, hits))
    denom = den.clamp(min=1.0)
    return num / denom, hits / denom


def sharded_grad_norm(model, grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """The global norm of a sharded model's gradients (``ShardPlan``): each
    sharded leaf's squares summed over its axis, each replicated leaf's
    counted once; None for a model that is not sharded."""
    plan = getattr(model, "shard_plan", None)
    if plan is None:
        return None
    sq = {True: grads[0].new_zeros((), dtype=torch.float32),
          False: grads[0].new_zeros((), dtype=torch.float32)}
    for (name, _), g in zip(model.named_parameters(), grads):
        g = g.float()
        sq[name in plan.specs] = sq[name in plan.specs] + (g * g).sum()
    [sharded] = all_reduce_list([sq[True]], plan.mesh, plan.axis)
    return torch.sqrt(sharded + sq[False])


def dt_gradients(model: DecisionTransformer, batch: Batch, mesh: Optional[Mesh] = None,
                 axes: Axes = DATA_AXIS):
    """(loss, accuracy, MoE aux or None, gradients in ``model.parameters()``
    order) of one forward in train mode and its backward.  With ``mesh``
    the batch is this rank's block over ``axes``: the loss's sums and the
    gradients are summed over them (the gradients in one all-reduce; a
    sharded model's FSDP leaves come back summed by their reduce-scatter),
    so every rank holds those of the whole batch.  The MoE aux loss of a
    sharded batch is not ported (ROADMAP A.8)."""
    rtg, states, actions, timesteps, mask = batch
    moe = bool(model.cfg.moe_experts)
    if moe and mesh is not None:
        raise NotImplementedError("the MoE aux loss over a data-parallel batch (ROADMAP A.8)")
    model.train()
    named = list(model.named_parameters())
    plan = getattr(model, "shard_plan", None)
    gathered = plan.specs if plan is not None and plan.gather else {}
    inputs = (rtg, states, actions, timesteps)
    if gathered:  # FSDP: the whole parameters
        full = {n: all_gather(p, plan.mesh, plan.axis, plan.dim(n)) if n in gathered else p
                for n, p in named}
        logits, moe_aux = torch.func.functional_call(model, full, inputs, {"return_aux": True})
    else:
        logits, moe_aux = model(*inputs, return_aux=True)
    loss, acc = dt_loss(logits, actions, mask, mesh, axes)
    if moe:
        loss = loss + model.cfg.moe_aux_coef * moe_aux
    grads = list(torch.autograd.grad(loss, [p for _, p in named]))
    if mesh is not None:
        summed = [i for i, (n, _) in enumerate(named) if n not in gathered]
        for i, g in zip(summed, all_reduce_list([grads[i] for i in summed], mesh, axes)):
            grads[i] = g
    return loss.detach(), acc, moe_aux.detach() if moe else None, grads


def make_dt_train_step(model_cfg: DTConfig, mesh: Optional[Mesh] = None,
                       axes: Axes = DATA_AXIS) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: forward in train
    mode, masked NLL (plus the MoE aux term), backward, one fused clip-AdamW
    update in place.  The metrics are device tensors keyed ``dt/loss`` and
    ``dt/action_accuracy``, and ``dt/moe_aux`` with MoE.  ``model_cfg`` is
    the JAX signature's; the state's model and its config are what run.
    With ``mesh`` the batch is this rank's shard over ``axes`` and the step
    is data parallel (module docstring); the sequence-parallel step
    (``parallel/seq_composed.py``) passes ``("data", "seq")``."""
    if mesh is not None:
        mesh.axes(axes)

    def train_step(state: DTTrainState, batch: Batch) -> Tuple[DTTrainState, Dict]:
        model, tcfg = state.model, state.train_cfg
        loss, acc, moe_aux, grads = dt_gradients(model, batch, mesh, axes)
        state.opt_state = fused_clip_adamw(
            list(model.parameters()), grads, state.opt_state, state.schedule,
            b1=tcfg.beta1, b2=tcfg.beta2, weight_decay=tcfg.weight_decay,
            max_grad_norm=tcfg.max_grad_norm, grad_norm=sharded_grad_norm(model, grads),
        )
        metrics = {"dt/loss": loss, "dt/action_accuracy": acc}
        if moe_aux is not None:
            metrics["dt/moe_aux"] = moe_aux
        return state, metrics

    return train_step


def make_dt_train_steps(
    model_cfg: DTConfig, batch_size: int, context_len: int, n_steps: int
) -> Callable:
    """``train_steps(state, buffer, generator) -> (state, metrics)``:
    ``n_steps`` iterations of window sampling and ``train_step``; the
    metrics are the last step's."""
    inner = make_dt_train_step(model_cfg)

    def train_steps(state: DTTrainState, buffer: TrajectoryBuffer,
                    generator: Optional[torch.Generator] = None):
        metrics: Dict = {}
        for _ in range(n_steps):
            batch = buffer.sample(generator, batch_size, context_len)
            state, metrics = inner(state, batch)
        return state, metrics

    return train_steps
