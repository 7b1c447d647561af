"""Decision-transformer offline training; port of
``mmtrl_tpu/algos/dt/train.py``.

The behaviour-cloning objective of the published DT design: cross-entropy of
the action predicted at each state token against the logged action, masked
over left-padding; fused global-norm clipping and AdamW
(``ops/fused_optim.py``) under optax's warmup-cosine schedule.  A step runs
the model in ``train()`` mode, so dropout draws from the global torch RNG:
seed it with ``torch.manual_seed``.  Attention goes through the CUDA
forward and backward kernels on the card (``ops/flash_attention.py``).
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
    logits: torch.Tensor, actions: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy): the masked mean NLL of the logged actions and the
    masked share of argmax hits (first index on ties, as ``jnp.argmax``),
    both over max(mask.sum(), 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, actions[..., None].long())[..., 0]
    m = mask.float()
    denom = m.sum().clamp(min=1.0)
    loss = (nll * m).sum() / denom
    acc = ((logits.argmax(dim=-1) == actions).float() * m).sum() / denom
    return loss, acc


def make_dt_train_step(model_cfg: DTConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: forward in train
    mode, masked NLL, backward, one fused clip-AdamW update in place.  The
    metrics are device tensors keyed ``dt/loss`` and ``dt/action_accuracy``.
    ``model_cfg`` is the JAX signature's; the state's model is what runs."""

    def train_step(state: DTTrainState, batch: Batch) -> Tuple[DTTrainState, Dict]:
        rtg, states, actions, timesteps, mask = batch
        model, tcfg = state.model, state.train_cfg
        model.train()
        params: List[torch.Tensor] = list(model.parameters())
        logits = model(rtg, states, actions, timesteps)
        loss, acc = dt_loss(logits, actions, mask)
        grads = torch.autograd.grad(loss, params)
        state.opt_state = fused_clip_adamw(
            params, grads, state.opt_state, state.schedule,
            b1=tcfg.beta1, b2=tcfg.beta2, weight_decay=tcfg.weight_decay,
            max_grad_norm=tcfg.max_grad_norm,
        )
        return state, {"dt/loss": loss.detach(), "dt/action_accuracy": acc}

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
