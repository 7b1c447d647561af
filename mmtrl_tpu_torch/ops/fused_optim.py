"""Global-norm clipping and AdamW in one pass; port of
``mmtrl_tpu/ops/fused_optim.py``, itself equal to
``optax.chain(optax.clip_by_global_norm(c), optax.adamw(...))``.

A plain function over lists of tensors.  Its state is optax's
``ScaleByAdamState``: the int32 step ``count`` and the first and second
moments ``mu`` and ``nu``, one float32 tensor per parameter.  The arithmetic
follows the JAX transform term for term:

- the clip scale is 1 when the global norm is below ``max_grad_norm``, else
  ``max_grad_norm / norm``;
- the learning rate is read at the count before the increment, the bias
  corrections ``1 - b**count`` at the count after it, in float32;
- eps goes outside the square root, and weight decay applies to every
  parameter, biases, LayerNorm scales and embeddings included;
- each update is cast to its parameter's dtype and added to it.

Unlike JAX, which returns new arrays, the parameters are updated in place.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Union

import torch

INT32_MAX = 2**31 - 1


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # () int32: steps taken
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def init_adam_state(params: Sequence[torch.Tensor]) -> ScaleByAdamState:
    """Zero moments and a zero count on the parameters' device."""
    device = params[0].device
    return ScaleByAdamState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


@torch.no_grad()
def fused_clip_adamw(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    state: ScaleByAdamState,
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    max_grad_norm: float = 0.25,
) -> ScaleByAdamState:
    """One clipped AdamW step: updates ``params`` in place and returns the
    next state.  ``learning_rate`` is a float or a schedule of the count."""
    g_norm = global_norm(grads)
    scale = torch.where(g_norm < max_grad_norm, 1.0, max_grad_norm / g_norm)
    count = torch.where(state.count < INT32_MAX, state.count + 1, state.count)
    lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
    exponent = count.float()
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** exponent
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** exponent
    mu_out, nu_out = [], []
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        g = g * scale
        mu2 = b1 * mu + (1.0 - b1) * g
        nu2 = b2 * nu + (1.0 - b2) * (g * g)
        upd = (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps) + weight_decay * p
        p.add_((-lr * upd).to(p.dtype))
        mu_out.append(mu2)
        nu_out.append(nu2)
    return ScaleByAdamState(count=count, mu=mu_out, nu=nu_out)
