"""Top-k gated Mixture-of-Experts FFN; port of ``mmtrl_tpu/models/moe.py``.

A transformer FFN whose experts' parameters are stacked with the expert
axis leading (``experts_w1`` (E, D, F), ``experts_b1`` (E, F),
``experts_w2`` (E, F, D), ``experts_b2`` (E, D)), stored float32 and cast to
the compute dtype, with a float32 router ``gate``.  Two dispatches:

- ``dense`` (GShard): every expert on every token, combined with the top-k
  softmax weights;
- ``gather`` (Switch/GShard capacity dispatch): each token goes to its
  top-k experts' slots, at most C per expert, C = ceil(T * k * cf / E)
  rounded up to 128 rows and capped at T; slots fill choice-major (every
  first choice before any second choice), so first choices win slots when
  an expert overflows, and a dropped assignment contributes zero.

The expert products are plain batched products (``einsum``/``bmm``), as
the JAX package computes them outside any Pallas kernel.  Top-k breaks
ties toward the lower expert index, as ``jax.lax.top_k`` does.  The router's
Switch load-balance loss comes back beside the output (JAX sows it under
``intermediates/moe_aux``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.models.common import Dense


def stable_top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (a stable descending sort), as ``jax.lax.top_k``;
    ``torch.topk`` promises no order among ties."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_combine_weights(gate_logits: torch.Tensor, k: int) -> torch.Tensor:
    """(..., E) router logits -> (..., E) combine weights: a softmax over
    the top-k logits, exactly 0 elsewhere; a plain softmax when k >= E."""
    E = gate_logits.shape[-1]
    if k >= E:
        return torch.softmax(gate_logits, dim=-1)
    vals, idx = stable_top_k(gate_logits, k)
    w = torch.softmax(vals, dim=-1)
    onehot = F.one_hot(idx, E).to(w.dtype)  # (..., k, E)
    return torch.einsum("...k,...ke->...e", w, onehot)


def moe_ffn_dense(x: torch.Tensor, combine: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """All experts on all tokens, then the combine-weighted sum:
    x (B, S, D), combine (B, S, E) -> (B, S, D)."""
    h = torch.einsum("bsd,edf->bsef", x, w1) + b1
    h = F.gelu(h, approximate="tanh")  # flax's gelu
    y = torch.einsum("bsef,efd->bsed", h, w2) + b2
    return torch.einsum("bsed,bse->bsd", y, combine.to(y.dtype))


def capacity(tokens: int, k: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert: ceil(T * k * cf / E), rounded up to 128 rows and
    capped at T.  It decides which assignments drop."""
    c = int(-(-tokens * k * capacity_factor // num_experts))
    return min(-(-c // 128) * 128, tokens)


def moe_ffn_gather(x: torch.Tensor, gate_logits: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *, top_k: int,
                   capacity_factor: float = 1.25) -> torch.Tensor:
    """Capacity-based top-k dispatch: x (B, S, D), float32 gate_logits
    (B, S, E) -> (B, S, D).  A cumsum over the choice-major one-hot
    assignment gives each assignment its slot; each kept assignment copies
    its token's row into its slot of the (E, C, D) expert inputs, the
    experts run as E-batched products over C rows, and each (token, choice)
    reads its slot's output row back; a dropped assignment reads the
    appended zero row.  Copies and reads go through ``index_copy`` and
    ``index_select``, whose backward passes are a gather and a scatter to
    distinct rows: no sort, no atomics on a row that is kept."""
    B, S, D = x.shape
    E = gate_logits.shape[-1]
    T, k = B * S, top_k
    C = capacity(T, k, E, capacity_factor)

    xt = x.reshape(T, D)
    vals, idx = stable_top_k(gate_logits.reshape(T, E), k)  # (T, k)
    wts = torch.softmax(vals, dim=-1)
    # Choice-major flattening: all first choices, then all second choices.
    eid = idx.T.reshape(-1)  # (kT,)
    wf = wts.T.reshape(-1)
    # (E, kT): the cumsum runs along the inner axis, kT long, E rows
    onehot = (eid[None, :] == torch.arange(E, device=x.device)[:, None]).long()
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(dim=0)  # (kT,)
    slot = torch.where(pos < C, eid * C + pos, E * C)  # E * C: dropped
    # Kept slots are distinct; dropped assignments all land on the extra
    # slot E * C, which is cut off.  Empty slots stay zero; their rows are
    # never read back.
    xin = xt.new_zeros(E * C + 1, D).index_copy(0, slot, xt.repeat(k, 1))
    xin = xin[: E * C].reshape(E, C, D)
    h = F.gelu(torch.bmm(xin, w1) + b1[:, None], approximate="tanh")
    y = torch.bmm(h, w2) + b2[:, None]
    yflat = torch.cat([y.reshape(E * C, D), y.new_zeros(1, D)], dim=0)
    gathered = yflat.index_select(0, slot).reshape(k, T, D)
    out = torch.einsum("kt,ktd->td", wf.reshape(k, T).to(y.dtype), gathered)
    return out.reshape(B, S, D)


def load_balance_aux(gate_probs: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """Switch aux loss, E * sum_e(token fraction_e * mean prob_e): a token
    counts toward every expert it routes to, the fractions normalised to
    sum to one.  Balanced routing gives 1."""
    E = gate_probs.shape[-1]
    dims = tuple(range(combine.dim() - 1))
    frac = (combine > 0).float().mean(dim=dims)
    frac = frac / frac.sum().clamp(min=1e-9)
    prob = gate_probs.float().mean(dim=tuple(range(gate_probs.dim() - 1)))
    return E * (frac * prob).sum()


class MoEFFN(nn.Module):
    """Drop-in for a transformer FFN: ``forward(x) -> (y, aux)``, y in the
    compute ``dtype``, aux the router's float32 load-balance loss."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, top_k: int = 2,
                 dtype: torch.dtype = torch.bfloat16, dispatch: str = "dense",
                 capacity_factor: float = 1.25, device: DeviceLike = None):
        super().__init__()
        if dispatch not in ("dense", "gather"):
            raise ValueError(f"unknown MoE dispatch {dispatch!r}")
        device = resolve_device(device)
        E, D, Fd = num_experts, d_model, d_ff
        self.top_k, self.dtype, self.dispatch = top_k, dtype, dispatch
        self.capacity_factor = capacity_factor
        self.gate = Dense(D, E, 1.0, device=device)

        def ortho(e: int, a: int, b: int):
            # flax's orthogonal on an (e, a, b) shape: one (e * a, b) matrix
            w = torch.empty(e * a, b, device=device)
            nn.init.orthogonal_(w)
            return nn.Parameter(w.reshape(e, a, b))

        self.experts_w1 = ortho(E, D, Fd)
        self.experts_b1 = nn.Parameter(torch.zeros(E, Fd, device=device))
        self.experts_w2 = ortho(E, Fd, D)
        self.experts_b2 = nn.Parameter(torch.zeros(E, D, device=device))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # The router runs in float32 on x cast to float32.
        gate_logits = self.gate(x.float())
        combine = moe_combine_weights(gate_logits, self.top_k)
        aux = load_balance_aux(torch.softmax(gate_logits, dim=-1), combine)
        ws = tuple(p.to(self.dtype) for p in (self.experts_w1, self.experts_b1,
                                               self.experts_w2, self.experts_b2))
        x = x.to(self.dtype)
        if self.dispatch == "gather":
            y = moe_ffn_gather(x, gate_logits, *ws, top_k=self.top_k,
                               capacity_factor=self.capacity_factor)
        else:
            y = moe_ffn_dense(x, combine, *ws)
        return y, aux
