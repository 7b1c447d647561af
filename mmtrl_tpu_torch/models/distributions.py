"""Categorical distribution helpers over logits; the categorical part of
``mmtrl_tpu/models/distributions.py``.

Sampling uses the Gumbel trick of the reference's JAX path
(cleanrl/ppo_atari_envpool_xla_jax.py:285-289) on uniforms in [0, 1) from an
explicit ``torch.Generator``, as ``jax.random.uniform`` draws them.  The
normal and tanh-normal helpers of the JAX module belong to the continuous
algorithms, which are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``argmax(logits - log(-log(u)))`` for given uniforms ``u``."""
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def categorical_sample(generator: Optional[torch.Generator], logits: torch.Tensor) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return gumbel_argmax(logits, u)


def categorical_log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, action[..., None].long())[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)
