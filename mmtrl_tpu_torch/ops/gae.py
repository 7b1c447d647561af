"""Generalized Advantage Estimation; port of ``mmtrl_tpu/ops/gae.py``.

A reverse loop over time on (T, N) tensors takes the place of the reverse
``lax.scan``; each step is the same float32 arithmetic as the scan body
(reference: src/train.py:171-189).
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_gae(
    rewards: torch.Tensor,  # (T, N)
    values: torch.Tensor,  # (T, N)
    dones: torch.Tensor,  # (T, N) done flag that PRECEDED obs t (CleanRL convention)
    next_value: torch.Tensor,  # (N,) bootstrap value of obs after step T-1
    next_done: torch.Tensor,  # (N,)
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), each (T, N).

    ``dones[t]`` is the done flag that *preceded* observation t, ``next_done``
    the flag after the final step."""
    dones_f = dones.float()
    advantages = torch.empty_like(values)
    next_adv = torch.zeros_like(next_value)
    nv, nd = next_value, next_done.float()
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * nv * (1.0 - nd) - values[t]
        next_adv = delta + gamma * gae_lambda * (1.0 - nd) * next_adv
        advantages[t] = next_adv
        nv, nd = values[t], dones_f[t]
    return advantages, advantages + values
