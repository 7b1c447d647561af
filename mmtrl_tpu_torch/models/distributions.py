"""Distribution helpers: categorical over logits, the diagonal normal and
the tanh-squashed normal; port of ``mmtrl_tpu/models/distributions.py``.

Categorical sampling uses the Gumbel trick of the reference's JAX path
(cleanrl/ppo_atari_envpool_xla_jax.py:285-289) on uniforms in [0, 1) from an
explicit ``torch.Generator``, as ``jax.random.uniform`` draws them.  The
normal samplers take their standard normals from the generator, or from
``noise`` when a test replays another implementation's draws.

The squashed normal's log-density subtracts ``log(scale * (1 - tanh(x)^2)
+ 1e-6)``.  Near saturation (|x| above about 8 in float32) ``1 - tanh^2``
is a few float32 ulps of 1, so a difference of an ulp in ``tanh`` between
two libraries moves the term by up to ``log(1 + 2 * scale * ulp / 1e-6)``,
0.67 at scale 2: XLA's float32 ``tanh`` on the CPU differs from torch's by
up to 2.4e-7 in about half of all inputs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
HALF_LOG_2PI_E = 0.5 * math.log(2 * math.pi * math.e)


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


# ---- diagonal gaussian ------------------------------------------------------
def standard_normal(generator: Optional[torch.Generator], like: torch.Tensor,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard normals shaped and placed as ``like``: ``noise`` when given,
    else drawn from ``generator``."""
    if noise is None:
        return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)
    return noise.to(like.device, like.dtype)


def normal_sample(generator: Optional[torch.Generator], mean: torch.Tensor,
                  log_std: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    return mean + torch.exp(log_std) * standard_normal(generator, mean, noise)


def _normal_log_density(mean: torch.Tensor, log_std: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    var = torch.exp(2 * log_std)
    return -((x - mean) ** 2) / (2 * var) - log_std - HALF_LOG_2PI


def normal_log_prob(mean: torch.Tensor, log_std: torch.Tensor,
                    action: torch.Tensor) -> torch.Tensor:
    return _normal_log_density(mean, log_std, action).sum(dim=-1)


def normal_entropy(log_std: torch.Tensor) -> torch.Tensor:
    return (log_std + HALF_LOG_2PI_E).sum(dim=-1)


# ---- tanh-squashed gaussian (SAC) -------------------------------------------
def squashed_normal_sample_log_prob(
    generator: Optional[torch.Generator],
    mean: torch.Tensor,
    log_std: torch.Tensor,
    action_scale: torch.Tensor,
    action_bias: torch.Tensor,
    eps: float = 1e-6,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(action, log_prob, squashed_mean): SAC's reparameterized sample with
    the tanh-Jacobian correction (reference:
    cleanrl/sac_continuous_action.py:110-140)."""
    x = normal_sample(generator, mean, log_std, noise)
    y = torch.tanh(x)
    action = y * action_scale + action_bias
    logp = _normal_log_density(mean, log_std, x) - torch.log(action_scale * (1 - y**2) + eps)
    return action, logp.sum(dim=-1), torch.tanh(mean) * action_scale + action_bias
