"""Decision Transformer for multimodal trajectories; port of
``mmtrl_tpu/models/decision_transformer.py``.

Per timestep t the tokens (returns-to-go_t, state_t, action_t) are embedded
to d_model, the timestep embedding is added to all three, the interleaved
3K-token sequence runs through a pre-LN causal GPT stack whose attention is
the CUDA flash kernel (``ops/flash_attention.py``), and actions are predicted
from the state-token outputs.  Module names follow the flax tree, so
``convert.dt_params_from_flax`` loads a JAX checkpoint with ``strict=True``.

Parameters stay float32; ``compute_dtype`` is what the products run in and
``ln_dtype`` what LayerNorm emits, with the JAX model's casts.  LayerNorm
follows flax's arithmetic: float32 statistics, the variance as
max(0, E[x^2] - E[x]^2), eps 1e-6.  Dropout is active in ``train()`` mode and
draws from the global torch RNG, which ``torch.utils.checkpoint`` restores,
so with ``remat`` the recomputed forward draws the same masks.  Dense FFN
only: ``moe_experts > 0`` and ``seq_axis`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.models.common import AtariTower, Dense
from mmtrl_tpu_torch.ops.flash_attention import causal_flash_attention

LN_EPS = 1e-6  # flax nn.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class DTConfig:
    """Field for field the JAX ``DTConfig``."""

    num_actions: int = 4
    context_len: int = 30  # K timesteps -> 3K tokens
    d_model: int = 512
    n_layers: int = 6
    n_heads: int = 4
    mlp_ratio: int = 4
    dropout: float = 0.1
    max_timestep: int = 4096
    state_kind: str = "multimodal"  # 'multimodal' (2,84,84) | 'vector'
    state_dim: int = 0  # used when state_kind == 'vector'
    conv_type: str = "big"
    fusion_type: str = "sum"
    compute_dtype: str = "bfloat16"
    remat: bool = False  # recompute each block's activations in the backward
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_coef: float = 0.01
    moe_dispatch: str = "dense"
    ln_dtype: str = "float32"
    seq_axis: Optional[str] = None
    seq_axis_size: int = 1

    @property
    def seq_len(self) -> int:
        return 3 * self.context_len


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: float32 statistics with the one-pass variance
    max(0, E[x^2] - E[x]^2), eps 1e-6, output in ``dtype``."""

    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__(d, eps=LN_EPS, device=device)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(self.out_dtype)


class Embed(nn.Embedding):
    """flax ``nn.Embed``: normal(0.02) init, float32 lookup."""

    def __init__(self, num: int, d: int, device: torch.device):
        super().__init__(num, d, device=device)
        with torch.no_grad():
            nn.init.normal_(self.weight, std=0.02)


class MultimodalStateEncoder(nn.Module):
    """(N, C, 84, 84) -> (N, d_model): video tower on channel 0, audio
    tower on the C - 1 channels after it (one MFCC plane in Minecraft2d,
    Skeleton+'s stereo pair), fused and projected.  ``state_channels`` is C:
    the JAX module reads it off the example batch at ``init``."""

    def __init__(self, d_model: int, conv_type: str, fusion_type: str,
                 dtype: torch.dtype, device: DeviceLike = None, state_channels: int = 2):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.fusion_type = dtype, fusion_type
        self.video_net = AtariTower(conv_type, 1, device=device)
        self.audio_net = AtariTower(conv_type, state_channels - 1, device=device)
        fused = self.video_net.feature_size * (1 if fusion_type == "sum" else 2)
        self.proj = Dense(fused, d_model, 1.0, device=device)

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        x = states.to(self.dtype)
        video = self.video_net(x[:, 0:1])
        audio = self.audio_net(x[:, 1:])
        if self.fusion_type == "sum":
            fused = video + audio
        else:
            fused = torch.cat([video, audio], dim=-1)
        return self.proj(fused)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: DTConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.d_model, 3 * cfg.d_model, 1.0, device=device)
        self.out = Dense(cfg.d_model, cfg.d_model, 1.0, device=device)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        H = self.cfg.n_heads
        q, k, v = self.qkv(x).split(D, dim=-1)  # contiguous thirds, as jnp.split

        def heads(t):  # (B, S, D) -> (B, H, S, hd)
            return t.reshape(B, S, H, D // H).transpose(1, 2).contiguous()

        o = causal_flash_attention(heads(q), heads(k), heads(v))
        o = o.transpose(1, 2).reshape(B, S, D)
        return self.drop(self.out(o))


class Block(nn.Module):
    def __init__(self, cfg: DTConfig, device: torch.device):
        super().__init__()
        ln_dtype = _dtype(cfg.ln_dtype)
        self.dtype = _dtype(cfg.compute_dtype)
        self.ln1 = LayerNorm(cfg.d_model, ln_dtype, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, ln_dtype, device)
        self.fc = Dense(cfg.d_model, cfg.mlp_ratio * cfg.d_model, 1.0, device=device)
        self.proj = Dense(cfg.mlp_ratio * cfg.d_model, cfg.d_model, 1.0, device=device)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x).to(self.dtype))
        h = self.ln2(x).to(self.dtype)
        h = self.proj(F.gelu(self.fc(h), approximate="tanh"))  # flax gelu is tanh
        return x + self.drop(h)


class DecisionTransformer(nn.Module):
    """``state_channels`` is the channel count of a multimodal state (2 in
    Minecraft2d, 3 in Skeleton+)."""

    def __init__(self, cfg: DTConfig, device: DeviceLike = None, state_channels: int = 2):
        super().__init__()
        if cfg.moe_experts:
            raise NotImplementedError("MoE FFN (moe_experts > 0) is not ported yet")
        if cfg.seq_axis is not None:
            raise NotImplementedError("sequence-parallel attention is not ported yet")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = _dtype(cfg.compute_dtype)
        d = cfg.d_model
        if cfg.state_kind == "multimodal":
            self.state_encoder = MultimodalStateEncoder(
                d, cfg.conv_type, cfg.fusion_type, self.dtype, device=device,
                state_channels=state_channels,
            )
        elif cfg.state_kind == "vector":
            self.state_encoder = Dense(cfg.state_dim, d, 1.0, device=device)
        else:
            raise ValueError(f"unknown state_kind {cfg.state_kind!r}")
        self.rtg_emb = Dense(1, d, 1.0, device=device)
        self.action_emb = Embed(cfg.num_actions, d, device)
        self.time_emb = Embed(cfg.max_timestep, d, device)
        self.drop = nn.Dropout(cfg.dropout)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg, device))
        self.ln_f = LayerNorm(d, _dtype(cfg.ln_dtype), device)
        self.action_head = Dense(d, cfg.num_actions, 0.01, device=device)

    def forward(
        self,
        rtg: torch.Tensor,  # (B, K) returns-to-go
        states: torch.Tensor,  # (B, K, 2, 84, 84) or (B, K, state_dim)
        actions: torch.Tensor,  # (B, K) int
        timesteps: torch.Tensor,  # (B, K) int, absolute episode timesteps
    ) -> torch.Tensor:
        """Action logits (B, K, num_actions) in float32, read from the
        state-token outputs."""
        cfg, dt = self.cfg, self.dtype
        B, K = rtg.shape
        if cfg.state_kind == "multimodal":
            flat = states.reshape((B * K,) + states.shape[2:])
            state_emb = self.state_encoder(flat).reshape(B, K, cfg.d_model)
        else:
            state_emb = self.state_encoder(states.to(dt))
        rtg_emb = self.rtg_emb(rtg[..., None].to(dt))
        act_emb = self.action_emb(actions).to(dt)
        time_emb = self.time_emb(timesteps).to(dt)
        # Interleave (R, s, a) per timestep; each token gets its timestep's
        # embedding.
        tokens = torch.stack(
            [rtg_emb + time_emb, state_emb + time_emb, act_emb + time_emb], dim=2
        ).reshape(B, 3 * K, cfg.d_model)
        x = self.drop(tokens)
        remat = cfg.remat and self.training and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            block = getattr(self, f"block_{i}")
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        x = self.ln_f(x)
        logits = self.action_head(x[:, 1::3].to(dt))  # state positions
        return logits.float()
