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
so with ``remat`` the recomputed forward draws the same masks.  With
``moe_experts > 0`` each block's FFN is the top-k MoE of ``models/moe.py``
(module ``moe``); every block returns its router's load-balance loss beside
its output, so a remat's recompute records nothing twice, and
``forward(..., return_aux=True)`` gives their mean over the blocks, the
``moe_aux`` that JAX sows.

Two multi-device modes run inside the modules, on a mesh that
``DecisionTransformer.use_mesh`` hands them (``parallel/mesh.py``):

- with ``cfg.seq_axis`` set, the tokens are this rank's contiguous chunk of
  the sequence and attention is the ring over that axis
  (``parallel/ring_attention.py``), causal over global positions, as JAX's
  model does under ``shard_map``; every other op is pointwise over tokens.
  The parameter tree is the dense model's, so a dense state dict loads into
  the sequence-sharded model and back;
- after ``parallel/sharding.py::shard_dt_params`` each attention and MLP
  runs Megatron's tensor parallelism over the mesh's ``model`` axis: the
  replicated input enters through ``enter``, the column-parallel ``qkv``
  and ``fc`` give this rank's heads and hidden units, and the row-parallel
  ``out`` and ``proj`` products are summed with ``psum`` before their
  replicated biases are added, once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.models.common import AtariTower, Dense
from mmtrl_tpu_torch.models.moe import MoEFFN
from mmtrl_tpu_torch.ops.flash_attention import causal_flash_attention
from mmtrl_tpu_torch.parallel.collectives import enter, psum
from mmtrl_tpu_torch.parallel.mesh import MODEL_AXIS
from mmtrl_tpu_torch.parallel.ring_attention import ring_attention

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


def row_parallel(layer: Dense, x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel ``Dense``: this rank's input columns' product, summed
    over the ``model`` axis, then the replicated bias, once (added before
    the sum, it would count once for every rank)."""
    y = psum(F.linear(x, layer.weight.to(x.dtype)), mesh, MODEL_AXIS)
    return y + layer.bias.to(x.dtype)


class CausalSelfAttention(nn.Module):
    mesh = None  # set by DecisionTransformer.use_mesh
    tensor_parallel = False  # set by parallel.sharding.shard_dt_params

    def __init__(self, cfg: DTConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.d_model, 3 * cfg.d_model, 1.0, device=device)
        self.out = Dense(cfg.d_model, cfg.d_model, 1.0, device=device)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        cfg = self.cfg
        tp = self.tensor_parallel
        if tp:
            x = enter(x, self.mesh, MODEL_AXIS)
        width = self.qkv.weight.shape[0] // 3  # D, or this rank's D / tp
        heads_here = cfg.n_heads * width // D
        q, k, v = self.qkv(x).split(width, dim=-1)  # contiguous thirds, as jnp.split

        def heads(t):  # (B, S, width) -> (B, heads_here, S, hd)
            return t.reshape(B, S, heads_here, D // cfg.n_heads).transpose(1, 2).contiguous()

        if cfg.seq_axis is not None:
            if self.mesh is None:
                raise ValueError("seq_axis needs a mesh: call DecisionTransformer.use_mesh")
            o = ring_attention(heads(q), heads(k), heads(v), self.mesh, cfg.seq_axis,
                               causal=True)
        else:
            o = causal_flash_attention(heads(q), heads(k), heads(v))
        o = o.transpose(1, 2).reshape(B, S, width)
        o = row_parallel(self.out, o, self.mesh) if tp else self.out(o)
        return self.drop(o)


class Block(nn.Module):
    mesh = None  # set by DecisionTransformer.use_mesh
    tensor_parallel = False  # set by parallel.sharding.shard_dt_params

    def __init__(self, cfg: DTConfig, device: torch.device):
        super().__init__()
        ln_dtype = _dtype(cfg.ln_dtype)
        self.dtype = _dtype(cfg.compute_dtype)
        self.ln1 = LayerNorm(cfg.d_model, ln_dtype, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, ln_dtype, device)
        d_ff = cfg.mlp_ratio * cfg.d_model
        if cfg.moe_experts:
            self.moe = MoEFFN(cfg.d_model, d_ff, cfg.moe_experts, cfg.moe_top_k, self.dtype,
                              cfg.moe_dispatch, device=device)
        else:
            self.fc = Dense(cfg.d_model, d_ff, 1.0, device=device)
            self.proj = Dense(d_ff, cfg.d_model, 1.0, device=device)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(output, the MoE router's aux loss or None)."""
        x = x + self.attn(self.ln1(x).to(self.dtype))
        h = self.ln2(x).to(self.dtype)
        aux = None
        if hasattr(self, "moe"):
            h, aux = self.moe(h)
        elif self.tensor_parallel:
            h = F.gelu(self.fc(enter(h, self.mesh, MODEL_AXIS)), approximate="tanh")
            h = row_parallel(self.proj, h, self.mesh)
        else:
            h = self.proj(F.gelu(self.fc(h), approximate="tanh"))  # flax gelu is tanh
        return x + self.drop(h), aux


class DecisionTransformer(nn.Module):
    """``state_channels`` is the channel count of a multimodal state (2 in
    Minecraft2d, 3 in Skeleton+)."""

    def __init__(self, cfg: DTConfig, device: DeviceLike = None, state_channels: int = 2):
        super().__init__()
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

    def use_mesh(self, mesh) -> "DecisionTransformer":
        """Hands ``mesh`` to every block and attention: the ring of
        ``cfg.seq_axis`` and tensor parallelism run over its axes."""
        for module in self.modules():
            if isinstance(module, (Block, CausalSelfAttention)):
                module.mesh = mesh
        return self

    def forward(
        self,
        rtg: torch.Tensor,  # (B, K) returns-to-go
        states: torch.Tensor,  # (B, K, 2, 84, 84) or (B, K, state_dim)
        actions: torch.Tensor,  # (B, K) int
        timesteps: torch.Tensor,  # (B, K) int, absolute episode timesteps
        return_aux: bool = False,
    ):
        """Action logits (B, K, num_actions) in float32, read from the
        state-token outputs; with ``return_aux``, (logits, the blocks' mean
        MoE aux loss, 0 without MoE)."""
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
        auxes = []
        for i in range(cfg.n_layers):
            block = getattr(self, f"block_{i}")
            x, aux = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if aux is not None:
                auxes.append(aux)
        x = self.ln_f(x)
        logits = self.action_head(x[:, 1::3].to(dt)).float()  # state positions
        if not return_aux:
            return logits
        moe_aux = sum(auxes) / len(auxes) if auxes else logits.new_zeros(())
        return logits, moe_aux
