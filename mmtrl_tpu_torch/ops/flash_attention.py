"""Causal flash attention: a hand-written CUDA forward kernel for Hopper.

Port of ``mmtrl_tpu/ops/flash_attention.py``.  Layout (B, H, S, D).  The
kernel (``csrc/flash_fwd.cu``, the port of the Pallas ``_fwd_kernel``) runs
the causal online softmax with float32 scores and accumulation, writes O in
the input dtype and the per-row logsumexp in float32, and never forms the
(S, S) score matrix in device memory.

A CUDA tensor always launches the kernel, at every sequence length: the JAX
package's ``PALLAS_MIN_SEQ`` crossover was measured on a TPU and is not
carried over.  A CPU tensor takes ``flash_attention_fwd_plain``, the plain
PyTorch version of exactly what the kernel computes.  Any other device
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 8  # query rows per CUDA block, one warp each
DEFAULT_BLOCK_K = 32  # keys per shared-memory tile, one per lane
BLOCK_Q_CHOICES = (4, 8, 16)
BLOCK_K_CHOICES = (32, 64)
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last set to 0 (plain-version calls on
# CPU tensors do not count).
launches = 0


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention, (B, H, S, D) -> (B, H, S, D); the JAX reference's
    arithmetic: float32 scores, a -1e30 mask, probabilities cast to v's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    S = q.shape[-2]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain PyTorch: (o, lse) with o in q's
    dtype and lse (B, H, S) float32; probabilities stay float32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    S = q.shape[-2]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def _check(q, k, v, block_q, block_k) -> Tuple[int, int]:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, S, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    block_q = block_q or DEFAULT_BLOCK_Q
    block_k = block_k or DEFAULT_BLOCK_K
    if block_q not in BLOCK_Q_CHOICES or block_k not in BLOCK_K_CHOICES:
        raise ValueError(
            f"block_q must be one of {BLOCK_Q_CHOICES} and block_k one of "
            f"{BLOCK_K_CHOICES} (0 = default), got {block_q}, {block_k}"
        )
    return block_q, block_k


@functools.cache
def _library() -> ctypes.CDLL:
    from mmtrl_tpu_torch.ops._build import load_library

    lib = load_library("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_q: int = 0,
    block_k: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention over (B, H, S, D) inputs.

    CUDA tensors launch the kernel: contiguous, float32 or bfloat16, D in
    ``HEAD_DIMS``, 16-byte aligned.  ``block_q`` (query rows per CUDA block)
    and ``block_k`` (keys per shared-memory tile) are used as given; 0 picks
    the default.  CPU tensors take the plain version.
    """
    global launches
    block_q, block_k = _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, H, S, D = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dim in {HEAD_DIMS}, got {D}")
    if B * H > 65535:  # grid.y
        raise ValueError(f"kernel takes B * H <= 65535, got {B * H}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B * H, S, D, _DTYPE_CODES[q.dtype], block_q, block_k, D**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    launches += 1
    return o, lse


def causal_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_q: int = 0,
    block_k: int = 0,
) -> torch.Tensor:
    """Causal multi-head attention, (B, H, S, D) -> (B, H, S, D)."""
    return flash_attention_fwd(q, k, v, block_q, block_k)[0]
