"""Causal flash attention: hand-written CUDA kernels for Hopper, forward and
backward, under a ``torch.autograd.Function``.

Port of ``mmtrl_tpu/ops/flash_attention.py``.  Layout (B, H, S, D).  Three
kernels, one for each Pallas kernel of the JAX package:

- ``csrc/flash_fwd.cu`` (``_fwd_kernel``): the causal online softmax with
  float32 scores and accumulation; writes O in the input dtype and the
  per-row logsumexp in float32;
- ``csrc/flash_dq.cu`` (``_dq_kernel``) and ``csrc/flash_dkv.cu``
  (``_dkv_kernel``): dQ, and dK with dV, from the probabilities recomputed
  from that logsumexp and delta = rowsum(dO * O).

Each source holds two kernels and takes one by dtype: bfloat16 runs on the
tensor cores (``wgmma`` on tiles that TMA loads into shared memory, on
``csrc/flash_sm90.cuh``); float32 runs on the CUDA cores, because a float32
``wgmma`` computes in TF32, about three decimal digits, which would break
float32's agreement with the plain version to 1e-5.  This is a dispatch on
dtype: every call of a dtype takes its kernel, and neither stands in for
the other.

None of them forms the (S, S) score matrix in device memory.  Like the
Pallas kernels they round the probabilities (and dS) to the input dtype
before each product with a (S, D) operand.

The kernel-level wrappers take a ``(block_q, block_k)`` pair, 0 for each
kernel's default: the float32 CUDA-core kernels choose from
``BLOCK_Q_CHOICES`` x ``BLOCK_K_CHOICES``, and each bf16 kernel has the one
tile ``BF16_BLOCKS``.  A pair that the kernel does not take raises
``ValueError`` naming it, for CPU and CUDA tensors alike.
``causal_flash_attention``, which the model calls, always runs every kernel
at its default.

A CUDA tensor always launches the kernels, at every sequence length: the
JAX package's ``PALLAS_MIN_SEQ`` crossover was measured on a TPU and is not
carried over.  A CPU tensor takes ``flash_attention_fwd_plain`` and
``flash_attention_bwd_plain``, plain PyTorch versions of exactly what the
kernels compute.  Any other device raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

NEG_INF = -1e30
# The float32 CUDA-core kernels: block_q rows per CUDA block, one warp
# each; block_k rows of the other operand per shared-memory tile.
DEFAULT_BLOCK_Q = 8
DEFAULT_BLOCK_K = 32
BLOCK_Q_CHOICES = (4, 8, 16)
BLOCK_K_CHOICES = (32, 64)
# Each bfloat16 kernel on the tensor cores has one tile: 64 rows per CUDA
# block (one consumer warpgroup; query rows for the forward and dQ, key rows
# for dK/dV) by 64 rows of the other operand per TMA tile.
BF16_BLOCKS = (64, 64)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since each count was last set to 0 (plain-version calls on
# CPU tensors do not count): flash_fwd, flash_dq and flash_dkv.
launches = 0
dq_launches = 0
dkv_launches = 0


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


def _causal(S: int, device: torch.device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes, in plain PyTorch: (o, lse) with o in
    q's dtype and lse (B, H, S) float32.  The probabilities exp(s - m) are
    rounded to v's dtype for the PV product and summed in float32 for l."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~_causal(q.shape[-2], q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True).detach()  # the row max cancels in o and lse
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the backward kernels compute, in plain PyTorch, as the JAX
    ``_bwd`` does: (dq, dk, dv) in the inputs' dtype from the saved float32
    ``lse`` and ``delta`` = rowsum(dO * O), both (B, H, S).  P is rounded to
    dO's dtype for dV, dS to the inputs' dtype for dQ and dK."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~_causal(q.shape[-2], q.device), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _blocks(kernel: str, dtype: torch.dtype, block_q: int, block_k: int) -> Tuple[int, int]:
    """The pair ``kernel`` ("flash_fwd", "flash_dq" or "flash_dkv") runs with
    in ``dtype``: each 0 replaced by its default; a value it does not take
    raises, never replaced."""
    if dtype == torch.bfloat16:
        default_q, default_k = BF16_BLOCKS
        qs, ks = (default_q,), (default_k,)
    else:
        qs, ks = BLOCK_Q_CHOICES, BLOCK_K_CHOICES
        default_q, default_k = DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K
    bq, bk = block_q or default_q, block_k or default_k
    if bq not in qs or bk not in ks:
        raise ValueError(
            f"{kernel} in {dtype} takes block_q in {qs} and block_k in {ks} "
            f"(0 = its default, {default_q} and {default_k}), got {block_q}, {block_k}"
        )
    return bq, bk


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, S, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")


def _check_kernel_inputs(first: torch.Tensor, heads_on_grid_y: bool,
                         **tensors: torch.Tensor) -> None:
    """What every kernel requires of a CUDA call, beyond ``_check``;
    ``first`` is the (B, H, S, D) q.  The float32 CUDA-core kernels put
    B * H on grid.y (``heads_on_grid_y``); the bf16 kernels' grid is 1-D."""
    if first.device.type != "cuda":
        raise ValueError(f"no kernel for device {first.device}")
    B, H, S, D = first.shape
    if first.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {first.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dim in {HEAD_DIMS}, got {D}")
    if heads_on_grid_y and B * H > 65535:
        raise ValueError(f"kernel takes B * H <= 65535, got {B * H}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    from mmtrl_tpu_torch.ops._build import load_library

    lib = load_library(name)
    n_ptrs = {"flash_fwd": 5, "flash_dq": 7, "flash_dkv": 8}[name]
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    smem = getattr(lib, f"{name}_bf16_smem")  # dynamic shared memory by head dim
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_int
    return lib


def _launch(name: str, tensors, q: torch.Tensor, block_q: int, block_k: int) -> None:
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        err = getattr(_library(name), name)(
            *(t.data_ptr() for t in tensors),
            B * H, S, D, _DTYPE_CODES[q.dtype], block_q, block_k, D**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_q: int = 0,
    block_k: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention over (B, H, S, D) inputs.

    CUDA tensors launch the kernel of their dtype: contiguous, float32 or
    bfloat16, D in ``HEAD_DIMS``, 16-byte aligned.  bfloat16 takes the
    tensor-core kernel, float32 the CUDA-core kernel (a float32 ``wgmma``
    would compute in TF32).  ``block_q`` (query rows per CUDA block) and
    ``block_k`` (keys per tile) are used as given, 0 for the default: the
    float32 kernel takes ``BLOCK_Q_CHOICES`` x ``BLOCK_K_CHOICES``, the
    bf16 kernel only ``BF16_BLOCKS``.  CPU tensors take the plain
    version.
    """
    global launches
    _check(q, k, v)
    block_q, block_k = _blocks("flash_fwd", q.dtype, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v)
    _check_kernel_inputs(q, q.dtype == torch.float32, q=q, k=k, v=v)
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    _launch("flash_fwd", (q, k, v, o, lse), q, block_q, block_k)
    launches += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"do must match q: {tuple(do.shape)} {do.dtype} {do.device} against "
            f"{tuple(q.shape)} {q.dtype} {q.device}"
        )
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(
                f"{name} must be float32 of shape {tuple(q.shape[:3])} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if q.device.type != "cpu":
        _check_kernel_inputs(q, q.dtype == torch.float32, q=q, k=k, v=v, do=do, lse=lse,
                             delta=delta)


def flash_attention_dq(q, k, v, do, lse, delta, block_q: int = 0, block_k: int = 0):
    """dq alone: ``flash_dq`` on CUDA tensors (``block_q`` query rows per
    CUDA block, ``block_k`` keys per tile), the plain version on the CPU."""
    global dq_launches
    _check_bwd(q, k, v, do, lse, delta)
    block_q, block_k = _blocks("flash_dq", q.dtype, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta)[0]
    dq = torch.empty_like(q)
    if q.numel():
        _launch("flash_dq", (q, k, v, do, lse, delta, dq), q, block_q, block_k)
        dq_launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, block_q: int = 0, block_k: int = 0):
    """(dk, dv) alone: ``flash_dkv`` on CUDA tensors (``block_q`` key rows
    per CUDA block, ``block_k`` queries per tile), the plain version on the
    CPU."""
    global dkv_launches
    _check_bwd(q, k, v, do, lse, delta)
    block_q, block_k = _blocks("flash_dkv", q.dtype, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _launch("flash_dkv", (q, k, v, do, lse, delta, dk, dv), q, block_q, block_k)
        dkv_launches += 1
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    block_q: int = 0,
    block_k: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of causal attention from the forward's inputs, the
    output gradient ``do`` (B, H, S, D) and the float32 ``lse`` and
    ``delta`` = rowsum(dO * O), both (B, H, S).

    CUDA tensors launch ``flash_dq`` and then ``flash_dkv``, with the
    forward's requirements on every tensor; as in the forward, bfloat16
    takes the tensor-core kernels and float32 the CUDA-core ones.
    ``block_q`` is the rows per CUDA block (query rows for dQ, key rows for
    dK/dV) and ``block_k`` the rows of the other operand per tile; 0 picks
    the default: ``BF16_BLOCKS`` is the bf16 kernels' one pair.  CPU tensors
    take the plain version.
    """
    if q.device.type == "cpu":
        _check_bwd(q, k, v, do, lse, delta)
        for kernel in ("flash_dq", "flash_dkv"):
            _blocks(kernel, q.dtype, block_q, block_k)
        return flash_attention_bwd_plain(q, k, v, do, lse, delta)
    dq = flash_attention_dq(q, k, v, do, lse, delta, block_q, block_k)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, block_q, block_k))


class FlashAttention(torch.autograd.Function):
    """Causal attention with the kernels' backward; the counterpart of the
    JAX package's ``jax.custom_vjp``.  Saves (q, k, v, o, lse); every
    kernel runs at its default blocks."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The gradient arrives through the caller's transpose and reshape, so
        # it need not be contiguous; delta uses O as the forward returned it.
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        return flash_attention_bwd(q, k, v, do, lse, delta)


def causal_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal multi-head attention, (B, H, S, D) -> (B, H, S, D),
    differentiable through the backward kernels (the plain backward on CPU
    tensors); every kernel runs at its default blocks."""
    return FlashAttention.apply(q, k, v)
