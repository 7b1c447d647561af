#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mmtrl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any fault raises and exits nonzero:

1. build   -- nvcc builds every kernel of the serving path from ``csrc/``.
2. kernel  -- each kernel against its plain PyTorch version on the card, at
              the serving path's shapes and a few more (O and LSE).
3. serve   -- the flagship multimodal Decision Transformer (d_model 512, 6
              layers, 4 heads of 128, K = 30, bf16, random weights from a
              seed) evaluated greedily in Minecraft2d through ``evaluate_dt``,
              16 envs x 64 steps; every attention call must launch the
              kernel.  Its logits are first held against the same weights
              on the CPU (plain attention) on a batch of real observations.
4. timing  -- kernel, plain version and ``F.scaled_dot_product_attention``
              (a yardstick the port never calls) at the serving and the
              long-context shapes, beside the bound from bytes and FLOPs;
              device time with the queue kept full, and the kernel's time
              per call when Python issues the calls back to back.

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.  Without CUDA it exits 1
and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

SEED = 0
KERNEL_SOURCES = ("flash_fwd",)
SERVE_SHAPE = (16, 4, 90, 128)  # (B, H, S, D) of every attention call in serve
LONG_SHAPE = (16, 4, 1026, 128)  # the long-context DT, K = 342
# (shape, dtype, (block_q, block_k)); (0, 0) is the default the model uses
KERNEL_CASES = [
    (SERVE_SHAPE, torch.bfloat16, (0, 0)),
    (LONG_SHAPE, torch.bfloat16, (0, 0)),
    ((2, 4, 37, 64), torch.bfloat16, (0, 0)),
    ((2, 4, 37, 64), torch.bfloat16, (4, 64)),
    ((2, 4, 37, 64), torch.bfloat16, (16, 32)),
    ((4, 4, 200, 128), torch.float32, (0, 0)),
    ((4, 4, 200, 128), torch.float32, (16, 64)),
]
# O: the kernel and the plain version both round one float32 result to the
# output dtype, so they may differ by one rounding of it (bf16: 2^-8
# relative) plus float32 summation order.  LSE is float32 in both.
O_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}  # (atol, rtol)
LSE_ATOL = 1e-4
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def qkv(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


def cuda_ms(fn, reps: int, prefill: bool = True) -> float:
    """Device ms per call over ``reps`` back-to-back calls.  With ``prefill``
    the stream first sleeps ~25 ms, so the host has queued every call before
    the first runs and host overhead leaves no gaps; without it the time is
    what back-to-back calls from Python achieve."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if prefill:
        torch.cuda._sleep(50_000_000)  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(shape, dtype):
    """(ms, 'bytes' | 'operations'): q, k, v read once, o and lse written
    once; QK^T and PV over the S(S+1)/2 causal pairs, 2 FLOPs a MAC."""
    B, H, S, D = shape
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * H * S * D * elem + B * H * S * 4
    flops = 4 * B * H * D * S * (S + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from mmtrl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fresh = [n for n in KERNEL_SOURCES if not _build.library_path(n).exists()]
    libs = _build.build(KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(line.split()[4]) for line in log.splitlines() if "spill stores" in line)
        emit("build", kernel=name, seconds=seconds, built=name in fresh,
             max_registers=max(regs, default=None), spill_store_bytes=spills)


def phase_kernel():
    from mmtrl_tpu_torch.ops import flash_attention as fa

    errs = {}
    for i, (shape, dtype, blocks) in enumerate(KERNEL_CASES):
        q, k, v = qkv(shape, dtype, SEED + i)
        o, lse = fa.flash_attention_fwd(q, k, v, *blocks)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
        torch.cuda.synchronize()
        atol, rtol = O_TOL[dtype]
        d_o = (o.float() - o_ref.float()).abs()
        err_o, err_lse = d_o.max().item(), (lse - lse_ref).abs().max().item()
        ok = bool((d_o <= atol + rtol * o_ref.float().abs()).all()) and err_lse <= LSE_ATOL
        emit("kernel", kernel="flash_fwd", shape=list(shape), dtype=str(dtype),
             blocks=list(blocks), max_abs_err_o=err_o, max_abs_err_lse=err_lse,
             o_tol=[atol, rtol], lse_atol=LSE_ATOL, ok=ok)
        check(ok, f"flash_fwd disagrees with its plain version at {shape} {dtype} {blocks}")
        check(math.isfinite(err_o), "non-finite output")
        errs[(shape, dtype, blocks)] = err_o
    return errs[(SERVE_SHAPE, torch.bfloat16, (0, 0))]


def flagship_cfg(compute_dtype: str):
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig

    # scripts/dt_minecraft.py's defaults; dropout is off in evaluation.
    return DTConfig(num_actions=4, context_len=30, d_model=512, n_layers=6, n_heads=4,
                    max_timestep=64, compute_dtype=compute_dtype)


def phase_reference():
    """Flagship logits on the card (kernel) against the same weights on the
    CPU (plain attention), on two context windows of real observations."""
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
    from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer

    env = Minecraft2d(device="cpu")
    obs, _ = env.reset(2 * 30, torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    batch = (
        torch.rand(2, 30, generator=g) * 10.0,
        obs.reshape(2, 30, 2, 84, 84),
        torch.randint(0, 4, (2, 30), generator=g),
        torch.arange(30).repeat(2, 1),
    )
    # float32 runs in full float32 on both sides (no TF32); bfloat16 rounds
    # every product on both sides, in other places and orders.
    for compute_dtype, atol_of_max in (("float32", 1e-3), ("bfloat16", 5e-2)):
        torch.manual_seed(SEED)
        cfg = flagship_cfg(compute_dtype)
        model = DecisionTransformer(cfg).eval()
        cpu_model = DecisionTransformer(cfg, device="cpu").eval()
        cpu_model.load_state_dict(model.state_dict())
        with torch.inference_mode():
            out = model(*(t.cuda() for t in batch)).cpu()
            ref = cpu_model(*batch)
        err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
        ok = out.shape == (2, 30, 4) and math.isfinite(err) and err <= atol_of_max * scale
        emit("reference", model="flagship DT", compute_dtype=compute_dtype,
             max_abs_err_logits=err, max_abs_logit=scale, tol_of_max=atol_of_max, ok=ok)
        check(ok, f"flagship logits on the card disagree with the CPU ({compute_dtype})")


def phase_serve():
    from mmtrl_tpu_torch.algos.dt import evaluate_dt
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
    from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer
    from mmtrl_tpu_torch.ops import flash_attention as fa

    cfg = flagship_cfg("bfloat16")
    num_envs, num_steps = 16, 64
    torch.manual_seed(SEED)
    model = DecisionTransformer(cfg)
    env = Minecraft2d()

    def run():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        out = evaluate_dt(env, cfg, model, 10.0, num_envs=num_envs, num_steps=num_steps,
                          greedy=True, rtg_clip=10.0, generator=gen)
        torch.cuda.synchronize()
        return {k: float(v) for k, v in out.items()}, time.perf_counter() - t0

    fa.launches = 0
    stats, first_s = run()
    launches = fa.launches
    _, second_s = run()
    emit("serve", model="flagship DT bf16", num_envs=num_envs, num_steps=num_steps,
         kernel_launches=launches, expected_launches=cfg.n_layers * num_steps,
         wall_s_first=first_s, wall_s_second=second_s, **stats)
    check(launches == cfg.n_layers * num_steps, f"{launches} kernel launches")
    check(all(math.isfinite(v) for v in stats.values()), "non-finite episode stats")
    # every episode ends within MAX_ITER = 30 steps, so 64 steps end >= 2 per env
    check(stats["eval/episodes"] >= 2 * num_envs, "too few finished episodes")
    check(1.0 <= stats["eval/episodic_length"] <= 30.0, "episode length out of range")
    return launches


def phase_timing(smi: str):
    import torch.nn.functional as F

    from mmtrl_tpu_torch.ops import flash_attention as fa

    rows = {}
    for label, shape, reps in (("serve", SERVE_SHAPE, 200), ("long", LONG_SHAPE, 20)):
        q, k, v = qkv(shape, torch.bfloat16, SEED)
        bound_ms, bound_by = attention_bound(shape, torch.bfloat16)
        blocks_ms = {
            f"{bq}x{bk}": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bq, bk), reps)
            for bq in fa.BLOCK_Q_CHOICES for bk in fa.BLOCK_K_CHOICES
        }
        row = dict(
            ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), reps),
            ms_from_python=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), reps, False),
            plain_ms=cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v), reps),
            library_ms=cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), reps
            ),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        emit("timing", kernel="flash_fwd", shape_name=label, shape=list(shape),
             dtype="bfloat16", card=smi, blocks_ms=blocks_ms, **row)
        rows[label] = row
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    # float32 reference checks compare full-precision float32 on both sides.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    phase_build()
    max_abs_err = phase_kernel()
    phase_reference()
    launches = phase_serve()
    timing = phase_timing(smi)["serve"]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mmtrl_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mmtrl_tpu/ops/flash_attention.py:52",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
