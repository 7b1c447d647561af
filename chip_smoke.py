#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mmtrl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any fault raises and exits nonzero:

1. build     -- nvcc builds every kernel source in ``csrc/``, all at once;
                per source the instantiations, most registers and spills and
                the ptxas warnings that it serialized ``wgmma``s, and per
                bf16 instantiation (one per kernel and head dim) its
                registers, spills, static and dynamic shared memory.
2. kernel    -- each kernel against its plain PyTorch version on the card:
                the forward (O and LSE) and the backward (dQ, dK, dV) at the
                serving and training paths' shapes and a few more; then the
                bf16 forward and the bf16 backward at every head dim and S in
                ``SWEEP_SEQS``, with one head all NaN, and with inputs whose
                last row ends their allocation.
3. reference -- flagship logits on the card against the same weights on the
                CPU (plain attention), float32 and bf16.
4. grad      -- the loss and every parameter's gradient of the flagship-width
                DT on the card against the same weights on the CPU, with
                ``remat`` off and on.
5. serve     -- the flagship multimodal Decision Transformer (d_model 512, 6
                layers, 4 heads of 128, K = 30, bf16, random weights from a
                seed) evaluated greedily in Minecraft2d through
                ``evaluate_dt``, 16 envs x 64 steps; every attention call
                must launch the forward kernel.
6. train     -- ``bench.py``'s training configuration (B = 128, K = 30,
                dropout 0.1, bf16 LayerNorm) on a 16 x 6144-step buffer made
                on the card: warm steps, then timed steps; every step must
                launch each of the three kernels once per layer.  Then
                collect -> train -> evaluate in Minecraft2d on the card.
7. timing    -- each kernel, its plain version and the PyTorch call that
                computes the same function (``F.scaled_dot_product_attention``
                and its backward, a yardstick the port never calls) at the
                serving, training and long-context shapes, beside the bound
                from bytes and FLOPs.

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.  Without CUDA it exits 1
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import torch

SEED = 0
KERNEL_SOURCES = ("flash_fwd", "flash_dq", "flash_dkv")
SERVE_SHAPE = (16, 4, 90, 128)  # (B, H, S, D) of every attention call in serve
TRAIN_SHAPE = (128, 4, 90, 128)  # ... in a bench.py train step (B = 128)
LONG_SHAPE = (16, 4, 1026, 128)  # the long-context DT, K = 342
# (shape, dtype, forward (block_q, block_k), backward (block_q, block_k));
# (0, 0) is each kernel's default, which the model uses.  The bf16 kernels
# (tensor cores) have the one tile (64, 64); the float32 CUDA-core kernels
# take their own choices.
KERNEL_CASES = [
    (SERVE_SHAPE, torch.bfloat16, (0, 0), (0, 0)),
    (TRAIN_SHAPE, torch.bfloat16, (0, 0), (0, 0)),
    (LONG_SHAPE, torch.bfloat16, (0, 0), (0, 0)),
    ((2, 4, 37, 64), torch.bfloat16, (0, 0), (0, 0)),
    ((2, 4, 37, 64), torch.bfloat16, (64, 64), (64, 64)),
    ((2, 4, 37, 64), torch.float32, (0, 0), (4, 64)),
    ((2, 4, 37, 64), torch.float32, (4, 64), (16, 32)),
    ((4, 4, 200, 128), torch.float32, (0, 0), (0, 0)),
    ((4, 4, 200, 128), torch.float32, (16, 64), (16, 64)),
    ((2, 2, 37, 16), torch.bfloat16, (0, 0), (0, 0)),
    ((2, 2, 37, 16), torch.float32, (4, 64), (4, 64)),
    ((2, 2, 70, 32), torch.float32, (16, 32), (16, 32)),
]
# The bf16 kernels, forward and backward, at every head dim and these
# sequence lengths: one row, one tile, a ragged tile on either side of 64 and
# the model's lengths.
SWEEP_DIMS = (16, 32, 64, 128)
SWEEP_SEQS = (1, 37, 63, 64, 65, 90, 1026)
# Exactly 12 MiB of bf16 each for q, k, v and dO, so that the caching
# allocator gives each a segment of its own and the last row ends where the
# segment does; S = 96 leaves a ragged last tile of 32 rows.
END_OF_ALLOCATION_SHAPE = (128, 4, 96, 128)
# O: the kernel and the plain version both round one float32 result to the
# output dtype, so they may differ by one rounding of it (bf16: 2^-8
# relative) plus float32 summation order.  LSE is float32 in both.
O_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}  # (atol, rtol)
LSE_ATOL = 1e-4
# dQ, dK, dV: both sides sum the same float32 terms in other orders, and in
# bf16 both round P and dS to bf16 before the products, where a float32
# difference in the last place can flip a rounding; the largest difference
# is held to this share of the tensor's largest magnitude (at least 1).
GRAD_TOL_OF_MAX = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
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


def randn(shape, dtype, seed, n=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(n)]


def cuda_ms(fn, reps: int, prefill: bool = True) -> float:
    """Device ms per call over ``reps`` back-to-back calls.  With ``prefill``
    the stream first sleeps ~100 ms, so the host has queued every call before
    the first runs and host overhead leaves no gaps (an autograd backward
    costs the host some 0.3 ms a call); without it the time is what
    back-to-back calls from Python achieve."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if prefill:
        torch.cuda._sleep(200_000_000)  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(kernel: str, shape, dtype):
    """(ms, 'bytes' | 'operations') of one kernel call: every (B, H, S, D)
    input read once and every output written once, with the float32 (B, H, S)
    vectors; FLOPs over the S(S+1)/2 causal pairs, 2 a MAC: QK^T and PV in
    the forward, QK^T, dO V^T and dS K for dQ, and those with P^T dO and
    dS^T Q, less dS K, for dK/dV."""
    B, H, S, D = shape
    elem = torch.finfo(dtype).bits // 8
    mats, vecs, macs = {"flash_fwd": (4, 1, 2), "flash_dq": (5, 2, 3),
                        "flash_dkv": (6, 2, 4)}[kernel]
    nbytes = mats * B * H * S * D * elem + vecs * B * H * S * 4
    flops = 2 * macs * B * H * D * S * (S + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_counts():
    from mmtrl_tpu_torch.ops import flash_attention as fa

    fa.launches = fa.dq_launches = fa.dkv_launches = 0


def read_counts():
    from mmtrl_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.launches, "flash_dq": fa.dq_launches,
            "flash_dkv": fa.dkv_launches}


def ptxas_entries(log: str):
    """(mangled kernel name, registers, spill store bytes, static shared
    bytes) of each kernel in an ``nvcc -Xptxas -v`` log."""
    entries, name, spills = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name is not None:
            regs = int(line.split("Used")[1].split()[0])
            smem = re.search(r"(\d+) bytes smem", line)
            entries.append((name, regs, spills, int(smem.group(1)) if smem else 0))
            name = None
    return entries


def phase_build():
    from mmtrl_tpu_torch.ops import _build
    from mmtrl_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fresh = [n for n in KERNEL_SOURCES if not _build.library_path(n).exists()]
    libs = _build.build(KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        entries = ptxas_entries(log)
        # ptxas C7513-C7518: waits inserted into a kernel's wgmma pipeline
        serialized = sorted({line.strip() for line in log.splitlines()
                             if "wgmma.mma_async instructions are serialized" in line})
        emit("build", kernel=name, seconds=seconds, built=name in fresh,
             instantiations=len(entries), max_registers=max((e[1] for e in entries), default=None),
             spill_store_bytes=sum(e[2] for e in entries), serialized_wgmma=serialized)
        # The bf16 kernel's instantiations one by one: <kernel>_sm90<D>.
        smem_of = getattr(fa._library(name), f"{name}_bf16_smem")
        for mangled, regs, spills, static in entries:
            found = re.search(r"_sm90ILi(\d+)E", mangled)
            if found:
                d = int(found.group(1))
                emit("build", kernel=f"{name} bf16", head_dim=d, blocks=list(fa.BF16_BLOCKS),
                     registers=regs, spill_store_bytes=spills, static_smem_bytes=static,
                     dynamic_smem_bytes=smem_of(d), build_seconds=seconds)


def check_fwd(q, k, v, blocks, what: str, heads=None):
    """The forward kernel against its plain version on the same inputs, over
    the (B, H) heads selected by the boolean mask ``heads`` (all by
    default); returns the largest differences of O and LSE, and the
    kernel's O and LSE."""
    from mmtrl_tpu_torch.ops import flash_attention as fa

    out = fa.flash_attention_fwd(q, k, v, *blocks)
    torch.cuda.synchronize()
    o, lse = out
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    if heads is not None:
        o, lse, o_ref, lse_ref = o[heads], lse[heads], o_ref[heads], lse_ref[heads]
    atol, rtol = O_TOL[q.dtype]
    d_o = (o.float() - o_ref.float()).abs()
    err_o, err_lse = d_o.max().item(), (lse - lse_ref).abs().max().item()
    ok = (bool((d_o <= atol + rtol * o_ref.float().abs()).all()) and err_lse <= LSE_ATOL
          and math.isfinite(err_o) and math.isfinite(err_lse))
    check(ok, f"flash_fwd disagrees with its plain version: {what}: "
              f"O {err_o}, LSE {err_lse}")
    return err_o, err_lse, out


def check_bwd(q, k, v, do, o, lse, blocks, what: str, heads=None):
    """dQ and dK/dV against the plain backward on the same inputs (both sides
    get the same lse and delta), over the (B, H) heads selected by the boolean
    mask ``heads`` (all by default); returns the largest difference of each
    of dQ, dK and dV."""
    from mmtrl_tpu_torch.ops import flash_attention as fa

    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, *blocks)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, *blocks)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    tol = GRAD_TOL_OF_MAX[q.dtype]
    errs = {}
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        if heads is not None:
            out, ref = out[heads], ref[heads]
        err = (out.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        errs[name] = err
        check(out.dtype == q.dtype and math.isfinite(err) and err <= tol * scale,
              f"{name} disagrees with the plain backward: {what}: {err} against "
              f"{tol} x {scale}")
    return errs


def phase_kernel():
    """Every kernel against its plain version; returns the largest error of
    each at the training shape."""
    from mmtrl_tpu_torch.ops import flash_attention as fa

    errs = {}
    for i, (shape, dtype, blocks, bwd_blocks) in enumerate(KERNEL_CASES):
        q, k, v, do = randn(shape, dtype, SEED + i, 4)
        err_o, err_lse, (o, lse) = check_fwd(q, k, v, blocks, f"{shape} {dtype} {blocks}")
        emit("kernel", kernel="flash_fwd", shape=list(shape), dtype=str(dtype),
             blocks=list(blocks), max_abs_err_o=err_o, max_abs_err_lse=err_lse,
             o_tol=list(O_TOL[dtype]), lse_atol=LSE_ATOL, ok=True)
        bwd_errs = check_bwd(q, k, v, do, o, lse, bwd_blocks, f"{shape} {dtype} {bwd_blocks}")
        emit("kernel", kernel="flash_dq+flash_dkv", shape=list(shape), dtype=str(dtype),
             blocks=list(bwd_blocks), **{f"max_abs_err_{n}": e for n, e in bwd_errs.items()},
             tol_of_max=GRAD_TOL_OF_MAX[dtype], ok=True)
        if (shape, dtype, blocks) == (TRAIN_SHAPE, torch.bfloat16, (0, 0)):
            errs = {"flash_fwd": err_o, "flash_dq": bwd_errs["dq"],
                    "flash_dkv": max(bwd_errs["dk"], bwd_errs["dv"])}

    bf16 = torch.bfloat16
    for D in SWEEP_DIMS:
        worst = dict.fromkeys(("o", "lse", "dq", "dk", "dv"), 0.0)
        for S in SWEEP_SEQS:
            q, k, v, do = randn((2, 3, S, D), bf16, SEED + S + D, 4)
            err_o, err_lse, (o, lse) = check_fwd(q, k, v, (0, 0), f"D {D} S {S}")
            found = {"o": err_o, "lse": err_lse,
                     **check_bwd(q, k, v, do, o, lse, (0, 0), f"D {D} S {S}")}
            worst = {n: max(worst[n], found[n]) for n in worst}
        emit("kernel", kernel="flash_fwd+flash_dq+flash_dkv", case="bf16 sweep", head_dim=D,
             heads=[2, 3], seqs=list(SWEEP_SEQS), **{f"max_abs_err_{n}": e for n, e in worst.items()},
             ok=True)

    # One head all NaN (K and V for the forward; Q, K, V and dO, and so its
    # lse and delta, for the backward): every other head must still equal the
    # plain version, so no tile or vector load reads across a head's last row.
    for S in (37, 90):
        q, k, v, do = randn((2, 4, S, 128), bf16, SEED + 7, 4)
        others = torch.ones(2, 4, dtype=torch.bool, device="cuda")
        others[0, 1] = False
        k[0, 1], v[0, 1] = float("nan"), float("nan")
        err_o, err_lse, _ = check_fwd(q, k, v, (0, 0), f"NaN head, S {S}", others)
        q[0, 1], do[0, 1] = float("nan"), float("nan")
        o, lse = fa.flash_attention_fwd(q, k, v)
        bwd_errs = check_bwd(q, k, v, do, o, lse, (0, 0), f"NaN head, S {S}", others)
        emit("kernel", kernel="flash_fwd+flash_dq+flash_dkv", case="NaN head (0, 1)",
             shape=[2, 4, S, 128], max_abs_err_o=err_o, max_abs_err_lse=err_lse,
             **{f"max_abs_err_{n}": e for n, e in bwd_errs.items()}, ok=True)

    # q, k, v and dO each alone in a segment that ends with their last row.
    torch.cuda.empty_cache()
    q, k, v, do = (torch.empty(END_OF_ALLOCATION_SHAPE, dtype=bf16, device="cuda")
                   for _ in range(4))
    for t, src in zip((q, k, v, do), randn(END_OF_ALLOCATION_SHAPE, bf16, SEED + 8, 4)):
        t.copy_(src)
    nbytes = q.numel() * q.element_size()
    segments = {s["address"]: s["total_size"] for s in torch.cuda.memory_snapshot()}
    check(all(segments.get(t.data_ptr()) == nbytes for t in (q, k, v, do)),
          "the end-of-allocation case did not get segments of its own")
    err_o, err_lse, (o, lse) = check_fwd(q, k, v, (0, 0), "end of allocation")
    bwd_errs = check_bwd(q, k, v, do, o, lse, (0, 0), "end of allocation")
    emit("kernel", kernel="flash_fwd+flash_dq+flash_dkv", case="last row ends its allocation",
         shape=list(END_OF_ALLOCATION_SHAPE), segment_bytes=nbytes,
         max_abs_err_o=err_o, max_abs_err_lse=err_lse,
         **{f"max_abs_err_{n}": e for n, e in bwd_errs.items()}, ok=True)
    return errs


def flagship_cfg(compute_dtype: str, **changes):
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig

    # scripts/dt_minecraft.py's defaults; dropout is off in evaluation.
    cfg = DTConfig(num_actions=4, context_len=30, d_model=512, n_layers=6, n_heads=4,
                   max_timestep=64, compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, **changes)


def observation_batch(B: int):
    """B context windows of real Minecraft2d observations, on the CPU."""
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d

    env = Minecraft2d(device="cpu")
    obs, _ = env.reset(B * 30, torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    return (
        torch.rand(B, 30, generator=g) * 10.0,
        obs.reshape(B, 30, 2, 84, 84),
        torch.randint(0, 4, (B, 30), generator=g),
        torch.arange(30).repeat(B, 1),
    )


def twin_models(cfg):
    """The same random weights as a card model and a CPU model."""
    from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer

    torch.manual_seed(SEED)
    model = DecisionTransformer(cfg)
    cpu_model = DecisionTransformer(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    return model, cpu_model


def phase_reference():
    """Flagship logits on the card (kernel) against the same weights on the
    CPU (plain attention), on two context windows of real observations."""
    batch = observation_batch(2)
    # float32 runs in full float32 on both sides (no TF32); bfloat16 rounds
    # every product on both sides, in other places and orders.
    for compute_dtype, atol_of_max in (("float32", 1e-3), ("bfloat16", 5e-2)):
        model, cpu_model = twin_models(flagship_cfg(compute_dtype))
        model.eval()
        cpu_model.eval()
        with torch.inference_mode():
            out = model(*(t.cuda() for t in batch)).cpu()
            ref = cpu_model(*batch)
        err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
        ok = out.shape == (2, 30, 4) and math.isfinite(err) and err <= atol_of_max * scale
        emit("reference", model="flagship DT", compute_dtype=compute_dtype,
             max_abs_err_logits=err, max_abs_logit=scale, tol_of_max=atol_of_max, ok=ok)
        check(ok, f"flagship logits on the card disagree with the CPU ({compute_dtype})")


def phase_grad():
    """Loss and gradients of the flagship-width DT, card against CPU, in train
    mode with dropout 0: float32 (no TF32 on either side), then bf16 compute
    with bf16 LayerNorm with remat off and on."""
    from mmtrl_tpu_torch.algos.dt.train import dt_loss

    rtg, states, actions, ts = observation_batch(2)
    mask = torch.ones(2, 30, dtype=torch.bool)
    mask[1, :7] = False
    # (compute dtype, remat, tolerance): float32 differs by summation order
    # only; bf16 rounds every product and the gradient flows back through six
    # layers of them, rounded in other places on the two sides.
    cases = (("float32", False, 1e-3), ("bfloat16", False, 5e-2), ("bfloat16", True, 5e-2))
    for compute_dtype, remat, tol in cases:
        ln = "bfloat16" if compute_dtype == "bfloat16" else "float32"
        cfg = flagship_cfg(compute_dtype, ln_dtype=ln, dropout=0.0, remat=remat)
        model, cpu_model = twin_models(cfg)
        sides = []
        reset_counts()
        for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
            m.train()
            b = [t.to(dev) for t in (rtg, states, actions, ts, mask)]
            loss, _ = dt_loss(m(*b[:4]), b[2], b[4])
            grads = torch.autograd.grad(loss, list(m.parameters()))
            sides.append((loss.item(), [g.float().cpu() for g in grads]))
        counts = read_counts()
        (loss_c, g_c), (loss_r, g_r) = sides
        worst, worst_name = 0.0, ""
        for (name, _), a, b in zip(model.named_parameters(), g_c, g_r):
            rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            if not math.isfinite(rel) or rel > worst:
                worst, worst_name = rel, name
        layers = cfg.n_layers
        expected = {"flash_fwd": layers * (2 if remat else 1), "flash_dq": layers,
                    "flash_dkv": layers}
        loss_err = abs(loss_c - loss_r)
        ok = (math.isfinite(loss_c) and loss_err <= tol * abs(loss_r)
              and worst <= tol and counts == expected)
        emit("grad", model="flagship DT", compute_dtype=compute_dtype, remat=remat,
             loss_card=loss_c, loss_cpu=loss_r, worst_grad_err_of_max=worst,
             worst_param=worst_name, tol_of_max=tol, launches=counts,
             expected_launches=expected, ok=ok)
        check(ok, f"flagship gradients on the card disagree with the CPU "
                  f"({compute_dtype}, remat={remat})")


def phase_serve():
    from mmtrl_tpu_torch.algos.dt import evaluate_dt
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
    from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer

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

    reset_counts()
    stats, first_s = run()
    counts = read_counts()
    launches = counts["flash_fwd"]
    _, second_s = run()
    emit("serve", model="flagship DT bf16", num_envs=num_envs, num_steps=num_steps,
         kernel_launches=launches, expected_launches=cfg.n_layers * num_steps,
         wall_s_first=first_s, wall_s_second=second_s, **stats)
    check(counts == {"flash_fwd": cfg.n_layers * num_steps, "flash_dq": 0, "flash_dkv": 0},
          f"{counts} kernel launches")
    check(all(math.isfinite(v) for v in stats.values()), "non-finite episode stats")
    # every episode ends within MAX_ITER = 30 steps, so 64 steps end >= 2 per env
    check(stats["eval/episodes"] >= 2 * num_envs, "too few finished episodes")
    check(1.0 <= stats["eval/episodic_length"] <= 30.0, "episode length out of range")
    return launches


def phase_train(smi: str):
    """bench.py's training step on the card, then collect -> train ->
    evaluate.  Returns the launches of the timed bench.py-config run."""
    from mmtrl_tpu_torch.algos.dt import (
        DTTrainConfig,
        collect_trajectories,
        create_dt_state,
        evaluate_dt,
        make_dt_train_step,
        make_dt_train_steps,
    )
    from mmtrl_tpu_torch.algos.dt.data import random_buffer
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig

    B, K, warm, timed = 128, 30, 3, 20
    cfg = DTConfig(num_actions=4, context_len=K, d_model=512, n_layers=6, n_heads=4,
                   dropout=0.1, max_timestep=64, ln_dtype="bfloat16")
    tcfg = DTTrainConfig(batch_size=B, total_steps=1000)
    buffer = random_buffer(16, 6144, torch.Generator(device="cuda").manual_seed(SEED))
    state = create_dt_state(cfg, tcfg, seed=SEED)
    step = make_dt_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.manual_seed(SEED)  # dropout
    before = [p.detach().clone() for p in state.model.parameters()]
    per_step = {"flash_fwd": cfg.n_layers, "flash_dq": cfg.n_layers, "flash_dkv": cfg.n_layers}
    losses = []
    reset_counts()
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        counts = read_counts()
        state, metrics = step(state, buffer.sample(gen, B, K))
        after = read_counts()
        check({k: after[k] - counts[k] for k in after} == per_step,
              f"train step {i} launched {after} after {counts}")
        losses.append(metrics["dt/loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    counts = read_counts()
    losses = [float(x) for x in losses]
    changed = sum(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))
    n_params = len(before)
    emit("train", config="bench.py flagship", batch_size=B, context_len=K,
         steps_warm=warm, steps_timed=timed, step_s=step_s,
         tokens_per_s=B * 3 * K / step_s, launches=counts,
         expected_launches={k: v * (warm + timed) for k, v in per_step.items()},
         loss_first=losses[0], loss_last=losses[-1],
         params_changed=changed, params=n_params, card=smi,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(changed == n_params, f"only {changed} of {n_params} parameters changed")
    del buffer

    # collect -> train -> evaluate, the whole offline path on the card
    env = Minecraft2d()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    t0 = time.perf_counter()
    data = collect_trajectories(env, 320, 16, generator=gen)
    collect_s = time.perf_counter() - t0
    state, metrics = make_dt_train_steps(cfg, B, K, 5)(state, data, gen)
    loss = float(metrics["dt/loss"])
    out = evaluate_dt(env, cfg, state.model, 10.0, num_envs=16, num_steps=40,
                      rtg_clip=10.0, generator=gen)
    stats = {k: float(v) for k, v in out.items()}
    emit("collect_train_evaluate", env="minecraft", collect_steps=320, num_envs=16,
         collect_s=collect_s, buffer_states=list(data.states.shape),
         episodes_collected=int(data.episode_starts.sum()), train_steps=5,
         loss=loss, still_training=state.model.training, **stats)
    check(math.isfinite(loss), "non-finite loss on collected data")
    check(state.model.training, "evaluate_dt left the model in eval mode")
    check(all(math.isfinite(v) for v in stats.values()) and stats["eval/episodes"] >= 16,
          "evaluation after training went wrong")
    return counts, step_s


def phase_timing(smi: str):
    import torch.nn.functional as F

    from mmtrl_tpu_torch.ops import flash_attention as fa

    rows = {}
    for label, shape, reps in (("serve", SERVE_SHAPE, 200), ("train", TRAIN_SHAPE, 100),
                               ("long", LONG_SHAPE, 10)):
        dt = torch.bfloat16
        q, k, v, do = randn(shape, dt, SEED, 4)
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        bwd_args = (q, k, v, do, lse, delta)
        kernels = {
            "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v),
                          lambda: fa.flash_attention_fwd_plain(q, k, v),
                          lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        }
        if label != "serve":  # serving runs no backward
            # SDPA's backward computes dQ, dK and dV in one call: the
            # yardstick of both backward kernels
            qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

            def library_bwd():
                return torch.autograd.grad(o_lib, (qg, kg, vg), do, retain_graph=True)

            kernels["flash_dq"] = (lambda: fa.flash_attention_dq(*bwd_args),
                                   lambda: fa.flash_attention_bwd_plain(*bwd_args), library_bwd)
            kernels["flash_dkv"] = (lambda: fa.flash_attention_dkv(*bwd_args),
                                    lambda: fa.flash_attention_bwd_plain(*bwd_args), library_bwd)
        for name, (kernel, plain, library) in kernels.items():
            bound_ms, bound_by = attention_bound(name, shape, dt)
            row = dict(
                ms=cuda_ms(kernel, reps),
                ms_from_python=cuda_ms(kernel, reps, False),
                plain_ms=cuda_ms(plain, reps),
                library_ms=cuda_ms(library, reps),
                bound_ms=bound_ms, bound_by=bound_by,
            )
            emit("timing", kernel=name, shape_name=label, shape=list(shape),
                 dtype="bfloat16", card=smi, **row)
            rows[(name, label)] = row
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    # float32 reference checks compare full-precision float32 on both sides.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    t_start = time.perf_counter()
    phase_build()
    errs = phase_kernel()
    phase_reference()
    phase_grad()
    phase_serve()
    launches, _ = phase_train(smi)
    timing = phase_timing(smi)
    sources = {"flash_fwd": ("flash_fwd.cu", 52), "flash_dq": ("flash_dq.cu", 145),
               "flash_dkv": ("flash_dkv.cu", 188)}
    kernels = []
    for name, (src, line) in sources.items():
        t = timing[(name, "train")]
        kernels.append({
            "name": name, "route": "cuda", "source": f"mmtrl_tpu_torch/csrc/{src}",
            "replaces": f"mmtrl_tpu/ops/flash_attention.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
