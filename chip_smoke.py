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
7. ppo       -- the online phase at full width (two big towers, casl,
                LSTM 128): the agent's outputs and one ``update_from_rollout``
                on the card against the CPU, three PPO updates through
                ``scripts.train`` (16 envs x 128 steps, 4 x 4 minibatches),
                update 4 in memory (rollout and update timed apart),
                ``scripts.dt_minecraft --policy-from`` the checkpoint:
                collect, train 20 steps, evaluate, with 6 launches of each
                kernel per train step and 384 forward launches in the
                evaluation; last a ``--load-from`` resume that runs update 4
                (profiled, in a child process) and equals update 4 in
                memory, generator stream included.  The agent and update
                checks take input scale 1 (the run keeps the reference's
                255).  cuDNN's deterministic flag and the run root are
                restored afterwards.
8. ppo_family -- the rest of online PPO at the entry points' widths: each
                new agent (CNN, google, RND with its target and predictor,
                PPG) and one update of ``make_ppo`` and ``make_rnd_ppo``
                (from the CPU's statistics; the statistics checked apart)
                and a 4-step ``make_ppg`` cycle on the card against the
                CPU, a 32-step cycle reported beside the CPU's own spread;
                ``scripts.{minecraft_cnn,minecraft_lstm_google,ppo_rnd}``
                (3 updates) and ``scripts.ppg --n-iteration 4`` (one cycle)
                through ``main``; ``scripts.evaluate`` on the CNN and casl
                checkpoints; and in a child process an RND ``--load-from``
                resume equal to update 4 in memory bit for bit, then one
                profiled update of each path.
9. rom       -- the cartridge path: the native 2600 library and the C++
                gridworld engine built with g++ (beside nvcc, in phase 1);
                ``rally_native`` at 32 envs for 300 pool steps, ``_obs`` on
                the card against the CPU; ``rally_ppo``
                at its defaults (32 envs x 128 steps, 4 x 4 minibatches, big
                towers, casl) for two updates with a save and one resumed
                update with a greedy evaluation; ``dt_rom --policy-from`` that
                checkpoint at full width with 4 experts, top-2, under the
                dense and the gather dispatch (collect 4,096 transitions, 30
                train steps, 300 evaluation pool steps; 6 launches of each
                kernel a train step and 6 forward launches an evaluation pool
                step); one full-width MoE Block forward and backward card vs
                CPU under each dispatch; train steps of the dense-FFN, MoE
                dense and MoE gather DTs timed at dt_rom's shape; one
                ``brick_ppo`` update.
10. skeleton -- Skeleton+ on the device simulator: the env card against
                CPU under the same draws (a reset, then a scripted episode
                with hits, misses, kills and respawns, contact, a win and
                the time limit; state and reward equal, the observation
                within its tolerance) and timed alone; ``skeleton_plus_ppo``
                at its defaults (8 envs x 128 steps, casl, two audio
                channels) for three updates with a save, a fourth resumed
                and profiled; ``evaluate --script skeleton_plus_ppo`` on the
                checkpoint.  No kernel lies on this path.
11. offpolicy_rom -- value learning on RALLY: a ``dqn_td_update`` and a
                ``c51_td_update`` at batch 128 card vs CPU (float64 within
                1e-9, float32 distances reported); ``dqn_rom`` (profiled)
                and ``c51_rom`` through ``main`` at full width, cut to
                5,120 transitions through a ring of 4,096 (255 updates,
                syncs every 125 and 250 pool steps) and a greedy
                evaluation; ``dt_rom --policy-kind dqn`` and ``c51`` from
                their checkpoints, counting each kernel's launches.
12. classic  -- the discrete classic-control zoo: CartPole, Acrobot and
                MountainCar card vs CPU from the same states and actions
                (auto-resets and truncations included) and CartPole timed
                alone; the sum-tree and the PER buffer card vs CPU under the
                same uniforms, repeated leaves included (indices, tree and
                largest priority bit for bit); the PER-weighted
                ``dqn_td_update`` card vs CPU in float64 (1e-12);
                ``dqn --prioritized-replay`` and ``c51`` through ``main`` at
                full width on CartPole-v1, cut to 5,120 steps with updates
                past 1,024, a ``--load-from`` resume of DQN equal bit for
                bit to the run continued in memory and one profiled
                iteration; ``ppo`` on CartPole-v1 (4 updates at its
                defaults) and ``evaluate --script ppo`` on its checkpoint,
                the model's first calls held against the CPU.  No kernel
                lies on this path: the phase asserts zero launches.
13. continuous -- the continuous half of classic control: Pendulum and the
                scripts' wrapper stack (``ClipAction``,
                ``NormalizeObservation``, ``NormalizeReward``, per-env
                statistics) card vs CPU from the same states, actions and
                reset draws, Pendulum timed alone; one
                ``make_continuous_ppo`` update with RPO at the defaults'
                shapes and one DDPG, TD3 and SAC update at batch 256 (the
                actor, alpha and Polyak passes included) card vs CPU in
                float64; ``ppo`` and ``rpo_continuous_action`` through
                ``main`` at their defaults (4 x 2,048 steps, 32 x 10
                minibatches), 2 updates each with a save, a third profiled;
                ``ddpg``, ``td3`` and ``sac_continuous_action`` at full width
                cut to 1,536 steps with updates past 1,024 and a greedy
                evaluation, the next 128 steps of each profiled, SAC's
                ``--load-from`` resume equal bit for bit to those steps in
                memory.  No kernel lies on this path: zero launches.
14. levels   -- procmaze and the two-agent Minecraft2d: each env card vs
                CPU for 300 steps under the same draws (procmaze at 64 envs,
                the two-agent env at 8 joint envs: state, reward, done and
                info equal, obs equal or, for the two-agent render, within
                1e-5) and timed alone at two batches; ``ppg --env-id
                procmaze --num-levels 200`` through ``main`` at its defaults
                (one cycle, the int8 aux store, then the greedy evaluation on
                the train window and on [800, 1000), timed apart) and one
                profiled policy rollout + update; ``ppo_ma_minecraft``
                through ``main`` at its defaults, 3 updates with a save and a
                fourth profiled; its agent and one update card vs CPU in
                float64.  No kernel lies on these paths: zero launches.
15. pong_door -- Doorpuzzle and the two-player Pong: Doorpuzzle card vs
                CPU for 300 steps at 64 envs under the same resets and slips
                (state, reward, done and info equal, obs within 1e-6) and
                timed alone at 16 and 64 envs; ``train --env-id doorpuzzle
                --attn-type casl`` through ``main`` at 16 x 128, one update
                and a save, the second resumed, profiled and saved,
                ``evaluate --env-id doorpuzzle`` on that checkpoint; the
                Pong slot observation card vs CPU at 8 joint envs and a pool
                step at 16 timed (emulator and observation apart);
                ``ppo_ma_pong`` through ``main`` at its defaults, likewise
                two updates (the second resumed, profiled and saved), a
                third resumed from that save equal bit for bit to the same
                resume from the runner in memory, and a greedy evaluation of
                256 pool steps.  No kernel lies on these paths: zero
                launches.
16. native_pools -- the native cartridge pools inside the fused loops and
                the two raw bridges: the pool's ``reset``/``step`` card vs
                CPU on RALLY (8 envs, 200 steps) and BRICK with sticky
                actions (100 steps; counter, reward, done, kills and life
                equal, obs within 2e-5); ``skeleton_plus_ppo --backend
                native --env-id rally_native`` through ``main`` at its
                defaults, two updates and a save, the third resumed from the
                saved observation and profiled (rollout, update and emulator
                apart); ``evaluate_policy`` greedy on a RALLY pool, 8 x 512,
                from that checkpoint, and ``evaluate_actions`` taking the
                pool's size; ``NativeMinecraft2d`` card vs CPU at 16 envs for
                300 steps, equal to the device env's render, timed at 16 and
                64; two ``AtariPool``s on RALLY's ROM equal, one window's
                MFCC card vs CPU.  No kernel lies on these paths: zero
                launches.
17. host_loops -- the gymnasium host bridge, the off-policy host loop and
                the two evaluation tools, a stand-in sub-env (gymnasium's
                Pendulum-v1 in numpy, 200-step time limit, defined here)
                behind ``GymPool``, as the card's machine has no gymnasium:
                the pool's ``reset``/``step`` card vs CPU (2 envs, 450 steps,
                all six arrays equal, truncations at 200 and 400);
                ``chunk_fn`` of SAC, TD3 and DDPG on one 64-step chunk card
                vs CPU in float64 (1e-12) and equal bit for bit to the fused
                loop on the card; SAC through ``run_offpolicy_hostloop`` (2
                envs, learning_starts 512, 2,304 steps, a save at 2,048, a
                resume from it for the last 256 held against the unbroken
                run, the chunks timed, a greedy evaluation); one
                ``ppo_continuous_action`` update on the stand-in pool, its
                host round trip timed; ``tools.eval_rom_policy`` on RALLY
                and ``tools.eval_pong`` against the tracker and noop, the
                taped logits card vs CPU within 1e-5.  No kernel lies on
                these paths: zero launches.
18. run_tools -- the run tooling, in a working directory of its own:
                ``train --attn-type casl`` at the repo's width, 2 updates with
                ``--track --capture-video --save-interval 1`` (the
                ``wandb_local`` run against the event file, the run journal's
                two records, three GIFs walked without PIL);
                ``record_episode`` card vs CPU from the same weights and
                draws (frames equal up to the first greedy flip, ``write_gif``
                byte-equal); ``dqn --track`` on CartPole-v1; two in-process
                tuner trials of ``ppo`` on CartPole-v1, each metric equal to
                the trial's last logged value, peak memory after each;
                ``PhaseTimer`` against CUDA events.  No kernel lies on these
                paths: zero launches.
19. parallel -- the DT's multi-device axes (``parallel/``): in a one-rank
                NCCL group the DP, TP, FSDP and seq steps of a small
                float32 config against the plain step (the seq step's ring
                launching no kernel), ``bench.py``'s flagship step timed
                through the plain, DP, TP and FSDP steps (6 launches of
                each kernel a step), the seq step at K = 342 against the
                flash step, the expert axis and the pipeline against their
                one-device forms; then a 2 data x 2 model gloo world of four
                processes on the card, equal to the one-rank step.
20. timing   -- each kernel, its plain version and the PyTorch call that
                computes the same function (``F.scaled_dot_product_attention``
                and its backward, a yardstick the port never calls) at the
                serving, training, dt_rom training and long-context shapes,
                beside the bound from bytes and FLOPs.

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
import tempfile
import time
from typing import Any, Optional

import torch

SEED = 0
KERNEL_SOURCES = ("flash_fwd", "flash_dq", "flash_dkv")
SERVE_SHAPE = (16, 4, 90, 128)  # (B, H, S, D) of every attention call in serve
TRAIN_SHAPE = (128, 4, 90, 128)  # ... in a bench.py train step (B = 128)
LONG_SHAPE = (16, 4, 1026, 128)  # the long-context DT, K = 342
ROM_TRAIN_SHAPE = (64, 4, 90, 128)  # ... in a dt_rom train step (B = 64); its eval is SERVE_SHAPE
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


def counts_since(before):
    """The launches of each kernel since ``before = read_counts()``."""
    after = read_counts()
    return {k: after[k] - before[k] for k in after}


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


# The online phase at the repo's own width (scripts/train.py): two big towers,
# casl attention, sum fusion, LSTM 128, Minecraft2d's 4 actions.
PPO_AGENT = dict(num_actions=4, conv_type="big", attn_type="casl", fusion_type="sum")
PPO_PARAMS = 3_722_343
PPO_CHECK_T, PPO_CHECK_B = 16, 16
# The card-against-CPU checks take the agent at input scale 1: Minecraft2d's
# observations already lie in [-1, 1], and at the reference's 255 (which the
# PPO run keeps) both towers' features come out 255 times smaller, so the
# outputs would hardly depend on the towers that do most of the work.
PPO_CHECK_AGENT = dict(PPO_AGENT, input_scale=1.0)
PPO_RUN = ["--attn-type", "casl", "--num-envs", "16", "--num-steps", "128",
           "--num-minibatches", "4", "--update-epochs", "4"]
# Logits, values and carry, card against CPU in float32 (no TF32 on either
# side): the towers' convs sum up to 3,136 terms in other orders (cuDNN
# against oneDNN), then 16 LSTM steps carry the differences; a few float32
# roundings (6e-8 each) of each output's largest magnitude, held to this
# share of it.
PPO_AGENT_TOL_OF_MAX = 1e-5
# Parameters after one update (16 Adam steps at lr 2.5e-4, eps 1e-5) on the
# card against the CPU from the same rollout and permutations: the gradients
# differ by float32 summation order and an Adam step's sensitivity to its
# gradient is bounded by eps, so the parameters agree far inside one step's
# size.  Held to 1e-5 absolute (4% of one step, 0.25% of the 16 steps).
PPO_PARAM_ATOL = 1e-5
# The same in float64 on both sides (the PPO family's feedforward and RND
# updates): roundings of 1e-16 switch no ReLU, and Adam's eps of 1e-5 turns
# them into steps some 1e-13 apart; 1e-9 is four powers of ten of room and
# still far below a float32 rounding of the parameters.
PPO_PARAM_ATOL_FLOAT64 = 1e-9
PPO_RESUME_ARGS = PPO_RUN + ["--total-timesteps", "8192"]


def restoring_flags(checks, *args):
    """``checks(*args)``, with cuDNN's deterministic flag and the run root
    restored afterwards: the entry points set both for the rest of the
    process, and the later phases run as they would without this one."""
    import os

    deterministic, run_root = torch.backends.cudnn.deterministic, os.environ.get("MMTRL_RUN_ROOT")
    try:
        return checks(*args)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if run_root is None:
            os.environ.pop("MMTRL_RUN_ROOT", None)
        else:
            os.environ["MMTRL_RUN_ROOT"] = run_root


def phase_ppo(smi: str, tmp: str = ""):
    """The online PPO path at full width: the agent and one update on the
    card against the CPU, three updates through ``scripts.train``, update 4
    in memory, PPO -> DT through ``scripts.dt_minecraft``, then a profiled
    ``--load-from`` resume in a child process.  Works in ``tmp`` (a fresh
    temporary directory when empty); returns the pipeline's kernel launches
    and the PPO run's checkpoint there."""
    if tmp:
        return restoring_flags(ppo_checks, smi, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ppo_") as tmp:
        return restoring_flags(ppo_checks, smi, tmp)


def ppo_checks(smi: str, tmp: str):
    import os

    from mmtrl_tpu_torch.algos.ppo import PPOConfig, make_recurrent_ppo
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
    from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
    from mmtrl_tpu_torch.scripts import dt_minecraft, train

    # 1. the agent, card against CPU, on a CPU rollout of real observations
    torch.manual_seed(SEED)
    agent = MultimodalRecurrentAgent(**PPO_CHECK_AGENT)
    cpu_agent = MultimodalRecurrentAgent(**PPO_CHECK_AGENT, device="cpu")
    cpu_agent.load_state_dict(agent.state_dict())
    n_params = sum(p.numel() for p in agent.parameters())
    check(n_params == PPO_PARAMS, f"the online agent has {n_params} parameters")
    T, B = PPO_CHECK_T, PPO_CHECK_B
    cfg = PPOConfig(num_envs=B, num_steps=T, num_minibatches=4, update_epochs=4,
                    total_timesteps=3 * T * B, clip_rewards=True)
    g = torch.Generator().manual_seed(SEED)
    cpu_ppo = make_recurrent_ppo(Minecraft2d(device="cpu"), cpu_agent, cfg)
    rs_cpu = cpu_ppo.init_runner(g)
    rs_cpu.carry = tuple(torch.randn(B, 128, generator=g) * 0.5 for _ in range(2))
    carry0 = rs_cpu.carry
    rs_cpu, rollout = cpu_ppo.rollout(rs_cpu)
    obs, _, _, _, dones, _ = rollout
    card_carry0 = tuple(c.cuda() for c in carry0)
    with torch.no_grad():
        ref = cpu_agent(obs, dones, carry0)
        out = agent(obs.cuda(), dones.cuda(), card_carry0)
        # how far the logits move when the towers see blank frames: how much
        # of the outputs the towers decide
        blank = agent(torch.zeros_like(obs).cuda(), dones.cuda(), card_carry0)
    errs, scales = {}, {}
    for name, o, r in zip(("logits", "value", "h", "c"), (out[0], out[1], *out[2]),
                          (ref[0], ref[1], *ref[2])):
        err, scale = (o.cpu() - r).abs().max().item(), r.abs().max().item()
        errs[name], scales[name] = err, scale
        check(math.isfinite(err) and err <= PPO_AGENT_TOL_OF_MAX * scale,
              f"online agent {name} on the card disagrees with the CPU: {err} of {scale}")
    tower_share = ((out[0] - blank[0]).abs().max() / out[0].abs().max()).item()
    emit("ppo", check="agent card vs cpu", T=T, B=B, params=n_params,
         input_scale=PPO_CHECK_AGENT["input_scale"], dones=int(dones.sum()),
         **{f"max_abs_err_{k}": v for k, v in errs.items()},
         **{f"max_abs_ref_{k}": v for k, v in scales.items()},
         logits_moved_by_blank_frames_of_max=tower_share,
         tol_of_max=PPO_AGENT_TOL_OF_MAX, card=smi, ok=True)

    # 2. one update_from_rollout, card against CPU, the same permutations
    perms = [torch.randperm(B, generator=g) for _ in range(cfg.update_epochs)]
    card_ppo = make_recurrent_ppo(Minecraft2d(), agent, cfg)
    rs_card = card_ppo.init_runner(torch.Generator(device="cuda").manual_seed(SEED))
    rs_card = dataclasses.replace(rs_card, obs=rs_cpu.obs.cuda(), done=rs_cpu.done.cuda(),
                                  carry=tuple(c.cuda() for c in rs_cpu.carry))
    before = [p.detach().clone() for p in cpu_agent.parameters()]
    rs_card, m_card = card_ppo.update_from_rollout(
        rs_card, card_carry0, tuple(x.cuda() for x in rollout), perms)
    rs_cpu, m_cpu = cpu_ppo.update_from_rollout(rs_cpu, carry0, rollout, perms)
    worst, worst_name, moved = 0.0, "", 0.0
    for (name, p), q, p0 in zip(agent.named_parameters(), cpu_agent.parameters(), before):
        err = (p.detach().cpu() - q.detach()).abs().max().item()
        moved = max(moved, (q.detach() - p0).abs().max().item())
        if not math.isfinite(err) or err > worst:
            worst, worst_name = err, name
    metrics = {k: (float(m_card[k]), float(m_cpu[k])) for k in m_cpu}
    emit("ppo", check="update card vs cpu", opt_steps=int(rs_card.step),
         worst_param_abs_err=worst, worst_param=worst_name, largest_param_move=moved,
         atol=PPO_PARAM_ATOL, metrics_card_cpu=metrics, card=smi, ok=worst <= PPO_PARAM_ATOL)
    check(int(rs_card.step) == int(rs_cpu.step) == 16, "the update took the wrong step count")
    check(worst <= PPO_PARAM_ATOL, f"update on the card disagrees with the CPU: {worst_name} {worst}")
    del rs_card, rs_cpu, rollout, obs, agent, cpu_agent

    # 3. three updates through the entry point
    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    save_dir = os.path.join(tmp, "ck")
    args = cli(train.Args, PPO_RUN + ["--total-timesteps", "6144", "--save-interval", "3",
                                      "--save-dir", save_dir])
    init = [train.make_agent(args, 4, torch.device("cuda")) for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(init[0].parameters(), init[1].parameters())),
          "the seeded agent init is not deterministic")
    start = [p.detach().clone() for p in init[0].parameters()]
    del init
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = train.main(args)
    run_s = time.perf_counter() - t0
    for row in first["history"]:
        emit("ppo", run="scripts.train", **row, card=smi)
    losses = [v for row in first["history"] for k, v in row.items() if k.startswith("losses/")
              and k != "losses/explained_variance"]
    runner = first["runner"]
    changed = sum(not torch.equal(a, b) for a, b in zip(start, runner.model.parameters()))
    check(len(first["history"]) == 3 and all(math.isfinite(x) for x in losses),
          "the PPO run's losses are not all finite")
    check(changed == len(start), f"only {changed} of {len(start)} parameters changed")
    ckpt = os.path.join(save_dir, first["run_name"])
    emit("ppo", run="scripts.train", updates=3, env_steps=first["global_step"], wall_s=run_s,
         sps_of_run=first["sps"], params_changed=changed, params=len(start),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)

    # 4. update 4 from the first run's runner in memory, its two halves
    # timed apart (train_iteration is rollout, then update_from_rollout)
    resume_args = cli(train.Args, PPO_RESUME_ARGS + ["--load-from", ckpt])
    cont = make_recurrent_ppo(Minecraft2d(), runner.model, train.ppo_config_from(resume_args))
    carry0 = runner.carry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner, data = cont.rollout(runner)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    runner, _ = cont.update_from_rollout(runner, carry0, data)
    torch.cuda.synchronize()
    emit("ppo", run="update 4 in memory", rollout_s=t1 - t0,
         update_s=time.perf_counter() - t1, card=smi)
    del data

    # 5. PPO -> DT: collect with the PPO agent, train the DT, evaluate it
    dt_args = cli(dt_minecraft.Args, [
        "--policy-from", ckpt, "--policy-conv-size", "big", "--policy-input-scale", "255",
        "--collect-envs", "16", "--collect-steps", "256", "--batch-size", "64",
        "--total-steps", "20", "--eval-envs", "16", "--eval-steps", "64",
        "--print-interval", "10", "--save-dir", save_dir])
    reset_counts()
    out = dt_minecraft.main(dt_args)
    counts = read_counts()
    # 6 layers: one forward, dQ and dK/dV launch per layer and train step,
    # one forward per layer and evaluation step (16 envs step together)
    layers, steps = dt_args.n_layers, dt_args.total_steps
    expected = {"flash_fwd": layers * (steps + dt_args.eval_steps),
                "flash_dq": layers * steps, "flash_dkv": layers * steps}
    emit("ppo", run="scripts.dt_minecraft --policy-from", **out, launches=counts,
         expected_launches=expected, card=smi)
    check(counts == expected, f"pipeline launched {counts}, not {expected}")
    check(all(math.isfinite(v) for v in out.values()), "non-finite pipeline results")
    check(out["eval/episodes"] >= 2 * dt_args.eval_envs, "too few evaluation episodes")

    # 6. the resume from the checkpoint, profiled in a child process (a
    # profiled process launches more slowly afterwards), against update 4 in
    # memory
    result = os.path.join(tmp, "resume.pt")
    here = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"), "--ppo-resume",
                    ckpt, result], check=True, timeout=300, cwd=here)
    resumed = torch.load(result, weights_only=True)
    check(resumed["initial_update"] == 4 and resumed["updates"] == [4],
          "the resumed run did not run update 4 alone")
    same_stream = torch.equal(runner.generator.get_state(), resumed["generator_state"])
    resume_err = max((p.detach().cpu() - q).abs().max().item()
                     for p, q in zip(runner.model.parameters(), resumed["params"]))
    emit("ppo", run="resume", initial_update=resumed["initial_update"],
         wall_s_profiled=resumed["wall_s"], kernel_launches=resumed["kernel_launches"],
         device_busy_ms=resumed["device_busy_ms"], top_kernels=resumed["top_kernels"],
         same_generator_state=same_stream, max_param_diff_vs_update_in_memory=resume_err,
         card=smi)
    check(same_stream, "the resumed run did not continue the saved generator stream")
    check(resume_err <= PPO_PARAM_ATOL, f"update 4 after a resume differs by {resume_err}")
    return counts, ckpt


def ppo_resume(ckpt: str, result: str) -> None:
    """The ppo phase's child process: ``scripts.train --load-from ckpt``
    under ``torch.profiler``; writes what the parent checks to ``result``."""
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import train

    args = cli(train.Args, PPO_RESUME_ARGS + ["--load-from", ckpt])
    resumed, _, launches, busy, top = device_profile(lambda: train.main(args))
    runner = resumed["runner"]
    torch.save({
        "initial_update": resumed["initial_update"],
        "updates": [r["update"] for r in resumed["history"]],
        "wall_s": resumed["history"][0]["wall_s"],
        "kernel_launches": launches,
        "device_busy_ms": busy,
        "top_kernels": top,
        "params": [p.detach().cpu() for p in runner.model.parameters()],
        "generator_state": runner.generator.get_state(),
    }, result)


def device_profile(fn):
    """``fn()`` under ``torch.profiler`` (CUDA activity), synchronized:
    (its result, wall s, device operations, device busy ms, the top 8
    kernels by device time as [name, ms, calls]).  The profiler's raw
    events are read directly: building its per-event Python objects
    (``prof.events()``) takes about 0.1 ms an event, tens of seconds for
    an update of 100,000 operations."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        ms, calls = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    busy = sum(e.duration_ns() for e in kernels) / 1e6
    return out, wall, len(kernels), busy, [[name, ms, calls] for name, (ms, calls) in top]


def env_step_timing(env, m: int, action=None):
    """(ms a step, device operations and busy ms of one profiled step) of
    ``env`` alone at ``m`` envs on the card, one action held: ``action``, or
    one of 4 drawn at random for each env."""
    gc = torch.Generator(device="cuda").manual_seed(SEED)
    _, s = env.reset(m, gc)
    a = torch.randint(0, 4, (m,), generator=gc, device="cuda") if action is None else action
    for _ in range(20):
        _, s, _, _, _ = env.step(s, a, gc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        _, s, _, _, _ = env.step(s, a, gc)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 200
    _, _, ops, busy, _ = device_profile(lambda: env.step(s, a, gc))
    return ms, ops, busy


# The rest of online PPO on Minecraft2d at the entry points' own widths:
# feedforward CNN PPO (big tower), the google LSTM agent (two big towers
# projected to 256), PPO + RND (big agent tower, small target and
# predictor towers) and PPG (IMPALA trunk).  The checks take input scale 1,
# as the ppo phase's do; the runs keep each script's default.
FAMILY_RUNS = {  # script: argv of a run of three updates (PPG: one cycle)
    "minecraft_cnn": ["--total-timesteps", "1536", "--save-interval", "3"],
    "minecraft_lstm_google": ["--total-timesteps", "384", "--save-interval", "3"],
    "ppo_rnd": ["--total-timesteps", "3072", "--save-interval", "3"],
    "ppg": ["--n-iteration", "4", "--total-timesteps", "2048", "--save-interval", "1"],
}
RND_RESUME_ARGS = ["--total-timesteps", "4096"]  # update 4 of the ppo_rnd run
EVAL_CHECK_CALLS = 8  # model calls of each evaluation held against the CPU
# One update profiled after one warm update, each from its run's checkpoint
# (after update 3; the PPG run's after cycle 1): updates 4 and 5 of 5
# (cycles 2 and 3 of 3).
FAMILY_PROFILES = {
    "minecraft_cnn": ["--total-timesteps", "2560"],
    "minecraft_lstm_google": ["--total-timesteps", "640"],
    "ppo_rnd": ["--total-timesteps", "5120"],
    "ppg": ["--n-iteration", "4", "--total-timesteps", "6144"],
}


def minecraft_observations(steps: int, envs: int, seed: int) -> torch.Tensor:
    """(steps, envs, 2, 84, 84) CPU observations of Minecraft2d under
    random actions."""
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d

    env, g = Minecraft2d(device="cpu"), torch.Generator().manual_seed(seed)
    o, state = env.reset(envs, g)
    frames = []
    for _ in range(steps):
        frames.append(o)
        o, state, _, _, _ = env.step(state, torch.randint(0, 4, (envs,), generator=g), g)
    return torch.stack(frames)


def card_and_cpu(build):
    """The module ``build(device)`` on the card, from the seed, and its
    copy on the CPU."""
    torch.manual_seed(SEED)
    card_module = build("cuda")
    cpu_module = build("cpu")
    cpu_module.load_state_dict(card_module.state_dict())
    return card_module, cpu_module


def float64(x: torch.Tensor) -> torch.Tensor:
    return x.double() if x.is_floating_point() else x


def param_err(modules, refs) -> tuple[float, str]:
    """The largest elementwise difference between the parameters of two
    lists of modules, and the parameter's name."""
    worst, worst_name = 0.0, ""
    for module, ref in zip(modules, refs, strict=True):
        for (name, p), q in zip(module.named_parameters(), ref.parameters(), strict=True):
            err = (p.detach().cpu().double() - q.detach().double()).abs().max().item()
            if not math.isfinite(err) or err > worst:
                worst, worst_name = err, name
    return worst, worst_name


def compare_params(label: str, smi: str, steps: int, card, cpu, before, metrics_card,
                   metrics_cpu, exact=None, **extra):
    """Whether the parameters of the ``card`` modules after an update agree
    with those of the same update of the ``cpu`` modules, from the same data
    and draws, within ``PPO_PARAM_ATOL`` (the caller fails the run if not).
    ``before`` holds the CPU modules' parameters before the update.  With
    ``exact`` (float64 copies of the card and CPU modules after the same
    update) the float64 pair is held to ``PPO_PARAM_ATOL_FLOAT64`` instead,
    and the float32 pair's distances, from each other and from float64, are
    reported."""
    moved = max((q.detach() - p0).abs().max().item()
                for module, params in zip(cpu, before) for q, p0 in zip(module.parameters(), params))
    worst, worst_name = param_err(card, cpu)
    metrics = {k: (float(metrics_card[k]), float(metrics_cpu[k])) for k in metrics_cpu}
    atol = PPO_PARAM_ATOL
    if exact is not None:
        card64, cpu64 = exact
        extra.update(float32_card_vs_cpu=worst, float32_card_vs_cpu_at=worst_name,
                     float32_card_vs_float64_cpu=param_err(card, cpu64)[0],
                     float32_cpu_vs_float64_cpu=param_err(cpu, cpu64)[0])
        (worst, worst_name), atol = param_err(card64, cpu64), PPO_PARAM_ATOL_FLOAT64
    ok = worst <= atol
    emit("ppo_family", check=f"{label} card vs cpu" + (" in float64" if exact else ""),
         opt_steps=steps, worst_param_abs_err=worst, worst_param=worst_name,
         largest_param_move=moved, atol=atol, float32_metrics_card_cpu=metrics, **extra,
         card=smi, ok=ok)
    check(moved > 0, f"{label} moved no parameter")
    return ok


def phase_ppo_family(smi: str, ppo_ckpt: str = ""):
    """The feedforward, google, RND and PPG paths: each agent and one update
    (a PPG cycle) on the card against the CPU, each entry point through its
    ``main``, the evaluate twin on the CNN run's checkpoint and on
    ``ppo_ckpt`` (the ppo phase's casl run), and in a child process an RND
    ``--load-from`` resume, equal bit for bit to the run continued in memory,
    then one profiled update of each path (for PPG a cycle)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_family_") as tmp:
        restoring_flags(family_checks, smi, tmp, ppo_ckpt)


def family_agent_checks(smi: str):
    from mmtrl_tpu_torch.algos.ppo.ppg import PPGAgent
    from mmtrl_tpu_torch.algos.ppo.rnd import RNDAgent, RNDNetwork
    from mmtrl_tpu_torch.models.agents import CNNAgent
    from mmtrl_tpu_torch.scripts.minecraft_lstm_google import GoogleAgent

    shape = (2, 84, 84)
    seq = minecraft_observations(4, 16, SEED)  # (T, N, 2, 84, 84)
    flat = seq.reshape((-1,) + shape)  # 64 frames for the feedforward agents
    done = torch.zeros(4, 4, dtype=torch.bool)
    done[2, 1] = True
    g = torch.Generator().manual_seed(SEED)
    carry = tuple(torch.randn(4, 128, generator=g) * 0.5 for _ in range(2))
    agents = {  # name: (build, CPU inputs, output names)
        "CNNAgent": (lambda d: CNNAgent(4, "big", input_scale=1.0, device=d), (flat,),
                     ("logits", "value")),
        "GoogleAgent": (lambda d: GoogleAgent(4, 0.5, input_scale=1.0, device=d),
                        (seq[:, :4], done, carry), ("logits", "value", "h", "c")),
        "RNDAgent": (lambda d: RNDAgent(4, shape, device=d), (flat,),
                     ("logits", "v_ext", "v_int")),
        "RNDNetwork target": (lambda d: RNDNetwork(shape, device=d), (flat,), ("embedding",)),
        "RNDNetwork predictor": (lambda d: RNDNetwork(shape, predictor=True, device=d), (flat,),
                                 ("embedding",)),
        "PPGAgent": (lambda d: PPGAgent(4, shape, device=d), (flat,),
                     ("logits", "value", "aux_value")),
    }
    for name, (build, inputs, names) in agents.items():
        card_module, cpu_module = card_and_cpu(build)
        on_card = [tuple(c.cuda() for c in x) if isinstance(x, tuple) else x.cuda()
                   for x in inputs]
        with torch.no_grad():
            out, ref = card_module(*on_card), cpu_module(*inputs)
        outs = lambda o: [y for x in (o if isinstance(o, tuple) else (o,))  # noqa: E731
                          for y in (x if isinstance(x, tuple) else (x,))]
        errs, scales = {}, {}
        for what, o, r in zip(names, outs(out), outs(ref), strict=True):
            errs[what], scales[what] = (o.cpu() - r).abs().max().item(), r.abs().max().item()
            check(math.isfinite(errs[what])
                  and errs[what] <= PPO_AGENT_TOL_OF_MAX * scales[what],
                  f"{name} {what} on the card disagrees with the CPU: "
                  f"{errs[what]} of {scales[what]}")
        emit("ppo_family", check=f"{name} card vs cpu",
             params=sum(p.numel() for p in card_module.parameters()),
             inputs=[list(x.shape) for x in inputs if torch.is_tensor(x)],
             **{f"max_abs_err_{k}": v for k, v in errs.items()},
             **{f"max_abs_ref_{k}": v for k, v in scales.items()},
             tol_of_max=PPO_AGENT_TOL_OF_MAX, card=smi, ok=True)


@dataclasses.dataclass
class UpdateCase:
    """An update check's inputs: its config, its modules on the card and
    their CPU copies (the RND case: agent, target, predictor), the CPU
    runner after the rollout, the rollout, and the draws in their place."""

    cfg: Any
    card: Any
    cpu: Any
    runner: Any
    data: tuple
    perms: list
    masks: Optional[list] = None


def ppo_update_case() -> tuple[UpdateCase, torch.Generator]:
    """The feedforward PPO check: the minecraft_cnn agent, its 4 envs, 16
    steps; and the generator that draws the later checks' rollouts."""
    from mmtrl_tpu_torch.algos.ppo import PPOConfig, make_ppo
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
    from mmtrl_tpu_torch.models.agents import CNNAgent

    cfg = PPOConfig(num_envs=4, num_steps=16, num_minibatches=4, update_epochs=4,
                    total_timesteps=3 * 64, clip_rewards=True)
    card_model, cpu_model = card_and_cpu(lambda d: CNNAgent(4, "big", input_scale=1.0, device=d))
    g = torch.Generator().manual_seed(SEED)
    cpu_ppo = make_ppo(Minecraft2d(device="cpu"), cpu_model, cfg)
    rs_cpu, data = cpu_ppo.rollout(cpu_ppo.init_runner(g))
    perms = [torch.randperm(cfg.batch_size, generator=g) for _ in range(cfg.update_epochs)]
    return UpdateCase(cfg, card_model, cpu_model, rs_cpu, data, perms), g


def rnd_update_case(g: torch.Generator) -> UpdateCase:
    """The RND check, drawn from ``g`` after ``ppo_update_case``: the
    ppo_rnd agent, target and predictor, its 8 envs, 16 steps."""
    from mmtrl_tpu_torch.algos.ppo.rnd import RNDAgent, RNDConfig, RNDNetwork, make_rnd_ppo
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d

    shape = (2, 84, 84)
    cfg = RNDConfig(num_envs=8, num_steps=16, num_minibatches=4, update_epochs=4,
                    total_timesteps=3 * 128, clip_rewards=True)
    card_nets, cpu_nets = zip(*(card_and_cpu(build) for build in (
        lambda d: RNDAgent(4, shape, device=d), lambda d: RNDNetwork(shape, device=d),
        lambda d: RNDNetwork(shape, predictor=True, device=d))))
    cpu_rnd = make_rnd_ppo(Minecraft2d(device="cpu"), cpu_nets[0], cfg, *cpu_nets[1:])
    rs_cpu, data = cpu_rnd.rollout(cpu_rnd.init_runner(g))
    perms = [torch.randperm(cfg.batch_size, generator=g) for _ in range(cfg.update_epochs)]
    masks = [[torch.rand(cfg.minibatch_size, generator=g) for _ in range(cfg.num_minibatches)]
             for _ in range(cfg.update_epochs)]
    return UpdateCase(cfg, card_nets, cpu_nets, rs_cpu, data, perms, masks)


def family_update_checks(smi: str):
    import copy

    from mmtrl_tpu_torch.algos.ppo import make_ppo
    from mmtrl_tpu_torch.algos.ppo.ppg import PPGAgent, PPGConfig, make_ppg
    from mmtrl_tpu_torch.algos.ppo.rnd import make_rnd_ppo
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d

    shape = (2, 84, 84)
    cpu_env, card_env = Minecraft2d(device="cpu"), Minecraft2d()
    card_gen = lambda: torch.Generator(device="cuda").manual_seed(SEED)  # noqa: E731
    cpu_gen = lambda: torch.Generator().manual_seed(SEED)  # noqa: E731
    snapshot = lambda m: [p.detach().clone() for p in m.parameters()]  # noqa: E731
    cuda = lambda x: x.cuda()  # noqa: E731
    cuda64 = lambda x: float64(x).cuda()  # noqa: E731

    def replayed(rs, rs_cpu, convert):
        """``rs`` with the CPU runner's observation and done flag."""
        return dataclasses.replace(rs, obs=convert(rs_cpu.obs), done=convert(rs_cpu.done))

    # The feedforward and RND updates are held to the same update in
    # float64 on both sides.  In float32 they are discontinuous in the
    # rounding: a pre-activation within rounding of zero takes the other
    # side of a ReLU on one side, and Adam (eps 1e-5) turns the switched
    # gradient term, and a gradient of pure rounding noise where the exact
    # one is near zero, into steps of up to the learning rate.  In the RND
    # check the CPU's float32 switches one ReLU of the agent's Conv_1 at
    # steps 3 and 15 and ends 8.9e-6 from float64, the card's none and
    # 1.4e-7 (tools/update_rounding.py counts them).
    case, g = ppo_update_case()
    cfg, rs_cpu, data, perms = case.cfg, case.runner, case.data, case.perms
    card64, cpu64 = (copy.deepcopy(m).double() for m in (case.card, case.cpu))

    def ppo_update(model, env, generator, convert):
        algo = make_ppo(env, model, cfg)
        rs = replayed(algo.init_runner(generator), rs_cpu, convert)
        return algo.update_from_rollout(rs, tuple(map(convert, data)), perms)

    before = snapshot(case.cpu)
    rs_card, m_card = ppo_update(case.card, card_env, card_gen(), cuda)
    ppo_update(card64, card_env, card_gen(), cuda64)
    ppo_update(cpu64, cpu_env, cpu_gen(), float64)
    rs_cpu, m_cpu = make_ppo(cpu_env, case.cpu, cfg).update_from_rollout(rs_cpu, data, perms)
    check(int(rs_card.step) == int(rs_cpu.step) == 16, "make_ppo took the wrong step count")
    oks = [compare_params("make_ppo update", smi, 16, [case.card], [case.cpu], [before], m_card,
                          m_cpu, exact=([card64], [cpu64]))]

    case = rnd_update_case(g)
    cfg, rs_cpu, data, perms, masks = case.cfg, case.runner, case.data, case.perms, case.masks
    card_nets, cpu_nets = case.card, case.cpu
    card64, cpu64 = ([copy.deepcopy(m).double() for m in nets] for nets in (card_nets, cpu_nets))
    cpu_rnd, card_rnd = (make_rnd_ppo(env, nets[0], cfg, nets[1], nets[2])
                         for env, nets in ((cpu_env, cpu_nets), (card_env, card_nets)))
    rs_card = replayed(card_rnd.init_runner(card_gen()), rs_cpu, cuda)
    card_data = tuple(map(cuda, data))
    # The statistics apart: an observation element that is constant over
    # the batch has a variance of float32 roundings, which the normalization
    # divides by sqrt(1e-8), so the predictor's inputs there differ by the
    # two devices' summation orders times 1e4 (reported below); the update
    # is compared from the CPU's statistics on every side.
    stats_cpu, stats_card = cpu_rnd.statistics(rs_cpu, data), card_rnd.statistics(rs_card,
                                                                                   card_data)
    pairs = [(stats_card[0].mean, stats_cpu[0].mean), (stats_card[0].var, stats_cpu[0].var),
             (stats_card[1].mean, stats_cpu[1].mean), (stats_card[1].var, stats_cpu[1].var),
             (stats_card[2], stats_cpu[2])]
    # float32 sums of the same values in other orders: a few roundings of
    # each statistic's largest magnitude (at least 1)
    stat_err = max(((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1.0)).item()
                   for a, b in pairs)
    next_obs = data[8].reshape((-1,) + shape)
    norm_err = (stats_card[0].normalize(next_obs.cuda()).clamp(-5, 5).cpu()
                - stats_cpu[0].normalize(next_obs).clamp(-5, 5)).abs().max().item()
    emit("ppo_family", check="RND statistics card vs cpu", max_err_of_max=stat_err,
         tol_of_max=1e-6, predictor_input_max_abs_err=norm_err,
         obs_var_min=stats_cpu[0].var.min().item(),
         obs_elements_var_below_1e_6=int((stats_cpu[0].var < 1e-6).sum()),
         int_reward_var=stats_cpu[1].var.item(), card=smi, ok=stat_err <= 1e-6)
    check(stat_err <= 1e-6, f"RND statistics on the card differ by {stat_err} of their largest")

    def rnd_update(nets, env, generator, convert):
        algo = make_rnd_ppo(env, nets[0], cfg, nets[1], nets[2])
        rs = replayed(algo.init_runner(generator), rs_cpu, convert)
        stats = (*(type(x)(convert(x.mean), convert(x.var), convert(x.count))
                   for x in stats_cpu[:2]), convert(stats_cpu[2]))
        return algo.update_from_rollout(rs, tuple(map(convert, data)), perms, masks, stats)

    trained = lambda nets: [nets[0], nets[2]]  # noqa: E731  (the target never trains)
    before = [snapshot(m) for m in trained(cpu_nets)]
    rs_card, m_card = rnd_update(card_nets, card_env, card_gen(), cuda)
    rnd_update(card64, card_env, card_gen(), cuda64)
    rnd_update(cpu64, cpu_env, cpu_gen(), float64)
    rs_cpu, m_cpu = cpu_rnd.update_from_rollout(rs_cpu, data, perms, masks, stats_cpu)
    check(int(rs_card.step) == int(rs_cpu.predictor_opt_state.count) == 16,
          "make_rnd_ppo took the wrong step count")
    oks.append(compare_params("make_rnd_ppo update", smi, 16, trained(card_nets),
                              trained(cpu_nets), before, m_card, m_cpu,
                              exact=(trained(card64), trained(cpu64))))

    # PPG: a cycle of 2 policy iterations (8 envs x 8 steps), both sides fed
    # the same two rollouts (recorded on the CPU) and draws.  A PPG cycle
    # is chaotic in its weights: the IMPALA trunk's max pools switch
    # windows, and Adam turns a switched gradient into a step of up to the
    # learning rate, so rounding-size differences grow over its steps.  The
    # gate takes one minibatch a policy iteration and one aux epoch of two
    # (4 steps).  The cycle reads its bf16 aux store back as float32,
    # whatever the parameters' dtype, so it has no float64 twin.
    cfg = PPGConfig(num_envs=8, num_steps=8, num_minibatches=1, n_iteration=2, e_auxiliary=1,
                    num_aux_minibatches=2, total_timesteps=3 * 128)
    card_model, cpu_model = card_and_cpu(lambda d: PPGAgent(4, shape, device=d))
    cpu_ppg, card_ppg = make_ppg(cpu_env, cpu_model, cfg), make_ppg(card_env, card_model, cfg)
    rs = cpu_ppg.init_runner(g)
    recorded = []
    for _ in range(cfg.n_iteration):
        rs, data = cpu_ppg.rollout(rs)
        recorded.append((rs.obs, rs.done, data))
    perms = [[torch.randperm(cfg.batch_size, generator=g)] for _ in range(cfg.n_iteration)]
    aux_perms = [torch.randperm(cfg.batch_size * cfg.n_iteration, generator=g)
                 for _ in range(cfg.e_auxiliary)]

    def cycle(ppg_algo, generator, device):
        rollouts = iter(recorded)

        def rollout(rs):
            obs, done, data = next(rollouts)
            return (dataclasses.replace(rs, obs=obs.to(device), done=done.to(device)),
                    tuple(x.to(device) for x in data))
        return ppg_algo.train_iteration(ppg_algo.init_runner(generator), rollout, perms,
                                        aux_perms)

    before = snapshot(cpu_model)
    rs_card, m_card = cycle(card_ppg, card_gen(), "cuda")
    rs_cpu, m_cpu = cycle(cpu_ppg, g, "cpu")
    steps = cfg.opt_steps_per_update
    check(int(rs_card.step) == int(rs_cpu.step) == steps, "make_ppg cycle took the wrong steps")
    oks.append(compare_params("make_ppg cycle", smi, steps, [card_model], [cpu_model], [before],
                              m_card, m_cpu))
    check(all(oks), "an update on the card disagrees with the CPU (the lines above)")


def family_checks(smi: str, tmp: str, ppo_ckpt: str):
    import os

    from mmtrl_tpu_torch.algos.ppo.core import runner_payload
    from mmtrl_tpu_torch.algos.ppo.rnd import make_rnd_ppo
    from mmtrl_tpu_torch.core.checkpoint import load_run
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.envs import make
    from mmtrl_tpu_torch.scripts import evaluate, minecraft_cnn, minecraft_lstm_google, ppg, ppo_rnd

    # deterministic cuDNN algorithms, as the entry points take them by
    # default (--torch-deterministic): the updates below are then the same
    # on every run, and the card is compared with the CPU, not with itself
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    family_agent_checks(smi)
    t1 = time.perf_counter()
    family_update_checks(smi)
    emit("ppo_family", section="card vs cpu", agents_s=t1 - t0,
         updates_s=time.perf_counter() - t1, card=smi)

    # the entry points through their main, each at its defaults
    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    save_dir = os.path.join(tmp, "ck")
    scripts = {"minecraft_cnn": minecraft_cnn, "minecraft_lstm_google": minecraft_lstm_google,
               "ppo_rnd": ppo_rnd, "ppg": ppg}
    cuda = torch.device("cuda")
    runs, ckpts = {}, {}
    t_section = time.perf_counter()
    for name, argv in FAMILY_RUNS.items():
        module = scripts[name]
        args = cli(module.Args, argv + ["--save-dir", save_dir])
        env = make(args.env_id, device=cuda)
        modules = module.make_agent(args, env, cuda)
        parts = ("model", "target", "predictor") if name == "ppo_rnd" else ("model",)
        modules = modules if isinstance(modules, tuple) else (modules,)
        start = {part: [p.detach().clone() for p in m.parameters()]
                 for part, m in zip(parts, modules, strict=True)}
        del modules
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = module.main(args)
        run_s = time.perf_counter() - t0
        for row in out["history"]:
            emit("ppo_family", run=f"scripts.{name}", **row, card=smi)
        runner = out["runner"]
        changed = {part: sum(not torch.equal(a, b) for a, b in
                             zip(start[part], getattr(runner, part).parameters()))
                   for part in parts}
        losses = [v for row in out["history"] for k, v in row.items()
                  if k.startswith("losses/") and k != "losses/explained_variance"]
        stats = [getattr(runner.stats, f.name) for f in dataclasses.fields(runner.stats)]
        updates = 1 if name == "ppg" else 3
        emit("ppo_family", run=f"scripts.{name}", updates=updates,
             env_steps=out["global_step"], wall_s=run_s, sps_of_run=out["sps"],
             wall_s_per_update=[row["wall_s"] for row in out["history"]],
             episodes=out["episode_count"], episodic_return=out["episodic_return"],
             params_changed=changed, params={k: len(v) for k, v in start.items()},
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
        check(len(out["history"]) == updates and all(math.isfinite(x) for x in losses),
              f"scripts.{name}: the losses are not all finite")
        for part in parts:  # the RND target never trains; everything else does
            want = 0 if part == "target" else len(start[part])
            check(changed[part] == want, f"scripts.{name}: {changed[part]} of "
                                         f"{len(start[part])} {part} parameters changed")
        check(all(bool(torch.isfinite(v).all()) for v in stats),
              f"scripts.{name}: non-finite episode statistics")
        runs[name], ckpts[name] = out, os.path.join(save_dir, out["run_name"])

    emit("ppo_family", section="entry points", seconds=time.perf_counter() - t_section,
         card=smi)

    # the evaluate twin at its defaults (16 envs x 512 steps).  Its model's
    # first calls are held against the checkpoint loaded on the CPU, on the
    # same inputs: a checkpoint not loaded, or not used, fails.
    for label, argv in (("minecraft_cnn", ["--script", "minecraft_cnn"]),
                        ("train casl", ["--script", "train", "--attn-type", "casl"])):
        ckpt = ckpts["minecraft_cnn"] if label == "minecraft_cnn" else ppo_ckpt
        if not ckpt:
            continue
        args = cli(evaluate.Args, argv + ["--load-from", ckpt])
        t0 = time.perf_counter()
        result, calls = evaluate_recording_calls(evaluate, args, EVAL_CHECK_CALLS)
        wall = time.perf_counter() - t0
        ref, _ = evaluate.build_model(args, make(args.env_id, device="cpu"), "cpu")
        ref.load_state_dict(load_run(ckpt, map_location="cpu")["model"])
        with torch.no_grad():
            wants = [ref(*inputs)[0] for inputs, _ in calls]
        err = max((logits - want).abs().max().item() for (_, logits), want in zip(calls, wants))
        scale = max(want.abs().max().item() for want in wants)
        emit("ppo_family", run=f"scripts.evaluate {label}", num_envs=args.num_envs,
             num_steps=args.num_steps, wall_s=wall, **result, calls_checked=len(calls),
             logits_max_abs_err_vs_cpu=err, logits_max_abs=scale, tol_of_max=PPO_AGENT_TOL_OF_MAX,
             card=smi)
        check(len(calls) == EVAL_CHECK_CALLS and err <= PPO_AGENT_TOL_OF_MAX * scale,
              f"scripts.evaluate {label}: the card's logits are {err} from the checkpoint's "
              f"on the CPU (largest {scale})")
        check(all(math.isfinite(v) for v in result.values()), "non-finite evaluation")
        # every episode ends within 30 steps: 512 steps end at least 17 per env
        check(result["eval/episodes"] >= 17 * args.num_envs, "too few evaluation episodes")

    # update 4 of the RND run in memory, then in the child its resume
    args = cli(ppo_rnd.Args, RND_RESUME_ARGS)
    rnd_runner = runs["ppo_rnd"]["runner"]
    cont = make_rnd_ppo(make(args.env_id, device=cuda), rnd_runner.model,
                        ppo_rnd.rnd_config_from(args), rnd_runner.target, rnd_runner.predictor)
    rnd_runner, _ = cont.train_iteration(rnd_runner)
    result = os.path.join(tmp, "family_child.pt")
    here = os.path.dirname(os.path.abspath(__file__))
    t_section = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"), "--family-child",
                    ckpts["ppo_rnd"], result, *(ckpts[name] for name in FAMILY_PROFILES)],
                   check=True, timeout=300, cwd=here)
    emit("ppo_family", section="child process", seconds=time.perf_counter() - t_section,
         card=smi)
    child = torch.load(result, weights_only=True)
    mine = runner_payload(rnd_runner)
    differing = [k for k in mine if not _same_payload(mine[k], child["rnd_payload"][k])]
    emit("ppo_family", run="ppo_rnd resume", initial_update=child["rnd_initial_update"],
         updates=child["rnd_updates"], differing_fields=differing, card=smi)
    check(child["rnd_initial_update"] == 4 and child["rnd_updates"] == [4],
          "the resumed RND run did not run update 4 alone")
    check(not differing, f"the resumed RND run differs from update 4 in memory in {differing}")
    for name in FAMILY_PROFILES:
        prof = child[name]
        emit("ppo_family", run=f"profiled scripts.{name} update", wall_s=prof["wall_s"],
             device_ops=prof["kernel_launches"], device_busy_ms=prof["device_busy_ms"],
             device_idle_share=1.0 - prof["device_busy_ms"] / (1e3 * prof["wall_s"]),
             top_kernels=prof["top_kernels"], card=smi)


def evaluate_recording_calls(evaluate, args, calls: int):
    """``evaluate.main(args)``, and the CPU copies of the inputs and the
    logits of its model's first ``calls`` calls."""
    real, records = evaluate.evaluate_policy, []

    def to_cpu(x):
        return tuple(map(to_cpu, x)) if isinstance(x, (tuple, list)) else x.cpu()

    def recorded(env, model, *rest, **kwargs):
        def hook(module, inputs, output):
            if len(records) < calls:
                records.append((to_cpu(inputs), output[0].cpu()))
        handle = model.register_forward_hook(hook)
        try:
            return real(env, model, *rest, **kwargs)
        finally:
            handle.remove()

    evaluate.evaluate_policy = recorded
    try:
        return evaluate.main(args), records
    finally:
        evaluate.evaluate_policy = real


def _same_payload(a, b) -> bool:
    """Two checkpoint payloads equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_payload(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_payload(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b  # a number (a step count, a learning rate)


def family_child(rnd_ckpt: str, result: str, *ckpts: str) -> None:
    """The ppo_family phase's child process: ``scripts.ppo_rnd --load-from``
    (update 4), then for each of ``FAMILY_PROFILES`` (its checkpoints in
    ``ckpts``, in order) one warm and one profiled update."""
    from mmtrl_tpu_torch.algos.ppo.core import runner_payload
    from mmtrl_tpu_torch.core.checkpoint import load_run
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import minecraft_cnn, minecraft_lstm_google, ppg, ppo_rnd

    out = {}
    resumed = ppo_rnd.main(cli(ppo_rnd.Args, RND_RESUME_ARGS + ["--load-from", rnd_ckpt]))
    out["rnd_initial_update"] = resumed["initial_update"]
    out["rnd_updates"] = [r["update"] for r in resumed["history"]]
    out["rnd_payload"] = runner_payload(resumed["runner"])
    scripts = {"minecraft_cnn": minecraft_cnn, "minecraft_lstm_google": minecraft_lstm_google,
               "ppo_rnd": ppo_rnd, "ppg": ppg}
    for (name, argv), ckpt in zip(FAMILY_PROFILES.items(), ckpts, strict=True):
        args = cli(scripts[name].Args, argv)
        algo, _, device = scripts[name].build(args)
        runner = algo.init_runner(torch.Generator(device=device).manual_seed(args.seed))
        runner = runner.load_payload(load_run(ckpt, map_location=device))
        runner, _ = algo.train_iteration(runner)  # warm
        (runner, _), wall, launches, busy, top = device_profile(
            lambda: algo.train_iteration(runner))
        out[name] = {"wall_s": wall, "kernel_launches": launches, "device_busy_ms": busy,
                     "top_kernels": top}
    torch.save(out, result)


# The cartridge path (ROADMAP A.5 and A.7's cartridge half): RALLY and BRICK
# on the native 2600 core, the host-loop PPO and the MoE DT through
# dt_rom.py, at the entry points' widths.
ROM_ENVS = 32  # rally_ppo's default pool
ROM_OBS_STEPS = 300  # pool steps of the observation check
ROM_OBS_EVERY = 25  # ... of which every 25th is made on the CPU as well
# The observation, card against CPU: cuFFT and pocketfft sum the spectrum in
# other orders, the log and the DCT carry that to the cepstra (values up to
# about 40, float32 steps of 4e-6), and the per-window min-max divides by the
# plane's range; a few float32 steps of each plane's range, in [-1, 1].
ROM_OBS_ATOL = 1e-4
# rally_ppo at its defaults: 32 envs x 128 steps, 4 epochs x 4 minibatches,
# big towers, casl, sum fusion.  Two updates and a save, then one resumed.
ROM_PPO_ARGS = ["--eval-steps", "0", "--save-interval", "2"]
ROM_PPO_UPDATE = 32 * 128  # env steps an update
# dt_rom at full width (d_model 512, 6 layers, 4 heads, K = 30, batch 64) with
# E = 4 experts, top-2 (tools/bench_moe_dispatch.py:44-50): 4,096 transitions
# from the PPO checkpoint, 30 train steps, then max(episode cap + 100,
# eval steps / envs) = 300 pool steps of evaluation.
ROM_DT_ARGS = ["--env-id", "rally_native", "--policy-conv-size", "big",
               "--collect-envs", "16", "--collect-steps", "4096", "--episode-steps", "200",
               "--total-steps", "30", "--steps-per-dispatch", "10", "--print-interval", "10",
               "--warmup-steps", "10", "--eval-steps", "0", "--target-return", "5",
               "--moe-experts", "4", "--moe-top-k", "2"]
ROM_DT_CFG = dict(num_actions=6, context_len=30, d_model=512, n_layers=6, n_heads=4,
                  max_timestep=2048)
# One MoE Block forward and backward, card against CPU, float32 with TF32 off
# and dropout 0: the same routing on both sides (a logit gap near 1e-6 would
# flip a choice; at 5,760 tokens the smallest gaps are some 1e-4), so the
# outputs and gradients differ by float32 summation order only.
ROM_BLOCK_TOL_OF_MAX = 1e-4
ROM_TIMED_STEPS = 10


def native_build_in_background():
    """A started thread that builds the native 2600 library and the C++
    gridworld engine (g++, some 10 s and 2 s) while nvcc builds the kernels;
    ``.error`` holds what it raised."""
    import threading

    from pathlib import Path

    from mmtrl_tpu_torch.envs import native_bridge, skeleton_native

    class Build(threading.Thread):
        error = None

        def run(self):
            try:
                for build in (skeleton_native.build_native, native_bridge.build_native):
                    t0 = time.perf_counter()
                    path = Path(build())
                    emit("build", library=str(path.name), seconds=time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001  re-raised by the caller's check
                self.error = e

    thread = Build()
    thread.start()
    return thread


def phase_rom(smi: str, tmp: str):
    """(a) RALLY observations card vs CPU, (b) rally_ppo with a save and a
    resume, (c) dt_rom with MoE under both dispatches, the MoE Block card vs
    CPU and train steps of the dense-FFN and MoE DTs timed, (d) brick_ppo;
    runs and checkpoints go under ``tmp``.  Returns the kernel launches of
    the two dt_rom runs."""
    return restoring_flags(rom_checks, smi, tmp)


def rom_observations(smi: str):
    """(a): ``rally_native`` at 32 envs for 300 pool steps of seeded random
    actions; ``_obs`` on the card against the CPU every 25th step; the
    emulator's and the observation's ms a pool step."""
    import numpy as np

    from mmtrl_tpu_torch.data.quant import dequant_audio_u8, quant_audio_u8
    from mmtrl_tpu_torch.envs.homebrew_native import NativeHomebrew

    env = NativeHomebrew(ROM_ENVS, seed=SEED)
    cpu_env = NativeHomebrew(ROM_ENVS, seed=SEED, device="cpu")  # for its _obs
    rng = np.random.default_rng(SEED)
    try:
        frames, audio = env._host_reset()
        worst, host_s, obs_s, rewards, dones = 0.0, 0.0, 0.0, 0.0, 0
        for t in range(ROM_OBS_STEPS):
            code = quant_audio_u8(audio)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obs = env._obs(frames, dequant_audio_u8(torch.from_numpy(code).cuda()))
            torch.cuda.synchronize()
            obs_s += time.perf_counter() - t0
            check(obs.shape == (ROM_ENVS, 3, 84, 84) and bool(torch.isfinite(obs).all()),
                  f"observation {tuple(obs.shape)} not finite")
            if t % ROM_OBS_EVERY == 0:
                ref = cpu_env._obs(frames, dequant_audio_u8(torch.from_numpy(code)))
                worst = max(worst, (obs.cpu() - ref).abs().max().item())
            t0 = time.perf_counter()
            frames, audio, kd, ld, done, win, _, _ = env._host_step(
                rng.integers(0, env.num_actions, ROM_ENVS).astype(np.int32))
            host_s += time.perf_counter() - t0
            rewards += float(env._reward(kd, ld, win).sum())
            dones += int(done.sum())
    finally:
        env.close()
        cpu_env.close()
    emit("rom_obs", env="rally_native", num_envs=ROM_ENVS, pool_steps=ROM_OBS_STEPS,
         checked_steps=len(range(0, ROM_OBS_STEPS, ROM_OBS_EVERY)), max_abs_err_obs=worst,
         tol=ROM_OBS_ATOL, emulator_ms_per_pool_step=1e3 * host_s / ROM_OBS_STEPS,
         obs_ms_per_pool_step=1e3 * obs_s / ROM_OBS_STEPS, reward_sum=rewards,
         episodes_ended=dones, card=smi, ok=worst <= ROM_OBS_ATOL)
    check(worst <= ROM_OBS_ATOL, f"RALLY observation card vs CPU {worst}")


def moe_block_check(dispatch: str):
    """One full-width MoE Block forward and backward, card against CPU."""
    from mmtrl_tpu_torch.models.decision_transformer import Block, DTConfig

    cfg = DTConfig(**ROM_DT_CFG, dropout=0.0, compute_dtype="float32", moe_experts=4,
                   moe_top_k=2, moe_dispatch=dispatch)
    torch.manual_seed(SEED)
    block = Block(cfg, torch.device("cuda"))
    cpu_block = Block(cfg, torch.device("cpu"))
    cpu_block.load_state_dict(block.state_dict())
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(64, 3 * cfg.context_len, cfg.d_model, generator=g)
    w = torch.randn(x.shape, generator=g)
    sides = []
    reset_counts()
    for m, dev in ((block, "cuda"), (cpu_block, "cpu")):
        xi = x.to(dev).requires_grad_()
        y, aux = m(xi)
        loss = (y * w.to(dev)).sum() + aux
        grads = torch.autograd.grad(loss, [xi] + list(m.parameters()))
        sides.append((y.detach().cpu(), aux.item(), [gr.cpu() for gr in grads]))
    counts = read_counts()
    (y_c, aux_c, g_c), (y_r, aux_r, g_r) = sides
    errs = {"y": (y_c - y_r).abs().max().item() / y_r.abs().max().item(),
            "aux": abs(aux_c - aux_r) / abs(aux_r)}
    names = ["x"] + [n for n, _ in block.named_parameters()]
    for name, a, b in zip(names, g_c, g_r):
        errs[f"grad {name}"] = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    worst = max(errs, key=errs.get)
    ok = all(math.isfinite(e) and e <= ROM_BLOCK_TOL_OF_MAX for e in errs.values())
    emit("rom_moe_block", dispatch=dispatch, compute_dtype="float32", tokens=x.shape[0] * x.shape[1],
         worst=worst, worst_err_of_max=errs[worst], err_y=errs["y"], err_aux=errs["aux"],
         aux_card=aux_c, tol_of_max=ROM_BLOCK_TOL_OF_MAX, launches=counts, ok=ok)
    check(ok, f"MoE block ({dispatch}) card vs CPU: {worst} {errs[worst]}")
    check(counts["flash_fwd"] == 1 and counts["flash_dq"] == 1 and counts["flash_dkv"] == 1,
          f"MoE block launches {counts}")


def dt_step_timing(smi: str, label: str, **moe):
    """ms a train step and tokens/s of the full-width DT at dt_rom's shape
    (B = 64, K = 30, 3 x 84 x 84 states, 6 actions) on a random buffer."""
    from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state, make_dt_train_step
    from mmtrl_tpu_torch.algos.dt.data import random_buffer
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig

    B, K = 64, 30
    cfg = DTConfig(**ROM_DT_CFG, **moe)
    buffer = random_buffer(16, 1024, torch.Generator(device="cuda").manual_seed(SEED),
                           state_shape=(3, 84, 84), num_actions=6)
    state = create_dt_state(cfg, DTTrainConfig(batch_size=B, total_steps=1000), seed=SEED,
                            state_channels=3)
    step = make_dt_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.manual_seed(SEED)
    for _ in range(3):
        state, metrics = step(state, buffer.sample(gen, B, K))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ROM_TIMED_STEPS):
        state, metrics = step(state, buffer.sample(gen, B, K))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / ROM_TIMED_STEPS
    (state, metrics), wall, ops, busy, top = device_profile(
        lambda: step(state, buffer.sample(gen, B, K)))
    metrics = {k: float(v) for k, v in metrics.items()}
    n_params = sum(p.numel() for p in state.model.parameters())
    emit("rom_dt_step", model=label, batch_size=B, context_len=K, params=n_params,
         step_ms=1e3 * step_s, tokens_per_s=B * 3 * K / step_s, steps_timed=ROM_TIMED_STEPS,
         profiled_step_ms=1e3 * wall, device_ops=ops, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:4], card=smi,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **metrics)
    check(all(math.isfinite(v) for v in metrics.values()), f"{label}: non-finite metrics")


def rom_checks(smi: str, tmp: str):
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import brick_ppo, dt_rom, rally_ppo

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    save_dir = os.path.join(tmp, "saved_agents")
    rom_observations(smi)

    # (b) rally_ppo: two updates with a save, then one resumed update
    def ppo_row(out, what):
        for r in out["history"]:
            emit("rom_ppo", run=what, update=r["update"], wall_s=r["wall_s"],
                 rollout_s=r["rollout_s"], update_s=r["update_s"], emulator_s=r["emulator_s"],
                 sps=r["sps"], env_steps_per_s=ROM_PPO_UPDATE / r["wall_s"],
                 episodic_return=r["episodic_return"], value_loss=r["losses/value_loss"],
                 max_memory_gb=r.get("max_memory_gb"), card=smi)
            check(all(math.isfinite(r[k]) for k in ("losses/policy_loss", "losses/value_loss",
                                                     "losses/entropy")),
                  f"{what}: non-finite losses in update {r['update']}")

    args = ROM_PPO_ARGS + ["--save-dir", save_dir]
    first = rally_ppo.main(cli(rally_ppo.Args, args + ["--total-timesteps",
                                                       str(2 * ROM_PPO_UPDATE)]))
    ppo_row(first, "rally_ppo")
    ckpt = os.path.join(save_dir, first["run_name"])
    resumed = rally_ppo.main(cli(rally_ppo.Args, [
        "--eval-steps", "200", "--load-from", ckpt, "--total-timesteps",
        str(3 * ROM_PPO_UPDATE)]))
    ppo_row(resumed, "rally_ppo --load-from")
    check(resumed["initial_update"] == 3 and [r["update"] for r in resumed["history"]] == [3],
          f"resume ran updates {[r['update'] for r in resumed['history']]}")
    emit("rom_ppo_eval", eval_steps=200, **{k: resumed.get(k) for k in
                                            ("eval_episodic_return", "eval_episodes")})

    # (c) the MoE DT through dt_rom, under both dispatches
    launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for dispatch in ("dense", "gather"):
        argv = ROM_DT_ARGS + ["--policy-from", ckpt, "--moe-dispatch", dispatch]
        reset_counts()
        out = dt_rom.main(cli(dt_rom.Args, argv))
        counts = read_counts()
        layers, steps, pool = 6, out["train_steps"], out["eval_pool_steps"]
        expected = {"flash_fwd": layers * (steps + pool), "flash_dq": layers * steps,
                    "flash_dkv": layers * steps}
        emit("rom_dt", dispatch=dispatch, collect_s=out["collect_s"], train_s=out["train_s"],
             eval_s=out["eval_s"], train_steps=steps, eval_pool_steps=pool,
             tokens_per_s=out["tokens_per_s"], loss=out["dt/loss"], moe_aux=out["dt/moe_aux"],
             behavior_return=out["behavior/episodic_return"],
             behavior_episodes=out["behavior/episodes"],
             eval_return=out["eval/episodic_return"], eval_episodes=out["eval/episodes"],
             launches=counts, expected_launches=expected, card=smi)
        check(counts == expected, f"dt_rom {dispatch}: launches {counts}, expected {expected}")
        launches = {k: launches[k] + v for k, v in counts.items()}
        check(math.isfinite(out["dt/loss"]) and math.isfinite(out["dt/moe_aux"]),
              f"dt_rom {dispatch}: loss {out['dt/loss']} aux {out['dt/moe_aux']}")
        check(out["eval/episodes"] >= 16, f"dt_rom {dispatch}: {out['eval/episodes']} episodes")
        moe_block_check(dispatch)
    dt_step_timing(smi, "dense FFN")
    for dispatch in ("dense", "gather"):
        dt_step_timing(smi, f"MoE {dispatch}", moe_experts=4, moe_top_k=2, moe_dispatch=dispatch)

    # (d) brick_ppo, one update, profiled (rollout and update)
    brick, wall, ops, busy, top = device_profile(lambda: brick_ppo.main(cli(brick_ppo.Args, [
        "--eval-steps", "0", "--total-timesteps", str(ROM_PPO_UPDATE)])))
    ppo_row(brick, "brick_ppo")
    emit("rom_ppo_profile", run="brick_ppo", wall_s=wall, device_ops=ops, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:4], card=smi)
    return launches


# Skeleton+ on the device simulator (ROADMAP A.7's first item): the env
# card against CPU under the same draws, skeleton_plus_ppo at its defaults
# (8 envs x 128 steps, 4 epochs x 4 minibatches, big towers, casl, two
# audio channels, input scale 1) and evaluate on its checkpoint.
SKEL_ENVS = 8  # skeleton_plus_ppo's default
SKEL_SCRIPT_STEPS = 80  # steps of the scripted card-vs-CPU episode
SKEL_TIMED_STEPS = 100  # sim steps timed alone, random actions
# The observation, card against CPU: the frame is the same additions (equal);
# the MFCC planes carry cuFFT's and pocketfft's other summation orders
# (cepstra up to about 40) through the fixed normalisation (range about 60).
SKEL_OBS_ATOL = 1e-4
SKEL_UPDATE = SKEL_ENVS * 128  # env steps an update
SKEL_PPO_ARGS = ["--save-interval", "3"]
# Value learning on RALLY (ROADMAP A.6's cartridge half): dqn_rom and
# c51_rom at full width (AtariTower('big') on 3 x 84 x 84, batch 128, 8 pool
# envs, C51 on 51 atoms over [-10, 10], int8 replay), cut in depth: a ring
# of 4,096 that the 5,120 transitions wrap, updates past 1,024 stored
# transitions (255 of them, every 2nd pool step), a 200-step episode cap
# and its floor of 300 greedy evaluation pool steps; C51's target sync every
# 250 pool steps (of 1,250) so that it syncs more than once.
Q_RUN_ARGS = ["--total-timesteps", "5120", "--buffer-size", "4096", "--learning-starts",
              "1024", "--episode-steps", "200", "--eval-steps", "1", "--save-interval", "1000"]
C51_RUN_ARGS = Q_RUN_ARGS + ["--target-network-frequency", "250"]
Q_BATCH = 128
# The TD updates card against CPU, float64 on both sides (in float32 a ReLU
# input within rounding of zero can switch, and Adam turns the switched
# near-zero gradient into a step of the learning rate).
Q_PARAM_ATOL_FLOAT64 = 1e-9
# dt_rom from the DQN checkpoint: the rom phase's cut of the PPO-policy run
# (ROM_DT_ARGS) with the dense FFN; from the C51 checkpoint a shorter one
# (2,048 transitions, 128 pool steps, enough for RALLY episodes to end; 10
# train steps; the same 300 evaluation pool steps).
Q_DT_ARGS = ROM_DT_ARGS[:ROM_DT_ARGS.index("--moe-experts")]  # the MoE flags end it
C51_DT_ARGS = Q_DT_ARGS + ["--collect-steps", "2048", "--total-steps", "10"]


class DrawTape:
    """The simulator's three sampler hooks on the CPU env, recorded, and
    the same draws replayed into the card env in the order it asks."""

    def __init__(self, cpu_env, card_env):
        self.tape = []
        for hook, draw in (("reset_sampler", cpu_env.draw_reset),
                           ("step_sampler", cpu_env.draw_step),
                           ("noise_sampler", cpu_env.draw_noise)):
            setattr(cpu_env, hook, self._record(draw))
            setattr(card_env, hook, self._replay)

    def _record(self, draw):
        def sampler(n, generator):
            out = draw(n, generator)
            self.tape.append(out)
            return out

        return sampler

    def _replay(self, n, generator):
        return self.tape.pop(0)


def skeleton_states(rows, device):
    """A SkeletonState of rows (agent (r, c), facing, skeleton (r, c),
    skel_hits, kills, life, t)."""
    from mmtrl_tpu_torch.envs.skeleton_plus import SIZE, SkeletonState

    cols = list(zip(*rows))
    values = dict(agent=[r * SIZE + c for r, c in cols[0]], facing=cols[1],
                  skeleton=[r * SIZE + c for r, c in cols[2]], skel_hits=cols[3],
                  kills=cols[4], life=cols[5], t=cols[6], phase=[0] * len(rows))
    return SkeletonState(**{k: torch.tensor(v, dtype=torch.long, device=device)
                            for k, v in values.items()})


def hunter(state, env) -> torch.Tensor:
    """The scripted policy: fire at a skeleton in sight within range, else
    turn toward or step along the BFS path to it."""
    from mmtrl_tpu_torch.envs.skeleton_plus import (
        FIRE, FIRE_RANGE, FORWARD, NOOP, SIZE, TURN_LEFT, TURN_RIGHT)

    a, f, s = state.agent, state.facing, state.skeleton
    target = env._next[a, s]
    dvec = torch.stack([target // SIZE - a // SIZE, target % SIZE - a % SIZE], -1)
    want = (dvec[:, None] == env._deltas[None]).all(-1).float().argmax(-1)
    act = torch.where(want == f, FORWARD,
                      torch.where((want - f) % 4 == 1, TURN_RIGHT, TURN_LEFT))
    act = torch.where(target == a, NOOP, act)
    return torch.where(env._vis[a, f, s] & (env._dist[a, s] <= FIRE_RANGE), FIRE, act)


def skeleton_sim_checks(smi: str):
    """(a) The simulator, card against CPU under the same draws: a reset of
    SKEL_ENVS envs, then a scripted episode whose first two envs start two
    hits from the win and 20 steps from the time limit (both with 30
    lives), the rest from the reset; state and reward equal every step,
    the observation within SKEL_OBS_ATOL.  The episode must show hits and
    misses, kills with respawns, contact, a win and the time limit.  Then
    the sim's ms a step alone."""
    from mmtrl_tpu_torch.envs.skeleton_plus import FIRE, SkeletonPlusSim

    cpu, card = SkeletonPlusSim(device="cpu"), SkeletonPlusSim()
    tape = DrawTape(cpu, card)
    g = torch.Generator().manual_seed(SEED)
    obs_cpu, s_cpu = cpu.reset(SKEL_ENVS, g)
    obs, s = card.reset(SKEL_ENVS)
    worst = (obs.cpu() - obs_cpu).abs().max().item()
    frame_equal = torch.equal(obs[:, 0].cpu(), obs_cpu[:, 0])
    start = skeleton_states([((1, 1), 1, (1, 3), 3, 4, 30, 0), ((9, 1), 0, (1, 9), 0, 1, 30, 380)],
                            "cpu")
    s_cpu = type(s_cpu)(**{f.name: torch.cat([getattr(start, f.name), getattr(s_cpu, f.name)[2:]])
                           for f in dataclasses.fields(s_cpu)})
    s = type(s)(**{f.name: getattr(s_cpu, f.name).cuda() for f in dataclasses.fields(s_cpu)})
    seen = dict(hit=0, miss=0, respawn=0, contact=0, win=0, time_limit=0)
    states_equal = True
    for _ in range(SKEL_SCRIPT_STEPS):
        action = hunter(s_cpu, cpu)
        before = s_cpu
        obs_cpu, s_cpu, r_cpu, d_cpu, info = cpu.step(s_cpu, action, g)
        obs, s, r, d, _ = card.step(s, action.cuda())
        states_equal &= all(torch.equal(getattr(s, f.name).cpu(), getattr(s_cpu, f.name))
                            for f in dataclasses.fields(s_cpu))
        states_equal &= torch.equal(r.cpu(), r_cpu) and torch.equal(d.cpu(), d_cpu)
        worst = max(worst, (obs.cpu() - obs_cpu).abs().max().item())
        frame_equal &= torch.equal(obs[:, 0].cpu(), obs_cpu[:, 0])
        fired = action == FIRE
        killed = info["kills"] > before.kills
        hit = killed | (~d_cpu & (s_cpu.skel_hits > before.skel_hits))
        seen["hit"] += int((fired & hit).sum())
        seen["miss"] += int((fired & ~hit & ~d_cpu).sum())
        seen["respawn"] += int((killed & (info["kills"] < 5)).sum())
        seen["contact"] += int((info["life"] < before.life).sum())
        seen["win"] += int((info["kills"] >= 5).sum())
        seen["time_limit"] += int((d_cpu & (info["kills"] < 5) & (info["life"] > 0)).sum())
    ok = states_equal and frame_equal and worst <= SKEL_OBS_ATOL and all(seen.values())
    emit("skeleton_sim", num_envs=SKEL_ENVS, steps=SKEL_SCRIPT_STEPS, states_equal=states_equal,
         frame_equal=frame_equal, max_abs_err_obs=worst, tol=SKEL_OBS_ATOL, events=seen,
         card=smi, ok=ok)
    check(ok, f"Skeleton+ sim card vs CPU: states {states_equal}, frame {frame_equal}, "
          f"obs {worst}, events {seen}")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    sim = SkeletonPlusSim()
    _, state = sim.reset(SKEL_ENVS, g)
    actions = torch.randint(0, 5, (SKEL_TIMED_STEPS, SKEL_ENVS), generator=g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SKEL_TIMED_STEPS):
        o, state, _, _, _ = sim.step(state, actions[t], g)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / SKEL_TIMED_STEPS
    _, wall, ops, busy, top = device_profile(lambda: sim.step(state, actions[0], g))
    emit("skeleton_sim_step", num_envs=SKEL_ENVS, step_ms=step_ms,
         env_steps_per_s=SKEL_ENVS * 1e3 / step_ms, profiled_step_ms=1e3 * wall, device_ops=ops,
         device_busy_ms=busy, idle_share=1 - busy / (1e3 * wall), top_kernels=top[:4], card=smi)


def skeleton_checks(smi: str, tmp: str):
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import evaluate, skeleton_plus_ppo

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    save_dir = os.path.join(tmp, "saved_agents")
    skeleton_sim_checks(smi)

    # (b) skeleton_plus_ppo at its defaults: three updates and a save, then
    # update 4 resumed from it and profiled
    out = skeleton_plus_ppo.main(cli(skeleton_plus_ppo.Args, SKEL_PPO_ARGS + [
        "--total-timesteps", str(3 * SKEL_UPDATE), "--save-dir", save_dir]))
    for r in out["history"]:
        emit("skeleton_ppo", update=r["update"], wall_s=r["wall_s"], sps=r["sps"],
             env_steps_per_s=SKEL_UPDATE / r["wall_s"], value_loss=r["losses/value_loss"],
             episodic_return=r["episodic_return"],
             max_memory_gb=r.get("max_memory_gb"), card=smi)
        check(all(math.isfinite(r[k]) for k in ("losses/policy_loss", "losses/value_loss",
                                                 "losses/entropy")),
              f"skeleton_plus_ppo: non-finite losses in update {r['update']}")
    check([r["update"] for r in out["history"]] == [1, 2, 3],
          f"skeleton_plus_ppo ran updates {[r['update'] for r in out['history']]}")
    model = out["runner"].model
    check(model.audio_net.Conv_0.weight.shape[1] == 2 and model.input_scale == 1.0,
          "skeleton_plus_ppo: the agent is not the two-channel, input-scale-1 casl agent")
    ckpt = os.path.join(save_dir, out["run_name"])
    resumed, wall, ops, busy, top = device_profile(lambda: skeleton_plus_ppo.main(cli(
        skeleton_plus_ppo.Args, ["--load-from", ckpt, "--total-timesteps",
                                 str(4 * SKEL_UPDATE)])))
    check([r["update"] for r in resumed["history"]] == [4], "skeleton_plus_ppo resume")
    emit("skeleton_ppo_profile", update=4, wall_s=wall, device_ops=ops, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:4], card=smi)

    # (c) evaluate on the checkpoint: 16 envs x 512 steps, greedy
    t0 = time.perf_counter()
    res = evaluate.main(cli(evaluate.Args, [
        "--load-from", ckpt, "--script", "skeleton_plus_ppo", "--env-id", "skeleton_plus",
        "--attn-type", "casl", "--input-scale", "1"]))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    emit("skeleton_evaluate", wall_s=eval_s, env_steps_per_s=16 * 512 / eval_s, **res, card=smi)
    check(res["eval/episodes"] >= 1 and math.isfinite(res["eval/episodic_return"]),
          f"skeleton evaluate: {res}")


def phase_skeleton(smi: str, tmp: str):
    """Skeleton+ on the device simulator: (a) the env card vs CPU and
    timed, (b) skeleton_plus_ppo at its defaults for three updates, a
    fourth resumed and profiled, (c) evaluate on the checkpoint.  No
    kernel of the port lies on this path (its agent has no attention)."""
    restoring_flags(skeleton_checks, smi, tmp)


def td_update_checks(smi: str):
    """A ``dqn_td_update`` and a ``c51_td_update`` at batch 128 on the
    full-width Q networks, card against CPU from the same weights and
    batch: in float64 within Q_PARAM_ATOL_FLOAT64, the float32 distances
    (card from CPU, each from float64) reported."""
    import copy

    from mmtrl_tpu_torch.algos.offpolicy import c51_td_update, create_dqn_state, dqn_td_update
    from mmtrl_tpu_torch.data.quant import dequant_obs_i8
    from mmtrl_tpu_torch.models.agents import DistributionalQNetwork, QNetwork

    g = torch.Generator().manual_seed(SEED)
    codes = torch.randint(-127, 128, (2, Q_BATCH, 3, 84, 84), generator=g, dtype=torch.int8)
    batch = dict(obs=dequant_obs_i8(codes[0]), next_obs=dequant_obs_i8(codes[1]),
                 action=torch.randint(0, 6, (Q_BATCH,), generator=g),
                 reward=torch.randint(-1, 2, (Q_BATCH,), generator=g).float(),
                 done=(torch.rand(Q_BATCH, generator=g) < 0.1).float())
    cases = {
        "dqn": (lambda d: QNetwork(6, 1.0, device=d), 1e-4, 1e-8,
                lambda ts, b, atoms: dqn_td_update(0.99, ts, b)[:3]),
        "c51": (lambda d: DistributionalQNetwork(6, 51, 1.0, device=d), 2.5e-4, 0.01 / Q_BATCH,
                lambda ts, b, atoms: c51_td_update(atoms, 0.99, ts, b)),
    }
    for name, (build, lr, eps, update) in cases.items():
        card_net, cpu_net = card_and_cpu(build)
        target_card, target_cpu = card_and_cpu(build)  # another init: a target apart
        runs = {}
        for label, net, target, device, dtype in (
                ("card", card_net, target_card, "cuda", torch.float32),
                ("cpu", cpu_net, target_cpu, "cpu", torch.float32),
                ("card64", card_net, target_card, "cuda", torch.float64),
                ("cpu64", cpu_net, target_cpu, "cpu", torch.float64)):
            ts = create_dqn_state(copy.deepcopy(net).to(dtype), lr, eps)
            ts.target.load_state_dict(target.state_dict())
            b = {k: (v.to(dtype) if v.is_floating_point() else v).to(device)
                 for k, v in batch.items()}
            atoms = torch.linspace(-10.0, 10.0, 51, dtype=dtype, device=device)
            ts, loss, q = update(ts, b, atoms)
            runs[label] = (ts.model, float(loss), float(q))
        err64, at64 = param_err([runs["card64"][0]], [runs["cpu64"][0]])
        moved = param_err([runs["cpu64"][0]], [cpu_net])[0]
        ok = err64 <= Q_PARAM_ATOL_FLOAT64 and moved > 0
        emit("offpolicy_td_update", algo=name, batch_size=Q_BATCH, worst_param_abs_err=err64,
             worst_param=at64, atol=Q_PARAM_ATOL_FLOAT64, largest_param_move=moved,
             float32_card_vs_cpu=param_err([runs["card"][0]], [runs["cpu"][0]])[0],
             float32_card_vs_float64_cpu=param_err([runs["card"][0]], [runs["cpu64"][0]])[0],
             float32_cpu_vs_float64_cpu=param_err([runs["cpu"][0]], [runs["cpu64"][0]])[0],
             loss_card_cpu=[runs["card"][1], runs["cpu"][1]],
             loss_float64_card_cpu=[runs["card64"][1], runs["cpu64"][1]],
             q_mean_card_cpu=[runs["card"][2], runs["cpu"][2]], card=smi, ok=ok)
        check(ok, f"{name}_td_update card vs CPU in float64: {err64} at {at64}, moved {moved}")


def offpolicy_checks(smi: str, tmp: str):
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import c51_rom, dqn_rom, dt_rom

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    save_dir = os.path.join(tmp, "saved_agents")
    td_update_checks(smi)

    # (b) dqn_rom (profiled) and c51_rom on RALLY
    ckpts = {}
    for name, module, argv in (("dqn_rom", dqn_rom, Q_RUN_ARGS), ("c51_rom", c51_rom, C51_RUN_ARGS)):
        out, wall, ops, busy, top = device_profile(lambda: module.main(cli(
            module.Args, argv + ["--save-dir", save_dir])))
        pool_steps = out["pool_steps"]
        emit("offpolicy_rom", run=name, wall_s=wall, train_s=out["train_s"],
             eval_s=out["eval_s"], emulator_s=out["emulator_s"], pool_steps=pool_steps,
             env_steps_per_s=out["global_step"] / out["train_s"],
             ms_per_pool_step=1e3 * out["train_s"] / pool_steps, updates=out["updates"],
             target_syncs=out["target_syncs"], td_loss=out["td_loss"],
             q_values=out["q_values"], episodes=out["episodes"],
             eval_pool_steps=out["eval_pool_steps"], eval_episodes=out.get("eval_episodes", 0),
             eval_return=out.get("eval_episodic_return"), device_ops=ops, device_busy_ms=busy,
             idle_share=1 - busy / (1e3 * wall), top_kernels=top[:4],
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
        check(out["updates"] >= 20 and out["target_syncs"] >= 2,
              f"{name}: {out['updates']} updates, {out['target_syncs']} target syncs")
        check(math.isfinite(out["td_loss"]) and math.isfinite(out["q_values"]),
              f"{name}: loss {out['td_loss']} q {out['q_values']}")
        check(out.get("eval_episodes", 0) >= 1, f"{name}: no evaluation episode ended")
        ckpts[name] = os.path.join(save_dir, out["run_name"])

    # (c) dt_rom from each Q checkpoint: the three kernels at full width
    launches = {}
    for kind, argv in (("dqn", Q_DT_ARGS), ("c51", C51_DT_ARGS)):
        reset_counts()
        out = dt_rom.main(cli(dt_rom.Args, argv + ["--policy-from", ckpts[f"{kind}_rom"],
                                                   "--policy-kind", kind]))
        counts = read_counts()
        layers, steps, pool = 6, out["train_steps"], out["eval_pool_steps"]
        expected = {"flash_fwd": layers * (steps + pool), "flash_dq": layers * steps,
                    "flash_dkv": layers * steps}
        emit("offpolicy_dt", policy_kind=kind, collect_s=out["collect_s"],
             train_s=out["train_s"], eval_s=out["eval_s"], train_steps=steps,
             eval_pool_steps=pool, tokens_per_s=out["tokens_per_s"], loss=out["dt/loss"],
             behavior_return=out["behavior/episodic_return"],
             behavior_episodes=out["behavior/episodes"],
             eval_return=out["eval/episodic_return"], eval_episodes=out["eval/episodes"],
             launches=counts, expected_launches=expected, card=smi)
        check(counts == expected, f"dt_rom --policy-kind {kind}: launches {counts}, "
              f"expected {expected}")
        check(math.isfinite(out["dt/loss"]) and out["eval/episodes"] >= 1,
              f"dt_rom --policy-kind {kind}: loss {out['dt/loss']}, "
              f"{out['eval/episodes']} episodes")
        launches[kind] = counts
    return launches


def phase_offpolicy_rom(smi: str, tmp: str):
    """Value learning on the cartridges: (a) both TD updates card vs CPU,
    (b) dqn_rom (profiled) and c51_rom on RALLY through ``main``, (c)
    dt_rom --policy-kind dqn and c51 from their checkpoints.  Returns the
    kernel launches of the two dt_rom runs."""
    return restoring_flags(offpolicy_checks, smi, tmp)


# The discrete classic-control zoo: CartPole, Acrobot and MountainCar on the
# card, DQN with PER and C51 through their fused loops, PPO with the 64-64
# tanh agent (Pendulum and the continuous algorithms: the continuous phase).
# No kernel of the port lies on this path (no attention).
CLASSIC_ENVS = ("CartPole-v1", "Acrobot-v1", "MountainCar-v0")
CLASSIC_ENV_BATCH = 64  # envs stepped together in the card-vs-CPU check
CLASSIC_ENV_STEPS = 40
# One step from the same float32 state on each device: CUDA's and the CPU's
# float32 sin and cos may part by an ulp or two, which the step carries into
# the state.  CartPole and MountainCar within 1e-6; Acrobot's four RK4
# stages and velocities up to 9 pi within 1e-5.
CLASSIC_STATE_ATOL = {"CartPole-v1": 1e-6, "Acrobot-v1": 1e-5, "MountainCar-v0": 1e-6}
PER_CAPACITY = 16_384  # the default buffer of 10,000 rounded up to a power of two
PER_BATCH = 128
# The weighted TD update card vs CPU, float64 on both sides
PER_TD_ATOL_FLOAT64 = 1e-12
# The runs through main at full width (120-84 Q nets, batch 128, a ring of
# 10,000; C51 on 101 atoms), cut in length: 5,120 of 500,000 steps (10
# iterations of 512), updates past 1,024 (of 10,000) stored transitions
# every 10th step (410), target syncs every 500 steps (10).  The cut total
# also shortens epsilon's decay (to 2,560 steps) and PER's beta anneal.
CLASSIC_Q_ARGS = ["--total-timesteps", "5120", "--learning-starts", "1024"]
CLASSIC_Q_ITERS = 10
# The DQN resume: 9 iterations saved, iteration 10 in memory and from the
# checkpoint
CLASSIC_RESUME_FIRST = ["--total-timesteps", "4608", "--learning-starts", "1024",
                        "--save-interval", "9"]
# PPO at the script's defaults (4 envs x 128 steps, 4 x 4 minibatches), 4
# updates of 500,000 steps' worth
CLASSIC_PPO_ARGS = ["--total-timesteps", "2048", "--save-interval", "4"]


def classic_env_checks(smi: str):
    """(a) Each env card vs CPU: 64 envs for 40 steps under random actions,
    each step from the CPU's state (so a step's error is its own), the
    card's auto-resets fed the CPU's reset draws."""
    from mmtrl_tpu_torch.envs import make

    g = torch.Generator().manual_seed(SEED)
    for env_id in CLASSIC_ENVS:
        tape = []

        def record(n, generator, env=None):
            out = env.draw_reset(n, generator)
            tape.append(out)
            return out

        cpu = make(env_id, device="cpu")
        cpu.sampler = lambda n, generator, env=cpu: record(n, generator, env)
        card_env = make(env_id, device="cuda", sampler=lambda n, generator: tape.pop(0))
        _, state = cpu.reset(CLASSIC_ENV_BATCH, g)
        state.t[:8] = cpu.max_steps - 4  # 8 envs reach the time limit
        tape.clear()
        worst, dones, truncs = 0.0, 0, 0
        flags_equal = True
        for _ in range(CLASSIC_ENV_STEPS):
            action = torch.randint(0, cpu.num_actions, (CLASSIC_ENV_BATCH,), generator=g)
            card_state = type(state)(**{f.name: getattr(state, f.name).cuda()
                                        for f in dataclasses.fields(state)})
            obs, nxt, r, d, info = cpu.step(state, action, g)
            c_obs, c_nxt, c_r, c_d, c_info = card_env.step(card_state, action.cuda())
            flags_equal &= (torch.equal(d, c_d.cpu()) and torch.equal(r, c_r.cpu())
                            and torch.equal(info["truncated"], c_info["truncated"].cpu()))
            for a, b in [(obs, c_obs), (info["final_obs"], c_info["final_obs"])] + [
                    (getattr(nxt, f.name), getattr(c_nxt, f.name))
                    for f in dataclasses.fields(nxt)]:
                worst = max(worst, (a.double() - b.cpu().double()).abs().max().item())
            dones += int(d.sum())
            truncs += int(info["truncated"].sum())
            state = nxt
        atol = CLASSIC_STATE_ATOL[env_id]
        ok = flags_equal and worst <= atol and truncs > 0
        emit("classic_env", env=env_id, envs=CLASSIC_ENV_BATCH, steps=CLASSIC_ENV_STEPS,
             max_abs_err=worst, atol=atol, done_reward_truncated_equal=flags_equal,
             dones=dones, truncated=truncs, card=smi, ok=ok)
        check(ok, f"{env_id} card vs CPU: {worst} (flags equal: {flags_equal})")

    # the card env alone: one step of 1 env (DQN's) and of 16, timed
    from mmtrl_tpu_torch.envs.classic import CartPole

    for n in (1, 16):
        ms, ops, busy = env_step_timing(CartPole(device="cuda"), n,
                                        torch.zeros(n, dtype=torch.long, device="cuda"))
        emit("classic_env", env="CartPole-v1", timed_envs=n, ms_per_step=ms,
             env_steps_per_s=n * 1e3 / ms, device_ops_per_step=ops, device_busy_ms=busy,
             card=smi)


def classic_per_checks(smi: str):
    """(b) The sum-tree and the PER buffer card vs CPU, the same uniforms
    and priorities, writes with repeated leaves: leaf indices equal, the
    tree and the largest priority bit for bit, the IS weights reported."""
    from mmtrl_tpu_torch.data.buffers import PrioritizedReplayBuffer, SumTree

    g = torch.Generator().manual_seed(SEED)
    sides = {"cpu": "cpu", "card": "cuda"}  # label: device
    trees = {label: SumTree.create(PER_CAPACITY, d) for label, d in sides.items()}
    same_idx = True
    for _ in range(8):
        idx = torch.randint(0, PER_CAPACITY, (4096,), generator=g)
        idx[100:200] = idx[0]  # one leaf written 101 times: the last value stands
        vals = torch.rand(4096, generator=g) * 3
        u = torch.rand(PER_BATCH, generator=g)
        for label, tree in trees.items():
            tree.update(idx.to(sides[label]), vals.to(sides[label]))
        picks = [tree.sample(None, PER_BATCH, u.to(sides[label])).cpu()
                 for label, tree in trees.items()]
        same_idx &= torch.equal(*picks)
    same_tree = torch.equal(trees["cpu"].nodes, trees["card"].nodes.cpu())
    last_ok = trees["cpu"].get(idx[:1]).item() == vals[199].item()
    emit("classic_per", check="SumTree update and sample card vs cpu", capacity=PER_CAPACITY,
         leaf_indices_equal=same_idx, tree_bit_for_bit=same_tree,
         repeated_leaf_keeps_last=last_ok, card=smi, ok=same_idx and same_tree and last_ok)
    check(same_idx and same_tree and last_ok, "SumTree: the card and the CPU part")

    example = dict(obs=torch.zeros(4), action=torch.zeros((), dtype=torch.long),
                   reward=torch.zeros(()), next_obs=torch.zeros(4), done=torch.zeros(()))
    bufs = {label: PrioritizedReplayBuffer.create({k: v.to(d) for k, v in example.items()},
                                                  10_000) for label, d in sides.items()}
    same_idx, weights_err = True, 0.0
    for r in range(40):  # 40 x 512 = 20,480 transitions: the ring of 16,384 wraps
        batch = dict(obs=torch.randn(512, 4, generator=g),
                     action=torch.randint(0, 2, (512,), generator=g),
                     reward=torch.ones(512), next_obs=torch.randn(512, 4, generator=g),
                     done=(torch.rand(512, generator=g) < 0.05).float())
        u = torch.rand(PER_BATCH, generator=g)
        prio = torch.rand(PER_BATCH, generator=g) * 4
        out = {}
        for label, buf in bufs.items():
            d = sides[label]
            buf.add_batch({k: v.to(d) for k, v in batch.items()}, 512)
            b, idx, w = buf.sample(None, PER_BATCH, 0.4 + 0.015 * r, u.to(d))
            idx = idx.clone()
            idx[1::16] = idx[0]  # repeated leaves in the priority write
            buf.update_priorities(idx, prio.to(d))
            out[label] = (idx.cpu(), w.cpu(), b["obs"].cpu())
        same_idx &= torch.equal(out["cpu"][0], out["card"][0]) and torch.equal(
            out["cpu"][2], out["card"][2])
        weights_err = max(weights_err, (out["cpu"][1] - out["card"][1]).abs().max().item())
    same_tree = torch.equal(bufs["cpu"].tree.nodes, bufs["card"].tree.nodes.cpu())
    same_max = torch.equal(bufs["cpu"].max_priority, bufs["card"].max_priority.cpu())
    ok = same_idx and same_tree and same_max and bufs["card"].buffer.capacity == PER_CAPACITY
    emit("classic_per", check="PrioritizedReplayBuffer card vs cpu", writes=40 * 512,
         capacity=bufs["card"].buffer.capacity, batch=PER_BATCH, leaf_indices_equal=same_idx,
         tree_bit_for_bit=same_tree, max_priority_equal=same_max,
         is_weights_max_abs_err=weights_err, card=smi, ok=ok)
    check(ok, "PrioritizedReplayBuffer: the card and the CPU part")


def classic_td_check(smi: str):
    """(c) ``dqn_td_update`` with PER weights on the full-width 120-84 Q
    net, batch 128, card vs CPU in float64."""
    import copy

    from mmtrl_tpu_torch.algos.offpolicy import create_dqn_state, dqn_td_update
    from mmtrl_tpu_torch.models.agents import QNetwork

    g = torch.Generator().manual_seed(SEED)
    batch = dict(obs=torch.randn(PER_BATCH, 4, generator=g),
                 action=torch.randint(0, 2, (PER_BATCH,), generator=g),
                 reward=torch.ones(PER_BATCH), next_obs=torch.randn(PER_BATCH, 4, generator=g),
                 done=(torch.rand(PER_BATCH, generator=g) < 0.1).float())
    weights = torch.rand(PER_BATCH, generator=g) * 0.9 + 0.1
    net, net_cpu = card_and_cpu(lambda d: QNetwork(2, obs_shape=(4,), device=d))
    torch.manual_seed(SEED + 1)
    target = QNetwork(2, obs_shape=(4,), device="cpu")  # another init: a target apart
    runs = {}
    for label, device, dtype in (("card64", "cuda", torch.float64), ("cpu64", "cpu", torch.float64),
                                 ("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32)):
        ts = create_dqn_state(copy.deepcopy(net).to(device, dtype), 2.5e-4)
        ts.target.load_state_dict(target.state_dict())
        b = {k: (v.to(dtype) if v.is_floating_point() else v).to(device) for k, v in batch.items()}
        ts, loss, q, td = dqn_td_update(0.99, ts, b, weights.to(device, dtype))
        runs[label] = (ts.model, float(loss), td.cpu())
    err, at = param_err([runs["card64"][0]], [runs["cpu64"][0]])
    td_err = (runs["card64"][2] - runs["cpu64"][2]).abs().max().item()
    moved = param_err([runs["cpu64"][0]], [net_cpu])[0]
    ok = err <= PER_TD_ATOL_FLOAT64 and td_err <= PER_TD_ATOL_FLOAT64 and moved > 0
    emit("classic_td_update", batch_size=PER_BATCH, worst_param_abs_err=err, worst_param=at,
         td_abs_err=td_err, atol=PER_TD_ATOL_FLOAT64, largest_param_move=moved,
         loss_float64_card_cpu=[runs["card64"][1], runs["cpu64"][1]],
         float32_card_vs_cpu=param_err([runs["card"][0]], [runs["cpu"][0]])[0],
         loss_float32_card_cpu=[runs["card"][1], runs["cpu"][1]], card=smi, ok=ok)
    check(ok, f"weighted dqn_td_update card vs CPU in float64: {err} at {at}, |td| {td_err}")


def classic_q_runs(smi: str, tmp: str):
    """(d) ``dqn --prioritized-replay`` and ``c51`` through ``main`` at
    full width on CartPole-v1, then the DQN resume against the run
    continued in memory, bit for bit, and one profiled iteration."""
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import c51, dqn

    save_dir = os.path.join(tmp, "classic_ck")
    for name, module, extra in (("dqn --prioritized-replay", dqn, ["--prioritized-replay"]),
                                ("c51", c51, [])):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = module.main(cli(module.Args, CLASSIC_Q_ARGS + extra))
        wall = time.perf_counter() - t0
        hist = out["history"]
        loss_key = "losses/td_loss" if module is dqn else "losses/loss"
        train_s = sum(r["wall_s"] for r in hist)
        emit("classic_q", run=name, iterations=len(hist), global_step=out["global_step"],
             wall_s=wall, train_s=train_s, eval_s=out["eval_s"],
             env_steps_per_s=out["global_step"] / train_s,
             wall_per_iteration_s=[r["wall_s"] for r in hist],
             last_step_losses=[r[loss_key] for r in hist],
             q_values=[r["losses/q_values"] for r in hist],
             episodic_return=out["episodic_return"], eval_return=out["eval_episodic_return"],
             eval_episodes=out["eval_episodes"],
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
        runner = out["runner"]
        check(len(hist) == CLASSIC_Q_ITERS and out["global_step"] == 512 * CLASSIC_Q_ITERS,
              f"{name}: {len(hist)} iterations")
        # 410 updates; iterations 5 and 10 end on a training step
        check(int(runner.train_state.step) == 410, f"{name}: {int(runner.train_state.step)} updates")
        check(all(math.isfinite(r[loss_key]) and math.isfinite(r["losses/q_values"])
                  for r in hist) and hist[-1][loss_key] != 0.0, f"{name}: losses {hist}")
        check(out["eval_episodes"] >= 16, f"{name}: {out['eval_episodes']} evaluation episodes")

    # the resume: 9 iterations saved; iteration 10 in memory and from the
    # checkpoint through --load-from, equal bit for bit
    extra = ["--prioritized-replay", "--save-dir", save_dir]
    first = dqn.main(cli(dqn.Args, CLASSIC_RESUME_FIRST + extra))
    args = cli(dqn.Args, CLASSIC_Q_ARGS + ["--prioritized-replay"])
    algo, _, _, _ = dqn.build(args)
    in_memory, _ = algo.train_iteration(first["runner"])
    resumed = dqn.main(cli(dqn.Args, CLASSIC_Q_ARGS + extra + [
        "--load-from", os.path.join(save_dir, first["run_name"])]))
    mine, theirs = in_memory.payload(), resumed["runner"].payload()
    differing = [k for k in mine if not _same_payload(mine[k], theirs[k])]
    emit("classic_q", run="dqn --prioritized-replay resume", initial_iteration=resumed[
        "initial_iteration"], differing_fields=differing, card=smi)
    check(resumed["initial_iteration"] == CLASSIC_Q_ITERS and not differing,
          f"the resumed DQN run differs from iteration 10 in memory in {differing}")

    # one more iteration, profiled
    algo.train_iteration(in_memory)  # warm
    (_, _), wall, ops, busy, top = device_profile(lambda: algo.train_iteration(in_memory))
    emit("classic_q", run="dqn --prioritized-replay profiled iteration", env_steps=512,
         wall_s=wall, device_ops=ops, device_ops_per_env_step=ops / 512, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:6], card=smi)


def classic_ppo_run(smi: str, tmp: str):
    """(e) ``ppo`` on CartPole-v1 for 4 updates at its defaults, then
    ``evaluate --script ppo`` from its checkpoint, the model's first calls
    held against the checkpoint loaded on the CPU."""
    import os

    from mmtrl_tpu_torch.core.checkpoint import load_run
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.envs import make
    from mmtrl_tpu_torch.scripts import evaluate, ppo

    save_dir = os.path.join(tmp, "classic_ck")
    torch.cuda.reset_peak_memory_stats()
    out = ppo.main(cli(ppo.Args, CLASSIC_PPO_ARGS + ["--save-dir", save_dir]))
    for row in out["history"]:
        emit("classic_ppo", run="scripts.ppo CartPole-v1", **row, card=smi)
    emit("classic_ppo", run="scripts.ppo CartPole-v1", sps_of_run=out["sps"],
         updates=len(out["history"]), card=smi)
    check(len(out["history"]) == 4 and all(
        math.isfinite(v) for row in out["history"] for k, v in row.items()
        if k.startswith("losses/")), "ppo: non-finite losses")
    ckpt = os.path.join(save_dir, out["run_name"])
    args = cli(evaluate.Args, ["--script", "ppo", "--env-id", "CartPole-v1", "--load-from", ckpt])
    t0 = time.perf_counter()
    result, calls = evaluate_recording_calls(evaluate, args, EVAL_CHECK_CALLS)
    wall = time.perf_counter() - t0
    ref, _ = evaluate.build_model(args, make(args.env_id, device="cpu"), "cpu")
    ref.load_state_dict(load_run(ckpt, map_location="cpu")["model"])
    with torch.no_grad():
        wants = [ref(*inputs)[0] for inputs, _ in calls]
    err = max((logits - want).abs().max().item() for (_, logits), want in zip(calls, wants))
    scale = max(want.abs().max().item() for want in wants)
    emit("classic_ppo", run="scripts.evaluate --script ppo", wall_s=wall, **result,
         calls_checked=len(calls), logits_max_abs_err_vs_cpu=err, logits_max_abs=scale,
         tol_of_max=PPO_AGENT_TOL_OF_MAX, card=smi)
    check(len(calls) == EVAL_CHECK_CALLS and err <= PPO_AGENT_TOL_OF_MAX * scale,
          f"evaluate --script ppo: the card's logits are {err} from the CPU's (largest {scale})")
    check(result["eval/episodes"] >= args.num_envs, "evaluate --script ppo: too few episodes")


def classic_checks(smi: str, tmp: str):
    import os

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    t0 = time.perf_counter()
    for step in (classic_env_checks, classic_per_checks, classic_td_check):
        step(smi)
    classic_q_runs(smi, tmp)
    classic_ppo_run(smi, tmp)
    emit("classic", seconds=time.perf_counter() - t0, card=smi)


def phase_classic(smi: str, tmp: str):
    """The discrete classic-control zoo: (a) the three envs card vs CPU,
    (b) the sum-tree and PER buffer card vs CPU bit for bit, (c) the
    weighted TD update card vs CPU in float64, (d) dqn --prioritized-replay
    and c51 through main with the DQN resume bit for bit and a profiled
    iteration, (e) ppo on CartPole-v1 and evaluate --script ppo.  No kernel
    of the port lies on this path."""
    restoring_flags(classic_checks, smi, tmp)


# The continuous half of classic control (ROADMAP A.6): Pendulum on the
# card, the continuous-action wrappers, PPO and RPO with a Gaussian policy,
# and DDPG, TD3 and SAC through their fused loops.  No kernel of the port
# lies on this path (no attention).
CONT_ENV_BATCH = 64  # envs stepped together in the card-vs-CPU checks
CONT_ENV_STEPS = 40
# One step from the same float32 state on each device: CUDA's and the CPU's
# float32 sin and cos may part by an ulp or two, which the step carries into
# the state (velocities up to 8); the cost (up to 16.3) within two roundings.
CONT_STATE_ATOL = 1e-6
CONT_REWARD_ATOL = 1e-5
# The wrappers' per-env statistics and scaled rewards, each within this
# share of its tensor's largest magnitude (at least 1); the normalized
# observations within CONT_OBS_TOL_OF_MAX: dividing by the std of a few
# steps' values amplifies the sin/cos ulps (6.5e-6 of the largest seen)
CONT_WRAPPER_TOL_OF_MAX = 1e-5
CONT_OBS_TOL_OF_MAX = 1e-4
CONT_BATCH = 256  # the off-policy updates' batch (the scripts' default)
# PPO and RPO through main at their defaults (4 envs x 2,048 steps, 32 x 10
# minibatches, the wrapper stack), 2 updates of 122, with a save
CONT_PPO_ARGS = ["--total-timesteps", "16384", "--save-interval", "2"]
# DDPG, TD3 and SAC at full width (256-256, batch 256, a ring of 131,072, 1
# env, 512 steps an iteration), cut in length: 1,536 of 1,000,000 steps,
# updates past 1,024 stored (of 25,000; SAC's 5,000): 512 critic steps,
# the actor every 2nd (SAC: 2 passes), SAC's target sync every step.  (At
# 5,120 steps the phase took 396 s on the card: SAC makes 871 device
# operations a training step.  The runs took 2,048 steps, 1,024 updates,
# until the parallel phase took the time of 512 of them.)
CONT_AC_STEPS = 1536
CONT_AC_ARGS = ["--total-timesteps", str(CONT_AC_STEPS), "--learning-starts", "1024",
                "--save-interval", "4"]
CONT_AC_ITERS = 3
CONT_AC_UPDATES = 512
# The next 128 steps, in iterations of 128 (the 13th): in memory (profiled)
# and, for SAC, from the checkpoint
CONT_NEXT_STEPS = 128
CONT_RESUME_ARGS = ["--total-timesteps", str(CONT_AC_STEPS + CONT_NEXT_STEPS),
                    "--learning-starts", "1024", "--steps-per-iteration", str(CONT_NEXT_STEPS)]


def to_device(state, device):
    """A (wrapped) env state, its tensors on ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    return type(state)(**{f.name: to_device(getattr(state, f.name), device)
                          for f in dataclasses.fields(state)})


def tensors_of(state, prefix=""):
    """{path: tensor} of a (wrapped) env state."""
    if isinstance(state, torch.Tensor):
        return {prefix: state}
    out = {}
    for f in dataclasses.fields(state):
        out.update(tensors_of(getattr(state, f.name), f"{prefix}.{f.name}" if prefix else f.name))
    return out


def tol_of_max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| at its largest over the largest |b| (at least 1)."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1.0)


def pendulum_pair(stack: bool):
    """(cpu env, card env, record): the card's resets take the CPU's draws,
    which ``record`` tapes; with ``stack`` both under the scripts' wrappers."""
    from mmtrl_tpu_torch.envs.classic import Pendulum
    from mmtrl_tpu_torch.envs.wrappers import ClipAction, NormalizeObservation, NormalizeReward

    tape = []
    cpu = Pendulum(device="cpu")

    def record(n, generator):
        out = cpu.draw_reset(n, generator)
        tape.append(out)
        return out

    cpu.sampler = record
    card_env = Pendulum(device="cuda", sampler=lambda n, generator: tape.pop(0))
    if stack:
        def wrap(e):
            return NormalizeReward(NormalizeObservation(ClipAction(e)))

        return wrap(cpu), wrap(card_env), tape
    return cpu, card_env, tape


def inner_max_steps(env) -> int:
    while hasattr(env, "env"):
        env = env.env
    return env.max_steps


def continuous_env_checks(smi: str):
    """(a) Pendulum card vs CPU: 64 envs for 40 steps under random torques
    in [-3, 3], each step from the CPU's state, the card's auto-resets fed
    the CPU's reset draws, 8 envs through the time limit; then the wrapper
    stack the same way, every env's statistics and return compared; then
    Pendulum, bare and wrapped, timed alone."""
    g = torch.Generator().manual_seed(SEED)
    for stack in (False, True):
        cpu, card_env, tape = pendulum_pair(stack)
        _, state = cpu.reset(CONT_ENV_BATCH, g)
        tape.clear()
        inner = state
        while hasattr(inner, "inner"):
            inner = inner.inner
        inner.t[:8] = inner_max_steps(cpu) - 4  # 8 envs reach the time limit
        worst, flags_equal, dones = {}, True, 0
        for _ in range(CONT_ENV_STEPS):
            action = torch.rand(CONT_ENV_BATCH, 1, generator=g) * 6 - 3
            obs, nxt, r, d, info = cpu.step(state, action, g)
            c_obs, c_nxt, c_r, c_d, c_info = card_env.step(to_device(state, "cuda"), action.cuda())
            flags_equal &= torch.equal(d, c_d.cpu()) and torch.equal(
                info["truncated"], c_info["truncated"].cpu()) and torch.equal(d, info["truncated"])
            pairs = {"obs": (c_obs, obs), "final_obs": (c_info["final_obs"], info["final_obs"]),
                     "reward": (c_r, r)}
            if stack:
                pairs["raw_reward"] = (c_info["raw_reward"], info["raw_reward"])
            ours = tensors_of(c_nxt)
            pairs.update({k: (ours[k], v) for k, v in tensors_of(nxt).items()})
            for k, (a, b) in pairs.items():
                if k == "t" or k.endswith(".t"):
                    flags_equal &= torch.equal(a.cpu(), b)
                    continue
                err = (tol_of_max_err(a, b) if stack
                       else (a.cpu().double() - b.double()).abs().max().item())
                worst[k] = max(worst.get(k, 0.0), err)
            dones += int(d.sum())
            state = nxt
        if stack:
            tol = {k: CONT_OBS_TOL_OF_MAX if k == "obs" else CONT_WRAPPER_TOL_OF_MAX
                   for k in worst}
        else:
            tol = {k: CONT_REWARD_ATOL if k == "reward" else CONT_STATE_ATOL for k in worst}
        ok = flags_equal and dones == 8 and all(worst[k] <= tol[k] for k in worst)
        emit("continuous_env", env="Pendulum-v1" + (" wrapped" if stack else ""),
             envs=CONT_ENV_BATCH, steps=CONT_ENV_STEPS, max_err=worst,
             tol=tol, err_is="of each tensor's largest (at least 1)" if stack else "absolute",
             done_truncated_equal=flags_equal, dones=dones, card=smi, ok=ok)
        check(ok, f"Pendulum card vs CPU (wrapped: {stack}): {worst}, flags {flags_equal}")

    # the card env alone: one step of 1 env (the off-policy loops') and of 4
    # (PPO's), timed; and the wrapped step of 4
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.envs.classic import Pendulum
    from mmtrl_tpu_torch.scripts import ppo_continuous_action

    for n, wrapped in ((1, False), (4, False), (4, True)):
        env = Pendulum(device="cuda")
        if wrapped:
            env = ppo_continuous_action.make_env(cli(ppo_continuous_action.Args, []),
                                                 torch.device("cuda"))
        ms, ops, busy = env_step_timing(env, n, torch.zeros(n, 1, device="cuda"))
        emit("continuous_env", env="Pendulum-v1" + (" wrapped" if wrapped else ""),
             timed_envs=n, ms_per_step=ms, env_steps_per_s=n * 1e3 / ms,
             device_ops_per_step=ops, device_busy_ms=busy, card=smi)


def continuous_update_checks(smi: str):
    """(b) One update of each algorithm on the card and on the CPU, in
    float64, from the same weights, data and draws: ``make_continuous_ppo``
    with RPO (alpha 0.5) at the defaults' shapes on a CPU rollout, and one
    DDPG, TD3 and SAC update at batch 256 on the step where the actor,
    alpha and Polyak passes run."""
    import copy

    from mmtrl_tpu_torch.algos.offpolicy.ddpg import ContinuousDraws
    from mmtrl_tpu_torch.algos.ppo.core import RunnerState, make_continuous_ppo
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.ops.fused_optim import init_adam_state
    from mmtrl_tpu_torch.scripts import (
        ddpg_continuous_action,
        ppo_continuous_action,
        sac_continuous_action,
        td3_continuous_action,
    )

    g = torch.Generator().manual_seed(SEED)
    args = cli(ppo_continuous_action.Args, ["--cuda", "False", "--rpo-alpha", "0.5"])
    algo, cfg, _ = ppo_continuous_action.build(args)
    rs = algo.init_runner(torch.Generator().manual_seed(SEED))
    rs, data = algo.rollout(rs)  # float32, on the CPU
    perms = [torch.randperm(cfg.batch_size, generator=g) for _ in range(cfg.update_epochs)]
    noise = [torch.rand(cfg.minibatch_size, 1, generator=g, dtype=torch.float64) - 0.5
             for _ in range(cfg.opt_steps_per_update)]
    out = {}
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(rs.model).to(device, torch.float64)
        run = RunnerState(model=model, opt_state=init_adam_state(list(model.parameters())),
                          env_state=None, obs=rs.obs.to(device, torch.float64),
                          done=rs.done.to(device), carry=(), stats=None, generator=None)
        rollout = tuple(x.to(device, torch.float64) if x.is_floating_point() else x.to(device)
                        for x in data)
        ppo = make_continuous_ppo(None, model, cfg)
        run, metrics = ppo.update_from_rollout(run, rollout, perms, rpo_noise=noise)
        out[device] = (run.model, {k: float(v) for k, v in metrics.items()})
    err, at = param_err([out["cuda"][0]], [out["cpu"][0]])
    moved = param_err([out["cpu"][0]], [rs.model])[0]
    ok = err <= PPO_PARAM_ATOL_FLOAT64 and moved > 0
    emit("continuous_update", algo="make_continuous_ppo rpo_alpha 0.5",
         opt_steps=cfg.opt_steps_per_update, minibatch=cfg.minibatch_size,
         worst_param_abs_err=err, worst_param=at, atol=PPO_PARAM_ATOL_FLOAT64,
         largest_param_move=moved, metrics_card_cpu={k: (out["cuda"][1][k], out["cpu"][1][k])
                                                     for k in out["cpu"][1]}, card=smi, ok=ok)
    check(ok, f"continuous PPO update card vs CPU in float64: {err} at {at}")

    theta = torch.rand(CONT_BATCH, generator=g, dtype=torch.float64) * 2 * math.pi - math.pi
    speed = torch.rand(CONT_BATCH, generator=g, dtype=torch.float64) * 16 - 8

    def pendulum_obs(th, w):
        return torch.stack([th.cos(), th.sin(), w], dim=-1)

    batch = dict(obs=pendulum_obs(theta, speed),
                 action=torch.rand(CONT_BATCH, 1, generator=g, dtype=torch.float64) * 4 - 2,
                 reward=-torch.rand(CONT_BATCH, generator=g, dtype=torch.float64) * 16,
                 next_obs=pendulum_obs(theta + 0.05 * speed, speed),
                 done=torch.zeros(CONT_BATCH, dtype=torch.float64))
    for name, module in (("ddpg", ddpg_continuous_action), ("td3", td3_continuous_action),
                         ("sac", sac_continuous_action)):
        built = {}
        for device in ("cpu", "cuda"):
            algo, cfg, _, _ = module.build(cli(module.Args, ["--cuda", str(device == "cuda")]))
            ts = algo.init_runner(torch.Generator(device=device).manual_seed(SEED)).train_state
            built[device] = (algo, cfg, ts, [ts.actor] + list(ts.critics))
        for device, (_, _, ts, nets) in built.items():
            for net, ref in zip(nets, built["cpu"][3]):  # the CPU's weights on both
                for part in ("model", "target"):
                    if getattr(net, part) is not None:
                        getattr(net, part).load_state_dict(getattr(ref, part).state_dict())
                        getattr(net, part).double()
                net.opt_state = init_adam_state(net.params)
            if ts.log_alpha is not None:
                ts.log_alpha = ts.log_alpha.double()
                ts.alpha_opt_state = init_adam_state([ts.log_alpha])
        actor_before = copy.deepcopy(built["cpu"][2].actor.model)
        target_noise = torch.randn(CONT_BATCH, 1, generator=g, dtype=torch.float64)
        actor_noise = [torch.randn(CONT_BATCH, 1, generator=g, dtype=torch.float64)
                       for _ in range(2)]
        results = {}
        for device, (algo, cfg, ts, nets) in built.items():
            draws = ContinuousDraws(None, None, None, target_noise.to(device),
                                    [x.to(device) for x in actor_noise])
            ts, metrics = algo.update(ts, {k: v.to(device) for k, v in batch.items()},
                                      cfg.policy_frequency, draws)
            modules = [m for net in nets for m in (net.model, net.target) if m is not None]
            results[device] = (modules, ts.log_alpha, {k: float(v) for k, v in metrics.items()})
        err, at = param_err(results["cuda"][0], results["cpu"][0])
        if results["cpu"][1] is not None:
            alpha_err = abs(results["cuda"][1].item() - results["cpu"][1].item())
            if alpha_err > err:
                err, at = alpha_err, "log_alpha"
        moved = param_err([built["cpu"][2].actor.model], [actor_before])[0]
        ok = err <= PER_TD_ATOL_FLOAT64 and moved > 0
        emit("continuous_update", algo=name, batch_size=CONT_BATCH, worst_abs_err=err,
             worst_param=at, atol=PER_TD_ATOL_FLOAT64, actor_largest_move=moved,
             metrics_card_cpu={k: (results["cuda"][2][k], results["cpu"][2][k])
                               for k in results["cpu"][2]}, card=smi, ok=ok)
        check(ok, f"{name} update card vs CPU in float64: {err} at {at} (moved {moved})")


def continuous_ppo_runs(smi: str, tmp: str):
    """(c) ``ppo_continuous_action`` and ``rpo_continuous_action`` through
    ``main`` at their defaults, two updates each with a save; one more PPO
    update in memory, profiled."""
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import ppo_continuous_action, rpo_continuous_action

    save_dir = os.path.join(tmp, "continuous_ck")
    for name, module in (("ppo", ppo_continuous_action), ("rpo", rpo_continuous_action)):
        torch.cuda.reset_peak_memory_stats()
        out = module.main(cli(module.Args, CONT_PPO_ARGS + ["--save-dir", save_dir]))
        for row in out["history"]:
            emit("continuous_ppo", run=f"scripts.{name}_continuous_action", **row, card=smi)
        emit("continuous_ppo", run=f"scripts.{name}_continuous_action", sps_of_run=out["sps"],
             updates=len(out["history"]), card=smi)
        check(len(out["history"]) == 2 and all(
            math.isfinite(v) for row in out["history"] for k, v in row.items()
            if k.startswith("losses/")), f"{name}: {out['history']}")
        check(os.path.exists(os.path.join(save_dir, out["run_name"])), f"{name}: no checkpoint")
        if name == "ppo":
            algo, cfg, _ = ppo_continuous_action.build(cli(ppo_continuous_action.Args, []))
            _, wall, ops, busy, top = device_profile(lambda: algo.train_iteration(out["runner"]))
            emit("continuous_ppo", run="ppo_continuous_action profiled update 3", wall_s=wall,
                 sps=cfg.batch_size / wall, device_ops=ops, device_busy_ms=busy,
                 idle_share=1 - busy / (1e3 * wall), top_kernels=top[:6], card=smi)


def continuous_ac_runs(smi: str, tmp: str):
    """(d) ``ddpg``, ``td3`` and ``sac_continuous_action`` through ``main``
    at full width, cut to 1,536 steps with updates past 1,024, each ending
    with the greedy evaluation and a save; the next 128 steps of each in
    memory, profiled; and SAC's next 128 from the checkpoint through
    ``--load-from``, equal bit for bit to those in memory."""
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import (
        ddpg_continuous_action,
        sac_continuous_action,
        td3_continuous_action,
    )

    save_dir = os.path.join(tmp, "continuous_ck")
    for name, module in (("ddpg", ddpg_continuous_action), ("td3", td3_continuous_action),
                         ("sac", sac_continuous_action)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = module.main(cli(module.Args, CONT_AC_ARGS + ["--save-dir", save_dir]))
        wall = time.perf_counter() - t0
        hist = out["history"]
        train_s = sum(r["wall_s"] for r in hist)
        loss_key = "losses/qf1_loss" if name == "ddpg" else "losses/qf_loss"
        warm = sum(r["wall_s"] for r in hist[:2])
        emit("continuous_ac", run=f"scripts.{name}_continuous_action", iterations=len(hist),
             global_step=out["global_step"], wall_s=wall, train_s=train_s, eval_s=out["eval_s"],
             env_steps_per_s=out["global_step"] / train_s,
             training_env_steps_per_s=(out["global_step"] - 1024) / (train_s - warm),
             wall_per_iteration_s=[r["wall_s"] for r in hist],
             last_step_losses=[r[loss_key] for r in hist],
             actor_losses=[r["losses/actor_loss"] for r in hist],
             q_values=[r["losses/qf1_values"] for r in hist],
             alpha=[r.get("losses/alpha") for r in hist] if name == "sac" else None,
             episodic_return=out["episodic_return"], eval_return=out["eval_episodic_return"],
             eval_episodes=out["eval_episodes"],
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
        ts = out["runner"].train_state
        actor_steps = CONT_AC_UPDATES if name == "sac" else CONT_AC_UPDATES // 2
        check(len(hist) == CONT_AC_ITERS and out["global_step"] == 512 * CONT_AC_ITERS,
              f"{name}: {len(hist)} iterations")
        check(all(int(c.step) == CONT_AC_UPDATES for c in ts.critics)
              and int(ts.actor.step) == actor_steps,
              f"{name}: critic steps {[int(c.step) for c in ts.critics]}, "
              f"actor {int(ts.actor.step)}")
        check(all(math.isfinite(r[loss_key]) and math.isfinite(r["losses/actor_loss"])
                  for r in hist) and hist[-1][loss_key] != 0.0
              and hist[-1]["losses/actor_loss"] != 0.0, f"{name}: losses {hist}")
        check(out["eval_episodes"] == 16 * 5, f"{name}: {out['eval_episodes']} episodes")

        # the next 128 steps in memory, profiled
        algo, _, _, _ = module.build(cli(module.Args, CONT_RESUME_ARGS))
        (runner, _), wall, ops, busy, top = device_profile(
            lambda: algo.train_iteration(out["runner"]))
        n = CONT_NEXT_STEPS
        emit("continuous_ac", run=f"{name} profiled, {n} training steps", env_steps=n,
             wall_s=wall, env_steps_per_s=n / wall, device_ops=ops,
             device_ops_per_env_step=ops / n, device_busy_ms=busy,
             idle_share=1 - busy / (1e3 * wall), top_kernels=top[:6], card=smi)
        if name == "sac":
            resumed = module.main(cli(module.Args, CONT_RESUME_ARGS + [
                "--save-dir", save_dir, "--load-from", os.path.join(save_dir, out["run_name"])]))
            mine, theirs = runner.payload(), resumed["runner"].payload()
            differing = [k for k in mine if not _same_payload(mine[k], theirs[k])]
            emit("continuous_ac", run="sac resume", initial_iteration=resumed[
                "initial_iteration"], differing_fields=differing, card=smi)
            check(resumed["history"][0]["global_step"] == CONT_AC_STEPS + CONT_NEXT_STEPS
                  and len(resumed["history"]) == 1 and not differing,
                  f"the resumed SAC run differs from its steps in memory in {differing}")


def continuous_checks(smi: str, tmp: str):
    import os

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    t0, seconds = time.perf_counter(), {}
    for step in (continuous_env_checks, continuous_update_checks):
        t = time.perf_counter()
        step(smi)
        seconds[step.__name__] = time.perf_counter() - t
    for step in (continuous_ppo_runs, continuous_ac_runs):
        t = time.perf_counter()
        step(smi, tmp)
        seconds[step.__name__] = time.perf_counter() - t
    emit("continuous", seconds=time.perf_counter() - t0, by_step=seconds, card=smi)


def phase_continuous(smi: str, tmp: str):
    """The continuous half of classic control: (a) Pendulum and the wrapper
    stack card vs CPU, Pendulum timed alone; (b) one continuous-PPO update
    with RPO and one DDPG, TD3 and SAC update card vs CPU in float64; (c)
    ppo and rpo_continuous_action through main, a profiled update; (d)
    ddpg, td3 and sac_continuous_action through main, the next 128 steps
    of each profiled, SAC's resumed bit for bit.  No kernel of the port lies on
    this path."""
    restoring_flags(continuous_checks, smi, tmp)


# Procmaze with PPG's train/held-out split and two-agent Minecraft2d (the
# device-resident envs of ROADMAP A.7), at the entry points' defaults.  No
# kernel of the port lies on these paths (no attention).
LEVELS_ENV_STEPS = 300  # steps of each card-vs-CPU env run
LEVELS_ENV_SLOTS = {"procmaze": 64, "minecraft_ma": 16}  # 64 envs; 8 joint envs
LEVELS_TIMED = {"procmaze": (8, 64), "minecraft_ma": (8, 16)}  # batches timed alone
# The two-agent frame: the render einsum in float32 on each device, within
# the CPU tests' OBS_ATOL of the JAX env (ProcMaze's planes are exact)
LEVELS_OBS_ATOL = 1e-5
# ppg --env-id procmaze --num-levels 200 at its defaults, one cycle (8 envs
# x 64 steps x 32 rollouts), then the held-out evaluation (64 x 512 a window)
LEVELS_PPG_ARGS = ["--env-id", "procmaze", "--num-levels", "200", "--total-timesteps", "16384"]
# ppo_ma_minecraft at its defaults (4 joint envs = 8 slots x 128 steps, 4 x 4
# minibatches), 3 updates with a save
LEVELS_MA_ARGS = ["--total-timesteps", "3072", "--save-interval", "3"]


def taped_pair(cls, hooks=(("sampler", "draw_reset"),)):
    """(cpu env, card env, tapes): each draw hook of the card env (``sampler``,
    or each ``(hook, draw method)`` of ``hooks``) takes the CPU's draws,
    which ``tapes[hook]`` records; the two share one host-built level bank."""
    tapes = {hook: [] for hook, _ in hooks}
    cpu = cls(device="cpu")

    def recorder(draw, tape):
        def record(n, generator):
            out = draw(n, generator)
            tape.append(out)
            return out
        return record

    for hook, draw in hooks:
        setattr(cpu, hook, recorder(getattr(cpu, draw), tapes[hook]))
    card_env = cls(device="cuda", **{hook: (lambda tape: lambda n, generator: tape.pop(0))(tape)
                                     for hook, tape in tapes.items()})
    return cpu, card_env, tapes


def step_card_vs_cpu(cpu, card_env, state, n: int, steps: int, g: torch.Generator):
    """``steps`` steps of ``cpu`` from ``state`` and of ``card_env`` from its
    copy on the card under the same random actions: (state, reward, done and
    info all equal, the largest observation difference, the pre-reset
    observation's included, done count, each boolean info summed)."""
    card_state = to_device(state, "cuda")
    equal, obs_err, dones, counts = True, 0.0, 0, {}
    for _ in range(steps):
        action = torch.randint(0, 4, (n,), generator=g)
        obs, state, r, d, info = cpu.step(state, action, g)
        c_obs, card_state, c_r, c_d, c_info = card_env.step(card_state, action.cuda())
        ours = tensors_of(card_state)
        equal &= all(torch.equal(ours[k].cpu(), v) for k, v in tensors_of(state).items())
        equal &= torch.equal(c_r.cpu(), r) and torch.equal(c_d.cpu(), d)
        equal &= set(c_info) == set(info) and all(
            torch.equal(c_info[k].cpu(), v) for k, v in info.items() if k != "final_obs")
        obs_err = max(obs_err, (c_obs.cpu() - obs).abs().max().item())
        if "final_obs" in info:
            obs_err = max(obs_err, (c_info["final_obs"].cpu() - info["final_obs"]).abs()
                          .max().item())
        dones += int(d.sum())
        for k, v in info.items():
            if v.dtype == torch.bool:
                counts[k] = counts.get(k, 0) + int(v.sum())
    return equal, obs_err, dones, counts


def levels_env_checks(smi: str):
    """(a) ProcMaze at 64 envs and the two-agent Minecraft2d at 8 joint envs
    (16 slots), card vs CPU for 300 steps under random actions, each side
    from its own state, the card's resets fed the CPU's draws: state,
    reward, done and info equal, obs equal (procmaze) or within
    ``LEVELS_OBS_ATOL``; then each env timed alone at two batches."""
    from mmtrl_tpu_torch.envs.minecraft2d_ma import MultiAgentMinecraft2d
    from mmtrl_tpu_torch.envs.procmaze import ProcMaze

    g = torch.Generator().manual_seed(SEED)
    classes = {"procmaze": ProcMaze, "minecraft_ma": MultiAgentMinecraft2d}
    for name, cls in classes.items():
        n = LEVELS_ENV_SLOTS[name]
        t0 = time.perf_counter()
        cpu, card_env, tapes = taped_pair(cls)
        _, state = cpu.reset(n, g)
        tapes["sampler"].clear()
        equal, obs_err, dones, counts = step_card_vs_cpu(cpu, card_env, state, n,
                                                         LEVELS_ENV_STEPS, g)
        solved = counts.get("solved", 0)
        atol = 0.0 if name == "procmaze" else LEVELS_OBS_ATOL
        ok = equal and obs_err <= atol and dones >= n and not tapes["sampler"]
        emit("levels_env", env=name, slots=n, steps=LEVELS_ENV_STEPS, state_reward_done_equal=equal,
             obs_max_abs_err=obs_err, obs_atol=atol, dones=dones, solved=solved,
             seconds=time.perf_counter() - t0, card=smi, ok=ok)
        check(ok, f"{name} card vs CPU: equal {equal}, obs {obs_err}, dones {dones}")
        for m in LEVELS_TIMED[name]:
            ms, ops, busy = env_step_timing(cls(device="cuda"), m)
            emit("levels_env", env=name, timed_slots=m, ms_per_step=ms,
                 slot_steps_per_s=m * 1e3 / ms, device_ops_per_step=ops, device_busy_ms=busy,
                 card=smi)


def levels_ppg_run(smi: str, tmp: str):
    """(b) ``ppg --env-id procmaze --num-levels 200`` through ``main`` at its
    defaults: one cycle with the int8 aux store, the train and held-out
    evaluation (timed apart) and its two scalars; then one policy rollout +
    update of the trained run, profiled."""
    import os

    from mmtrl_tpu_torch.algos.ppo.core import feedforward_update
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import ppg

    args = cli(ppg.Args, LEVELS_PPG_ARGS)
    cfg = ppg.ppg_config_from(args)
    check(cfg.aux_store_dtype == "int8", f"procmaze's aux store is {cfg.aux_store_dtype}")
    evaluation, plain = {}, ppg.generalization

    def timed_generalization(*a, **k):
        t0 = time.perf_counter()
        res = plain(*a, **k)
        torch.cuda.synchronize()
        evaluation["wall_s"] = time.perf_counter() - t0
        evaluation["metrics"] = res[1]
        return res

    torch.cuda.reset_peak_memory_stats()
    ppg.generalization = timed_generalization
    try:
        t0 = time.perf_counter()
        out = ppg.main(args)
        wall = time.perf_counter() - t0
    finally:
        ppg.generalization = plain
    hist, res = out["history"], out["generalization"]
    episodes = {tag: int(m["eval/episodes"]) for tag, m in evaluation["metrics"].items()}
    run_dir = os.path.join(os.environ["MMTRL_RUN_ROOT"], out["run_name"])
    emit("levels_ppg", run="scripts.ppg --env-id procmaze --num-levels 200", cycles=len(hist),
         global_step=out["global_step"], cycle_wall_s=hist[0]["wall_s"],
         eval_wall_s=evaluation["wall_s"], main_wall_s=wall, train_return=res["train"],
         heldout_return=res["test"], eval_episodes=episodes,
         episodic_return=out["episodic_return"], episode_count=out["episode_count"],
         losses={k: v for k, v in hist[0].items() if k.startswith("losses/")},
         aux_store=cfg.aux_store_dtype, aux_store_mb=cfg.batch_size * cfg.n_iteration
         * 3 * 84 * 84 / 2**20, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         card=smi)
    check(len(hist) == 1 and out["global_step"] == 16384, f"ppg procmaze: {len(hist)} cycles")
    check(all(math.isfinite(v) for k, v in hist[0].items() if k.startswith("losses/")),
          f"ppg procmaze: losses {hist[0]}")
    check(set(res) == {"train", "test"} and all(math.isfinite(v) for v in res.values())
          and min(episodes.values()) >= 2 * ppg.EVAL_ENVS,
          f"ppg procmaze evaluation: {res}, {episodes} episodes")
    check(len(os.listdir(run_dir)) == 2, f"ppg procmaze: event files {os.listdir(run_dir)}")

    algo, _, _ = ppg.build(args)
    policy_cfg = dataclasses.replace(cfg, update_epochs=cfg.e_policy, target_kl=None,
                                     clip_rewards=False)

    def policy_iteration():
        rs, data = algo.rollout(out["runner"])
        return feedforward_update(policy_cfg, rs, data, None, allow_unused=True)

    policy_iteration()  # warm
    _, wall, ops, busy, top = device_profile(policy_iteration)
    emit("levels_ppg", run="ppg procmaze profiled policy rollout + update",
         env_steps=cfg.batch_size, wall_s=wall, device_ops=ops, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:6], card=smi)


def levels_ma_checks(smi: str, tmp: str):
    """(c) ``ppo_ma_minecraft`` through ``main`` at its defaults, 3 updates
    with a save, and a fourth in memory, profiled; then its agent on
    two-agent observations and one
    ``make_ppo`` update from a CPU rollout (8 slots x 16 steps, 4 x 4
    minibatches) card vs CPU in float64."""
    import copy
    import os

    from mmtrl_tpu_torch.algos.ppo import PPOConfig, RunnerState, make_ppo
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.envs.minecraft2d_ma import MultiAgentMinecraft2d
    from mmtrl_tpu_torch.ops.fused_optim import init_adam_state
    from mmtrl_tpu_torch.scripts import ppo_ma_minecraft

    save_dir = os.path.join(tmp, "levels_ck")
    torch.cuda.reset_peak_memory_stats()
    out = ppo_ma_minecraft.main(cli(ppo_ma_minecraft.Args,
                                    LEVELS_MA_ARGS + ["--save-dir", save_dir]))
    for row in out["history"]:
        emit("levels_ma", run="scripts.ppo_ma_minecraft", **row, card=smi)
    emit("levels_ma", run="scripts.ppo_ma_minecraft", sps_of_run=out["sps"],
         updates=len(out["history"]), global_step=out["global_step"],
         episodes=out["episode_count"], max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         card=smi)
    check(len(out["history"]) == 3 and out["global_step"] == 3072 and all(
        math.isfinite(v) for row in out["history"] for k, v in row.items()
        if k.startswith("losses/")), f"ppo_ma_minecraft: {out['history']}")
    check(os.path.exists(os.path.join(save_dir, out["run_name"])), "ppo_ma_minecraft: no save")
    algo, cfg, _ = ppo_ma_minecraft.build(cli(ppo_ma_minecraft.Args, []))
    _, wall, ops, busy, top = device_profile(lambda: algo.train_iteration(out["runner"]))
    emit("levels_ma", run="ppo_ma_minecraft profiled update 4", slot_steps=cfg.batch_size,
         wall_s=wall, sps=cfg.batch_size / wall, device_ops=ops, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:6], card=smi)

    args = cli(ppo_ma_minecraft.Args, ["--cuda", "False"])
    cfg = PPOConfig(num_envs=8, num_steps=16, num_minibatches=4, update_epochs=4,
                    total_timesteps=3 * 128, clip_rewards=True)
    env = MultiAgentMinecraft2d(device="cpu")
    model = ppo_ma_minecraft.make_agent(args, env, torch.device("cpu"))
    g = torch.Generator().manual_seed(SEED)
    algo = make_ppo(env, model, cfg)
    rs, data = algo.rollout(algo.init_runner(g))
    perms = [torch.randperm(cfg.batch_size, generator=g) for _ in range(cfg.update_epochs)]
    obs = data[0].reshape(-1, 3, 84, 84).double()
    results = {}
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(device, torch.float64)
        with torch.no_grad():
            outputs = m(obs.to(device))
        run = RunnerState(model=m, opt_state=init_adam_state(list(m.parameters())),
                          env_state=None, obs=rs.obs.to(device, torch.float64),
                          done=rs.done.to(device), carry=(), stats=None, generator=None)
        rollout = tuple(x.to(device, torch.float64) if x.is_floating_point() else x.to(device)
                        for x in data)
        run, metrics = make_ppo(None, m, cfg).update_from_rollout(run, rollout, perms)
        results[device] = (outputs, run.model, {k: float(v) for k, v in metrics.items()})
    out_err = max((a.cpu() - b).abs().max().item()
                  for a, b in zip(results["cuda"][0], results["cpu"][0]))
    err, at = param_err([results["cuda"][1]], [results["cpu"][1]])
    moved = param_err([results["cpu"][1]], [model])[0]
    ok = out_err <= PPO_PARAM_ATOL_FLOAT64 and err <= PPO_PARAM_ATOL_FLOAT64 and moved > 0
    emit("levels_ma", check="CNNAgent (3 channels) and one make_ppo update card vs cpu in "
         "float64", frames=obs.shape[0], agent_max_abs_err=out_err,
         opt_steps=cfg.update_epochs * cfg.num_minibatches, worst_param_abs_err=err,
         worst_param=at, atol=PPO_PARAM_ATOL_FLOAT64, largest_param_move=moved,
         metrics_card_cpu={k: (results["cuda"][2][k], results["cpu"][2][k])
                           for k in results["cpu"][2]}, card=smi, ok=ok)
    check(ok, f"two-agent agent/update card vs CPU in float64: {out_err}, {err} at {at}")


def levels_checks(smi: str, tmp: str):
    import os

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    t0, seconds = time.perf_counter(), {}
    t = time.perf_counter()
    levels_env_checks(smi)
    seconds["levels_env_checks"] = time.perf_counter() - t
    for step in (levels_ppg_run, levels_ma_checks):
        t = time.perf_counter()
        step(smi, tmp)
        seconds[step.__name__] = time.perf_counter() - t
    emit("levels", seconds=time.perf_counter() - t0, by_step=seconds, card=smi)


def phase_levels(smi: str, tmp: str):
    """Procmaze and the two-agent Minecraft2d: (a) both envs card vs CPU
    under the same draws, each timed alone; (b) ppg --env-id procmaze through
    main (one cycle, the held-out evaluation) and a profiled policy
    iteration; (c) ppo_ma_minecraft through main and a profiled update,
    its agent and one update card vs CPU in float64.  No kernel of the port
    lies on these paths."""
    restoring_flags(levels_checks, smi, tmp)


# Doorpuzzle through the online PPO entry points, and the two-player Pong
# through ppo_ma_pong's slot-aware host loop (ROADMAP A.7), at the entry
# points' widths.  No kernel of the port lies on these paths (no attention).
DOOR_ENVS = 64
DOOR_ENV_STEPS = 300  # steps of the card-vs-CPU env run
DOOR_TIMED = (16, 64)  # batches timed alone
DOOR_HOOKS = (("sampler", "draw_reset"), ("slip_sampler", "draw_slip"))
# Doorpuzzle's frame: each pixel of the render einsum has one nonzero term
# (nearest resize), so both devices' sums are exact; held to 1e-6
DOOR_OBS_ATOL = 1e-6
# train --env-id doorpuzzle at the ppo phase's run (16 envs x 128 steps, 4 x
# 4 minibatches, big towers, casl, input scale 255), a save after each update
DOOR_UPDATE = 16 * 128
DOOR_TRAIN_ARGS = PPO_RUN + ["--env-id", "doorpuzzle", "--save-interval", "1"]
PONG_OBS_JOINT = 8  # joint envs (16 slots) of the card-vs-CPU observation check
PONG_OBS_STEPS = 100
PONG_TIMED_JOINT = 16  # ppo_ma_pong's default pool, timed alone
PONG_TIMED_STEPS = 100
# ppo_ma_pong at its defaults: 16 joint envs = 32 slots x 128 steps, 4 x 4
# minibatches, small towers, casl, input scale 1
PONG_UPDATE = 2 * 16 * 128  # slot-steps an update
PONG_EVAL_STEPS = 256


def door_env_checks(smi: str):
    """(a) Doorpuzzle at 64 envs, card vs CPU for 300 steps under random
    actions, the card's resets and slips fed the CPU's draws: state, reward,
    done and info equal, obs within ``DOOR_OBS_ATOL``; (b) a step timed alone
    at two batches."""
    from mmtrl_tpu_torch.envs.doorpuzzle import Doorpuzzle

    g = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    cpu, card_env, tapes = taped_pair(Doorpuzzle, DOOR_HOOKS)
    _, state = cpu.reset(DOOR_ENVS, g)
    tapes["sampler"].clear()
    equal, obs_err, dones, counts = step_card_vs_cpu(cpu, card_env, state, DOOR_ENVS,
                                                     DOOR_ENV_STEPS, g)
    ok = (equal and obs_err <= DOOR_OBS_ATOL and dones >= DOOR_ENVS
          and not any(tapes.values()))
    emit("door_env", envs=DOOR_ENVS, steps=DOOR_ENV_STEPS, state_reward_done_equal=equal,
         obs_max_abs_err=obs_err, obs_atol=DOOR_OBS_ATOL, dones=dones,
         successes=counts.get("success", 0), seconds=time.perf_counter() - t0, card=smi, ok=ok)
    check(ok, f"doorpuzzle card vs CPU: equal {equal}, obs {obs_err}, dones {dones}")
    for m in DOOR_TIMED:
        ms, ops, busy = env_step_timing(Doorpuzzle(device="cuda"), m)
        emit("door_env", timed_envs=m, ms_per_step=ms, env_steps_per_s=m * 1e3 / ms,
             device_ops_per_step=ops, device_busy_ms=busy, card=smi)


def door_ppo_run(smi: str, tmp: str):
    """(c) ``train --env-id doorpuzzle --attn-type casl`` at 16 x 128: one
    update and a save, then the second resumed from it under the profiler
    and saved; ``evaluate --env-id doorpuzzle`` (16 x 512, greedy) from that
    checkpoint."""
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.envs.doorpuzzle import DoorpuzzleState
    from mmtrl_tpu_torch.scripts import evaluate, train

    save_dir = os.path.join(tmp, "door_ck")

    def run(updates: int, *extra: str):
        return train.main(cli(train.Args, DOOR_TRAIN_ARGS + [
            "--total-timesteps", str(updates * DOOR_UPDATE), "--save-dir", save_dir, *extra]))

    torch.cuda.reset_peak_memory_stats()
    first = run(1)
    out, wall, ops, busy, top = device_profile(
        lambda: run(2, "--load-from", os.path.join(save_dir, first["run_name"])))
    hist = first["history"] + out["history"]
    for r in hist:
        emit("door_train", update=r["update"], profiled=r["update"] == 2, wall_s=r["wall_s"],
             sps=r["sps"], env_steps_per_s=DOOR_UPDATE / r["wall_s"],
             episodic_return=r["episodic_return"], value_loss=r["losses/value_loss"],
             max_memory_gb=r.get("max_memory_gb"), card=smi)
    check([r["update"] for r in hist] == [1, 2] and out["global_step"] == 2 * DOOR_UPDATE
          and all(math.isfinite(v) for r in hist for k, v in r.items()
                  if k.startswith("losses/")), f"train doorpuzzle: {hist}")
    check(isinstance(out["runner"].env_state, DoorpuzzleState)
          and tuple(out["runner"].obs.shape) == (16, 2, 84, 84), "train doorpuzzle: not the env")
    emit("door_train_profile", update=2, wall_s=wall, device_ops=ops, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:6], card=smi)

    ckpt = os.path.join(save_dir, out["run_name"])
    t0 = time.perf_counter()
    res = evaluate.main(cli(evaluate.Args, ["--load-from", ckpt, "--env-id", "doorpuzzle",
                                            "--script", "train", "--attn-type", "casl"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit("door_evaluate", wall_s=wall, env_steps_per_s=16 * 512 / wall, **res, card=smi)
    check(res["eval/episodes"] >= 16 and math.isfinite(res["eval/episodic_return"]),
          f"evaluate doorpuzzle: {res}")


def pong_obs_checks(smi: str):
    """(d) Two ``NativePong2P`` pools of 8 joint envs on one seed, stepped
    by the same random slot actions for 100 steps: every host array equal,
    the card's slot observations against the CPU's within ``ROM_OBS_ATOL``,
    player 1's video plane player 0's mirrored; then a pool step at
    ppo_ma_pong's 16 joint envs timed alone, emulator and observation
    apart."""
    import numpy as np

    from mmtrl_tpu_torch.data.quant import dequant_audio_u8, quant_audio_u8
    from mmtrl_tpu_torch.envs.pong_ma import NativePong2P

    n = PONG_OBS_JOINT
    env = NativePong2P(n, seed=SEED)
    cpu_env = NativePong2P(n, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    try:
        (f, a), (cf, ca) = env._host_reset(), cpu_env._host_reset()
        equal = np.array_equal(f, cf) and np.array_equal(a, ca)
        worst, mirrored, points, dones = 0.0, True, 0, 0
        for _ in range(PONG_OBS_STEPS):
            code = quant_audio_u8(a)
            obs = env._obs(f, dequant_audio_u8(torch.from_numpy(code).cuda()))
            ref = cpu_env._obs(cf, dequant_audio_u8(torch.from_numpy(quant_audio_u8(ca))))
            worst = max(worst, (obs.cpu() - ref).abs().max().item())
            mirrored &= torch.equal(obs[1::2, 0], obs[0::2, 0].flip(-1)) and torch.equal(
                obs[1::2, 1:], obs[0::2, 1:])
            actions = rng.integers(0, env.num_actions, 2 * n).astype(np.int32)
            out, cout = env._host_step(actions), cpu_env._host_step(actions)
            equal &= all(np.array_equal(x, y) for x, y in zip(out, cout))
            (f, a), (cf, ca) = out[:2], cout[:2]
            points += int(np.maximum(out[2], 0).sum())
            dones += int(out[4].sum())
    finally:
        env.close()
        cpu_env.close()
    ok = equal and worst <= ROM_OBS_ATOL and mirrored
    emit("pong_obs", joint_envs=n, slots=2 * n, steps=PONG_OBS_STEPS, host_arrays_equal=equal,
         obs_max_abs_err=worst, obs_atol=ROM_OBS_ATOL, player1_mirrored=mirrored,
         points=points, slot_dones=dones, card=smi, ok=ok)
    check(ok, f"pong card vs CPU: host arrays {equal}, obs {worst}, mirrored {mirrored}")

    env = NativePong2P(PONG_TIMED_JOINT, seed=SEED)
    try:
        f, a = env._host_reset()
        host_s = obs_s = 0.0
        for _ in range(PONG_TIMED_STEPS):
            code = quant_audio_u8(a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obs = env._obs(f, dequant_audio_u8(torch.from_numpy(code).cuda()))
            torch.cuda.synchronize()
            obs_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            f, a = env._host_step(rng.integers(0, env.num_actions, env.num_slots)
                                  .astype(np.int32))[:2]
            host_s += time.perf_counter() - t0
        check(tuple(obs.shape) == (env.num_slots, 3, 84, 84), f"pong obs {tuple(obs.shape)}")
    finally:
        env.close()
    step_ms = 1e3 * (host_s + obs_s) / PONG_TIMED_STEPS
    emit("pong_pool", joint_envs=PONG_TIMED_JOINT, slots=2 * PONG_TIMED_JOINT,
         emulator_ms_per_pool_step=1e3 * host_s / PONG_TIMED_STEPS,
         obs_ms_per_pool_step=1e3 * obs_s / PONG_TIMED_STEPS,
         slot_steps_per_s=2 * PONG_TIMED_JOINT * 1e3 / step_ms, card=smi)


def pong_ppo_run(smi: str, tmp: str):
    """(e) ``ppo_ma_pong`` at its defaults: one update and a save, the
    second resumed from it under the profiler and saved; a third resumed
    from that save with a greedy evaluation of 256 pool steps, and the same
    third resumed from the second's runner in memory (the host loop's
    ``load_run`` handed its payload): bit for bit the same."""
    import os

    from mmtrl_tpu_torch.algos.ppo import hostloop
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import ppo_ma_pong

    save_dir = os.path.join(tmp, "pong_ck")
    evaluation = {}
    plain_load, plain_eval = hostloop.load_run, hostloop.greedy_evaluation

    def run(updates: int, *extra: str):
        return ppo_ma_pong.main(cli(ppo_ma_pong.Args, [
            "--total-timesteps", str(updates * PONG_UPDATE), "--save-dir", save_dir, *extra]))

    def timed_evaluation(*a, **k):
        t0 = time.perf_counter()
        res = plain_eval(*a, **k)
        torch.cuda.synchronize()
        evaluation.update(wall_s=time.perf_counter() - t0, **res)
        return res

    torch.cuda.reset_peak_memory_stats()
    first = run(1, "--save-interval", "1")
    second, wall, ops, busy, top = device_profile(lambda: run(
        2, "--save-interval", "1", "--load-from", os.path.join(save_dir, first["run_name"])))
    hostloop.greedy_evaluation = timed_evaluation
    try:
        resumed = run(3, "--load-from", os.path.join(save_dir, second["run_name"]),
                      "--eval-steps", str(PONG_EVAL_STEPS))
    finally:
        hostloop.greedy_evaluation = plain_eval
    hostloop.load_run = lambda path, map_location: second["runner"].payload()
    try:
        in_memory = run(3, "--load-from", "memory")
    finally:
        hostloop.load_run = plain_load

    hist = first["history"] + second["history"] + resumed["history"]
    for r in hist:
        emit("pong_ppo", update=r["update"], profiled=r["update"] == 2, wall_s=r["wall_s"],
             rollout_s=r["rollout_s"], update_s=r["update_s"], emulator_s=r["emulator_s"],
             sps=r["sps"], slot_steps_per_s=PONG_UPDATE / r["wall_s"],
             episodic_return=r["episodic_return"], value_loss=r["losses/value_loss"],
             max_memory_gb=r.get("max_memory_gb"), card=smi)
    check([r["update"] for r in hist] == [1, 2, 3] and resumed["global_step"] == 3 * PONG_UPDATE
          and second["global_step"] == 2 * PONG_UPDATE
          and all(math.isfinite(v) for r in hist for k, v in r.items()
                  if k.startswith("losses/")), f"ppo_ma_pong: {hist}")
    check(tuple(first["runner"].obs.shape) == (32, 3, 84, 84)
          and first["runner"].model.audio_net.Conv_0.weight.shape[1] == 2,
          "ppo_ma_pong: the runner is not the 32-slot, two-audio-channel one")
    emit("pong_ppo_profile", update=2, wall_s=wall, device_ops=ops, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:6], card=smi)

    a, b = resumed["runner"], in_memory["runner"]
    same = (all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
            and all(torch.equal(x, y) for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                                                      b.opt_state.mu + b.opt_state.nu))
            and torch.equal(a.generator.get_state(), b.generator.get_state())
            and resumed["history"][0]["losses/value_loss"]
            == in_memory["history"][0]["losses/value_loss"])
    emit("pong_resume", update=3, resumed_equals_in_memory=same,
         eval_steps=PONG_EVAL_STEPS, eval_slot_steps_per_s=2 * 16 * PONG_EVAL_STEPS
         / evaluation.get("wall_s", math.inf), evaluation=evaluation, card=smi, ok=same)
    check(same, "ppo_ma_pong: the resume from the save differs from the one from memory")
    check("wall_s" in evaluation, "ppo_ma_pong: no greedy evaluation ran")


def pong_door_checks(smi: str, tmp: str):
    import os

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    t0, seconds = time.perf_counter(), {}
    for step, args in ((door_env_checks, (smi,)), (door_ppo_run, (smi, tmp)),
                       (pong_obs_checks, (smi,)), (pong_ppo_run, (smi, tmp))):
        t = time.perf_counter()
        step(*args)
        seconds[step.__name__] = time.perf_counter() - t
    emit("pong_door", seconds=time.perf_counter() - t0, by_step=seconds, card=smi)


def phase_pong_door(smi: str, tmp: str):
    """Doorpuzzle and the two-player Pong: (a) Doorpuzzle card vs CPU under
    the same draws, (b) timed alone; (c) ``train --env-id doorpuzzle`` at the
    ppo phase's run (16 x 128) for two updates, the second resumed from a
    save and profiled, and ``evaluate`` on its checkpoint; (d) the Pong slot
    observation card vs CPU and a pool step timed; (e) ``ppo_ma_pong`` at
    its defaults, two updates (the second resumed and profiled), a resumed
    third equal to the same resume from memory, a greedy evaluation of 256
    pool steps.  Cut: (c) runs at
    the ppo phase's 16 envs and 4 x 4 minibatches, not train's reference
    defaults (1 env, 1 x 1); (e)'s evaluation is 256 pool steps.  No kernel
    of the port lies on these paths."""
    restoring_flags(pong_door_checks, smi, tmp)


# The native cartridge pools inside the fused PPO loop and the evaluation,
# and the two raw bridges (ROADMAP A.7): at the entry points' widths.  No
# kernel of the port lies on these paths (no attention).
POOL_ENVS = 8  # skeleton_plus_ppo's default pool
POOL_RUNS = {"rally_native": (200, 0.0), "brick_native": (100, 0.25)}  # steps, sticky
# The observation, card against CPU: tests/test_torch_native.py's OBS_ATOL
# (the MFCC planes' float32 FFT, log and projections in other orders, each
# plane divided by its own range; the rom phase read 1.67e-6)
POOL_OBS_ATOL = 2e-5
POOL_OBS_EVERY = 10  # steps between two observations made on the CPU as well
# skeleton_plus_ppo --backend native --env-id rally_native at its defaults:
# 8 envs x 128 steps, 4 x 4 minibatches, big towers, casl, input scale 1
POOL_NUM_STEPS = 128
POOL_UPDATE = POOL_ENVS * POOL_NUM_STEPS
POOL_PPO_ARGS = ["--backend", "native", "--env-id", "rally_native"]
POOL_EVAL_STEPS = 512
POOL_ACTIONS_STEPS = 64  # evaluate_actions, asked for 2 x the pool's envs
GRID_ENVS, GRID_STEPS = 16, 300
GRID_TIMED = (16, 64)
# The gridworld's render, card against CPU: one float32 einsum of a one-hot
# against the bank, summed in other orders (tests/test_native_bridge.py's
# 1e-5); against the device env's render on the same card: equal
GRID_OBS_ATOL = 1e-5
ATARI_MACHINES, ATARI_STEPS = 4, 60
# One stereo window's MFCC, card against CPU: cuFFT and pocketfft in other
# orders, the float32 cepstra up to about 40 (tests/test_torch_native.py's
# MFCC tolerance)
ATARI_MFCC_ATOL = 1e-4


def pool_surface_checks(smi: str):
    """(a) ``rally_native`` at 8 envs for 200 steps and ``brick_native``
    with sticky actions 0.25 for 100, each a pool on the card stepped
    through ``reset``/``step`` and one on the CPU from one seed stepped by
    its host arrays under the same random actions: the card's counter,
    reward, done, kills and life equal to the CPU pool's, and its
    observation within ``POOL_OBS_ATOL`` of the CPU's ``_obs`` at the reset
    and every ``POOL_OBS_EVERY``-th step; the card's step timed."""
    import numpy as np

    from mmtrl_tpu_torch.envs.homebrew_native import make_native_env

    rng = np.random.default_rng(SEED)
    for env_id, (steps, sticky) in POOL_RUNS.items():
        kw = dict(num_envs=POOL_ENVS, seed=SEED, repeat_action_probability=sticky)
        card_env, cpu_env = make_native_env(env_id, **kw), make_native_env(env_id, device="cpu",
                                                                           **kw)
        try:
            o, s = card_env.reset(POOL_ENVS)
            frames, audio = cpu_env._host_reset()
            on_card = o.is_cuda and s.is_cuda
            equal = torch.equal(s.cpu(), torch.zeros(POOL_ENVS, dtype=torch.int32))
            worst, checked = (o.cpu() - cpu_env._obs(frames, audio)).abs().max().item(), 1
            step_s, dones, reward = 0.0, 0, 0.0
            for t in range(1, steps + 1):
                a = rng.integers(0, card_env.num_actions, POOL_ENVS)
                a_card = torch.from_numpy(a).cuda()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o, s, r, d, info = card_env.step(s, a_card)
                torch.cuda.synchronize()
                step_s += time.perf_counter() - t0
                frames, audio, kd, ld, done, win, kills, life = cpu_env._host_step(a)
                cr = torch.from_numpy(cpu_env._reward(kd, ld, win))
                on_card &= all(x.is_cuda for x in (o, s, r, d, *info.values()))
                equal &= (torch.equal(s.cpu(), torch.full((POOL_ENVS,), t, dtype=torch.int32))
                          and r.dtype == torch.float32 and torch.equal(r.cpu(), cr)
                          and torch.equal(d.cpu(), torch.from_numpy(done.astype(bool)))
                          and set(info) == {"kills", "life"}
                          and torch.equal(info["kills"].cpu(), torch.from_numpy(kills))
                          and torch.equal(info["life"].cpu(), torch.from_numpy(life)))
                if t % POOL_OBS_EVERY == 0:
                    worst = max(worst, (o.cpu() - cpu_env._obs(frames, audio)).abs().max().item())
                    checked += 1
                dones, reward = dones + int(done.sum()), reward + float(cr.sum())
        finally:
            card_env.close()
            cpu_env.close()
        ok = on_card and equal and worst <= POOL_OBS_ATOL
        emit("pool_surface", env=env_id, envs=POOL_ENVS, steps=steps, sticky=sticky,
             state_reward_done_info_equal=equal, obs_max_abs_err=worst, obs_atol=POOL_OBS_ATOL,
             obs_checked_steps=checked, on_card=on_card, ms_per_pool_step=1e3 * step_s / steps,
             env_steps_per_s=POOL_ENVS * steps / step_s, dones=dones, reward_sum=reward,
             card=smi, ok=ok)
        check(ok, f"{env_id} pool card vs CPU: on card {on_card}, equal {equal}, obs {worst}")


def pool_ppo_run(smi: str, tmp: str) -> str:
    """(b) ``skeleton_plus_ppo --backend native --env-id rally_native`` at
    its defaults through ``main``: two updates and a save, each
    ``train_iteration``'s rollout and update timed apart, and the pool's
    emulator inside the rollout; then the third resumed from the save
    through the plain ``main`` under the profiler.  The resumed run
    continues the saved counter, and ``load_payload`` puts the saved
    observation over the freshly reset pool (ROADMAP C.21).  Returns the
    checkpoint."""
    import dataclasses as dc
    import os

    from mmtrl_tpu_torch.core.checkpoint import load_run
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import skeleton_plus_ppo

    save_dir = os.path.join(tmp, "pool_ck")
    plain = skeleton_plus_ppo.make_recurrent_ppo
    splits = []

    def timed_ppo(env, model, cfg):
        algo = plain(env, model, cfg)
        host_step, emulator = env._host_step, []

        def timed_host_step(actions):
            t0 = time.perf_counter()
            out = host_step(actions)
            emulator.append(time.perf_counter() - t0)
            return out

        env._host_step = timed_host_step

        def train_iteration(rs):
            emulator.clear()
            t0 = time.perf_counter()
            initial_carry = rs.carry
            rs, data = algo.rollout(rs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = algo.update_from_rollout(rs, initial_carry, data)
            torch.cuda.synchronize()
            splits.append(dict(rollout_s=t1 - t0, update_s=time.perf_counter() - t1,
                               emulator_s=sum(emulator), pool_steps=len(emulator)))
            return out

        return dc.replace(algo, train_iteration=train_iteration)

    def run(updates: int, *extra: str):
        return skeleton_plus_ppo.main(cli(skeleton_plus_ppo.Args, POOL_PPO_ARGS + [
            "--total-timesteps", str(updates * POOL_UPDATE), "--save-dir", save_dir, *extra]))

    torch.cuda.reset_peak_memory_stats()
    skeleton_plus_ppo.make_recurrent_ppo = timed_ppo
    try:
        t0 = time.perf_counter()
        first = run(2, "--save-interval", "2")
        first_s = time.perf_counter() - t0
    finally:
        skeleton_plus_ppo.make_recurrent_ppo = plain
    ckpt = os.path.join(save_dir, first["run_name"])
    t0 = time.perf_counter()
    resumed, wall, ops, busy, top = device_profile(lambda: run(3, "--load-from", ckpt))
    profiled_s = time.perf_counter() - t0
    for r, split in zip(first["history"], splits):
        emit("pool_ppo", update=r["update"], profiled=False, wall_s=r["wall_s"],
             **split, emulator_share_of_rollout=split["emulator_s"] / split["rollout_s"],
             action_syncs=split["pool_steps"], sps=r["sps"],
             env_steps_per_s=POOL_UPDATE / r["wall_s"], episodic_return=r["episodic_return"],
             value_loss=r["losses/value_loss"], max_memory_gb=r.get("max_memory_gb"), card=smi)
    hist = first["history"] + resumed["history"]
    r = resumed["history"][-1]
    emit("pool_ppo", update=r["update"], profiled=True, wall_s=r["wall_s"], sps=r["sps"],
         env_steps_per_s=POOL_UPDATE / r["wall_s"], episodic_return=r["episodic_return"],
         value_loss=r["losses/value_loss"], max_memory_gb=r.get("max_memory_gb"), card=smi)
    runner, saved = resumed["runner"], load_run(ckpt, map_location="cuda")
    check([r["update"] for r in hist] == [1, 2, 3] and resumed["initial_update"] == 3
          and len(splits) == 2 and all(sp["pool_steps"] == POOL_NUM_STEPS for sp in splits)
          and all(math.isfinite(v) for r in hist for k, v in r.items() if k.startswith("losses/")),
          f"skeleton_plus_ppo --backend native: {hist} {splits}")
    check(runner.obs.is_cuda and tuple(runner.obs.shape) == (POOL_ENVS, 3, 84, 84)
          and runner.env_state.is_cuda and runner.env_state.dtype == torch.int32
          and all(p.is_cuda for p in runner.model.parameters()),
          "skeleton_plus_ppo --backend native: the runner is not the card's pool runner")
    # C.21: the counter goes on from the save's 256 (a fresh pool's would
    # read 128 after the update), and the restored observation is the saved one
    restored = runner.load_payload(saved)
    c21 = (int(runner.env_state[0]) == 3 * POOL_NUM_STEPS
           and torch.equal(restored.obs, saved["obs"])
           and torch.equal(restored.env_state, saved["env_state"]))
    emit("pool_ppo_profile", update=3, wall_s=wall, device_ops=ops, device_busy_ms=busy,
         idle_share=1 - busy / (1e3 * wall), top_kernels=top[:6],
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         resumed_from_the_saved_state=c21, first_main_s=first_s, profiled_call_s=profiled_s,
         card=smi)
    check(c21, "the resumed run did not go on from the saved observation and counter")
    return ckpt


def pool_evaluation(smi: str, ckpt: str):
    """(c) ``evaluate_policy`` greedy on a ``rally_native`` pool of 8 envs x
    512 steps with the checkpoint's agent; ``evaluate_actions`` asked for
    16 envs on that pool takes its 8.  (``evaluate --env-id
    skeleton_plus_native`` needs SkelPlus.bin, not in the repository: not
    run.)"""
    from mmtrl_tpu_torch.core.checkpoint import load_run
    from mmtrl_tpu_torch.envs.homebrew_native import make_native_env
    from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
    from mmtrl_tpu_torch.utils.evaluate import evaluate_actions, evaluate_policy

    env = make_native_env("rally_native", num_envs=POOL_ENVS, seed=SEED + 1)
    try:
        model = MultimodalRecurrentAgent(num_actions=6, conv_type="big", attn_type="casl",
                                         fusion_type="sum", input_scale=1.0, audio_channels=2,
                                         device="cuda")
        model.load_state_dict(load_run(ckpt, map_location="cuda")["model"])
        g = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_policy(env, model, g, num_envs=POOL_ENVS, num_steps=POOL_EVAL_STEPS,
                              recurrent=True, initial_carry=model.initial_carry(POOL_ENVS, "cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = {k: float(v) for k, v in res.items()}
        emit("pool_evaluate", envs=POOL_ENVS, steps=POOL_EVAL_STEPS, wall_s=wall,
             env_steps_per_s=POOL_ENVS * POOL_EVAL_STEPS / wall, **res, card=smi)
        check(res["eval/episodes"] >= 1 and math.isfinite(res["eval/episodic_return"]),
              f"evaluate_policy on the pool: {res}")

        resets, plain_reset = [], env.reset

        def recording_reset(num_envs, generator=None):
            resets.append(num_envs)
            return plain_reset(num_envs, generator)

        env.reset = recording_reset
        w = torch.randn(6, 84 * 84, generator=g, device="cuda")
        out = evaluate_actions(env, lambda obs: (obs[:, 0].reshape(-1, 84 * 84) @ w.T).argmax(-1),
                               g, num_envs=2 * POOL_ENVS, num_steps=POOL_ACTIONS_STEPS)
        out = {k: float(v) for k, v in out.items()}
        emit("pool_evaluate_actions", asked_envs=2 * POOL_ENVS, reset_envs=resets,
             steps=POOL_ACTIONS_STEPS, **out, card=smi, ok=resets == [POOL_ENVS])
        check(resets == [POOL_ENVS] and math.isfinite(out["eval/episodic_length"]),
              f"evaluate_actions on a pool of {POOL_ENVS}: reset {resets}, {out}")
    finally:
        env.close()


def gridworld_checks(smi: str):
    """(d) ``NativeMinecraft2d`` at 16 envs for 300 steps, a pool on the card
    and one on the CPU from one seed under the same random actions (every
    other step through the public ``step``): tiles, audio index, reward and
    done equal, the observation within ``GRID_OBS_ATOL``, and each card frame
    and audio plane equal to the device ``Minecraft2d``'s render of the same
    tiles on the card; then a step timed alone at 16 and 64 envs."""
    import numpy as np

    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d, render_frame
    from mmtrl_tpu_torch.envs.native_bridge import NativeMinecraft2d

    card_env = NativeMinecraft2d(GRID_ENVS, seed=SEED)
    cpu_env = NativeMinecraft2d(GRID_ENVS, seed=SEED, device="cpu")
    device_env = Minecraft2d(device="cuda")
    rng = np.random.default_rng(SEED)
    try:
        (t, a), (ct, ca) = card_env._host_reset(), cpu_env._host_reset()
        equal = np.array_equal(t, ct) and np.array_equal(a, ca)
        obs = card_env._render(t, a)
        worst, render_equal, dones = 0.0, True, 0
        for step in range(GRID_STEPS):
            ref = cpu_env._render(ct, ca)
            worst = max(worst, (obs.cpu() - ref).abs().max().item())
            tiles = torch.from_numpy(ct).cuda().long()
            render_equal &= (obs.is_cuda and torch.equal(obs[:, 0], render_frame(device_env._bank, tiles))
                             and torch.equal(obs[:, 1], device_env._audio[torch.from_numpy(ca).cuda().long()]))
            actions = rng.integers(0, 4, GRID_ENVS).astype(np.int32)
            cout = cpu_env._host_step(actions)
            if step % 2:
                obs, r, d = card_env.step(torch.from_numpy(actions).cuda())
                equal &= (r.is_cuda and torch.equal(r.cpu(), torch.from_numpy(cout[2]))
                          and torch.equal(d.cpu(), torch.from_numpy(cout[3].astype(bool))))
            else:
                out = card_env._host_step(actions)
                equal &= all(np.array_equal(x, y) for x, y in zip(out, cout))
                obs = card_env._render(*out[:2])
            ct, ca = cout[:2]
            dones += int(cout[3].sum())
    finally:
        card_env.close()
        cpu_env.close()
    ok = equal and render_equal and worst <= GRID_OBS_ATOL and dones >= GRID_ENVS
    emit("gridworld", envs=GRID_ENVS, steps=GRID_STEPS, host_arrays_equal=equal,
         obs_max_abs_err=worst, obs_atol=GRID_OBS_ATOL, equal_to_device_render=render_equal,
         dones=dones, card=smi, ok=ok)
    check(ok, f"NativeMinecraft2d card vs CPU: equal {equal}, render {render_equal}, "
              f"obs {worst}, dones {dones}")
    for m in GRID_TIMED:
        env = NativeMinecraft2d(m, seed=SEED)
        try:
            env.reset()
            act = torch.randint(0, 4, (m,), device="cuda")
            for _ in range(20):
                env.step(act)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                env.step(act)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 200
        finally:
            env.close()
        emit("gridworld", timed_envs=m, ms_per_step=ms, env_steps_per_s=m * 1e3 / ms, card=smi)


def atari_checks(smi: str):
    """(e) Two ``AtariPool``s of 4 machines on ``native/homebrew/rally.bin``
    from one seed, 60 steps of joystick play with the console's reset
    pressed: frames, audio and RAM equal; then one stereo window through
    ``mfcc_tensor`` on the card and on the CPU."""
    import numpy as np

    from mmtrl_tpu_torch.envs.atari_bridge import RESET_SWITCH, RIGHT, UP, AtariPool
    from mmtrl_tpu_torch.envs.homebrew_native import RALLY_ROM
    from mmtrl_tpu_torch.ops.mfcc import SKELETON_PLUS_PARAMS, mfcc_tensor

    pools = [AtariPool(RALLY_ROM, ATARI_MACHINES, seed=SEED) for _ in range(2)]
    plan = [RESET_SWITCH if 20 <= i < 23 else UP if (i // 5) % 2 else RIGHT
            for i in range(ATARI_STEPS)]
    try:
        equal, heard, step_s = True, 0.0, 0.0
        for act in plan:
            actions = np.full(ATARI_MACHINES, act, np.uint8)
            t0 = time.perf_counter()
            frames, audio = pools[0].step(actions)
            step_s += time.perf_counter() - t0
            frames2, audio2 = pools[1].step(actions)
            equal &= (np.array_equal(frames, frames2) and np.array_equal(audio, audio2)
                      and np.array_equal(pools[0].ram(), pools[1].ram()))
            heard += float(audio.sum())
    finally:
        for p in pools:
            p.close()
    window = torch.from_numpy(audio[0] * 32000.0)  # (2, 524): the stereo window
    card_feats = mfcc_tensor(window.cuda(), SKELETON_PLUS_PARAMS)
    feats = mfcc_tensor(window, SKELETON_PLUS_PARAMS)
    err = (card_feats.cpu() - feats).abs().max().item()
    ok = (equal and heard > 0 and card_feats.is_cuda and feats.shape[-1] == 13
          and bool(torch.isfinite(card_feats).all()) and err <= ATARI_MFCC_ATOL)
    emit("atari_pool", rom="rally.bin", machines=ATARI_MACHINES, steps=ATARI_STEPS,
         frames_audio_ram_equal=equal, audio_sum=heard, ms_per_step=1e3 * step_s / ATARI_STEPS,
         mfcc_shape=list(card_feats.shape), mfcc_max_abs_err=err, mfcc_atol=ATARI_MFCC_ATOL,
         card=smi, ok=ok)
    check(ok, f"AtariPool: equal {equal}, heard {heard}, MFCC card vs CPU {err}")


def native_pools_checks(smi: str, tmp: str):
    import os

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    t0, seconds = time.perf_counter(), {}

    def timed(step, *args):
        t = time.perf_counter()
        out = step(*args)
        seconds[step.__name__] = time.perf_counter() - t
        return out

    timed(pool_surface_checks, smi)
    ckpt = timed(pool_ppo_run, smi, tmp)
    timed(pool_evaluation, smi, ckpt)
    timed(gridworld_checks, smi)
    timed(atari_checks, smi)
    emit("native_pools", seconds=time.perf_counter() - t0, by_step=seconds, card=smi)


def phase_native_pools(smi: str, tmp: str):
    """The native cartridge pools inside the fused loops, and the two raw
    bridges: (a) the pool's ``reset``/``step`` card vs CPU on RALLY (8 envs,
    200 steps) and BRICK with sticky actions (100 steps); (b)
    ``skeleton_plus_ppo --backend native --env-id rally_native`` through
    ``main`` at its defaults (8 envs x 128 steps, 4 x 4 minibatches, big
    towers, casl), two updates and a save with rollout, update and
    emulator timed apart, the third resumed from it (from the saved
    observation, ROADMAP C.21) and profiled; (c) ``evaluate_policy`` greedy on a
    RALLY pool of 8 envs x 512 steps from that checkpoint, and
    ``evaluate_actions`` asked for 16 envs on the pool of 8; (d)
    ``NativeMinecraft2d`` card vs CPU at 16 envs for 300 steps and against
    the device env's render, timed at 16 and 64 envs; (e) ``AtariPool`` on
    RALLY's ROM, two pools of one seed equal, one window's MFCC card vs
    CPU.  Not run: ``evaluate --env-id skeleton_plus_native``, which needs
    SkelPlus.bin (not in the repository).  Nothing is cut: the issue's
    sizes as they are.  No kernel of the port lies on these paths."""
    restoring_flags(native_pools_checks, smi, tmp)


# The gymnasium host bridge, the off-policy host loop and the two
# evaluation tools.  The card's machine has no gymnasium (nor mujoco), so
# the phase hands ``GymPool`` a stand-in sub-env: gymnasium's Pendulum-v1
# in numpy under its 200-step time limit, defined here and nowhere in the
# package.  Everything but gymnasium itself runs as a user's run does.
HOST_ENVS = 2
HOST_POOL_STEPS = 450  # (a): through two time limits
HOST_TIME_LIMIT = 200
# (b) one chunk of 64 steps of 2 envs, updates once more than 64
# transitions are stored (steps 33-64: 32 updates at batch 256)
HOST_CHUNK = 64
HOST_CHUNK_STARTS = 64
# (c) SAC through run_offpolicy_hostloop: 2 envs, chunks of 64 steps,
# learning_starts 512, a save at 2,048 steps, 256 more from it
HOST_LOOP_STEPS, HOST_LOOP_MORE, HOST_LOOP_STARTS = 2048, 256, 512
HOST_EVAL_EPISODES = 2
# (e) eval_rom_policy on rally_native; (f) eval_pong, from the phase's own
# checkpoint of a random small-tower casl agent (6 actions, input scale 1)
TOOL_ROM_ARGS = ["--env-id", "rally_native", "--num-envs", "8", "--num-steps", "256"]
TOOL_PONG_ARGS = ["--num-envs", "4", "--num-steps", "300", "--episode-steps", "150"]
# The taped policy's logits, card against CPU: the agents' checks'
# tolerance (tests of the port read 1.2e-6 for the casl agent)
TOOL_LOGIT_ATOL = 1e-5


class StandInBox:
    """The fields of ``gymnasium.spaces.Box`` that ``GymPool`` reads."""

    def __init__(self, low, high):
        import numpy as np

        self.low, self.high = np.asarray(low, np.float32), np.asarray(high, np.float32)
        self.shape = self.low.shape


class StandInPendulum:
    """gymnasium's Pendulum-v1 (``classic_control/pendulum.py``) in numpy
    under a ``HOST_TIME_LIMIT``-step time limit: ``reset(seed=)`` restarts
    its generator, ``step(a)`` gives ``(obs, reward, terminated,
    truncated, info)``; the spaces are Boxes."""

    def __init__(self):
        import numpy as np

        self.np = np
        self.observation_space = StandInBox([-1.0, -1.0, -8.0], [1.0, 1.0, 8.0])
        self.action_space = StandInBox([-2.0], [2.0])
        self._rng, self._t, self._state = np.random.default_rng(), 0, None

    def reset(self, seed=None, options=None):
        np = self.np
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state, self._t = self._rng.uniform([-np.pi, -1.0], [np.pi, 1.0]), 0
        return self._obs(), {}

    def step(self, action):
        np = self.np
        th, thdot = self._state
        u = float(np.clip(action, -2.0, 2.0)[0])
        cost = ((th + np.pi) % (2 * np.pi) - np.pi) ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = float(np.clip(thdot + (3 * 10.0 / 2 * np.sin(th) + 3.0 * u) * 0.05, -8.0, 8.0))
        self._state, self._t = np.array([th + thdot * 0.05, thdot]), self._t + 1
        return self._obs(), -cost, False, self._t >= HOST_TIME_LIMIT, {}

    def _obs(self):
        th, thdot = self._state
        return self.np.array([self.np.cos(th), self.np.sin(th), thdot], self.np.float32)

    def close(self):
        pass


def stand_in_pool_cls():
    """``GymPool`` building a ``StandInPendulum`` in place of each
    ``gymnasium.make``."""
    from mmtrl_tpu_torch.envs.gym_bridge import GymPool

    class StandInPool(GymPool):
        def _make_sub_env(self, index: int):
            return StandInPendulum()

    return StandInPool


def host_pool_checks(smi: str):
    """(a) The pool's ``reset``/``step`` on the card against a CPU pool of
    the same seed, 2 envs x 450 steps of uniform torques: obs, final_obs,
    reward, raw reward, done and truncated equal, every tensor on the card;
    both envs truncated at steps 200 and 400 with ``final_obs`` apart from
    the fresh observation; the card's step (the action to the host, the
    six arrays back in one copy) timed."""
    import numpy as np

    Pool = stand_in_pool_cls()
    card_pool, cpu_pool = Pool("Pendulum-v1", HOST_ENVS, seed=SEED), Pool(
        "Pendulum-v1", HOST_ENVS, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    (o, s), (co, cs) = card_pool.reset(HOST_ENVS), cpu_pool.reset(HOST_ENVS)
    equal, on_card = torch.equal(o.cpu(), co) and torch.equal(s.cpu(), cs), o.is_cuda and s.is_cuda
    truncated_at, apart, step_s = [], True, 0.0
    for t in range(1, HOST_POOL_STEPS + 1):
        a = torch.from_numpy(rng.uniform(-2, 2, (HOST_ENVS, 1)).astype(np.float32))
        a_card = a.cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = card_pool.step(s, a_card)
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t0
        ref = cpu_pool.step(cs, a)
        (o, s, r, d, info), (co, cs, cr, cd, cinfo) = out, ref
        pairs = [(o, co), (s, cs), (r, cr), (d, cd)] + [(info[k], cinfo[k]) for k in cinfo]
        equal &= all(torch.equal(x.cpu(), y) for x, y in pairs) and set(info) == {
            "final_obs", "raw_reward", "truncated"}
        on_card &= all(x.is_cuda for x, _ in pairs)
        if d.any():
            truncated_at.append(t)
            apart &= bool(info["truncated"].all() and (info["final_obs"] != o).any(-1).all())
    card_pool.close()
    cpu_pool.close()
    ok = equal and on_card and apart and truncated_at == [200, 400]
    emit("host_pool", envs=HOST_ENVS, steps=HOST_POOL_STEPS, all_equal=equal, on_card=on_card,
         truncated_at=truncated_at, final_obs_apart=apart,
         ms_per_step_round_trip=1e3 * step_s / HOST_POOL_STEPS, card=smi, ok=ok)
    check(ok, f"GymPool card vs CPU: equal {equal}, on card {on_card}, truncated at "
              f"{truncated_at}, final_obs apart {apart}")


def recorded_host_chunk(steps: int, seed: int):
    """(steps, 2, ...) transitions of the stand-in pool under uniform
    torques, stored as the host loop stores them."""
    import numpy as np

    pool = stand_in_pool_cls()("Pendulum-v1", HOST_ENVS, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    obs, out = pool._host_reset(), {k: [] for k in ("obs", "action", "reward", "next_obs", "done")}
    for _ in range(steps):
        a = rng.uniform(-2, 2, (HOST_ENVS, 1)).astype(np.float32)
        nobs, final_obs, r, _, d, trunc = pool._host_step(a)
        for k, v in zip(out, (obs, a, r, np.where(d[:, None], final_obs, nobs),
                              (d.astype(bool) & ~trunc.astype(bool)).astype(np.float32))):
            out[k].append(v)
        obs = nobs
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def host_chunk_checks(smi: str):
    """(b) ``chunk_fn`` of SAC, TD3 and DDPG on one recorded chunk (64
    steps of 2 envs, 32 updates at batch 256), on the card and on the CPU
    in float64 from the same weights and draws: every parameter, target
    and SAC's temperature within ``PER_TD_ATOL_FLOAT64``.  Then on the
    card in float32 the fused ``train_iteration`` on the stand-in pool and
    ``chunk_fn`` on the transitions it stored, from copies of one state
    under the same draws: every buffer entry, parameter, Adam moment and
    metric equal bit for bit."""
    import copy
    import importlib

    from mmtrl_tpu_torch.algos.offpolicy.ddpg import ContinuousDraws
    from mmtrl_tpu_torch.algos.offpolicy.hostloop import SpecEnv
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.ops.fused_optim import init_adam_state
    from mmtrl_tpu_torch.scripts._common import config_of
    from mmtrl_tpu_torch.scripts import (
        ddpg_continuous_action,
        sac_continuous_action,
        td3_continuous_action,
    )

    Pool = stand_in_pool_cls()
    chunk = recorded_host_chunk(HOST_CHUNK, SEED + 1)
    g = torch.Generator().manual_seed(SEED)
    n, B = HOST_ENVS, CONT_BATCH
    algos = (("sac", sac_continuous_action, "make_sac", "SACConfig"),
             ("td3", td3_continuous_action, "make_td3", "TD3Config"),
             ("ddpg", ddpg_continuous_action, "make_ddpg", "DDPGConfig"))
    for name, module, factory_name, cfg_name in algos:
        algo_module = importlib.import_module(f"mmtrl_tpu_torch.algos.offpolicy.{name}")
        factory, cfg_cls = getattr(algo_module, factory_name), getattr(algo_module, cfg_name)
        args = cli(module.Args, [])
        cfg = dataclasses.replace(config_of(cfg_cls, args), num_envs=n,
                                  learning_starts=HOST_CHUNK_STARTS, steps_per_iteration=HOST_CHUNK)
        draws = []
        for t in range(HOST_CHUNK):
            train = (t + 1) * n > HOST_CHUNK_STARTS
            draws.append(ContinuousDraws(
                torch.randn(n, 1, generator=g), torch.rand(n, 1, generator=g) * 4 - 2,
                torch.randint(0, (t + 1) * n, (B,), generator=g) if train else None,
                torch.randn(B, 1, generator=g, dtype=torch.float64) if train else None,
                [torch.randn(B, 1, generator=g, dtype=torch.float64) for _ in range(2)]
                if train else None))
        pool_cpu = Pool("Pendulum-v1", n, device="cpu")  # its shapes and spaces
        actor, critics = module.networks(args, SpecEnv(pool_cpu, n, torch.device("cpu")),
                                         torch.device("cpu"))

        # float64, card against CPU
        results, t_card = {}, 0.0
        for device in ("cpu", "cuda"):
            dev = torch.device(device)
            a = copy.deepcopy(actor).to(dev)
            cs = [copy.deepcopy(c).to(dev) for c in critics]
            algo = factory(SpecEnv(pool_cpu, n, dev), a, *cs, cfg)
            runner = algo.init_runner(torch.Generator(device=dev).manual_seed(SEED))
            ts = runner.train_state
            for net in [ts.actor] + list(ts.critics):
                for part in ("model", "target"):
                    if getattr(net, part) is not None:
                        getattr(net, part).double()
                net.opt_state = init_adam_state(net.params)
            if ts.log_alpha is not None:
                ts.log_alpha = ts.log_alpha.double()
                ts.alpha_opt_state = init_adam_state([ts.log_alpha])
            runner.buffer.data = {k: v.double() for k, v in runner.buffer.data.items()}
            moved = [dr._replace(**{k: (v.to(dev) if isinstance(v, torch.Tensor) else
                                        [x.to(dev) for x in v] if v is not None else None)
                                    for k, v in dr._asdict().items()}) for dr in draws]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner, metrics = algo.chunk_fn(
                runner, {k: v.to(dev, torch.float64) for k, v in chunk.items()}, moved)
            torch.cuda.synchronize()
            if device == "cuda":
                t_card = time.perf_counter() - t0
            ts = runner.train_state
            modules = [m for net in [ts.actor] + list(ts.critics)
                       for m in (net.model, net.target) if m is not None]
            results[device] = (modules, ts, {k: float(v) for k, v in metrics.items()})
        err, at = param_err(results["cuda"][0], results["cpu"][0])
        if results["cpu"][1].log_alpha is not None:
            alpha_err = abs(results["cuda"][1].log_alpha.item()
                            - results["cpu"][1].log_alpha.item())
            if alpha_err > err:
                err, at = alpha_err, "log_alpha"
        steps = [int(c.step) for c in results["cuda"][1].critics]
        ok64 = err <= PER_TD_ATOL_FLOAT64 and steps == [HOST_CHUNK - HOST_CHUNK_STARTS // n] * len(
            steps)

        # float32 on the card: the fused loop on the stand-in pool against
        # the chunk path on what it stored
        runs = []
        for env in (Pool("Pendulum-v1", n, seed=SEED + 2), None):
            a = copy.deepcopy(actor).cuda()
            cs = [copy.deepcopy(c).cuda() for c in critics]
            algo = factory(env if env is not None else SpecEnv(pool_cpu, n, torch.device("cuda")),
                           a, *cs, cfg)
            runs.append((algo, algo.init_runner(torch.Generator(device="cuda").manual_seed(SEED))))
        def on_card(x):
            return x.cuda().float() if x.is_floating_point() else x.cuda()

        card_draws = [dr._replace(**{k: (on_card(v) if isinstance(v, torch.Tensor) else
                                         [on_card(x) for x in v] if v is not None else None)
                                     for k, v in dr._asdict().items()}) for dr in draws]
        (fused_algo, fused), (chunk_algo, chunked) = runs
        fused, fm = fused_algo.train_iteration(fused, card_draws)
        stored = {k: v[:HOST_CHUNK * n].reshape((HOST_CHUNK, n) + v.shape[1:]).clone()
                  for k, v in fused.buffer.data.items()}
        chunked, cm = chunk_algo.chunk_fn(chunked, stored, card_draws)
        mine, theirs = chunked.payload(), fused.payload()
        differing = [k for k in ("train_state", "buffer", "global_step")
                     if not _same_payload(mine[k], theirs[k])]
        same_metrics = {k: float(v) for k, v in fm.items()} == {k: float(v) for k, v in cm.items()}
        ok = ok64 and not differing and same_metrics
        emit("host_chunk", algo=name, envs=n, steps=HOST_CHUNK, updates=steps,
             batch_size=B, float64_worst_abs_err=err, worst_param=at, atol=PER_TD_ATOL_FLOAT64,
             float64_card_chunk_s=t_card, fused_equals_chunk_fields_differing=differing,
             fused_equals_chunk_metrics=same_metrics,
             metrics_card_cpu={k: (results["cuda"][2][k], results["cpu"][2][k])
                               for k in results["cpu"][2]}, card=smi, ok=ok)
        check(ok, f"{name} chunk path: float64 {err} at {at} (updates {steps}); fused vs chunk "
                  f"differ in {differing}, metrics equal {same_metrics}")


def host_loop_run(smi: str, tmp: str):
    """(c) SAC through ``run_offpolicy_hostloop`` on a stand-in pool of 2
    envs (chunks of 64 steps, learning_starts 512, batch 256): an unbroken
    run of 2,304 steps saving at 2,048; a second run resumed from that save
    through ``--load-from`` for the last 256, held against the unbroken
    one (the state it loads equal to the unbroken run's at 2,048 bit for
    bit; its global step and update counts equal at the end, and the
    stored rows before 2,048; the rows after differ, as the host envs
    restart from their seeds as in JAX); a chunk's host and card seconds;
    the greedy evaluation of 2 episodes; one more training chunk (the
    unbroken run's last 64 stored steps) through ``chunk_fn`` under the
    profiler, for the card's busy and idle share of a chunk."""
    import copy
    import os
    import types

    from mmtrl_tpu_torch.algos.offpolicy import hostloop
    from mmtrl_tpu_torch.algos.offpolicy.hostloop import SpecEnv, run_offpolicy_hostloop
    from mmtrl_tpu_torch.algos.offpolicy.sac import SACConfig, make_sac
    from mmtrl_tpu_torch.core.checkpoint import load_run
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import sac_continuous_action

    Pool = stand_in_pool_cls()
    save_dir = os.path.join(tmp, "host_loop_ck")
    saves, plain_save = {}, hostloop.save_run

    def recording_save(payload, run_name, save_dir):
        if payload["global_step"] == HOST_LOOP_STEPS and run_name == "unbroken":
            saves["at_save"] = copy.deepcopy(payload)
            plain_save(payload, "at_2048", save_dir)
        return plain_save(payload, run_name, save_dir)

    total = HOST_LOOP_STEPS + HOST_LOOP_MORE
    cfg = SACConfig(total_timesteps=total, num_envs=HOST_ENVS,
                    learning_starts=HOST_LOOP_STARTS, steps_per_iteration=512)

    def run(run_name, load_from=""):
        args = types.SimpleNamespace(**dict(
            vars(cli(sac_continuous_action.Args, [])), env_id="Pendulum-v1",
            exp_name="host_loops", seed=SEED, chunk_size=HOST_CHUNK,
            save_interval=HOST_LOOP_STEPS // (HOST_CHUNK * HOST_ENVS), save_dir=save_dir,
            load_from=load_from))
        pool = Pool("Pendulum-v1", HOST_ENVS, seed=SEED)
        actor, critics = sac_continuous_action.networks(
            args, SpecEnv(pool, HOST_ENVS, torch.device("cuda")), torch.device("cuda"))
        t0 = time.perf_counter()
        out = run_offpolicy_hostloop(make_sac, pool, actor, critics, cfg, args,
                                     torch.device("cuda"), run_name=run_name,
                                     eval_episodes=HOST_EVAL_EPISODES)
        out["wall_s"] = time.perf_counter() - t0
        return out

    hostloop.save_run = recording_save
    try:
        torch.cuda.reset_peak_memory_stats()
        unbroken = run("unbroken")
        resumed = run("resumed", os.path.join(save_dir, "at_2048"))
    finally:
        hostloop.save_run = plain_save
    # the checkpoint the resumed run loaded: the unbroken run's state at 2,048
    restored = _same_payload(load_run(os.path.join(save_dir, "at_2048"), map_location="cpu"),
                             saves["at_save"])
    rts, uts = resumed["runner"].train_state, unbroken["runner"].train_state
    rb, ub = resumed["runner"].buffer, unbroken["runner"].buffer
    rows_equal = all(torch.equal(rb.data[k][:HOST_LOOP_STEPS], ub.data[k][:HOST_LOOP_STEPS])
                     for k in rb.data)
    counts = ([int(c.step) for c in rts.critics] + [int(rts.actor.step)],
              [int(c.step) for c in uts.critics] + [int(uts.actor.step)])
    updates = (HOST_LOOP_STEPS + HOST_LOOP_MORE - HOST_LOOP_STARTS) // HOST_ENVS
    walls = unbroken["chunk_walls"]
    warm = [w for i, w in enumerate(walls) if (i + 1) * HOST_CHUNK * HOST_ENVS <= HOST_LOOP_STARTS]
    training = walls[len(warm) + 1:]  # past the first training chunk (first launches)
    train_host = sum(w[0] for w in training)
    train_card = sum(w[1] for w in training)
    ok = (restored and rows_equal and counts[0] == counts[1] == [updates] * 3
          and unbroken["global_step"] == resumed["global_step"] == HOST_LOOP_STEPS + HOST_LOOP_MORE
          and resumed["chunks"] == HOST_LOOP_MORE // (HOST_CHUNK * HOST_ENVS)
          and all(math.isfinite(x) for x in (unbroken["eval_episodic_return"],
                                             resumed["eval_episodic_return"]))
          and unbroken["episodes"] >= HOST_ENVS * 5)
    # one more training chunk, profiled: the unbroken run's last 64 steps
    spec = SpecEnv(Pool("Pendulum-v1", HOST_ENVS, seed=SEED), HOST_ENVS, torch.device("cuda"))
    actor, critics = sac_continuous_action.networks(
        cli(sac_continuous_action.Args, []), spec, torch.device("cuda"))
    algo = make_sac(spec, actor, *critics, cfg)
    rows = slice(total - HOST_CHUNK * HOST_ENVS, total)
    transitions = {k: v[rows].clone().reshape((HOST_CHUNK, HOST_ENVS) + tuple(v.shape[1:]))
                   for k, v in ub.data.items()}
    _, prof_wall, prof_ops, prof_busy, prof_top = device_profile(
        lambda: algo.chunk_fn(unbroken["runner"], transitions))
    emit("host_loop", algo="sac", envs=HOST_ENVS, chunk=HOST_CHUNK, steps=unbroken["global_step"],
         chunks=unbroken["chunks"], updates=counts[1], wall_s=unbroken["wall_s"],
         train_env_steps_per_s=len(training) * HOST_CHUNK * HOST_ENVS / (train_host + train_card),
         warmup_chunk_card_ms=1e3 * sum(w[1] for w in warm) / len(warm),
         training_chunk_card_ms=1e3 * train_card / len(training),
         training_chunk_host_ms=1e3 * train_host / len(training),
         host_share_of_training_chunk=train_host / (train_host + train_card),
         profiled_chunk_ms=1e3 * prof_wall, profiled_chunk_device_ops=prof_ops,
         profiled_chunk_busy_ms=prof_busy, profiled_chunk_idle=1 - prof_busy / (1e3 * prof_wall),
         profiled_chunk_top=prof_top[:4],
         episodes=unbroken["episodes"], episodic_return=unbroken["episodic_return"],
         eval_return=unbroken["eval_episodic_return"], eval_episodes=HOST_EVAL_EPISODES,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
    emit("host_loop_resume", resumed_from=HOST_LOOP_STEPS, more_steps=HOST_LOOP_MORE,
         loaded_state_equals_unbroken_at_save=restored, rows_before_save_equal=rows_equal,
         update_counts_resumed_unbroken=counts, wall_s=resumed["wall_s"], card=smi, ok=ok)
    check(ok, f"host loop resume: restored {restored}, rows {rows_equal}, counts {counts}, "
              f"steps {unbroken['global_step']} / {resumed['global_step']}")


def host_ppo_run(smi: str, tmp: str):
    """(d) One ``ppo_continuous_action`` update through ``main`` on a
    stand-in pool (``make_any``'s bridge branch; ``--norm-obs False
    --norm-reward False``: wrap ``"none"``) at the defaults' 4 envs x 2,048
    steps, 32 x 10 minibatches; each pool step timed (the action to the
    host and the results back)."""
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import ppo_continuous_action

    Pool = stand_in_pool_cls()
    pools, step_s = [], []

    def stand_in_make_any(env_id, num_envs=None, seed=0, wrap="none", gamma=0.99, device=None):
        pool = Pool(env_id, num_envs, seed=seed, wrap=wrap, gamma=gamma, device=device)
        plain_step = pool.step

        def timed_step(state, action, generator=None):
            t0 = time.perf_counter()
            out = plain_step(state, action, generator)
            step_s.append(time.perf_counter() - t0)  # the copy back is synchronous
            return out

        pool.step = timed_step
        pools.append(pool)
        return pool, True

    plain = ppo_continuous_action.make_any
    ppo_continuous_action.make_any = stand_in_make_any
    try:
        out = ppo_continuous_action.main(cli(ppo_continuous_action.Args, [
            "--env-id", "Pendulum-v1", "--norm-obs", "False", "--norm-reward", "False",
            "--total-timesteps", "8192", "--save-dir", os.path.join(tmp, "host_ppo_ck")]))
    finally:
        ppo_continuous_action.make_any = plain
    row = out["history"][0]
    rollout_steps = 2048
    ok = (len(pools) == 1 and type(pools[0]).__name__ == "StandInPool"
          and len(out["history"]) == 1 and len(step_s) == rollout_steps
          and out["runner"].obs.is_cuda
          and all(math.isfinite(v) for k, v in row.items() if k.startswith("losses/")))
    emit("host_ppo", envs=4, steps=rollout_steps, wall_s=row["wall_s"], sps=row["sps"],
         ms_per_step_round_trip=1e3 * sum(step_s) / len(step_s),
         round_trip_share_of_update=sum(step_s) / row["wall_s"],
         value_loss=row["losses/value_loss"], card=smi, ok=ok)
    check(ok, f"ppo_continuous_action on the stand-in pool: {row}, {len(step_s)} steps")


def host_tools(smi: str, tmp: str):
    """(e) ``eval_rom_policy`` on ``rally_native``, 8 envs x 256 steps,
    greedy and sampled, and (f) ``eval_pong`` against ``tracker`` and
    ``noop``, 4 joint envs x 300 steps with 150-step episodes, each from
    the phase's own checkpoint of a random small-tower casl agent; over the
    greedy tracker run's taped observations the CPU's logits (the
    checkpoint loaded there, one call over the whole tape) within
    ``TOOL_LOGIT_ATOL`` of the card's and the greedy actions equal."""
    import os

    from mmtrl_tpu_torch.core.checkpoint import load_run, save_run
    from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
    from mmtrl_tpu_torch.tools import eval_pong, eval_rom_policy

    torch.manual_seed(SEED)
    agent = dict(num_actions=6, conv_type="small", attn_type="casl", fusion_type="sum",
                 input_scale=1.0, audio_channels=2)
    ckpt = save_run({"model": MultimodalRecurrentAgent(**agent, device="cuda").state_dict()},
                    "tool_agent", os.path.join(tmp, "tools_ck"))
    t0 = time.perf_counter()
    rom = eval_rom_policy.main(["--load-from", ckpt] + TOOL_ROM_ARGS)
    rom_s = time.perf_counter() - t0
    emit("host_tools", tool="eval_rom_policy", args=TOOL_ROM_ARGS, wall_s=rom_s,
         env_steps_per_s=2 * 8 * 256 / rom_s, **{f"{rule} {k}": v for rule, res in rom.items()
                                                  for k, v in res.items()}, card=smi)
    check(set(rom) == {"greedy", "sampled"} and all(
        math.isfinite(v) for res in rom.values() for v in res.values()), f"eval_rom_policy: {rom}")

    tape = []
    plain_agent = eval_pong.MultimodalRecurrentAgent

    class TapedAgent(plain_agent):
        def forward(self, obs, done, carry):
            out = super().forward(obs, done, carry)
            if len(tape) < 300:
                tape.append((obs.cpu(), done.cpu(), out[0].cpu()))
            return out

    for opponent in ("tracker", "noop"):
        eval_pong.MultimodalRecurrentAgent = TapedAgent if opponent == "tracker" else plain_agent
        try:
            t0 = time.perf_counter()
            res = eval_pong.main(["--load-from", ckpt, "--opponent", opponent] + TOOL_PONG_ARGS)
            wall = time.perf_counter() - t0
        finally:
            eval_pong.MultimodalRecurrentAgent = plain_agent
        emit("host_tools", tool="eval_pong", opponent=opponent, args=TOOL_PONG_ARGS, wall_s=wall,
             slot_steps_per_s=2 * 2 * 4 * 300 / wall,
             **{f"{rule} {k}": v for rule, r in res.items() for k, v in r.items()}, card=smi)
        check(all(r.get("episodes", 0) >= 4 for r in res.values()), f"eval_pong {opponent}: {res}")

    cpu_model = MultimodalRecurrentAgent(**agent, device="cpu")
    cpu_model.load_state_dict(load_run(ckpt, map_location="cpu")["model"])
    obs = torch.cat([o for o, _, _ in tape])  # (T, 8, 3, 84, 84)
    done = torch.cat([d for _, d, _ in tape])
    card_logits = torch.cat([lg for _, _, lg in tape])
    with torch.no_grad():
        cpu_logits = cpu_model(obs, done, cpu_model.initial_carry(obs.shape[1], "cpu"))[0]
    err = (card_logits - cpu_logits).abs().max().item()
    same_greedy = torch.equal(card_logits.argmax(-1), cpu_logits.argmax(-1))
    ok = len(tape) == 300 and err <= TOOL_LOGIT_ATOL and same_greedy
    emit("host_tools", tool="eval_pong", taped_steps=len(tape), slots=obs.shape[1],
         logits_max_abs_err=err, atol=TOOL_LOGIT_ATOL, greedy_actions_equal=same_greedy,
         card=smi, ok=ok)
    check(ok, f"eval_pong's taped logits card vs CPU: {err}, greedy equal {same_greedy}")


def host_loops_checks(smi: str, tmp: str):
    import importlib.util
    import os

    os.environ["MMTRL_RUN_ROOT"] = os.path.join(tmp, "runs")
    installed = {m: importlib.util.find_spec(m) is not None for m in ("gymnasium", "mujoco")}
    emit("host_loops", installed=installed,
         sub_env="the GymPool's gymnasium envs" if installed["gymnasium"] else
         "gymnasium is absent: a stand-in sub-env (Pendulum-v1 in numpy, 200-step time limit) "
         "behind GymPool", card=smi)
    t0, seconds = time.perf_counter(), {}

    def timed(step, *args):
        t = time.perf_counter()
        out = step(*args)
        seconds[step.__name__] = time.perf_counter() - t
        return out

    timed(host_pool_checks, smi)
    timed(host_chunk_checks, smi)
    timed(host_loop_run, smi, tmp)
    timed(host_ppo_run, smi, tmp)
    timed(host_tools, smi, tmp)
    emit("host_loops", seconds=time.perf_counter() - t0, by_step=seconds, card=smi)


def phase_host_loops(smi: str, tmp: str):
    """The gymnasium host bridge, the off-policy host loop and the two
    evaluation tools, with a stand-in sub-env behind ``GymPool`` (the card's
    machine has no gymnasium): (a) the pool's ``reset``/``step`` card vs CPU,
    2 envs x 450 steps, truncations at 200 and 400; (b) ``chunk_fn`` of
    SAC, TD3 and DDPG on one 64-step chunk card vs CPU in float64, and
    equal bit for bit to the fused loop on the card; (c) SAC through
    ``run_offpolicy_hostloop``, 2 envs, learning_starts 512, 2,304 steps
    with a save at 2,048, and a resume from it for the last 256 held
    against the unbroken run, the chunks timed, a 2-episode greedy
    evaluation; (d) one ``ppo_continuous_action`` update on the stand-in
    pool, its host round trip timed; (e) ``eval_rom_policy`` on RALLY, 8 x
    256; (f) ``eval_pong`` against the tracker and noop, 4 x 300, the taped
    logits card vs CPU.  Cuts: the tools run from a random agent the phase
    saves (no training run of their own), 256 and 300 steps; the host
    loop's 2,304 of SAC's 1,000,000 steps.  No kernel of the port lies on
    these paths."""
    restoring_flags(host_loops_checks, smi, tmp)


# The run tooling (ROADMAP A.9): the --track journal, --capture-video GIFs,
# the run journal, the tuner and the phase timer, on the card.  No kernel of
# the port lies on these paths.  The phase works in a directory of its own:
# the runners write runs_manifest.jsonl, wandb_local/ and videos/ where they
# run.
TOOLS_TRAIN_ARGS = ["--attn-type", "casl", "--total-timesteps", "256", "--track",
                    "--capture-video", "--save-interval", "1"]  # 2 updates of 1 env x 128
TOOLS_GIFS = ("update_1.gif", "update_2.gif", "final.gif")
TOOLS_VIDEO_STEPS = 256  # capture_video's episode
TOOLS_GIF_SIZE = (168, 168)
TOOLS_DQN_ARGS = ["--env-id", "CartPole-v1", "--total-timesteps", "1024",
                  "--learning-starts", "512", "--track"]
TOOLS_TRIALS = 2  # tuner trials of one seed of ppo on CartPole-v1, 2 updates each
TOOLS_TUNER_STEPS = 1024
TOOLS_TIMED_ITERS = 2  # rollout + update pairs under the phase timer


def journal_checks(smi: str, run_name: str, track: bool, gifs=()) -> dict:
    """The run's two manifest records ("running", "finished"); with
    ``track`` its ``wandb_local`` run finished, one history row per scalar
    of its event file (read by ``read_scalars``, no TensorBoard), each row's
    value the event's (float32) at its step, and the summary of the rows'
    keys; each GIF of ``gifs`` walked by ``read_gif_header`` (no PIL)."""
    import glob
    import os

    import numpy as np

    from mmtrl_tpu_torch.core.metrics import read_scalars
    from mmtrl_tpu_torch.utils.video import read_gif_header

    with open("runs_manifest.jsonl") as f:
        statuses = [json.loads(line)["status"] for line in f
                    if json.loads(line)["run_name"] == run_name]
    scalars = read_scalars(os.path.join(os.environ["MMTRL_RUN_ROOT"], run_name))
    n_scalars = sum(len(steps) for steps, _ in scalars.values())
    out = {"run_name": run_name, "manifest": statuses, "scalars": n_scalars}
    ok = statuses == ["running", "finished"]
    if track:
        (run_dir,) = glob.glob(os.path.join("wandb_local", "*", run_name))
        with open(os.path.join(run_dir, "wandb-metadata.json")) as f:
            state = json.load(f)["state"]
        with open(os.path.join(run_dir, "history.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
        same = all(
            [(r["_step"], np.float32(r[tag])) for r in rows if tag in r]
            == [(int(a), np.float32(b)) for a, b in zip(*scalars[tag])] for tag in scalars)
        out.update(state=state, history_rows=len(rows), history_equals_events=same)
        ok &= (state == "finished" and len(rows) == n_scalars > 0 and same
               and set(summary) == set().union(*rows))
    for name in gifs:
        info = read_gif_header(os.path.join("videos", run_name, name))
        out[name] = {k: info[k] for k in ("width", "height", "frames", "loop")}
        ok &= (info["frames"] >= 1 and info["loop"] == 0 and None not in info["delays_ms"]
               and (info["width"], info["height"]) == TOOLS_GIF_SIZE)
    if gifs:
        ok &= sorted(os.listdir(os.path.join("videos", run_name))) == sorted(gifs)
    emit("run_tools", journal=out, card=smi, ok=ok)
    check(ok, f"the run journal of {run_name}: {out}")
    return out


def tools_record_checks(smi: str, args, model):
    """``record_episode`` of the trained casl agent, 256 greedy steps of
    Minecraft2d, on the card and from the same weights on the CPU, the
    card's resets replaying the CPU's draws: the frames equal up to the
    first greedy action that flips on float rounding (C.13), the step
    reported, and ``write_gif`` byte-equal over those frames."""
    import os

    import numpy as np

    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
    from mmtrl_tpu_torch.scripts.train import make_agent, recurrent_video_policy
    from mmtrl_tpu_torch.utils.video import obs_to_frames, record_episode, write_gif

    cpu_env, card_env, _ = taped_pair(Minecraft2d)
    cpu_model = make_agent(args, card_env.num_actions, torch.device("cpu"))
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    actions = {"cpu": [], "card": []}

    def taped(side):
        def policy(m, obs, done, carry, generator):
            action, carry = recurrent_video_policy(m, obs, done, carry, generator)
            actions[side].append(action)
            return action, carry
        return policy

    seed = SEED + 777
    t0 = time.perf_counter()
    cpu_traj = record_episode(cpu_env, taped("cpu"), cpu_model, torch.Generator().manual_seed(seed),
                              TOOLS_VIDEO_STEPS, cpu_model.initial_carry(1))
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_traj = record_episode(card_env, taped("card"), model,
                               torch.Generator(device="cuda").manual_seed(seed),
                               TOOLS_VIDEO_STEPS, model.initial_carry(1))
    card_s = time.perf_counter() - t0  # the copy to the host ends it
    flips = torch.nonzero(torch.stack(actions["card"]).cpu() != torch.stack(actions["cpu"]))
    first_flip = int(flips[0, 0]) if len(flips) else None
    upto = TOOLS_VIDEO_STEPS if first_flip is None else first_flip + 1
    card_frames, cpu_frames = obs_to_frames(card_traj[:upto]), obs_to_frames(cpu_traj[:upto])
    t0 = time.perf_counter()
    card_gif = write_gif(card_frames, os.path.join("record", "card.gif"))
    gif_s = time.perf_counter() - t0
    cpu_gif = write_gif(cpu_frames, os.path.join("record", "cpu.gif"))
    with open(card_gif, "rb") as a, open(cpu_gif, "rb") as b:
        gif_equal = a.read() == b.read()
    frames_equal = np.array_equal(card_frames, cpu_frames)
    ok = frames_equal and gif_equal
    emit("run_tools", record_episode="minecraft, big casl, greedy", steps=TOOLS_VIDEO_STEPS,
         first_greedy_flip=first_flip, frames_compared=upto, frames_equal=frames_equal,
         obs_max_abs_err=float(np.abs(card_traj[:upto] - cpu_traj[:upto]).max()),
         distinct_frames=len({f.tobytes() for f in card_frames}), gif_bytes_equal=gif_equal,
         card_record_s=card_s, cpu_record_s=cpu_s, write_gif_s=gif_s,
         gif_bytes=os.path.getsize(card_gif), card=smi, ok=ok)
    check(ok, f"record_episode card vs CPU: frames {frames_equal}, GIF bytes {gif_equal}")


def tools_phase_timer(smi: str, args, runner):
    """``PhaseTimer`` around ``TOOLS_TIMED_ITERS`` rollouts and updates of
    the trained run, each phase also bracketed by CUDA events: the timer's
    wall (the phase, then its device's synchronize) holds the events' time."""
    from mmtrl_tpu_torch.algos.ppo import make_recurrent_ppo
    from mmtrl_tpu_torch.envs import make
    from mmtrl_tpu_torch.scripts._common import ppo_config_from
    from mmtrl_tpu_torch.utils.profiling import PhaseTimer

    algo = make_recurrent_ppo(make(args.env_id, device="cuda"), runner.model,
                              ppo_config_from(args))
    timer, events, rs = PhaseTimer(), {"rollout": 0.0, "update": 0.0}, runner
    for _ in range(TOOLS_TIMED_ITERS):
        carry = rs.carry
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        with timer.phase("rollout", block_on=rs.obs):
            rs, data = algo.rollout(rs)
        marks[1].record()
        with timer.phase("update", block_on=rs.obs):
            rs, metrics = algo.update_from_rollout(rs, carry, data)
        marks[2].record()
        torch.cuda.synchronize()
        events["rollout"] += marks[0].elapsed_time(marks[1])
        events["update"] += marks[1].elapsed_time(marks[2])
    timer_ms = timer.averages()
    event_ms = {f"profile/{k}_ms": v / TOOLS_TIMED_ITERS for k, v in events.items()}
    ok = all(0 < event_ms[k] <= timer_ms[k] * 1.01 + 0.5 for k in event_ms) and all(
        math.isfinite(float(v)) for v in metrics.values())
    emit("run_tools", phase_timer=timer_ms, cuda_events=event_ms, iterations=TOOLS_TIMED_ITERS,
         card=smi, ok=ok)
    check(ok, f"PhaseTimer {timer_ms} against CUDA events {event_ms}")


def tools_tuner(smi: str):
    """Two tuner trials of one seed of ``ppo`` on CartPole-v1, in-process
    on the card under ``runs_tuner/``: each trial's metric (the last point,
    window 1) equal to the last value that trial logged, read back from its
    event file; the peak CUDA memory after each trial."""
    import glob
    import os

    import numpy as np

    from mmtrl_tpu_torch.scripts import ppo
    from mmtrl_tpu_torch.utils import wandb_local
    from mmtrl_tpu_torch.utils.tuner import Tuner

    trials = []

    class MeteredTuner(Tuner):
        def _run_script(self, argv):
            # a run's name ends in its start's whole second: two trials in
            # one second would share a run directory
            time.sleep(1.0 - time.time() % 1.0)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            value = super()._run_script(argv + ["--track"])
            trials.append({"metric": value, "wall_s": time.perf_counter() - t0,
                           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "held_gb": torch.cuda.memory_allocated() / 1e9})
            emit("run_tools", tuner_trial=len(trials) - 1, argv=argv, card=smi, **trials[-1])
            return value

    tuner = MeteredTuner(
        script=ppo.__file__, metric="charts/episodic_return", metric_last_n_average_window=1,
        target_scores={"CartPole-v1": None}, storage="hpopt.log", study_name="chip_smoke",
        params_fn=lambda trial: {
            "learning-rate": trial.suggest_float("learning-rate", 1e-4, 1e-3, log=True),
            "total-timesteps": TOOLS_TUNER_STEPS})
    results = tuner.tune(num_trials=TOOLS_TRIALS, num_seeds=1)
    runs = sorted(glob.glob(os.path.join("runs_tuner", "chip_smoke", "*")), key=os.path.getmtime)
    logged = []
    for run_dir in runs:
        steps, series = wandb_local.load_history(
            glob.glob(os.path.join("wandb_local", "*", os.path.basename(run_dir)))[0])
        values = series["charts/episodic_return"]
        logged.append(float(np.float32(values[~np.isnan(values)][-1])))
    ok = (len(runs) == len(results) == TOOLS_TRIALS
          and [r["score"] for r in results] == [t["metric"] for t in trials] == logged)
    emit("run_tools", tuner_scores=[r["score"] for r in results], last_logged=logged,
         params=[r["params"] for r in results], card=smi, ok=ok)
    check(ok, f"the tuner's metrics {[t['metric'] for t in trials]} against the logged {logged}")


def run_tools_checks(smi: str, tmp: str):
    import os

    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import dqn, train

    work = os.path.join(tmp, "run_tools")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    os.environ["MMTRL_RUN_ROOT"] = os.path.join(work, "runs")
    t_phase, seconds = time.perf_counter(), {}
    try:
        t0 = time.perf_counter()
        args = cli(train.Args, TOOLS_TRAIN_ARGS)
        out = train.main(args)
        seconds["train"] = time.perf_counter() - t0
        emit("run_tools", run="train", args=TOOLS_TRAIN_ARGS, wall_s=seconds["train"],
             update_walls_s=[r["wall_s"] for r in out["history"]], videos=out["videos"], card=smi)
        journal_checks(smi, out["run_name"], track=True, gifs=TOOLS_GIFS)
        t0 = time.perf_counter()
        tools_record_checks(smi, args, out["runner"].model)
        seconds["record"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tools_phase_timer(smi, args, out["runner"])
        seconds["phase_timer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        q = dqn.main(cli(dqn.Args, TOOLS_DQN_ARGS))
        seconds["dqn"] = time.perf_counter() - t0
        journal_checks(smi, q["run_name"], track=True)
        check(not os.path.exists(os.path.join("videos", q["run_name"])), "dqn wrote a video")
        t0 = time.perf_counter()
        tools_tuner(smi)
        seconds["tuner"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    emit("run_tools", seconds=time.perf_counter() - t_phase, by_step=seconds, card=smi)


def phase_run_tools(smi: str, tmp: str):
    """The run tooling on the card, in its own working directory: (a)
    ``train --attn-type casl`` at the repo's width (1 env x 128, big
    towers), 2 updates with ``--track --capture-video --save-interval 1``:
    the ``wandb_local`` run (a history row per logged scalar, equal to the
    event file's, the summary, state "finished"), the two manifest records,
    ``update_1.gif``, ``update_2.gif`` and ``final.gif`` by the port's own
    header walk; ``record_episode`` card vs CPU from the same weights and
    draws, frames equal up to the first greedy flip, ``write_gif``
    byte-equal; (b) ``dqn --track`` on CartPole-v1 cut to 1,024 steps (of
    500,000), the off-policy runner's mirror and journal, no video; (c) two
    tuner trials of ``ppo`` on CartPole-v1 cut to 1,024 steps, in-process,
    each metric equal to the trial's last logged value, the peak CUDA
    memory after each; (d) ``PhaseTimer`` around (a)'s rollout and update
    against CUDA events.  No kernel of the port lies on these paths."""
    restoring_flags(run_tools_checks, smi, tmp)


# The DT's multi-device axes (ROADMAP A.8) on the one card: a one-rank NCCL
# group, and a 2 data x 2 model gloo world of four processes on the card.
# The small float32 config holds each step against the plain step: vector
# states (no convolution), 4 heads of 32, two steps (the warmup schedule's
# first learning rate is 0, the second moves the parameters).
PAR_SMALL = dict(num_actions=4, context_len=6, d_model=128, n_layers=2, n_heads=4, dropout=0.0,
                 max_timestep=64, state_kind="vector", state_dim=16, compute_dtype="float32")
PAR_SMALL_B = 8
PAR_STEPS = 2
# JAX's tolerances for the data x seq step (tests/test_seq_composed.py):
# loss, accuracy, every parameter after the steps.
PAR_LOSS_ATOL, PAR_ACC_ATOL, PAR_PARAM_ATOL = 1e-5, 1e-6, 2e-5
# The gloo world's gradients, summed over its ranks' blocks, against the
# one-rank step's (tests/test_moe.py's tolerances for gradients): Adam and
# the clip would hide a gradient scaled uniformly.
PAR_GRAD_RTOL, PAR_GRAD_ATOL = 1e-5, 1e-6
PAR_TIMED = (2, 10)  # flagship steps of each mode: warm, timed
PAR_LONG = (16, 342)  # the long-context seq step: B, K (S = 1026)
PAR_LONG_TIMED = (1, 3)
# bf16: the ring's float32 softmax against the flash kernel's bf16 P
PAR_LONG_LOSS_RTOL = 2e-2
PAR_MOE = (64, 90, 512, 2048, 4)  # B, S, D, F, E: dt_rom's MoE FFN
PAR_PIPE_MLP = (512, 2048, 8, 64)  # d, hidden, microbatches, rows each
PAR_PIPE_DT = (4, 4)  # flagship blocks in float32: microbatches, windows each
PAR_TOL_OF_MAX = 1e-5
PAR_WORLD = (2, 2)  # data, model
PAR_CHILD_S = 300


def par_small_batch(device="cuda"):
    B, K = PAR_SMALL_B, PAR_SMALL["context_len"]
    g = torch.Generator(device=device).manual_seed(SEED)
    mask = torch.ones(B, K, dtype=torch.bool, device=device)
    mask[0, -2:] = False
    return (torch.rand(B, K, generator=g, device=device) * 10 - 5,
            torch.randn(B, K, PAR_SMALL["state_dim"], generator=g, device=device),
            torch.randint(0, 4, (B, K), generator=g, device=device),
            torch.arange(K, device=device).repeat(B, 1), mask)


def par_small_state(cfg, prepare=None, state_dict=None):
    """A train state of the small config from SEED (or ``state_dict``);
    ``prepare(model)`` shards it before the moments are made."""
    from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state
    from mmtrl_tpu_torch.ops.fused_optim import init_adam_state

    state = create_dt_state(cfg, DTTrainConfig(batch_size=PAR_SMALL_B, total_steps=10,
                                               warmup_steps=2), seed=SEED)
    if state_dict is not None:
        state.model.load_state_dict(state_dict, strict=True)
    if prepare is not None:
        prepare(state.model)
        state.opt_state = init_adam_state(list(state.model.parameters()))
    return state


def par_run(step, state, batch, n):
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {name: p.detach() for name, p in state.model.named_parameters()}


def par_errors(metrics, params, ref_metrics, ref_params, slicer=lambda name, t: t):
    """(largest loss, accuracy and parameter distance) from the reference."""
    loss = max(abs(a["dt/loss"] - b["dt/loss"]) for a, b in zip(metrics, ref_metrics))
    acc = max(abs(a["dt/action_accuracy"] - b["dt/action_accuracy"])
              for a, b in zip(metrics, ref_metrics))
    param = max((params[n].float().cpu() - slicer(n, ref_params[n]).float().cpu())
                .abs().max().item() for n in ref_params)
    return loss, acc, param


def parallel_small_checks(smi: str):
    """(a1) The DP, TP, FSDP and seq steps on one rank against the plain
    step, float32, two steps each; the flash launches of each."""
    from mmtrl_tpu_torch.algos.dt import make_dt_train_step
    from mmtrl_tpu_torch.algos.dt.train import dt_gradients
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig
    from mmtrl_tpu_torch.parallel import make_mesh, shard_batch
    from mmtrl_tpu_torch.parallel.seq_composed import (
        make_dt_seq_train_step,
        seq_cfg,
        shard_dt_batch,
    )
    from mmtrl_tpu_torch.parallel.sharding import shard_dt_params, shard_fsdp_params

    cfg = DTConfig(**PAR_SMALL)
    batch = par_small_batch()
    state = par_small_state(cfg)
    init = {n: t.detach().clone() for n, t in state.model.state_dict().items()}
    ref_grads = dict(zip(init, dt_gradients(state.model, batch)[3]))
    ref_metrics, ref_params = par_run(make_dt_train_step(cfg), state, batch, PAR_STEPS)
    dp = make_mesh()
    tp = make_mesh((1, 1), ("data", "model"))
    sq = make_mesh((1, 1), ("data", "seq"))
    scfg = seq_cfg(cfg, 1)
    modes = {
        "dp": (make_dt_train_step(cfg, dp), par_small_state(cfg), shard_batch(dp, batch)),
        "tp": (make_dt_train_step(cfg, tp), par_small_state(cfg, lambda m: shard_dt_params(tp, m)),
               shard_batch(tp, batch)),
        "fsdp": (make_dt_train_step(cfg, dp),
                 par_small_state(cfg, lambda m: shard_fsdp_params(dp, m, min_size=1)),
                 shard_batch(dp, batch)),
        "seq": (make_dt_seq_train_step(scfg, sq), par_small_state(scfg), shard_dt_batch(batch, sq)),
    }
    layers = cfg.n_layers * PAR_STEPS
    for mode, (step, state, b) in modes.items():
        plan = getattr(state.model, "shard_plan", None)
        sharded = len(plan.specs) if plan is not None else 0
        before = read_counts()
        metrics, params = par_run(step, state, b, PAR_STEPS)
        counts = counts_since(before)
        expected = dict.fromkeys(counts, 0 if mode == "seq" else layers)
        loss, acc, param = par_errors(metrics, params, ref_metrics, ref_params)
        ok = (loss <= PAR_LOSS_ATOL and acc <= PAR_ACC_ATOL and param <= PAR_PARAM_ATOL
              and counts == expected)
        emit("parallel", check=f"{mode} step, one NCCL rank, vs the plain step",
             config="small float32", steps=PAR_STEPS, losses=[m["dt/loss"] for m in metrics],
             loss_err=loss, acc_err=acc, param_err=param, sharded_leaves=sharded,
             launches=counts, expected_launches=expected, ok=ok, card=smi)
        check(ok, f"the {mode} step disagrees with the plain step or launched {counts}")
    return init, batch, ref_grads, ref_metrics, ref_params


def parallel_flagship(smi: str):
    """(a2) bench.py's flagship step through the plain, DP, TP and FSDP
    steps on one rank: ms a step and 6 launches of each kernel a step."""
    from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state, make_dt_train_step
    from mmtrl_tpu_torch.algos.dt.data import random_buffer
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig
    from mmtrl_tpu_torch.ops.fused_optim import init_adam_state
    from mmtrl_tpu_torch.parallel import make_mesh, shard_batch
    from mmtrl_tpu_torch.parallel.sharding import shard_dt_params, shard_fsdp_params

    B, K = 128, 30
    cfg = DTConfig(num_actions=4, context_len=K, d_model=512, n_layers=6, n_heads=4,
                   dropout=0.1, max_timestep=64, ln_dtype="bfloat16")
    buffer = random_buffer(16, 6144, torch.Generator(device="cuda").manual_seed(SEED))
    dp, tp = make_mesh(), make_mesh((1, 1), ("data", "model"))
    modes = {"plain": (None, None), "dp": (dp, None),
             "tp": (tp, lambda m: shard_dt_params(tp, m)),
             "fsdp": (dp, lambda m: shard_fsdp_params(dp, m))}
    per_step = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"), cfg.n_layers)
    warm, timed = PAR_TIMED
    rows = {mode: [] for mode in modes}
    # in turns, forward then back: plain, dp, tp, fsdp, fsdp, tp, dp, plain
    for mode in list(modes) + list(reversed(modes)):
        mesh, prepare = modes[mode]
        state = create_dt_state(cfg, DTTrainConfig(batch_size=B, total_steps=1000), seed=SEED)
        if prepare is not None:
            prepare(state.model)
            state.opt_state = init_adam_state(list(state.model.parameters()))
        step = make_dt_train_step(cfg, mesh)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.manual_seed(SEED)  # dropout
        losses = []
        start = read_counts()
        for i in range(warm + timed):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            batch = buffer.sample(gen, B, K)
            before = read_counts()
            state, m = step(state, batch if mesh is None else shard_batch(mesh, batch))
            after = read_counts()
            check({k: after[k] - before[k] for k in after} == per_step,
                  f"{mode} flagship step {i} launched {after} after {before}")
            losses.append(m["dt/loss"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / timed
        losses = [float(x) for x in losses]
        rows[mode].append(ms)
        emit("parallel", check=f"{mode} flagship step, one NCCL rank", config="bench.py flagship",
             batch_size=B, context_len=K, steps_warm=warm, steps_timed=timed, step_ms=ms,
             turn=len(rows[mode]), launches=counts_since(start),
             launches_per_step=per_step, loss_first=losses[0], loss_last=losses[-1],
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
        check(all(math.isfinite(x) for x in losses), f"{mode}: non-finite loss")
        del state
    return rows


def parallel_long(smi: str):
    """(a3) The seq step with a ring of one rank at K = 342 (S = 1026)
    against the flash DT step from the same weights: ms a step, zero flash
    launches, the first losses within bf16's tolerance."""
    from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state, make_dt_train_step
    from mmtrl_tpu_torch.algos.dt.data import random_buffer
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig
    from mmtrl_tpu_torch.parallel import make_mesh
    from mmtrl_tpu_torch.parallel.seq_composed import make_dt_seq_train_step, seq_cfg

    B, K = PAR_LONG
    cfg = DTConfig(num_actions=4, context_len=K, d_model=512, n_layers=6, n_heads=4,
                   dropout=0.0, max_timestep=64, ln_dtype="bfloat16")
    tcfg = DTTrainConfig(batch_size=B, total_steps=1000)
    buffer = random_buffer(16, 2048, torch.Generator(device="cuda").manual_seed(SEED))
    batch = buffer.sample(torch.Generator(device="cuda").manual_seed(SEED), B, K)
    sq = make_mesh((1, 1), ("data", "seq"))
    scfg = seq_cfg(cfg, 1)
    rows = {}
    for mode, c, step in (("flash", cfg, make_dt_train_step(cfg)),
                          ("seq ring", scfg, make_dt_seq_train_step(scfg, sq))):
        state = create_dt_state(c, tcfg, seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        warm, timed = PAR_LONG_TIMED
        losses = []
        for i in range(warm + timed):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(m["dt/loss"])
        torch.cuda.synchronize()
        rows[mode] = dict(step_ms=1e3 * (time.perf_counter() - t0) / timed,
                          loss_first=float(losses[0]), launches=counts_since(before),
                          max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        del state
    rel = abs(rows["seq ring"]["loss_first"] - rows["flash"]["loss_first"]) / abs(
        rows["flash"]["loss_first"])
    ok = (not any(rows["seq ring"]["launches"].values()) and rel <= PAR_LONG_LOSS_RTOL
          and math.isfinite(rows["seq ring"]["loss_first"]))
    emit("parallel", check="seq step, a ring of one rank, vs the flash step",
         config="flagship bf16", batch_size=B, context_len=K, seq_len=3 * K, **{
             k.replace(" ", "_"): v for k, v in rows.items()}, loss_rel_err=rel,
         loss_rtol=PAR_LONG_LOSS_RTOL, ok=ok, card=smi)
    check(ok, f"the long seq step: {rows}, loss rel err {rel}")
    return rows


def parallel_expert_pipeline(smi: str):
    """(a4) The expert axis and the pipeline on one rank against their
    one-device forms: values and gradients, zero flash launches (the MLP
    stage); the pipeline over six flagship blocks, whose attention launches
    the forward kernel."""
    from mmtrl_tpu_torch.models.decision_transformer import Block
    from mmtrl_tpu_torch.models.moe import moe_combine_weights, moe_ffn_dense
    from mmtrl_tpu_torch.parallel import make_mesh, pipeline_apply, stack_stage_params
    from mmtrl_tpu_torch.parallel.expert import expert_parallel_moe

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1.0)

    # the expert axis at dt_rom's MoE width
    B, S, D, F, E = PAR_MOE
    x, logits = rand(B, S, D), rand(B, S, E)
    ws = [rand(E, D, F, scale=0.02), rand(E, F, scale=0.02), rand(E, F, D, scale=0.02),
          rand(E, D, scale=0.02)]
    combine = moe_combine_weights(logits, 2)
    mesh = make_mesh((1,), ("expert",))
    sides = {}
    before = read_counts()
    for name, fn in (("dense", lambda x, *w: moe_ffn_dense(x, combine, *w)),
                     ("expert", lambda x, *w: expert_parallel_moe(x, combine, *w, mesh))):
        args = [t.detach().requires_grad_() for t in [x] + ws]
        y = fn(*args)
        grads = torch.autograd.grad((y ** 2).mean(), args)
        with torch.no_grad():
            ms = cuda_ms(lambda: fn(x, *ws), 10)
        sides[name] = (y.detach(), grads, ms)
    moe_launches = counts_since(before)
    y_err = rel(sides["expert"][0], sides["dense"][0])
    g_err = max(rel(a, b) for a, b in zip(sides["expert"][1], sides["dense"][1]))
    ok = y_err <= PAR_TOL_OF_MAX and g_err <= PAR_TOL_OF_MAX and not any(moe_launches.values())
    emit("parallel", check="expert axis, one rank, vs moe_ffn_dense", shape=[B, S, D, F, E],
         value_err_of_max=y_err, grad_err_of_max=g_err, ms=sides["expert"][2],
         plain_ms=sides["dense"][2], launches=moe_launches, ok=ok, card=smi)
    check(ok, f"the expert axis disagrees: {y_err}, {g_err}, {moe_launches}")

    # the pipeline of an MLP stage
    d, hidden, M, rows = PAR_PIPE_MLP
    mesh = make_mesh((1,), ("pipe",))
    params = {"w1": rand(d, hidden, scale=d ** -0.5), "b1": rand(hidden, scale=0.1),
              "w2": rand(hidden, d, scale=hidden ** -0.5), "b2": rand(d, scale=0.1)}
    xs = rand(M, rows, d)

    def mlp(p, x):
        return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    before = read_counts()
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    out = pipeline_apply(mlp, leaves, xs, mesh)
    grads = torch.autograd.grad((out ** 2).sum(), list(leaves.values()))
    ref = mlp(leaves, xs)
    ref_grads = torch.autograd.grad((ref ** 2).sum(), list(leaves.values()))
    with torch.no_grad():
        ms, plain_ms = cuda_ms(lambda: pipeline_apply(mlp, params, xs, mesh), 10), \
            cuda_ms(lambda: mlp(params, xs), 10)
    mlp_launches = counts_since(before)
    errs = (rel(out.detach(), ref.detach()), max(rel(a, b) for a, b in zip(grads, ref_grads)))
    ok = max(errs) <= PAR_TOL_OF_MAX and not any(mlp_launches.values())
    emit("parallel", check="pipeline, one rank, MLP stage vs sequential",
         shape=[M, rows, d, hidden],
         value_err_of_max=errs[0], grad_err_of_max=errs[1], ms=ms, plain_ms=plain_ms,
         launches=mlp_launches, ok=ok, card=smi)
    check(ok, f"the pipeline disagrees: {errs}, {mlp_launches}")

    # the pipeline over the flagship's six blocks, float32
    cfg = flagship_cfg("float32", dropout=0.0)
    torch.manual_seed(SEED)
    blocks = [Block(cfg, torch.device("cuda")).eval() for _ in range(cfg.n_layers)]
    stacked = stack_stage_params([dict(b.named_parameters()) for b in blocks])
    M, W = PAR_PIPE_DT
    xs = rand(M, W, cfg.seq_len, cfg.d_model)

    def stage(p, x):
        for i in range(cfg.n_layers):
            x, _ = torch.func.functional_call(blocks[0], {k: v[i] for k, v in p.items()}, (x,))
        return x

    with torch.no_grad():
        before = read_counts()
        out = pipeline_apply(stage, stacked, xs, mesh)
        dt_launches = counts_since(before)
        ref = xs.reshape(M * W, cfg.seq_len, cfg.d_model)
        for b in blocks:
            ref, _ = b(ref)
        ref = ref.reshape(xs.shape)
    err = rel(out, ref)
    expected = {"flash_fwd": M * cfg.n_layers, "flash_dq": 0, "flash_dkv": 0}
    ok = err <= PAR_TOL_OF_MAX and dt_launches == expected
    emit("parallel", check="pipeline, one rank, six flagship blocks vs sequential",
         shape=[M, W, cfg.seq_len, cfg.d_model], value_err_of_max=err, launches=dt_launches,
         expected_launches=expected, ok=ok, card=smi)
    check(ok, f"the DT-block pipeline disagrees: {err}, {dt_launches}")


def parallel_world(smi: str, tmp: str, init, batch, ref_grads, ref_metrics, ref_params):
    """(b) A 2 data x 2 model gloo world of four processes on the card: its
    summed gradients at the initial weights and its float32 step after two
    steps against (a1)'s one-rank plain step."""
    import os

    from mmtrl_tpu_torch.parallel.sharding import tp_slice

    inputs = os.path.join(tmp, "parallel_inputs.pt")
    torch.save({"state_dict": {n: t.cpu() for n, t in init.items()},
                "batch": [t.cpu() for t in batch]}, inputs)
    here = os.path.dirname(os.path.abspath(__file__))
    store = os.path.join(tmp, "parallel_store")
    world = PAR_WORLD[0] * PAR_WORLD[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                               "--parallel-child", str(r), store, inputs, tmp], cwd=here)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=PAR_CHILD_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    check(codes == [0] * world, f"the gloo world's ranks exited with {codes}")
    tp = PAR_WORLD[1]
    layers = PAR_SMALL["n_layers"] * PAR_STEPS
    for r in range(world):
        res = torch.load(os.path.join(tmp, f"parallel_rank{r}.pt"), weights_only=True)
        grad = 0.0  # the largest |g - want| - rtol |want|, held to the atol
        for n, g in ref_grads.items():
            want = tp_slice(n, g, tp, res["model_index"]).cpu()
            excess = (res["grads"][n] - want).abs() - PAR_GRAD_RTOL * want.abs()
            grad = max(grad, excess.max().item())
        loss, acc, param = par_errors(
            res["metrics"], res["params"], ref_metrics, ref_params,
            lambda n, t: tp_slice(n, t, tp, res["model_index"]))
        expected = dict.fromkeys(res["launches"], layers)
        ok = (grad <= PAR_GRAD_ATOL and loss <= PAR_LOSS_ATOL and acc <= PAR_ACC_ATOL
              and param <= PAR_PARAM_ATOL and res["launches"] == expected
              and res["device"] == "cuda")
        emit("parallel", check="2 data x 2 model gloo world on the card vs the one-rank step",
             rank=r, model_index=res["model_index"], grad_err_over_rtol=grad, loss_err=loss,
             acc_err=acc,
             param_err=param, launches=res["launches"], expected_launches=expected,
             step_ms=res["step_ms"], world_wall_s=wall, ok=ok, card=smi)
        check(ok, f"gloo rank {r} disagrees with the one-rank step")


def parallel_child(rank: str, store: str, inputs: str, out_dir: str) -> None:
    """One rank of (b): gloo on the card, the TP slices of the small config
    over (data, model) = PAR_WORLD, two steps; writes its results."""
    import datetime
    import os

    import torch.distributed as dist

    from mmtrl_tpu_torch.algos.dt import make_dt_train_step
    from mmtrl_tpu_torch.algos.dt.train import dt_gradients
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig
    from mmtrl_tpu_torch.parallel import make_mesh, shard_batch
    from mmtrl_tpu_torch.parallel.mesh import replicate
    from mmtrl_tpu_torch.parallel.sharding import shard_dt_params

    rank = int(rank)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=PAR_WORLD[0] * PAR_WORLD[1],
                            timeout=datetime.timedelta(seconds=120))
    data = torch.load(inputs, weights_only=True)
    mesh = make_mesh(PAR_WORLD, ("data", "model"))
    cfg = DTConfig(**PAR_SMALL)

    def prepare(model):
        # every rank but the first starts from other weights; the broadcast
        # (gloo on CUDA tensors) gives each the first rank's
        if rank:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        replicate(mesh, list(model.parameters()))
        shard_dt_params(mesh, model)

    state = par_small_state(cfg, prepare, {n: t.cuda() for n, t in data["state_dict"].items()}
                            if rank == 0 else None)
    batch = shard_batch(mesh, [t.cuda() for t in data["batch"]])
    names = [n for n, _ in state.model.named_parameters()]
    grads = {n: g.cpu() for n, g in zip(names, dt_gradients(state.model, batch, mesh)[3])}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, params = par_run(make_dt_train_step(cfg, mesh), state, batch, PAR_STEPS)
    torch.cuda.synchronize()
    torch.save({"metrics": metrics, "grads": grads,
                "params": {n: p.cpu() for n, p in params.items()},
                "model_index": mesh.index("model"), "launches": read_counts(),
                "device": next(iter(params.values())).device.type,
                "step_ms": 1e3 * (time.perf_counter() - t0) / PAR_STEPS},
               os.path.join(out_dir, f"parallel_rank{rank}.pt"))
    dist.destroy_process_group()


def parallel_checks(smi: str, tmp: str):
    import os

    import torch.distributed as dist

    t_phase, seconds = time.perf_counter(), {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
                            rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        small = parallel_small_checks(smi)
        seconds["small"] = time.perf_counter() - t0
        for step in (parallel_flagship, parallel_long, parallel_expert_pipeline):
            t0 = time.perf_counter()
            step(smi)
            seconds[step.__name__] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    parallel_world(smi, tmp, *small)
    seconds["gloo_world"] = time.perf_counter() - t0
    emit("parallel", seconds=time.perf_counter() - t_phase, by_step=seconds, card=smi)


def phase_parallel(smi: str, tmp: str):
    """The DT's multi-device axes (``parallel/``) on the card.  (a) In a
    one-rank NCCL group: the DP, TP (data x model (1, 1)), FSDP (every leaf
    sharded) and seq (a ring of one rank) steps of a small float32 config
    against the plain step, two steps each, within JAX's tolerances, the
    seq step launching no kernel and each other 2 of each a step;
    ``bench.py``'s flagship step (B = 128, K = 30, bf16, dropout 0.1)
    through the plain, DP, TP and FSDP steps, timed, 6 launches of each
    kernel a step; the seq step at K = 342 (S = 1026) against the flash
    step, timed, no launch; the expert axis at dt_rom's MoE width and the
    pipeline of an MLP stage against their one-device forms (values and
    gradients, no launch) and over the flagship's six blocks in float32.
    (b) A 2 data x 2 model gloo world of four processes on the card (gloo's
    all-reduce and broadcast of CUDA tensors), every rank but the first
    starting from other weights and broadcast the first's, equal after two
    steps to (a)'s one-rank step."""
    restoring_flags(parallel_checks, smi, tmp)


def phase_timing(smi: str):
    import torch.nn.functional as F

    from mmtrl_tpu_torch.ops import flash_attention as fa

    rows = {}
    for label, shape, reps in (("serve", SERVE_SHAPE, 200), ("train", TRAIN_SHAPE, 100),
                               ("rom_train", ROM_TRAIN_SHAPE, 100), ("long", LONG_SHAPE, 10)):
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
    if sys.argv[1:2] == ["--ppo-resume"]:  # the ppo phase's child process
        ppo_resume(*sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--family-child"]:  # the ppo_family phase's child process
        family_child(*sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--parallel-child"]:  # a rank of the parallel phase's world
        parallel_child(*sys.argv[2:])
        return 0
    smi = card()
    t_start = time.perf_counter()
    native = native_build_in_background()
    phase_build()
    native.join()
    check(native.error is None, f"native 2600 library: {native.error}")
    errs = phase_kernel()
    phase_reference()
    phase_grad()
    phase_serve()
    launches, _ = phase_train(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        _, ppo_ckpt = phase_ppo(smi, tmp)
        phase_ppo_family(smi, ppo_ckpt)
        rom_launches = phase_rom(smi, tmp)
        phase_skeleton(smi, tmp)
        q_launches = phase_offpolicy_rom(smi, tmp)
        reset_counts()
        phase_classic(smi, tmp)
        classic_launches = read_counts()
        check(not any(classic_launches.values()),
              f"the classic phase launched attention kernels: {classic_launches}")
        reset_counts()
        phase_continuous(smi, tmp)
        continuous_launches = read_counts()
        check(not any(continuous_launches.values()),
              f"the continuous phase launched attention kernels: {continuous_launches}")
        reset_counts()
        phase_levels(smi, tmp)
        levels_launches = read_counts()
        check(not any(levels_launches.values()),
              f"the levels phase launched attention kernels: {levels_launches}")
        reset_counts()
        phase_pong_door(smi, tmp)
        pong_door_launches = read_counts()
        check(not any(pong_door_launches.values()),
              f"the pong_door phase launched attention kernels: {pong_door_launches}")
        reset_counts()
        phase_native_pools(smi, tmp)
        native_pools_launches = read_counts()
        check(not any(native_pools_launches.values()),
              f"the native_pools phase launched attention kernels: {native_pools_launches}")
        reset_counts()
        phase_host_loops(smi, tmp)
        host_loops_launches = read_counts()
        check(not any(host_loops_launches.values()),
              f"the host_loops phase launched attention kernels: {host_loops_launches}")
        reset_counts()
        phase_run_tools(smi, tmp)
        run_tools_launches = read_counts()
        check(not any(run_tools_launches.values()),
              f"the run_tools phase launched attention kernels: {run_tools_launches}")
        reset_counts()
        phase_parallel(smi, tmp)
        parallel_launches = read_counts()
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
            # the cartridge slice's shapes: dt_rom's train step (B = 64)
            "rom_train": {k: timing[(name, "rom_train")][k]
                          for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "rom_launches": rom_launches[name],
            # dt_rom from the Q checkpoints (the value-learning slice)
            "dqn_dt_launches": q_launches["dqn"][name],
            "c51_dt_launches": q_launches["c51"][name],
            # the classic-control slices: no attention on their paths
            "classic_launches": classic_launches[name],
            "continuous_launches": continuous_launches[name],
            # procmaze (PPG's held-out split) and the two-agent Minecraft2d
            "levels_launches": levels_launches[name],
            # Doorpuzzle and the two-player Pong
            "pong_door_launches": pong_door_launches[name],
            # the native pools in the fused loops, the two raw bridges
            "native_pools_launches": native_pools_launches[name],
            # the gymnasium bridge, the off-policy host loop, the two tools
            "host_loops_launches": host_loops_launches[name],
            # the run tooling: journal, wandb_local, GIFs, tuner, phase timer
            "run_tools_launches": run_tools_launches[name],
            # the multi-device axes on one NCCL rank: the DP, TP and FSDP
            # steps launch, the ring, seq step, expert axis and MLP pipeline
            # do not, the pipeline over DT blocks launches the forward
            "parallel_launches": parallel_launches[name],
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
