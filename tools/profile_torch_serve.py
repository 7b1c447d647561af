#!/usr/bin/env python3
"""Where the device time goes when the PyTorch/CUDA port serves or trains
the DT.

    python3 tools/profile_torch_serve.py            # serve
    python3 tools/profile_torch_serve.py --train    # train
    python3 tools/profile_torch_serve.py --train --modes plain,dp,tp,fsdp

Serve runs ``mmtrl_tpu_torch``'s ``evaluate_dt`` at the flagship width
(d_model 512, 6 layers, 4 heads, K = 30, bf16, random weights from a seed) in
Minecraft2d on one GPU, 16 envs x 64 steps as chip_smoke.py serves: once to
warm up, then once under ``torch.profiler``.  Train runs ``bench.py``'s
training configuration (B = 128, K = 30, dropout 0.1, bf16 LayerNorm) on a
16 x 6144-step buffer made on the card, as chip_smoke.py does: three warm
steps, ten timed without the profiler, then five under it.  ``--modes``
trains through the mesh modes of ``make_dt_train_step`` on a one-rank NCCL
group, in the order given, as chip_smoke.py's parallel phase does:
``plain`` (no mesh), ``dp`` (data parallel), ``tp`` (data x model 1 x 1,
``shard_dt_params``) and ``fsdp`` (``shard_fsdp_params``).  Prints one JSON
line a run: the window's wall time, the device's busy time (sum of kernel
durations; one stream, so they do not overlap) and idle share, the kernel
launches of each attention kernel, the device time, calls and share of the
top kernels and of every attention kernel, the host's self time and calls
of the top operators and of the collectives' operators, with the card's
name and power limit.  Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

NUM_ENVS, NUM_STEPS = 16, 64
TRAIN_WARM, TRAIN_TIMED, TRAIN_STEPS = 3, 10, 5
MODES = ("plain", "dp", "tp", "fsdp")
# host operators of the collectives (c10d's dispatcher ops, the NCCL calls,
# the profiler's record of each collective)
COLLECTIVE_OPS = ("c10d::", "nccl:", "record_param_comms")


def kernel_times(prof):
    """(device microseconds, calls) per kernel name, from a profile."""
    us, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
    return us, calls


def serve_run():
    """(run, steps): a callable that serves the flagship DT once."""
    from mmtrl_tpu_torch.algos.dt import evaluate_dt
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
    from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer, DTConfig

    cfg = DTConfig(num_actions=4, context_len=30, d_model=512, n_layers=6, n_heads=4,
                   max_timestep=64, compute_dtype="bfloat16")
    torch.manual_seed(0)
    model = DecisionTransformer(cfg)
    env = Minecraft2d()

    def run():
        evaluate_dt(env, cfg, model, 10.0, num_envs=NUM_ENVS,
                    num_steps=NUM_STEPS, rtg_clip=10.0,
                    generator=torch.Generator(device="cuda").manual_seed(0))

    run()
    return run, NUM_STEPS


def host_times(prof):
    """(host self microseconds, calls) per operator name, from a profile."""
    us, calls = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            us[e.key] += e.self_cpu_time_total
            calls[e.key] += e.count
    return us, calls


def train_run(mode: str = "plain"):
    """(run, steps): a callable that takes TRAIN_STEPS flagship train steps
    through ``mode``; TRAIN_TIMED more, timed, give ``run.step_ms``."""
    from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state, make_dt_train_step
    from mmtrl_tpu_torch.algos.dt.data import random_buffer
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig
    from mmtrl_tpu_torch.ops.fused_optim import init_adam_state
    from mmtrl_tpu_torch.parallel import make_mesh, shard_batch
    from mmtrl_tpu_torch.parallel.sharding import shard_dt_params, shard_fsdp_params

    B, K = 128, 30
    cfg = DTConfig(num_actions=4, context_len=K, d_model=512, n_layers=6, n_heads=4,
                   dropout=0.1, max_timestep=64, ln_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(0)
    buffer = random_buffer(16, 6144, g)
    state = create_dt_state(cfg, DTTrainConfig(batch_size=B, total_steps=1000), seed=0)
    mesh = None
    if mode != "plain":
        mesh = make_mesh((1, 1), ("data", "model")) if mode == "tp" else make_mesh()
        if mode != "dp":
            (shard_dt_params if mode == "tp" else shard_fsdp_params)(mesh, state.model)
            state.opt_state = init_adam_state(list(state.model.parameters()))
    step = make_dt_train_step(cfg, mesh)

    def run(n=TRAIN_STEPS):
        nonlocal state
        for _ in range(n):
            batch = buffer.sample(g, B, K)
            state, _ = step(state, batch if mesh is None else shard_batch(mesh, batch))

    run(TRAIN_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(TRAIN_TIMED)
    torch.cuda.synchronize()
    run.step_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
    return run, TRAIN_STEPS


def profile_run(run, steps, label, card):
    """One JSON line: ``run`` under the profiler."""
    from mmtrl_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    us, calls = kernel_times(prof)
    host_us, host_calls = host_times(prof)
    busy_s = sum(us.values()) / 1e6
    print(json.dumps({
        "card": card, "path": label, "steps": steps,
        "step_ms_unprofiled": getattr(run, "step_ms", None),
        "launches": {"flash_fwd": fa.launches, "flash_dq": fa.dq_launches,
                     "flash_dkv": fa.dkv_launches},
        "wall_s": wall_s, "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s,
        "kernel_launches": sum(calls.values()),
        # the port's attention kernels, whether or not among the top ones
        "attention_kernels": [
            {"name": name[:80], "device_ms": t / 1e3, "calls": calls[name],
             "share_of_busy": t / 1e6 / busy_s}
            for name, t in us.most_common() if "_sm90<" in name or "flash_" in name
        ],
        "top_kernels": [
            {"name": name[:80], "device_ms": t / 1e3, "calls": calls[name],
             "share_of_busy": t / 1e6 / busy_s}
            for name, t in us.most_common(15)
        ],
        "nccl_kernels": [
            {"name": name[:80], "device_ms": t / 1e3, "calls": calls[name]}
            for name, t in us.most_common() if "nccl" in name.lower()
        ],
        "host_self_ms": sum(host_us.values()) / 1e3,
        "top_host_ops": [
            {"name": name[:80], "self_ms": t / 1e3, "calls": host_calls[name]}
            for name, t in host_us.most_common(15)
        ],
        "collective_host_ops": [
            {"name": name[:80], "self_ms": t / 1e3, "calls": host_calls[name]}
            for name, t in host_us.most_common() if name.startswith(COLLECTIVE_OPS)
        ],
    }), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train", action="store_true", help="profile training steps")
    parser.add_argument("--modes", default="",
                        help="with --train: comma-separated mesh modes of the step, "
                             f"of {', '.join(MODES)}, profiled in turn on a one-rank NCCL group")
    args = parser.parse_args()
    modes = [m for m in args.modes.split(",") if m]
    if modes and (not args.train or set(modes) - set(MODES)):
        parser.error(f"--modes takes --train and modes of {MODES}")
    if not torch.cuda.is_available():
        print("profile_torch_serve: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if not modes:
        run, steps = train_run() if args.train else serve_run()
        profile_run(run, steps, "train" if args.train else "serve", card)
        return 0
    import torch.distributed as dist

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="profile_modes_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            for mode in modes:
                run, steps = train_run(mode)
                profile_run(run, steps, f"train {mode}", card)
                del run
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
