"""Host-side loop of the PPO entry scripts; port of
``mmtrl_tpu/algos/ppo/runner.py``.

TensorBoard logging with the reference's names (src/train.py:269-279), SPS
accounting, periodic checkpoints with ``--save-interval``/``--save-dir``/
``--load-from`` (src/utils.py:23-44,103-108), ``--profile``, ``--track``
(the metrics writer's ``wandb_local/`` mirror), ``--capture-video`` (a
greedy episode GIF under ``videos/<run_name>/`` at every checkpoint and at
the end, ``utils/video.py``) and the run journal (``utils/resume.py``:
"running" at the start, "finished" at the end, in ``runs_manifest.jsonl``
of the working directory).  One ``train_iteration`` call per update, of any
algorithm of the package: feedforward and recurrent PPO, PPO + RND, or a
PPG cycle.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from mmtrl_tpu_torch.algos.ppo.core import lr_schedule
from mmtrl_tpu_torch.core.checkpoint import load_run, save_run
from mmtrl_tpu_torch.core.distributed import maybe_initialize_distributed
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.utils.profiling import start_trace
from mmtrl_tpu_torch.utils.resume import journal_run
from mmtrl_tpu_torch.utils.video import capture_video

VIDEO_SEED_OFFSET = 777  # the capture's generator: seed + 777, as in JAX

# (env, step_policy(model, obs, done, carry, generator) -> (action, carry),
#  model_of(runner), initial carry)
VideoSetup = Tuple[Any, Callable, Callable[[Any], Any], Any]

PROFILE_UPDATES = (3, 7)  # --profile traces these updates, both included


def run_training(algo: Any, cfg: Any, args, device: torch.device,
                 run_name: Optional[str] = None,
                 video_setup: Optional[VideoSetup] = None) -> Dict[str, Any]:
    """Drives ``cfg.num_updates`` iterations of ``algo``, which has
    ``init_runner(generator)`` and ``train_iteration(runner)``; the runner
    has ``step`` (optimizer steps), ``stats``, ``payload()`` and
    ``load_payload()``.  ``cfg`` gives ``batch_size`` (env steps per
    iteration), ``num_updates``, ``opt_steps_per_update`` and the learning
    rate's ``anneal_lr`` and ``learning_rate``.  Every metric the iteration
    returns is logged under its own name.  With ``--capture-video`` and a
    ``video_setup``, each checkpoint and the end record a greedy episode
    (``utils/video.py::capture_video``, its draws from a generator seeded
    ``seed + 777``); a script without one ignores the flag, as the JAX
    script does.  Returns a summary dict with the final runner, one row per
    update (wall seconds, SPS, metrics, peak device memory) and the GIFs
    written."""
    maybe_initialize_distributed(device)
    run_name = run_name or f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}"
    writer = MetricsWriter(run_name, args)
    journal_run(run_name, sys.argv, "running")
    videos = []

    def maybe_capture(runner, tag):
        if video_setup is None or not getattr(args, "capture_video", False):
            return
        venv, step_policy, model_of, carry = video_setup
        generator = torch.Generator(device=venv.device).manual_seed(
            args.seed + VIDEO_SEED_OFFSET)
        path = capture_video(venv, step_policy, model_of(runner), run_name, generator,
                             tag=tag, initial_carry=carry)
        print(f"recorded rollout video: {path}")
        videos.append(path)

    if getattr(args, "track", False):
        print(f"tracking to wandb_local/ (the local wandb journal); run: {run_name}")
    schedule = lr_schedule(cfg)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    runner = algo.init_runner(generator)
    initial_update = 1
    if getattr(args, "load_from", ""):
        runner = runner.load_payload(load_run(args.load_from, map_location=device))
        # The update counter comes from the checkpoint itself: optimizer
        # steps over optimizer steps per update (the reference restores
        # initial_update from its pickle, src/utils.py:40-44).
        opt_step = int(runner.step)
        initial_update = opt_step // cfg.opt_steps_per_update + 1
        print(f"resuming at update {initial_update} (opt step {opt_step})")

    cuda = device.type == "cuda"
    global_step = (initial_update - 1) * cfg.batch_size
    start = time.time()
    last_return = 0.0
    history = []
    profiler = None
    for update in range(initial_update, cfg.num_updates + 1):
        if getattr(args, "profile", False) and update == PROFILE_UPDATES[0]:
            profiler = start_trace(f"profiles/{run_name}", cuda)
        t0 = time.perf_counter()
        runner, metrics = algo.train_iteration(runner)
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        if profiler is not None and update == PROFILE_UPDATES[1]:
            profiler.stop()
            profiler = None
            print(f"profiler trace written to profiles/{run_name}")
        global_step += cfg.batch_size

        if update % getattr(args, "print_interval", 1) == 0:
            stats = runner.stats
            metrics = {k: float(v) for k, v in metrics.items()}
            mean_return = float(stats.returned_episode_returns.mean())
            last_return = mean_return
            writer.scalar("charts/episodic_return", mean_return, global_step)
            writer.scalar("charts/mean_episodic_return", float(stats.mean_return), global_step)
            writer.scalar("charts/episodic_length",
                          float(stats.returned_episode_lengths.mean()), global_step)
            # the rate of the update's last optimizer step
            rate = schedule(runner.step - 1) if callable(schedule) else schedule
            writer.scalar("charts/learning_rate", float(rate), global_step)
            writer.scalars(metrics, global_step)
            sps = writer.sps(global_step)
            row = {"update": update, "global_step": global_step, "wall_s": wall, "sps": sps,
                   "episodic_return": mean_return, **metrics}
            if cuda:
                row["max_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            history.append(row)
            print(f"update={update}/{cfg.num_updates} global_step={global_step} "
                  f"episodic_return={mean_return:.2f} SPS={sps:.0f} wall={wall:.3f}s")

        if getattr(args, "save_interval", 0) and update % args.save_interval == 0:
            save_run(runner.payload(), run_name, args.save_dir)
            maybe_capture(runner, f"update_{update}")

    if profiler is not None:
        profiler.stop()
    if getattr(args, "save_interval", 0):
        save_run(runner.payload(), run_name, args.save_dir)
    maybe_capture(runner, "final")
    journal_run(run_name, sys.argv, "finished")
    writer.close()
    elapsed = time.time() - start
    return {
        "run_name": run_name,
        "initial_update": initial_update,
        "global_step": global_step,
        "sps": (global_step - (initial_update - 1) * cfg.batch_size) / max(elapsed, 1e-9),
        "episodic_return": last_return,
        "episode_count": int(runner.stats.episode_count),
        "history": history,
        "runner": runner,
        "videos": videos,
    }
