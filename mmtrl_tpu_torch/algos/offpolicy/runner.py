"""Host side of the fused off-policy trainers (DQN, C51, DDPG, TD3, SAC); port of
``mmtrl_tpu/algos/offpolicy/runner.py``.

One ``train_iteration`` call per iteration; TensorBoard logging with the
reference's names (``charts/episodic_return``, ``charts/mean_episodic_return``,
``charts/episodic_length``, the iteration's ``losses/*``, ``charts/SPS``),
periodic checkpoints of the whole runner (``--save-interval``,
``--save-dir``) and ``--load-from``, and a final greedy evaluation
(``utils/evaluate.py::evaluate_actions``, 16 envs x 1,000 steps).  The
resumed run takes its iteration counter from the runner's global step,
``global_step // (total_timesteps // num_iterations) + 1``.  The run
journals "running" and "finished" to ``runs_manifest.jsonl``
(``utils/resume.py``) as the JAX runner does; ``--track`` mirrors the
metrics to ``wandb_local/``, and ``--capture-video`` is accepted and
ignored, as in JAX.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch.core.checkpoint import load_run, save_run
from mmtrl_tpu_torch.core.distributed import maybe_initialize_distributed
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.utils.evaluate import evaluate_actions
from mmtrl_tpu_torch.utils.resume import journal_run

EVAL_SEED_OFFSET = 10_000  # the evaluation's generator: seed + 10,000, as in JAX

# (env, act_fn(module, obs) -> action, module_of(train_state))
EvalSetup = Tuple[Any, Callable[[nn.Module, torch.Tensor], torch.Tensor],
                  Callable[[Any], nn.Module]]


def run_offpolicy(algo: Any, cfg: Any, args, device: torch.device,
                  run_name: Optional[str] = None,
                  eval_setup: Optional[EvalSetup] = None) -> Dict[str, Any]:
    """Drives ``cfg.num_iterations`` iterations of ``algo`` (``init_runner``,
    ``train_iteration``).  Returns a summary: the run name, the first
    iteration run, the global step, the last logged return, the final
    runner, one row per logged iteration (wall seconds, SPS, the metrics,
    peak device memory) and, with ``eval_setup``, the greedy evaluation."""
    maybe_initialize_distributed(device)
    run_name = run_name or f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}"
    writer = MetricsWriter(run_name, args)
    journal_run(run_name, sys.argv, "running")
    runner = algo.init_runner(torch.Generator(device=device).manual_seed(args.seed))
    initial_it = 1
    if getattr(args, "load_from", ""):
        runner = runner.load_payload(load_run(args.load_from, map_location=device))
        steps_per_it = max(1, cfg.total_timesteps // cfg.num_iterations)
        initial_it = runner.global_step // steps_per_it + 1
        print(f"resuming at iteration {initial_it}")

    cuda = device.type == "cuda"
    last_return = 0.0
    history = []
    for it in range(initial_it, cfg.num_iterations + 1):
        t0 = time.perf_counter()
        runner, metrics = algo.train_iteration(runner)
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        global_step = runner.global_step
        if it % getattr(args, "print_interval", 1) == 0:
            stats = runner.stats
            metrics = {k: float(v) for k, v in metrics.items()}
            last_return = float(stats.returned_episode_returns.mean())
            writer.scalar("charts/episodic_return", last_return, global_step)
            writer.scalar("charts/mean_episodic_return", float(stats.mean_return), global_step)
            writer.scalar("charts/episodic_length",
                          float(stats.returned_episode_lengths.mean()), global_step)
            writer.scalars(metrics, global_step)
            sps = writer.sps(global_step)
            row = {"iteration": it, "global_step": global_step, "wall_s": wall, "sps": sps,
                   "episodic_return": last_return, **metrics}
            if cuda:
                row["max_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            history.append(row)
            print(f"iter={it}/{cfg.num_iterations} global_step={global_step} "
                  f"episodic_return={last_return:.2f} SPS={sps:.0f} wall={wall:.3f}s")
        if getattr(args, "save_interval", 0) and it % args.save_interval == 0:
            save_run(runner.payload(), run_name, args.save_dir)

    if getattr(args, "save_interval", 0):
        save_run(runner.payload(), run_name, args.save_dir)
    result: Dict[str, Any] = {
        "run_name": run_name, "initial_iteration": initial_it,
        "global_step": runner.global_step, "episodic_return": last_return,
        "runner": runner, "history": history,
    }
    if eval_setup is not None:
        env, act_fn, module_of = eval_setup
        module = module_of(runner.train_state)
        t0 = time.perf_counter()
        ev = evaluate_actions(
            env, lambda obs: act_fn(module, obs),
            torch.Generator(device=device).manual_seed(args.seed + EVAL_SEED_OFFSET))
        ev = {k: float(v) for k, v in ev.items()}
        result["eval_s"] = time.perf_counter() - t0
        writer.scalar("eval/episodic_return", ev["eval/episodic_return"], result["global_step"])
        print(f"final greedy eval: return={ev['eval/episodic_return']:.2f} "
              f"over {ev['eval/episodes']:.0f} episodes")
        result["eval_episodic_return"] = ev["eval/episodic_return"]
        result["eval_episodes"] = ev["eval/episodes"]
    journal_run(run_name, sys.argv, "finished")
    writer.close()
    return result
