"""Host-loop recurrent PPO for the native (host-stepped) envs, the ROM
path; port of ``mmtrl_tpu/algos/ppo/hostloop.py``.

- host: the C++ 2600 pool steps the cartridge and returns raw (frame,
  stereo audio) batches and reward components; the audio is quantised to
  its u8 code (``data/quant.py``) before it crosses to the device;
- device, per pool step: the observation (``env._obs`` of the dequantised
  code), the recurrent policy step and the rollout buffer write; only the
  sampled actions come back (``algos/hostpool.py``);
- device, per update: the value bootstrap, GAE and the recurrent PPO
  update of ``make_recurrent_ppo(...).update_from_rollout``, the function
  the Minecraft2d runs use.

One ``torch.Generator`` on the device, seeded from ``--seed``, draws the
actions and the update's permutations.  ``--save-interval`` saves the
runner's payload (``core/checkpoint.py``); ``--load-from`` restores it and
resumes at the update after the saved one, with the pool freshly reset, as
the JAX loop does.  The step's reward is the env's ``_reward``, already
host numpy (the JAX loop mirrors its jnp ``_reward`` in
``_shaped_reward_np``).  The run journals "running" and "finished" to
``runs_manifest.jsonl`` (``utils/resume.py``) as the JAX loop does;
``--track`` mirrors the metrics to ``wandb_local/``, and
``--capture-video`` is accepted and ignored, as in JAX.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmtrl_tpu_torch.algos.ppo.core import PPOConfig, _maybe_clip, make_recurrent_ppo
from mmtrl_tpu_torch.core.checkpoint import load_run, save_run
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.utils.resume import journal_run
from mmtrl_tpu_torch.algos.hostpool import HostPool, slot_count


class _SpecEnv:
    """The spaces of a native env and an all-zeros reset: what
    ``make_recurrent_ppo``'s ``init_runner`` reads.  The host loop never
    steps it."""

    def __init__(self, env):
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.num_actions = env.num_actions
        self.name = env.name
        self.device = env.device

    def reset(self, num_envs: int, generator=None):
        obs = torch.zeros((num_envs,) + tuple(self.observation_space.shape), device=self.device)
        return obs, None


def run_recurrent_ppo_hostloop(env, model, cfg: PPOConfig, args, device: torch.device,
                               run_name: Optional[str] = None,
                               eval_steps: int = 0) -> Dict[str, Any]:
    """Trains ``model`` (a ``MultimodalRecurrentAgent`` on ``device``) on the
    pool ``env`` (``_host_reset``, ``_host_step``, ``_obs`` on ``device``;
    ``cfg.num_envs`` rows, a two-player pool's agent slots) for
    ``cfg.num_updates`` updates, then, with ``eval_steps``, runs that
    many greedy pool steps.  Returns a summary with the final runner, one
    row per update (wall, rollout and update seconds, emulator seconds,
    SPS, metrics) and the evaluation's statistics."""
    run_name = run_name or f"{env.name}__{args.exp_name}__{args.seed}__{int(time.time())}"
    writer = MetricsWriter(run_name, args)
    journal_run(run_name, sys.argv, "running")
    n, t_len = cfg.num_envs, cfg.num_steps
    if slot_count(env) != n:
        raise ValueError(f"the pool steps {slot_count(env)} rows (envs or agent slots), "
                         f"the config {n}")
    parts = make_recurrent_ppo(_SpecEnv(env), model, cfg)
    rs = parts.init_runner(torch.Generator(device=device).manual_seed(args.seed))
    initial_update = 1
    if getattr(args, "load_from", ""):
        rs = rs.load_payload(load_run(args.load_from, map_location=device))
        opt_step = int(rs.step)
        initial_update = opt_step // max(1, cfg.opt_steps_per_update) + 1
        print(f"resuming at update {initial_update} (opt step {opt_step})")

    obs_shape = tuple(env.observation_space.shape)
    buf_obs = torch.zeros((t_len, n) + obs_shape, device=device)
    buf_actions = torch.zeros((t_len, n), dtype=torch.long, device=device)
    buf_logprobs, buf_values = (torch.zeros((t_len, n), device=device) for _ in range(2))
    buf_dones = torch.zeros((t_len, n), dtype=torch.bool, device=device)
    rewards_np = np.empty((t_len, n), np.float32)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    pool = HostPool(env)
    ep_ret = np.zeros(n, np.float64)
    recent: list = []
    recent_kills: list = []
    history = []
    start = time.time()
    gs = (initial_update - 1) * n * t_len
    for update in range(initial_update, cfg.num_updates + 1):
        t0, host0 = time.perf_counter(), pool.host_s
        initial_carry = rs.carry
        carry = rs.carry
        for t in range(t_len):
            obs, prev_done = pool.obs(), pool.done_tensor()
            action, logprob, value, carry = parts.policy_step(rs.model, obs, prev_done, carry,
                                                              rs.generator)
            buf_obs[t], buf_actions[t], buf_logprobs[t] = obs, action, logprob
            buf_dones[t], buf_values[t] = prev_done, value
            reward, done, kills = pool.step(action.cpu().numpy())
            rewards_np[t] = reward
            ep_ret += reward
            for i in np.nonzero(done)[0]:
                recent.append(float(ep_ret[i]))
                recent_kills.append(int(kills[i]))
                ep_ret[i] = 0.0
            gs += n
        sync()
        t1 = time.perf_counter()
        rs = dataclasses.replace(rs, obs=pool.obs(), done=pool.done_tensor(), carry=carry)
        rewards = _maybe_clip(cfg, torch.from_numpy(rewards_np).to(device))
        rollout = (buf_obs, buf_actions, buf_logprobs, rewards, buf_dones, buf_values)
        rs, metrics = parts.update_from_rollout(rs, initial_carry, rollout)
        sync()
        t2 = time.perf_counter()
        row = {"update": update, "global_step": gs, "wall_s": t2 - t0, "rollout_s": t1 - t0,
               "update_s": t2 - t1, "emulator_s": pool.host_s - host0}
        if update % getattr(args, "print_interval", 1) == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            ret = float(np.mean(recent[-40:])) if recent else float("nan")
            kills_mean = float(np.mean(recent_kills[-40:])) if recent_kills else 0.0
            if recent:
                writer.scalar("charts/episodic_return", ret, gs)
                writer.scalar("charts/episodic_kills", kills_mean, gs)
            writer.scalars(metrics, gs)
            sps = writer.sps(gs)
            row.update(sps=sps, episodic_return=ret, **metrics)
            if device.type == "cuda":
                row["max_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            print(f"update={update}/{cfg.num_updates} global_step={gs} "
                  f"episodic_return={ret:.2f} kills={kills_mean:.2f} SPS={sps:.0f} "
                  f"wall={row['wall_s']:.3f}s", flush=True)
        history.append(row)
        if getattr(args, "save_interval", 0) and update % args.save_interval == 0:
            save_run(rs.payload(), run_name, args.save_dir)

    if getattr(args, "save_interval", 0):
        save_run(rs.payload(), run_name, args.save_dir)
    result: Dict[str, Any] = {
        "run_name": run_name,
        "initial_update": initial_update,
        "global_step": gs,
        "episodic_return": float(np.mean(recent[-40:])) if recent else 0.0,
        "history": history,
        "runner": rs,
        "train_s": time.time() - start,
    }
    if eval_steps:
        result.update(greedy_evaluation(env, rs.model, eval_steps, device))
        if "eval_episodic_return" in result:
            writer.scalar("eval/episodic_return", result["eval_episodic_return"], gs)
            print(f"final greedy eval: return={result['eval_episodic_return']:.2f} "
                  f"kills={result['eval_kills']:.2f} over {result['eval_episodes']} episodes")
    journal_run(run_name, sys.argv, "finished")
    writer.close()
    return result


@torch.no_grad()
def greedy_evaluation(env, model, steps: int, device: torch.device) -> Dict[str, float]:
    """``steps`` greedy pool steps from a fresh reset (later episodes follow
    from the pool's auto-reset): the mean return and kills of the episodes
    that end, and their count."""
    pool = HostPool(env)
    n = slot_count(env)
    carry = model.initial_carry(n, device)
    ep_ret = np.zeros(n, np.float64)
    rets, kills_done = [], []
    for _ in range(steps):
        logits, _, carry = model(pool.obs()[None], pool.done_tensor()[None], carry)
        reward, done, kills = pool.step(logits[0].argmax(dim=-1).cpu().numpy())
        ep_ret += reward
        for i in np.nonzero(done)[0]:
            rets.append(float(ep_ret[i]))
            kills_done.append(int(kills[i]))
            ep_ret[i] = 0.0
    if not rets:
        return {}
    return {"eval_episodic_return": float(np.mean(rets)), "eval_kills": float(np.mean(kills_done)),
            "eval_episodes": len(rets)}
