"""Host-loop DQN (and C51) on the native cartridge envs; port of
``mmtrl_tpu/algos/offpolicy/hostloop_dqn.py``.

The split is the PPO host loop's (``algos/ppo/hostloop.py``):

- host: the C++ 2600 pool steps the cartridge and keeps the raw episode
  statistics (``algos/hostpool.py``);
- device, per pool step (``step_fn``): the observation (``env._obs`` of the
  dequantised audio code), the store of the pending int8 transition
  (skipped on the very first call), epsilon-greedy acting, and on the
  cadence the sampled TD update and the target sync.  Only the actions
  come back to the host.

The JAX step is one jitted call with ``lax.cond`` branches; here the two
conditions are host integers, so they are plain branches.  The replay ring
stores int8 observations (``data/quant.py``): a (3, 84, 84) transition pair
in 42 KB, 100k of them in 4.2 GB of device memory.

Cadence: ``train_frequency`` and ``target_network_frequency`` count POOL
steps (``num_envs`` transitions each); updates start once more than
``learning_starts`` transitions are stored.  The pool's single ``done``
(life loss, game over or the step cap) is stored as a true termination,
as the JAX loop does.

The value-learning algorithm is pluggable: ``greedy_fn(model, obs) ->
actions`` and ``update_fn(ts, batch) -> (ts, loss, q_mean)`` default to
DQN's argmax-Q and ``dqn_td_update``; ``scripts/c51_rom.py`` passes C51's.
A resume (``--load-from``) restores the parameters, the target and the
Adam state; the replay ring restarts cold at ``global_step`` 0.  The run
journals "running" and "finished" to ``runs_manifest.jsonl``
(``utils/resume.py``) as the JAX loop does; ``--track`` mirrors the metrics
to ``wandb_local/``, and ``--capture-video`` is accepted and ignored, as
in JAX.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mmtrl_tpu_torch.algos.hostpool import HostPool
from mmtrl_tpu_torch.algos.offpolicy.common import StepDraws, linear_epsilon
from mmtrl_tpu_torch.algos.offpolicy.dqn import (
    DQNConfig,
    DQNTrainState,
    argmax_q,
    create_dqn_state,
    dqn_td_update,
    sync_target,
)
from mmtrl_tpu_torch.core.checkpoint import load_run, save_run
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.data.buffers import ReplayBuffer
from mmtrl_tpu_torch.data.quant import dequant_obs_i8, quant_obs_i8
from mmtrl_tpu_torch.utils.resume import journal_run

GreedyFn = Callable[[nn.Module, torch.Tensor], torch.Tensor]
UpdateFn = Callable[[DQNTrainState, Dict[str, torch.Tensor]],
                    Tuple[DQNTrainState, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class DQNHostRunner:
    train_state: DQNTrainState
    buffer: ReplayBuffer
    pending_obs: torch.Tensor  # (N, C, H, W) obs at t, waiting for (r, obs')
    generator: torch.Generator
    global_step: int = 0  # env transitions stored


class DQNHostLoop(NamedTuple):
    init_runner: Callable[[torch.Generator], DQNHostRunner]
    step_fn: Callable[..., Tuple[DQNHostRunner, torch.Tensor, Dict[str, Any]]]
    act_greedy: Callable[[nn.Module, torch.Tensor], torch.Tensor]


def make_dqn_hostloop(env, model: nn.Module, cfg: DQNConfig, greedy_fn: Optional[GreedyFn] = None,
                      update_fn: Optional[UpdateFn] = None, adam_eps: float = 1e-8
                      ) -> DQNHostLoop:
    """``env`` is a native pool (``num_envs``, ``observation_space``, ``_obs``
    on ``env.device``); ``model`` the Q network on that device, its
    parameters already initialised."""
    n, device = env.num_envs, env.device
    obs_shape = tuple(env.observation_space.shape)
    greedy_fn = greedy_fn or argmax_q
    if update_fn is None:
        def update_fn(ts, batch):
            ts, loss, q_mean, _ = dqn_td_update(cfg.gamma, ts, batch)
            return ts, loss, q_mean

    def init_runner(generator: torch.Generator) -> DQNHostRunner:
        zeros = torch.zeros((n,) + obs_shape, device=device)
        example = dict(
            obs=quant_obs_i8(zeros[0]),
            action=torch.zeros((), dtype=torch.long, device=device),
            reward=torch.zeros((), device=device),
            next_obs=quant_obs_i8(zeros[0]),
            done=torch.zeros((), device=device),
        )
        return DQNHostRunner(
            train_state=create_dqn_state(model, cfg.learning_rate, adam_eps),
            buffer=ReplayBuffer.create(example, cfg.buffer_size),
            pending_obs=zeros,
            generator=generator,
        )

    def step_fn(runner: DQNHostRunner, obs: torch.Tensor, reward: np.ndarray, done: np.ndarray,
                prev_action: np.ndarray, store: bool, draws: Optional[StepDraws] = None):
        """One pool step from the observation after the pool's last step,
        its reward and done, and the actions that led there."""
        if store:
            runner.buffer.add_batch(dict(
                obs=quant_obs_i8(runner.pending_obs),
                action=torch.as_tensor(prev_action, device=device).long(),
                reward=torch.as_tensor(reward, device=device).float(),
                next_obs=quant_obs_i8(obs),
                done=torch.as_tensor(done, device=device).float(),
            ), n)
        gs = runner.global_step + (n if store else 0)
        pool_t = gs // n
        eps = linear_epsilon(cfg.start_e, cfg.end_e,
                             cfg.exploration_fraction * cfg.total_timesteps, gs)
        ts = runner.train_state
        with torch.no_grad():
            greedy = greedy_fn(ts.model, obs)
        gen = runner.generator
        if draws is None:
            draws = StepDraws(
                torch.randint(0, env.num_actions, (n,), generator=gen, device=device),
                torch.rand(n, generator=gen, device=device), None)
        action = torch.where(draws.explore_u.to(device) < eps, draws.random_action.to(device),
                             greedy)

        trained = gs > cfg.learning_starts and pool_t % cfg.train_frequency == 0
        loss = q_mean = None
        if trained:
            batch = runner.buffer.sample(gen, cfg.batch_size, draws.sample_idx)
            batch["obs"] = dequant_obs_i8(batch["obs"])
            batch["next_obs"] = dequant_obs_i8(batch["next_obs"])
            ts, loss, q_mean = update_fn(ts, batch)
        synced = pool_t % cfg.target_network_frequency == 0
        if synced:
            sync_target(ts, cfg.tau)
        runner = dataclasses.replace(runner, train_state=ts, pending_obs=obs, global_step=gs)
        return runner, action, dict(td_loss=loss, q_values=q_mean, epsilon=float(eps),
                                    trained=trained, synced=synced)

    @torch.no_grad()
    def act_greedy(net: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        return greedy_fn(net, obs)

    return DQNHostLoop(init_runner, step_fn, act_greedy)


def run_dqn_hostloop(env, model: nn.Module, cfg: DQNConfig, args, device: torch.device,
                     run_name: Optional[str] = None, eval_steps: int = 0,
                     greedy_fn: Optional[GreedyFn] = None, update_fn: Optional[UpdateFn] = None,
                     adam_eps: float = 1e-8) -> Dict[str, Any]:
    """Trains ``model`` on the pool ``env`` for ``cfg.total_timesteps``
    transitions, then, with ``eval_steps``, evaluates greedily for at least
    the episode cap plus 100 pool steps.  Returns a summary: the run name,
    the final runner, transitions, pool steps, updates, target syncs, the
    training wall and the emulator's share, the last update's TD loss and
    mean Q, and the evaluation's statistics."""
    run_name = run_name or f"{env.name}__{args.exp_name}__{args.seed}__{int(time.time())}"
    writer = MetricsWriter(run_name, args)
    journal_run(run_name, sys.argv, "running")
    n = env.num_envs
    loop = make_dqn_hostloop(env, model, cfg, greedy_fn, update_fn, adam_eps)
    runner = loop.init_runner(torch.Generator(device=device).manual_seed(args.seed))
    if getattr(args, "load_from", ""):
        runner.train_state.load_payload(load_run(args.load_from, map_location=device))
        print(f"resumed train state from {args.load_from}", flush=True)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    pool = HostPool(env)
    reward = np.zeros(n, np.float32)
    action_np = np.zeros(n, np.int64)
    store = False
    ep_ret = np.zeros(n, np.float64)
    recent: list = []
    recent_score: list = []
    gs = pool_i = updates = syncs = 0
    last_update: Dict[str, float] = {}
    print_every = max(1, getattr(args, "print_interval", 1)) * 50
    start = time.perf_counter()
    while gs < cfg.total_timesteps:
        runner, action, metrics = loop.step_fn(runner, pool.obs(), reward, pool.done, action_np,
                                               store)
        store = True
        updates += metrics["trained"]
        syncs += metrics["synced"]
        if metrics["trained"]:
            last_update = {"td_loss": metrics["td_loss"], "q_values": metrics["q_values"]}
        action_np = action.cpu().numpy()
        reward, done, score = pool.step(action_np)
        ep_ret += reward
        for i in np.nonzero(done)[0]:
            recent.append(float(ep_ret[i]))
            recent_score.append(int(score[i]))
            ep_ret[i] = 0.0
        gs += n
        pool_i += 1
        if pool_i % print_every == 0:
            ret = float(np.mean(recent[-40:])) if recent else float("nan")
            if recent:
                writer.scalar("charts/episodic_return", ret, gs)
            line = f"pool_step={pool_i} global_step={gs} episodic_return={ret:.2f} "
            if last_update:
                last_update = {k: float(v) for k, v in last_update.items()}
                writer.scalars({f"losses/{k}": v for k, v in last_update.items()}, gs)
                line += f"q={last_update['q_values']:.2f} "
            print(line + f"score={np.mean(recent_score[-40:]) if recent_score else 0:.2f} "
                  f"eps={metrics['epsilon']:.3f} SPS={writer.sps(gs):.0f}", flush=True)
        if getattr(args, "save_interval", 0) and pool_i % (args.save_interval * 50) == 0:
            # the replay ring stays on the device; the train state is saved
            save_run(runner.train_state.payload(), run_name, args.save_dir)
    sync()
    train_s = time.perf_counter() - start

    if getattr(args, "save_interval", 0):
        # the final save comes before the evaluation, which may be cut short
        save_run(runner.train_state.payload(), run_name, args.save_dir)
    result: Dict[str, Any] = {
        "run_name": run_name, "runner": runner, "global_step": gs, "pool_steps": pool_i,
        "updates": updates, "target_syncs": syncs, "train_s": train_s,
        "emulator_s": pool.host_s,
        "episodic_return": float(np.mean(recent[-40:])) if recent else 0.0,
        "episodes": len(recent),
        **{k: float(v) for k, v in last_update.items()},
    }
    if eval_steps:
        # A surviving policy ends episodes only at the step cap: floor the
        # window at the cap plus a margin.
        eval_pool_steps = max(eval_steps, getattr(env, "episode_steps", 0) + 100)
        pool = HostPool(env)
        ep_ret = np.zeros(n, np.float64)
        ev_rets, ev_scores = [], []
        t0 = time.perf_counter()
        for _ in range(eval_pool_steps):
            a = loop.act_greedy(runner.train_state.model, pool.obs()).cpu().numpy()
            r, done, score = pool.step(a)
            ep_ret += r
            for i in np.nonzero(done)[0]:
                ev_rets.append(float(ep_ret[i]))
                ev_scores.append(int(score[i]))
                ep_ret[i] = 0.0
        result["eval_s"] = time.perf_counter() - t0
        result["eval_pool_steps"] = eval_pool_steps
        if ev_rets:
            result.update(eval_episodic_return=float(np.mean(ev_rets)),
                          eval_score=float(np.mean(ev_scores)), eval_episodes=len(ev_rets))
            writer.scalar("eval/episodic_return", result["eval_episodic_return"], gs)
            print(f"final greedy eval: return={result['eval_episodic_return']:.2f} "
                  f"score={result['eval_score']:.2f} over {len(ev_rets)} episodes")
    journal_run(run_name, sys.argv, "finished")
    writer.close()
    return result
