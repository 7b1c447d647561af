"""Host-loop off-policy training: host envs, updates on the card; port of
``mmtrl_tpu/algos/offpolicy/hostloop.py``.

MuJoCo runs on the host (``envs/gym_bridge.py::GymPool``), so the loop is
split as the reference's torch scripts split it
(cleanrl/sac_continuous_action.py's rollout loop), with every update on
the card:

- host: the gymnasium envs through the pool's ``_host_reset`` and
  ``_host_step``, the behaviour actions from a CPU copy of the actor, and
  the raw episode statistics;
- card: the replay buffer and the update cadence.  A chunk of
  ``chunk_size`` steps of transitions crosses to the card in one copy,
  and the algorithm's ``chunk_fn`` runs ``insert_update`` (the code the
  fused loop runs after its env step) on each step in order.

Against the reference, the update math, the update:data ratio, the buffer
contents and the cadences (``policy_frequency`` and the rest) are the
same.  The one deviation is the behaviour policy's staleness: the actions
of a chunk come from the actor's parameters at the end of the previous
chunk (up to ``chunk_size`` env steps old, 64 by default), which are
fetched from the card once a chunk; the warmup's uniform actions
(``np.random.default_rng(seed)``) are unaffected.

A resume (``--load-from``) restores the whole runner: networks, Adam
states, replay buffer, global step and generator.  The host envs restart
from their seeds and the warmup and exploration streams from theirs, as
in JAX.  The run journals "running" and "finished" to
``runs_manifest.jsonl`` (``utils/resume.py``) as the JAX loop does;
``--track`` mirrors the metrics to ``wandb_local/``, and
``--capture-video`` is accepted and ignored, as in JAX.
"""

from __future__ import annotations

import copy
import math
import sys
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parameters_to_vector, vector_to_parameters

from mmtrl_tpu_torch.algos.offpolicy.ddpg import ContinuousDraws
from mmtrl_tpu_torch.algos.offpolicy.runner import EVAL_SEED_OFFSET
from mmtrl_tpu_torch.core.checkpoint import load_run, save_run
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.utils.resume import journal_run


class SpecEnv:
    """The shapes and spaces of a host pool, handed to the algorithm
    factories: ``reset`` gives zeros on ``device`` (the runner's initial
    observation, which the host loop never reads); ``step`` raises, as the
    host loop trains through ``chunk_fn``."""

    def __init__(self, pool, num_envs: int, device: torch.device):
        self.observation_space = pool.observation_space
        self.action_space = pool.action_space
        self.num_envs = num_envs
        self.name = pool.name
        self.device = device

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        obs = torch.zeros((num_envs,) + tuple(self.observation_space.shape), device=self.device)
        return obs, torch.zeros(num_envs, dtype=torch.int32, device=self.device)

    def step(self, state, action, generator=None):
        raise NotImplementedError("the host loop never steps the SpecEnv")


class HostLoopDraws(NamedTuple):
    """A test's replacement of the host loop's draws, to replay another
    implementation's: ``explore_noise()`` the next exploring step's
    ``(num_envs, *action_shape)`` standard normals; ``chunk()`` the next
    chunk's ``ContinuousDraws``, one a step, for ``chunk_fn``."""

    explore_noise: Callable[[], torch.Tensor]
    chunk: Callable[[], Sequence[ContinuousDraws]]


def host_greedy_eval(pool_cls, env_id: str, act: Callable[[torch.Tensor], torch.Tensor],
                     episodes: int, seed: int) -> float:
    """Greedy rollouts on a fresh pool of one host env until ``episodes``
    end; the mean raw return.  ``act(obs) -> action`` on CPU tensors."""
    pool = pool_cls(env_id, 1, seed=seed, device="cpu")
    obs = pool._host_reset()
    rets, cur = [], 0.0
    while len(rets) < episodes:
        with torch.no_grad():
            a = act(torch.from_numpy(obs)).numpy()
        obs, _f, _r, raw_r, done, _t = pool._host_step(a)
        cur += float(raw_r[0])
        if done[0]:
            rets.append(cur)
            cur = 0.0
    pool.close()
    return float(np.mean(rets))


def run_offpolicy_hostloop(factory, pool, actor_model: nn.Module,
                           critic_models: Sequence[nn.Module], cfg, args, device: torch.device,
                           run_name: Optional[str] = None,
                           eval_episodes: int = 20,
                           draws: Optional[HostLoopDraws] = None) -> Dict[str, Any]:
    """Trains through ``factory(env, actor, *critics, cfg)`` (``make_ddpg``,
    ``make_td3``, ``make_sac``) on the host ``pool`` (its ``_host_reset``
    and ``_host_step``) for ``cfg.total_timesteps`` env steps, rounded up to
    whole chunks, with the networks on ``device``; then saves (with
    ``--save-interval``) and evaluates greedily over ``eval_episodes``
    episodes of a fresh pool of the same class.  Returns a summary: the run
    name, the final runner, the global step, chunks, the last logged
    return, episodes, each chunk's (host seconds: envs and behaviour
    actions; card seconds: the copy to the card, ``chunk_fn`` and the
    parameters' fetch), and the evaluation's return."""
    run_name = run_name or f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}"
    writer = MetricsWriter(run_name, args)
    journal_run(run_name, sys.argv, "running")

    n = cfg.num_envs
    chunk = int(getattr(args, "chunk_size", 64))
    algo = factory(SpecEnv(pool, n, device), actor_model, *critic_models, cfg)
    runner = algo.init_runner(torch.Generator(device=device).manual_seed(args.seed))
    if getattr(args, "load_from", ""):
        runner = runner.load_payload(load_run(args.load_from, map_location=device))
        print(f"resuming at global_step {runner.global_step}")

    # the behaviour actor: a CPU copy, its parameters fetched in one copy
    cpu_actor = copy.deepcopy(algo.actor_module(runner.train_state)).to("cpu").requires_grad_(False)
    cpu_space = algo.space.to("cpu")

    def fetch_params():
        vec = parameters_to_vector(algo.actor_module(runner.train_state).parameters())
        vector_to_parameters(vec.detach().cpu(), cpu_actor.parameters())

    fetch_params()
    act_gen = torch.Generator().manual_seed(args.seed + 1)
    rng = np.random.default_rng(args.seed)
    a_low = np.asarray(pool.action_space.low, np.float32)
    a_high = np.asarray(pool.action_space.high, np.float32)
    a_shape = tuple(pool.action_space.shape)
    obs_shape = tuple(pool.observation_space.shape)

    # one host array a chunk, (chunk, n, obs | next_obs | action | reward | done)
    ow, aw = math.prod(obs_shape), math.prod(a_shape)
    host = np.empty((chunk, n, 2 * ow + aw + 2), np.float32)
    t_obs, t_nobs = host[..., :ow], host[..., ow:2 * ow]
    t_act, t_rew, t_done = host[..., 2 * ow:2 * ow + aw], host[..., -2], host[..., -1]

    obs = pool._host_reset()
    ep_ret = np.zeros(n)
    recent: list = []
    gs = runner.global_step
    print_every_steps = max(1, getattr(args, "print_interval", 1)) * getattr(
        cfg, "steps_per_iteration", 512)
    next_print = gs + print_every_steps
    chunk_i = 0
    last_return = 0.0
    walls = []  # per chunk: (host seconds, the chunk's seconds on the card)
    while gs < cfg.total_timesteps:
        t0 = time.perf_counter()
        for t in range(chunk):
            if gs < cfg.learning_starts:
                action = rng.uniform(a_low, a_high, (n,) + a_shape).astype(np.float32)
            else:
                noise = (draws.explore_noise() if draws is not None
                         else torch.randn((n,) + a_shape, generator=act_gen))
                with torch.no_grad():
                    action = algo.act_explore(cpu_actor, torch.from_numpy(obs), noise,
                                              cpu_space).numpy()
            nobs, final_obs, rew, raw_rew, done, trunc = pool._host_step(action)
            t_obs[t] = obs.reshape(n, ow)
            t_act[t] = action.reshape(n, aw)
            t_rew[t] = rew
            # SB3 handle_timeout_termination: done excludes time-limit
            # truncation; next_obs is the TRUE post-transition observation
            t_done[t] = done.astype(bool) & ~trunc.astype(bool)
            t_nobs[t] = np.where(done[:, None], final_obs.reshape(n, ow), nobs.reshape(n, ow))
            ep_ret += raw_rew
            for i in np.nonzero(done)[0]:
                recent.append(float(ep_ret[i]))
                ep_ret[i] = 0.0
            obs = nobs
            gs += n
        t1 = time.perf_counter()
        dev = torch.from_numpy(host).to(device)
        transitions = dict(obs=dev[..., :ow].reshape((chunk, n) + obs_shape),
                           action=dev[..., 2 * ow:2 * ow + aw].reshape((chunk, n) + a_shape),
                           reward=dev[..., -2],
                           next_obs=dev[..., ow:2 * ow].reshape((chunk, n) + obs_shape),
                           done=dev[..., -1])
        runner, metrics = algo.chunk_fn(runner, transitions,
                                        None if draws is None else draws.chunk())
        fetch_params()  # the sync point: the behaviour policy is at most a chunk stale
        t2 = time.perf_counter()
        walls.append((t1 - t0, t2 - t1))
        chunk_i += 1
        if gs >= next_print:
            next_print += print_every_steps
            if recent:
                last_return = float(np.mean(recent[-20:]))
                writer.scalar("charts/episodic_return", last_return, gs)
            writer.scalars({k: float(v) for k, v in metrics.items()}, gs)
            sps = writer.sps(gs)
            print(f"chunk={chunk_i} global_step={gs} episodic_return={last_return:.2f} "
                  f"SPS={sps:.0f}")
        if getattr(args, "save_interval", 0) and chunk_i % args.save_interval == 0:
            save_run(runner.payload(), run_name, args.save_dir)

    if getattr(args, "save_interval", 0):
        save_run(runner.payload(), run_name, args.save_dir)
    result: Dict[str, Any] = {
        "run_name": run_name, "runner": runner, "global_step": gs, "chunks": chunk_i,
        "episodic_return": last_return, "episodes": len(recent), "chunk_walls": walls,
    }
    ev = host_greedy_eval(type(pool), args.env_id,
                          lambda o: algo.act_greedy(cpu_actor, o, cpu_space), eval_episodes,
                          args.seed + EVAL_SEED_OFFSET)
    writer.scalar("eval/episodic_return", ev, gs)
    print(f"final greedy eval: return={ev:.2f} over {eval_episodes} episodes")
    result["eval_episodic_return"] = ev
    journal_run(run_name, sys.argv, "finished")
    writer.close()
    pool.close()
    return result
