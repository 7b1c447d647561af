"""Trajectory collection and DT evaluation on the native cartridge envs;
port of ``mmtrl_tpu/algos/dt/hostloop.py``.

The native 2600 pool steps on the host (C++), so the offline phase splits
as the PPO host loop does (``algos/ppo/hostloop.py``):

- host: the pool steps the cartridge; each step's audio is quantised to
  the u8 code (``data/quant.py``) before it crosses to the device
  (``algos/hostpool.py``);
- device, per pool step: the observation (luma, resize and the streaming
  MFCC, ``env._obs``), then the behaviour policy (collection) or the
  return-conditioned DT over its shift-register context (evaluation).
  Only the action batch comes back to the host, and during collection the
  int8 code of the observation for the host dataset.

The ``TrajectoryBuffer`` and the evaluation protocol are those of the
device pipeline (``data.py``, ``evaluate.py``): the same stream-major
layout, masking and conditioning.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmtrl_tpu_torch.algos.dt.data import TrajectoryBuffer, returns_to_go
from mmtrl_tpu_torch.data.quant import OBS_SCALE, quant_obs_i8
from mmtrl_tpu_torch.algos.hostpool import HostPool
from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer, DTConfig


@torch.no_grad()
def collect_trajectories_host(
    env,
    generator: Optional[torch.Generator],
    num_pool_steps: int,
    policy_fn: Optional[Callable] = None,
    policy_carry=None,
    state_dtype: torch.dtype = torch.bfloat16,
    print_every: int = 0,
) -> Tuple[TrajectoryBuffer, Dict[str, float]]:
    """Roll a behaviour policy on a native pool env for ``num_pool_steps``.

    ``policy_fn(generator, obs, done, carry) -> (action, carry)``, the
    contract of ``data.collect_trajectories``; uniform over the actions when
    None.  The dataset accumulates on the host as the int8 code of each
    observation and is dequantised into the buffer on the env's device at
    the end.  Returns ``(buffer, stats)``, stats the behaviour policy's mean
    episodic return over the collection and its episode count."""
    n, device = env.num_envs, env.device
    if policy_fn is None:

        def policy_fn(gen, obs, done, carry):
            return torch.randint(0, env.num_actions, (obs.shape[0],), generator=gen,
                                 device=device), carry

    pool = HostPool(env)
    t_in_ep = np.zeros(n, np.int64)
    feat = int(np.prod(env.observation_space.shape))
    states_h = np.empty((num_pool_steps, n, feat), np.int8)
    actions_h = np.empty((num_pool_steps, n), np.int64)
    rewards_h = np.empty((num_pool_steps, n), np.float32)
    dones_h = np.empty((num_pool_steps, n), np.float32)
    tsteps_h = np.empty((num_pool_steps, n), np.int64)

    carry = policy_carry
    ep_ret = np.zeros(n, np.float64)
    rets: list = []
    for t in range(num_pool_steps):
        obs = pool.obs()
        action_d, carry = policy_fn(generator, obs, pool.done_tensor(), carry)
        states_h[t] = quant_obs_i8(obs.reshape(n, -1)).cpu().numpy()
        action = action_d.cpu().numpy()
        actions_h[t] = action
        tsteps_h[t] = t_in_ep
        rewards_h[t], done, _ = pool.step(action)
        dones_h[t] = done.astype(np.float32)
        ep_ret += rewards_h[t]
        for i in np.nonzero(done)[0]:
            rets.append(float(ep_ret[i]))
            ep_ret[i] = 0.0
        t_in_ep = np.where(done, 0, t_in_ep + 1)
        if print_every and (t + 1) % print_every == 0:
            recent = float(np.mean(rets[-40:])) if rets else float("nan")
            print(f"collect {(t + 1) * n}/{num_pool_steps * n} transitions "
                  f"behavior_return={recent:.2f}", flush=True)

    rtg = returns_to_go(torch.from_numpy(rewards_h), torch.from_numpy(dones_h))

    def stream_major(x) -> torch.Tensor:
        return torch.as_tensor(x).transpose(0, 1).contiguous().to(device)

    timesteps = stream_major(tsteps_h)
    buffer = TrajectoryBuffer(
        states=stream_major(states_h).to(state_dtype) / OBS_SCALE,
        actions=stream_major(actions_h),
        rtg=stream_major(rtg),
        timesteps=timesteps,
        episode_starts=timesteps == 0,
        state_shape=tuple(env.observation_space.shape),
    )
    stats = {
        "behavior/episodic_return": float(np.mean(rets)) if rets else float("nan"),
        "behavior/episodes": float(len(rets)),
    }
    return buffer, stats


def _shift_append(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([buf[:, 1:], x[:, None]], dim=1)


def _clear_done(buf: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    return torch.where(done.view((-1,) + (1,) * (buf.dim() - 1)), torch.zeros_like(buf), buf)


@torch.inference_mode()
def evaluate_dt_host(
    env,
    model_cfg: DTConfig,
    model: DecisionTransformer,
    generator: Optional[torch.Generator],
    target_return: float,
    num_steps: int,
    greedy: bool = True,
    rtg_clip: Optional[float] = None,
) -> Dict[str, float]:
    """Return-conditioned DT evaluation on a native pool env, the protocol
    of ``evaluate.evaluate_dt``: a shift-register context (states kept in
    bf16), the action read from the last state token, the return target
    decremented by each observed reward, the context and target reset at
    episode end, the target capped at ``rtg_clip``.  Each pool step first
    settles the previous transition, then appends the new observation.
    ``generator`` draws the actions when not ``greedy``."""
    K, n, device = model_cfg.context_len, env.num_envs, env.device
    state_shape = tuple(env.observation_space.shape)
    states = torch.zeros((n, K) + state_shape, dtype=torch.bfloat16, device=device)
    actions = torch.zeros((n, K), dtype=torch.long, device=device)
    rtg = torch.zeros((n, K), dtype=torch.float32, device=device)
    timesteps = torch.zeros((n, K), dtype=torch.long, device=device)
    t_in_ep = torch.zeros(n, dtype=torch.long, device=device)
    rt = torch.full((n,), float(target_return), dtype=torch.float32, device=device)
    placeholder = torch.zeros(n, dtype=torch.long, device=device)

    was_training = model.training
    model.eval()
    try:
        pool = HostPool(env)
        reward = np.zeros(n, np.float32)
        ep_ret = np.zeros(n, np.float64)
        ep_len = np.zeros(n, np.int64)
        rets, lens = [], []
        for _ in range(num_steps):
            obs, d = pool.obs(), pool.done_tensor()
            rt = torch.where(d, float(target_return), rt - torch.from_numpy(reward).to(device))
            if rtg_clip is not None:
                rt = rt.clamp(max=rtg_clip)
            t_in_ep = torch.where(d, 0, t_in_ep)
            states = _shift_append(_clear_done(states, d), obs.to(torch.bfloat16))
            rtg = _shift_append(_clear_done(rtg, d), rt)
            timesteps = _shift_append(_clear_done(timesteps, d), t_in_ep)
            prev_actions = _clear_done(actions, d)
            logits = model(rtg, states, _shift_append(prev_actions, placeholder), timesteps)[:, -1]
            if greedy:
                action_d = logits.argmax(dim=-1)
            else:
                action_d = torch.multinomial(logits.softmax(dim=-1), 1, generator=generator)[:, 0]
            actions = _shift_append(prev_actions, action_d)
            t_in_ep = t_in_ep + 1

            reward, done, _ = pool.step(action_d.cpu().numpy())
            ep_ret += reward
            ep_len += 1
            for i in np.nonzero(done)[0]:
                rets.append(float(ep_ret[i]))
                lens.append(int(ep_len[i]))
                ep_ret[i] = 0.0
                ep_len[i] = 0
    finally:
        model.train(was_training)
    return {
        "eval/episodic_return": float(np.mean(rets)) if rets else float("nan"),
        "eval/episodic_length": float(np.mean(lens)) if lens else float("nan"),
        "eval/episodes": float(len(rets)),
    }
