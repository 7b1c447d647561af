"""Decision-transformer evaluation on the device; port of
``mmtrl_tpu/algos/dt/evaluate.py``.

Rolls the DT in the batched env conditioned on a target return, the
published DT protocol: shift-register context windows of (rtg, state,
action), the next action predicted from the last state token, the return
target decremented by each observed reward.  A Python loop takes the place
of ``lax.scan``; the tensors stay on the device throughout.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.core.metrics import EpisodeStatistics
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer, DTConfig


def _shift_append(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([buf[:, 1:], x[:, None]], dim=1)


def _clear_done(buf: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    return torch.where(done.view((-1,) + (1,) * (buf.dim() - 1)), 0, buf)


@torch.inference_mode()
def evaluate_dt(
    env: Environment,
    cfg: DTConfig,
    model: DecisionTransformer,
    target_return: float,
    num_envs: int = 16,
    num_steps: int = 64,
    greedy: bool = True,
    rtg_clip: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """``rtg_clip`` bounds the running return-to-go to the training data's
    support: with negative step rewards ``target - sum(r)`` otherwise climbs
    past any value seen in training.  ``generator`` drives the env's reset
    draws and, when not greedy, the action samples."""
    device = resolve_device(device)
    if env.device != device:
        raise ValueError(f"env is on {env.device}, evaluation on {device}")
    was_training = model.training
    model.eval()
    try:
        return _rollout(env, cfg, model, target_return, num_envs, num_steps, greedy,
                        rtg_clip, generator, device)
    finally:
        model.train(was_training)  # the caller's mode, also when the rollout raises


def _rollout(env, cfg, model, target_return, num_envs, num_steps, greedy, rtg_clip,
             generator, device) -> Dict[str, torch.Tensor]:
    K = cfg.context_len

    obs, env_state = env.reset(num_envs, generator)
    states = torch.zeros((num_envs, K) + obs.shape[1:], dtype=obs.dtype, device=device)
    actions = torch.zeros((num_envs, K), dtype=torch.long, device=device)
    rtg = torch.zeros((num_envs, K), dtype=torch.float32, device=device)
    timesteps = torch.zeros((num_envs, K), dtype=torch.long, device=device)
    t_in_ep = torch.zeros(num_envs, dtype=torch.long, device=device)
    rt = torch.full((num_envs,), target_return, dtype=torch.float32, device=device)
    stats = EpisodeStatistics.create(num_envs, device)
    placeholder = torch.zeros(num_envs, dtype=torch.long, device=device)

    for _ in range(num_steps):
        states = _shift_append(states, obs)
        rtg = _shift_append(rtg, rt)
        timesteps = _shift_append(timesteps, t_in_ep)
        # The current step's action slot is a placeholder (0): the DT
        # predicts it from the state token, which precedes it causally.
        logits = model(rtg, states, _shift_append(actions, placeholder), timesteps)[:, -1]
        if greedy:
            action = logits.argmax(dim=-1)
        else:
            action = torch.multinomial(logits.softmax(dim=-1), 1, generator=generator)[:, 0]
        obs, env_state, reward, done, _ = env.step(env_state, action, generator)
        stats = stats.update(reward, done)
        rt = torch.where(done, target_return, rt - reward)
        if rtg_clip is not None:
            rt = rt.clamp(max=rtg_clip)
        t_in_ep = torch.where(done, 0, t_in_ep + 1)
        # On done, clear the context so the new episode starts fresh.
        states = _clear_done(states, done)
        actions = _clear_done(_shift_append(actions, action), done)
        rtg = _clear_done(rtg, done)
        timesteps = _clear_done(timesteps, done)

    return {
        "eval/episodic_return": stats.mean_return,
        "eval/episodic_length": stats.mean_length,
        "eval/episodes": stats.episode_count,
    }
