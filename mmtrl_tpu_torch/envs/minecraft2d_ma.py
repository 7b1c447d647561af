"""Two-agent Minecraft2d for parameter-sharing multi-agent PPO, batched on
the device; port of ``mmtrl_tpu/envs/minecraft2d_ma.py`` (the reference's
cleanrl/ppo_pettingzoo_ma_atari.py structure, its SuperSuit agent-indicator
channel at :150-159).

Two agents share the 5x5 grid, the gem and the targets and act every step.
Each observes (3, 84, 84): the shared frame, the audio plane of its own
distance to the gem, and an indicator plane of -1 (agent 0) or +1 (agent 1).
Rewards are each agent's own (+10 / -10 for the target it reaches by the
gem's type, -1 a step); the episode of a joint env ends for both when
either agent is on a target or at ``MAX_ITER``.

The batch is one of agent SLOTS, as parameter sharing batches every agent
through one policy: ``reset(num_slots)`` makes ``num_slots // 2`` joint
envs, slot ``2j`` agent 0 of joint env ``j`` and slot ``2j + 1`` its agent
1.  ``step`` takes one action a slot and auto-resets each joint env that is
done, drawing one reset per joint env each step; ``info`` is empty, as
JAX's.  A reset draws 5 distinct cells (agent 0, agent 1, good, bad, gem)
and a gem type; ``sampler`` replaces that draw, so a test can replay the
draws another implementation made.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.assets import (
    GRID,
    IMG,
    T_AGENT,
    T_BAD,
    T_GEM,
    T_GOOD,
    audio_planes,
    minecraft_render_bank,
)
from mmtrl_tpu_torch.envs.base import Environment, StepResult, _expand, tree_select
from mmtrl_tpu_torch.envs.minecraft2d import (
    GEM_GOLD,
    LISTEN_RANGE_SQ,
    MAX_ITER,
    REWARD_BAD,
    REWARD_GOOD,
    REWARD_STEP,
    render_frame,
)

NUM_AGENTS = 2

# (cells (n, 5) long in [0, 25), all distinct per row: agent 0, agent 1,
#  good, bad, gem; gem_type (n,) long in {0, 1}), n joint envs
ResetDraw = Tuple[torch.Tensor, torch.Tensor]
Sampler = Callable[[int, Optional[torch.Generator]], ResetDraw]


@dataclasses.dataclass
class MAState:
    agents: torch.Tensor  # (n, 2, 2) long: agent, row/col
    good: torch.Tensor  # (n, 2)
    bad: torch.Tensor  # (n, 2)
    gem: torch.Tensor  # (n, 2)
    gem_type: torch.Tensor  # (n,) long, 0 gold / 1 iron
    t: torch.Tensor  # (n,) long


class MultiAgentMinecraft2d(Environment):
    num_agents = NUM_AGENTS

    def __init__(self, device: DeviceLike = None, sampler: Optional[Sampler] = None):
        self.device = resolve_device(device)
        self.sampler = sampler or self.draw_reset
        self._bank = torch.tensor(minecraft_render_bank(), device=self.device)
        self._audio = torch.tensor(audio_planes(), device=self.device)
        self._deltas = torch.tensor(
            [[-1, 0], [1, 0], [0, 1], [0, -1]], dtype=torch.long, device=self.device
        )  # up, down, right, left (Minecraft2d's order)
        self._indicator = torch.tensor([-1.0, 1.0], device=self.device)  # -1 + 2i

    # ---- reset ----------------------------------------------------------
    def draw_reset(self, n: int, generator: Optional[torch.Generator] = None) -> ResetDraw:
        """5 distinct cells (a uniform draw without replacement) and a gem
        type for each of ``n`` joint envs."""
        cells = torch.rand(
            n, GRID * GRID, generator=generator, device=self.device
        ).argsort(dim=-1)[:, :5]
        gem_type = torch.randint(0, 2, (n,), generator=generator, device=self.device)
        return cells, gem_type

    def reset(self, num_slots: int, generator: Optional[torch.Generator] = None):
        if num_slots % NUM_AGENTS:
            raise ValueError(f"{num_slots} agent slots do not make whole joint envs "
                             f"of {NUM_AGENTS}")
        n = num_slots // NUM_AGENTS
        cells, gem_type = self.sampler(n, generator)
        locs = torch.stack([cells // GRID, cells % GRID], dim=-1).to(self.device)
        state = MAState(
            agents=locs[:, :2], good=locs[:, 2], bad=locs[:, 3], gem=locs[:, 4],
            gem_type=gem_type.to(self.device, torch.long),
            t=torch.zeros(n, dtype=torch.long, device=self.device),
        )
        return self._obs(state), state

    # ---- rendering ------------------------------------------------------
    def _tile_map(self, s: MAState) -> torch.Tensor:
        """(n, 25) tile id per cell, written in JAX's order: gem, bad, good,
        agent 0, agent 1; a later write wins where cells coincide.  One
        scatter per entity (one index a row), so the order is the calls'."""
        tiles = torch.zeros(s.t.shape[0], GRID * GRID, dtype=torch.long, device=self.device)
        for loc, tile in ((s.gem, T_GEM), (s.bad, T_BAD), (s.good, T_GOOD),
                          (s.agents[:, 0], T_AGENT), (s.agents[:, 1], T_AGENT)):
            tiles.scatter_(1, (loc[:, 0] * GRID + loc[:, 1])[:, None], tile)
        return tiles

    def _obs(self, s: MAState) -> torch.Tensor:
        """(2n, 3, 84, 84): per slot the shared frame, its agent's audio
        plane and its indicator plane."""
        n = s.t.shape[0]
        frame = render_frame(self._bank, self._tile_map(s))
        d2 = ((s.agents - s.gem[:, None]) ** 2).sum(dim=-1)  # (n, 2)
        audio_idx = torch.where(d2 <= LISTEN_RANGE_SQ, s.gem_type[:, None], 2)
        obs = torch.stack([
            frame[:, None].expand(n, NUM_AGENTS, IMG, IMG),
            self._audio[audio_idx],
            self._indicator[:, None, None].expand(n, NUM_AGENTS, IMG, IMG),
        ], dim=2)
        return obs.reshape(n * NUM_AGENTS, 3, IMG, IMG)

    # ---- step -----------------------------------------------------------
    def _step_env(self, state: MAState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        """The joint transition of every env, ``action`` one a slot.
        Deterministic: draws nothing from ``generator``."""
        joint = action.reshape(-1, NUM_AGENTS)
        agents = (state.agents + self._deltas[joint]).clamp(0, GRID - 1)
        at_good = (agents == state.good[:, None]).all(dim=-1)  # (n, 2)
        at_bad = (agents == state.bad[:, None]).all(dim=-1)
        gold = (state.gem_type == GEM_GOLD)[:, None]
        rewards = torch.where(
            (at_good & gold) | (at_bad & ~gold),
            REWARD_GOOD,
            torch.where((at_good & ~gold) | (at_bad & gold), REWARD_BAD, REWARD_STEP),
        ).float()
        new = dataclasses.replace(state, agents=agents, t=state.t + 1)
        done = (at_good | at_bad).any(dim=-1) | (new.t >= MAX_ITER)
        dones = done[:, None].expand(-1, NUM_AGENTS).reshape(-1)
        return self._obs(new), new, rewards.reshape(-1), dones, {}

    def step(self, state: MAState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> StepResult:
        """The transition, then each joint env that is done reset: one reset
        draw a joint env each step, as JAX's ``v_step``; ``info`` is
        empty."""
        obs_st, state_st, rewards, dones, _ = self._step_env(state, action, generator)
        obs_rs, state_rs = self.reset(action.shape[0], generator)
        state = tree_select(dones[::NUM_AGENTS], state_rs, state_st)
        obs = torch.where(_expand(dones, obs_st), obs_rs, obs_st)
        return obs, state, rewards, dones, {}

    # ---- spaces ---------------------------------------------------------
    @property
    def observation_space(self):
        return spaces.Box(-1.0, 1.0, (3, IMG, IMG))

    @property
    def action_space(self):
        return spaces.Discrete(4)

    @property
    def name(self):
        return "minecraft_ma"
