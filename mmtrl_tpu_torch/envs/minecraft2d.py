"""Minecraft2d, the multimodal (video + audio) gridworld, batched on the
device; port of ``mmtrl_tpu/envs/minecraft2d.py``.

- 5x5 grid: agent, good target (gold pick), bad target (bronze shovel) and
  a gem of hidden type in {gold, iron} (reference: Minecraft.py:41,74-75).
- Rewards +10 for the target matching the gem type, -10 for the other, -1
  per step; the episode ends on either target or after 30 steps.
- Observation (2, 84, 84) float32 in [-1, 1]: channel 0 a gray render of
  the grid (the gem always drawn gold), channel 1 the MFCC plane of the
  gem-type wav within 1.5 cells of the gem, else background noise.

Rendering is one einsum of the one-hot tile map against the render bank,
and audio a 3-way select over the cached planes, all on the device.  Reset
draws 4 distinct cells and a gem type; ``sampler`` replaces that draw, so a
test can replay the draws another implementation made.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

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
from mmtrl_tpu_torch.envs.base import Environment, StepResult

# Actions (reference: Minecraft.py:13-21)
UP, DOWN, RIGHT, LEFT = 0, 1, 2, 3

GEM_GOLD, GEM_IRON = 0, 1
MAX_ITER = 30  # reference: Config.py:76
LISTEN_RANGE_SQ = 2  # integer cells: d^2 <= 2  <=>  d <= 1.5 (Config.py:77)

REWARD_STEP = -1.0
REWARD_GOOD = 10.0
REWARD_BAD = -10.0

# (cells (n, 4) long in [0, 25), all distinct per row: agent, good, bad, gem;
#  gem_type (n,) long in {0, 1})
ResetDraw = Tuple[torch.Tensor, torch.Tensor]
Sampler = Callable[[int, Optional[torch.Generator]], ResetDraw]


@dataclasses.dataclass
class MinecraftState:
    agent: torch.Tensor  # (n, 2) long row, col
    good: torch.Tensor  # (n, 2)
    bad: torch.Tensor  # (n, 2)
    gem: torch.Tensor  # (n, 2)
    gem_type: torch.Tensor  # (n,) long, 0 gold / 1 iron
    t: torch.Tensor  # (n,) long


def render_frame(bank: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """(n, 84, 84) gray frames in [-1, 1] of the (n, 25) tile maps ``tiles``:
    one einsum of their one-hot against the render ``bank`` (cells x tiles x
    84 x 84)."""
    onehot = F.one_hot(tiles, bank.shape[1]).float()
    # Clip to [0, 255] like the reference's uint8 saturation before the
    # affine rescale (bicubic can overshoot at tile edges).
    frame = torch.einsum("npt,ptyx->nyx", onehot, bank).clamp(0.0, 255.0)
    return frame * (2.0 / 255.0) - 1.0


class Minecraft2d(Environment):
    def __init__(self, use_audio: bool = True, device: DeviceLike = None,
                 sampler: Optional[Sampler] = None):
        self.use_audio = use_audio
        self.device = resolve_device(device)
        self.sampler = sampler or self.draw_reset
        self._bank = torch.tensor(minecraft_render_bank(), device=self.device)
        self._audio = torch.tensor(audio_planes(), device=self.device)
        self._deltas = torch.tensor(
            [[-1, 0], [1, 0], [0, 1], [0, -1]], dtype=torch.long, device=self.device
        )

    # ---- reset ----------------------------------------------------------
    def draw_reset(self, n: int, generator: Optional[torch.Generator] = None) -> ResetDraw:
        """4 distinct cells (a uniform draw without replacement) and a gem type."""
        cells = torch.rand(
            n, GRID * GRID, generator=generator, device=self.device
        ).argsort(dim=-1)[:, :4]
        gem_type = torch.randint(0, 2, (n,), generator=generator, device=self.device)
        return cells, gem_type

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        cells, gem_type = self.sampler(num_envs, generator)
        locs = torch.stack([cells // GRID, cells % GRID], dim=-1).to(self.device)
        state = MinecraftState(
            agent=locs[:, 0], good=locs[:, 1], bad=locs[:, 2], gem=locs[:, 3],
            gem_type=gem_type.to(self.device, torch.long),
            t=torch.zeros(num_envs, dtype=torch.long, device=self.device),
        )
        return self._obs(state), state

    # ---- rendering ------------------------------------------------------
    def _tile_map(self, s: MinecraftState) -> torch.Tensor:
        """(n, 25) tile id per cell; priority agent > good > bad > gem."""
        tiles = torch.zeros(s.t.shape[0], GRID * GRID, dtype=torch.long, device=self.device)
        for loc, tile in ((s.gem, T_GEM), (s.bad, T_BAD), (s.good, T_GOOD), (s.agent, T_AGENT)):
            tiles.scatter_(1, (loc[:, 0] * GRID + loc[:, 1])[:, None], tile)
        return tiles

    def _obs(self, s: MinecraftState) -> torch.Tensor:
        frame = render_frame(self._bank, self._tile_map(s))
        if not self.use_audio:
            return frame[:, None]
        d2 = ((s.agent - s.gem) ** 2).sum(dim=-1)
        audio_idx = torch.where(d2 <= LISTEN_RANGE_SQ, s.gem_type, 2)
        return torch.stack([frame, self._audio[audio_idx]], dim=1)

    # ---- step -----------------------------------------------------------
    def _step_env(self, state: MinecraftState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        """Deterministic: draws nothing from ``generator``."""
        agent = (state.agent + self._deltas[action]).clamp(0, GRID - 1)
        at_good = (agent == state.good).all(dim=-1)
        at_bad = (agent == state.bad).all(dim=-1)
        gold = state.gem_type == GEM_GOLD
        reward = torch.where(
            (at_good & gold) | (at_bad & ~gold),
            REWARD_GOOD,
            torch.where((at_good & ~gold) | (at_bad & gold), REWARD_BAD, REWARD_STEP),
        ).float()
        new = dataclasses.replace(state, agent=agent, t=state.t + 1)
        done = at_good | at_bad | (new.t >= MAX_ITER)
        info = {"at_good": at_good, "at_bad": at_bad}
        return self._obs(new), new, reward, done, info

    # ---- spaces ---------------------------------------------------------
    @property
    def observation_space(self):
        shape = (2 if self.use_audio else 1, IMG, IMG)
        return spaces.Box(0.0, 4.0, shape)  # reference's declared bounds

    @property
    def action_space(self):
        return spaces.Discrete(4)

    @property
    def name(self):
        return "minecraft"
