"""Doorpuzzle, a two-stage key/door puzzle with noisy moves, batched on the
device; port of ``mmtrl_tpu/envs/doorpuzzle.py``.

- 5x5 grid: the agent starts at (0, 0), door 1 is at (0, 4), door 2 at
  (4, 0) (reference: Doorpuzzle.py:73-79); the key lies at the centre, or
  in hard mode on a uniform cell that is neither the start nor a door
  (Doorpuzzle.py:82-92); its hidden type is 1 or 2.
- A move slips laterally with probability 0.2, 0.1 to each side
  (Doorpuzzle.py:147-163).
- Walking onto the key picks it up silently; reward 1 only at the door of
  the key's type while holding the key (Doorpuzzle.py:211-229), else 0.
- The episode ends at either door or after 30 steps (Doorpuzzle.py:240-253).
- Observation (2, 84, 84) float32 in [-1, 1]: the simple render (flat gray
  tiles, nearest-resized, one einsum against the render bank) and, within
  1.5 cells of a key not yet held, the key type's MFCC plane, else noise.

Two draws make the env random, each behind a hook that a test can replace,
as ``Minecraft2d``'s ``sampler``: ``sampler`` draws a reset (the key type
and the key's cell, the centre outside hard mode) and ``slip_sampler`` a
step's slips (the column of the slip table: left, straight, right).  By
default they draw from the generator that ``reset`` and ``step`` are given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.assets import (
    DP_AGENT,
    DP_KEY1,
    DP_KEY2,
    DP_T1,
    DP_T2,
    GRID,
    IMG,
    audio_planes,
    doorpuzzle_render_bank,
)
from mmtrl_tpu_torch.envs.base import Environment, StepResult
from mmtrl_tpu_torch.envs.minecraft2d import render_frame

UP, DOWN, RIGHT, LEFT = 0, 1, 2, 3
MAX_ITER = 30
LISTEN_RANGE_SQ = 2
NOISE_TRANS = 0.2

# Lateral-slip table (Doorpuzzle.py:150-157): row = intended action,
# columns = [left-slip, straight, right-slip].
SLIP = ((LEFT, UP, RIGHT), (RIGHT, DOWN, LEFT), (UP, RIGHT, DOWN), (DOWN, LEFT, UP))
DOOR1_CELL, DOOR2_CELL = GRID - 1, GRID * (GRID - 1)  # (0, 4), (4, 0)
CENTRE_CELL = (GRID // 2) * GRID + GRID // 2
# hard mode's key cells: every cell but the agent's start and the doors
KEY_CELLS = tuple(c for c in range(GRID * GRID) if c not in (0, DOOR1_CELL, DOOR2_CELL))

# (key_type (n,) long in {1, 2}, key cell (n,) long in [0, 25))
ResetDraw = Tuple[torch.Tensor, torch.Tensor]
Sampler = Callable[[int, Optional[torch.Generator]], object]


@dataclasses.dataclass
class DoorpuzzleState:
    agent: torch.Tensor  # (n, 2) long row, col
    key_loc: torch.Tensor  # (n, 2) long
    key_type: torch.Tensor  # (n,) long, 1 or 2
    has_key: torch.Tensor  # (n,) bool
    t: torch.Tensor  # (n,) long


class Doorpuzzle(Environment):
    def __init__(self, hard_mode: bool = False, use_audio: bool = True,
                 device: DeviceLike = None, sampler: Optional[Sampler] = None,
                 slip_sampler: Optional[Sampler] = None):
        self.hard_mode = hard_mode
        self.use_audio = use_audio
        self.device = dev = resolve_device(device)
        self.sampler = sampler or self.draw_reset
        self.slip_sampler = slip_sampler or self.draw_slip
        self._bank = torch.tensor(doorpuzzle_render_bank(), device=dev)
        self._audio = torch.tensor(audio_planes(), device=dev)
        self._slip = torch.tensor(SLIP, dtype=torch.long, device=dev)
        self._deltas = torch.tensor([[-1, 0], [1, 0], [0, 1], [0, -1]], dtype=torch.long,
                                    device=dev)
        self._key_cells = torch.tensor(KEY_CELLS, dtype=torch.long, device=dev)
        self._door1 = torch.tensor([0, GRID - 1], dtype=torch.long, device=dev)
        self._door2 = torch.tensor([GRID - 1, 0], dtype=torch.long, device=dev)

    # ---- draws -----------------------------------------------------------
    def draw_reset(self, n: int, generator: Optional[torch.Generator] = None) -> ResetDraw:
        """The key type, uniform in {1, 2}, and the key's cell: the centre,
        or in hard mode uniform over ``KEY_CELLS``."""
        key_type = torch.randint(1, 3, (n,), generator=generator, device=self.device)
        if not self.hard_mode:
            return key_type, torch.full((n,), CENTRE_CELL, dtype=torch.long, device=self.device)
        idx = torch.randint(0, len(KEY_CELLS), (n,), generator=generator, device=self.device)
        return key_type, self._key_cells[idx]

    def draw_slip(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(n,) long slip-table columns: 0 and 2 with probability 0.1 each."""
        u = torch.rand(n, generator=generator, device=self.device)
        return (u >= NOISE_TRANS / 2).long() + (u >= 1.0 - NOISE_TRANS / 2).long()

    # ---- reset -----------------------------------------------------------
    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        key_type, cell = self.sampler(num_envs, generator)
        cell = cell.to(self.device, torch.long)
        zeros = torch.zeros(num_envs, dtype=torch.long, device=self.device)
        state = DoorpuzzleState(
            agent=torch.zeros(num_envs, 2, dtype=torch.long, device=self.device),
            key_loc=torch.stack([cell // GRID, cell % GRID], dim=-1),
            key_type=key_type.to(self.device, torch.long),
            has_key=zeros.bool(),
            t=zeros,
        )
        return self._obs(state), state

    # ---- rendering -------------------------------------------------------
    def _tile_map(self, s: DoorpuzzleState) -> torch.Tensor:
        """(n, 25) tile id per cell (0 = background), written key, door 1,
        door 2, agent: the later write wins where two share a cell."""
        n = s.t.shape[0]
        tiles = torch.zeros(n, GRID * GRID, dtype=torch.long, device=self.device)
        key_tile = torch.where(s.has_key, 0, torch.where(s.key_type == 1, DP_KEY1, DP_KEY2))
        tiles.scatter_(1, (s.key_loc[:, 0] * GRID + s.key_loc[:, 1])[:, None], key_tile[:, None])
        tiles[:, DOOR1_CELL] = DP_T1
        tiles[:, DOOR2_CELL] = DP_T2
        tiles.scatter_(1, (s.agent[:, 0] * GRID + s.agent[:, 1])[:, None], DP_AGENT)
        return tiles

    def _obs(self, s: DoorpuzzleState) -> torch.Tensor:
        # JAX adds its base canvas, which is zero (``doorpuzzle_base_frame``)
        frame = render_frame(self._bank, self._tile_map(s))
        if not self.use_audio:
            return frame[:, None]
        d2 = ((s.agent - s.key_loc) ** 2).sum(dim=-1)
        audible = ~s.has_key & (d2 <= LISTEN_RANGE_SQ)
        audio_idx = torch.where(audible, s.key_type - 1, 2)
        return torch.stack([frame, self._audio[audio_idx]], dim=1)

    # ---- step ------------------------------------------------------------
    def _step_env(self, state: DoorpuzzleState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        slip = self.slip_sampler(action.shape[0], generator).to(self.device, torch.long)
        actual = self._slip[action.to(self.device), slip]
        agent = (state.agent + self._deltas[actual]).clamp(0, GRID - 1)

        on_key = (agent == state.key_loc).all(dim=-1) & ~state.has_key
        has_key = state.has_key | on_key
        at_d1 = (agent == self._door1).all(dim=-1)
        at_d2 = (agent == self._door2).all(dim=-1)
        # the key held before this step's pickup (Doorpuzzle.py:211-231);
        # the key never lies on a door, so a pickup never pays
        reward = ((at_d1 & state.has_key & (state.key_type == 1))
                  | (at_d2 & state.has_key & (state.key_type == 2))).float()

        new = dataclasses.replace(state, agent=agent, has_key=has_key, t=state.t + 1)
        done = at_d1 | at_d2 | (new.t >= MAX_ITER)
        info = {"has_key": has_key, "success": reward > 0}
        return self._obs(new), new, reward, done, info

    # ---- spaces ----------------------------------------------------------
    @property
    def observation_space(self):
        return spaces.Box(-1.0, 1.0, (2 if self.use_audio else 1, IMG, IMG))

    @property
    def action_space(self):
        return spaces.Discrete(4)

    @property
    def name(self):
        return "doorpuzzle"
