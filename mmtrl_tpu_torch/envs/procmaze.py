"""ProcMaze, a procgen-style distribution of generated mazes, batched on the
device; port of ``mmtrl_tpu/envs/procmaze.py`` (the reference's
cleanrl/ppg_procgen.py contract: ``num_levels``/``start_level`` select the
train window, a disjoint window measures generalization).

- The level bank is generated on the host once (randomized-DFS perfect
  mazes, numpy, JAX's generator and order of draws) and held on the env's
  device: walls, starts, goals, the wall planes and the per-cell planes.
- Observation (3, 84, 84) float32 in {-1, +1}: the wall plane, the agent's
  cell and the goal's cell, each cell a 6 x 6 block (3 px margin).
- Actions 0 up, 1 down, 2 left, 3 right.  A wall, or the grid's edge, keeps
  the agent where it is.
- Rewards -0.01 a step, +10 on the goal, which ends the episode; reaching
  ``max_steps`` ends it too, folded into ``done`` with no truncation flag.

Reset draws a level uniformly from the train window; ``sampler`` replaces
that draw, so a test can replay the draws another implementation made.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.base import Environment, StepResult

GRID = 13  # maze cells per side (odd: walls on even lattice lines)
IMG = 84
CELL_PX = IMG // GRID  # 6 px per cell, 6 * 13 = 78, centred with a 3 px margin
MARGIN = (IMG - GRID * CELL_PX) // 2

REWARD_GOAL = 10.0
REWARD_STEP = -0.01

# Actions: 0 up, 1 down, 2 left, 3 right (row/col deltas).
DELTAS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], np.int32)

# (n, generator) -> (n,) long: the absolute level index of each reset
Sampler = Callable[[int, Optional[torch.Generator]], torch.Tensor]


def _gen_maze(rng: np.random.Generator) -> np.ndarray:
    """Randomized-DFS perfect maze on a GRID x GRID grid; True = wall."""
    walls = np.ones((GRID, GRID), bool)
    # Cells live on odd coordinates; walls between them are carved.
    cells = [(r, c) for r in range(1, GRID, 2) for c in range(1, GRID, 2)]
    start = cells[rng.integers(len(cells))]
    stack = [start]
    walls[start] = False
    while stack:
        r, c = stack[-1]
        nbrs = []
        for dr, dc in ((-2, 0), (2, 0), (0, -2), (0, 2)):
            nr, nc = r + dr, c + dc
            if 1 <= nr < GRID - 1 and 1 <= nc < GRID - 1 and walls[nr, nc]:
                nbrs.append((nr, nc))
        if not nbrs:
            stack.pop()
            continue
        nr, nc = nbrs[rng.integers(len(nbrs))]
        walls[(r + nr) // 2, (c + nc) // 2] = False
        walls[nr, nc] = False
        stack.append((nr, nc))
    return walls


def _far_apart(rng: np.random.Generator, walls: np.ndarray):
    """Start and goal on distinct open cells, biased far apart."""
    open_cells = np.argwhere(~walls)
    best, best_d = None, -1
    for _ in range(8):
        a, b = open_cells[rng.integers(len(open_cells), size=2)]
        while np.array_equal(a, b):  # distinct cells; a redraw keeps the stream
            a, b = open_cells[rng.integers(len(open_cells), size=2)]
        d = abs(int(a[0]) - int(b[0])) + abs(int(a[1]) - int(b[1]))
        if d > best_d:
            best, best_d = (a, b), d
    return best


def _blocks(grid: np.ndarray) -> np.ndarray:
    """(..., GRID, GRID) bool -> (..., IMG, IMG) float32 planes: +1 on the
    pixel block of each True cell, -1 elsewhere (the margin included)."""
    up = np.repeat(np.repeat(grid, CELL_PX, axis=-2), CELL_PX, axis=-1)
    px = np.full(grid.shape[:-2] + (IMG, IMG), -1.0, np.float32)
    span = slice(MARGIN, MARGIN + GRID * CELL_PX)
    px[..., span, span] = np.where(up, 1.0, -1.0)
    return px


@dataclasses.dataclass(frozen=True)
class LevelBank:
    """The generated levels, numpy arrays on the host (read-only)."""

    walls: np.ndarray  # (L, GRID, GRID) bool
    starts: np.ndarray  # (L, 2) int32 row, col
    goals: np.ndarray  # (L, 2) int32
    wall_px: np.ndarray  # (L, IMG, IMG) float32 wall planes
    cell_px: np.ndarray  # (GRID * GRID, IMG, IMG) float32 plane of each cell


@functools.lru_cache(maxsize=2)
def level_bank(seed: int = 1234, total_levels: int = 1000) -> LevelBank:
    """The ``total_levels`` levels of generation seed ``seed``, each maze
    then its start and goal drawn from one ``default_rng(seed)``, as the
    JAX env draws them.  Cached: a train and a held-out env, or the same
    env on two devices, share one generation (about 33 MB at 1,000)."""
    rng = np.random.default_rng(seed)
    walls, starts, goals = [], [], []
    for _ in range(total_levels):
        w = _gen_maze(rng)
        s, g = _far_apart(rng, w)
        walls.append(w)
        starts.append(s)
        goals.append(g)
    walls = np.stack(walls)
    bank = LevelBank(
        walls=walls,
        starts=np.stack(starts).astype(np.int32),
        goals=np.stack(goals).astype(np.int32),
        wall_px=_blocks(walls),
        cell_px=_blocks(np.eye(GRID * GRID, dtype=bool).reshape(-1, GRID, GRID)),
    )
    for f in dataclasses.fields(bank):
        getattr(bank, f.name).flags.writeable = False
    return bank


@dataclasses.dataclass
class ProcMazeState:
    level: torch.Tensor  # (n,) long index into the level bank
    pos: torch.Tensor  # (n, 2) long row, col
    t: torch.Tensor  # (n,) long


class ProcMaze(Environment):
    """Procgen-contract maze distribution.  ``num_levels=0`` means every
    level from ``start_level`` on (procgen's "full distribution", here the
    ``total_levels`` generated)."""

    def __init__(self, num_levels: int = 200, start_level: int = 0, total_levels: int = 1000,
                 max_steps: int = 256, seed: int = 1234, device: DeviceLike = None,
                 sampler: Optional[Sampler] = None):
        if num_levels == 0:
            num_levels = total_levels - start_level
        if start_level < 0 or num_levels < 1 or start_level + num_levels > total_levels:
            raise ValueError(f"levels [{start_level}, {start_level + num_levels}) are not "
                             f"inside the {total_levels} generated")
        self.start_level = start_level
        self.num_levels = num_levels
        self.max_steps = max_steps
        self.device = resolve_device(device)
        self.sampler = sampler or self.draw_reset
        bank = level_bank(seed, total_levels)
        on = functools.partial(torch.tensor, device=self.device)
        self._walls = on(bank.walls)
        self._starts = on(bank.starts, dtype=torch.long)
        self._goals = on(bank.goals, dtype=torch.long)
        self._wall_px = on(bank.wall_px)
        self._cell_px = on(bank.cell_px)
        self._deltas = on(DELTAS, dtype=torch.long)

    # ---- reset ----------------------------------------------------------
    def draw_reset(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``start_level`` + a uniform draw in [0, num_levels)."""
        return self.start_level + torch.randint(0, self.num_levels, (n,), generator=generator,
                                                device=self.device)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        level = self.sampler(num_envs, generator).to(self.device, torch.long)
        state = ProcMazeState(level=level, pos=self._starts[level],
                              t=torch.zeros(num_envs, dtype=torch.long, device=self.device))
        return self._obs(state), state

    # ---- rendering ------------------------------------------------------
    def _obs(self, s: ProcMazeState) -> torch.Tensor:
        goal = self._goals[s.level]
        return torch.stack([
            self._wall_px[s.level],
            self._cell_px[s.pos[:, 0] * GRID + s.pos[:, 1]],
            self._cell_px[goal[:, 0] * GRID + goal[:, 1]],
        ], dim=1)

    # ---- step -----------------------------------------------------------
    def _step_env(self, state: ProcMazeState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        """Deterministic: draws nothing from ``generator``."""
        nxt = (state.pos + self._deltas[action]).clamp(0, GRID - 1)
        blocked = self._walls[state.level, nxt[:, 0], nxt[:, 1]]
        pos = torch.where(blocked[:, None], state.pos, nxt)
        reached = (pos == self._goals[state.level]).all(dim=-1)
        t = state.t + 1
        done = reached | (t >= self.max_steps)
        reward = REWARD_STEP + REWARD_GOAL * reached.float()
        new = ProcMazeState(level=state.level, pos=pos, t=t)
        return self._obs(new), new, reward, done, {"level": state.level, "solved": reached}

    # ---- spaces ---------------------------------------------------------
    @property
    def observation_space(self) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (3, IMG, IMG))

    @property
    def action_space(self):
        return spaces.Discrete(4)

    @property
    def name(self) -> str:
        return f"procmaze[{self.start_level}:{self.start_level + self.num_levels}]"
