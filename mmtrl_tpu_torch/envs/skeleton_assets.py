"""Host-side constants of the Skeleton+ simulator (``envs/skeleton_plus.py``);
the port's own copy of ``mmtrl_tpu/envs/skeleton_assets.py``, numpy only.

The simulator is a behavioural model of the Skeleton+ 2600 cartridge (a
maze hunt: footstep volume encodes the skeleton's distance and front/back,
stereo balance left/right, the skeleton is visible only in the line of
sight).  This module computes what its device step reads:

- a fixed 11x11 maze,
- all-pairs BFS next-step and distance tables (the skeleton's pursuit),
- line of sight per (cell, facing),
- additive top-down render layers (walls, per-cell agent and skeleton
  sprites),
- a base footstep window at the cartridge's 30,720 Hz audio rate (drawn
  from ``np.random.RandomState(1234)``, so every copy holds the same
  samples), the linear operators that lift a window's MFCC matrix to an
  84x84 plane, and the fixed statistics that normalise it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from mmtrl_tpu_torch.ops.mfcc import SKELETON_PLUS_PARAMS, mfcc

SIZE = 11  # maze cells per side
IMG = 84
CELL_PX = 7  # 11 * 7 = 77, centered in 84
PAD = (IMG - SIZE * CELL_PX) // 2

# Facings: 0=N, 1=E, 2=S, 3=W; deltas in (row, col).
FACING_DELTAS = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]], dtype=np.int32)

AUDIO_SR = SKELETON_PLUS_PARAMS.samplerate  # 30720
WINDOW = 1024  # audio samples delivered per env step (~33 ms)


@functools.lru_cache(maxsize=1)
def maze() -> np.ndarray:
    """(SIZE, SIZE) uint8, 1 = wall.  Fixed symmetric corridor maze."""
    m = np.zeros((SIZE, SIZE), dtype=np.uint8)
    m[0, :] = m[-1, :] = 1
    m[:, 0] = m[:, -1] = 1
    # Inner pillars/walls (symmetric, corridor width 1).
    for r in range(2, SIZE - 2, 2):
        for c in range(2, SIZE - 2, 2):
            m[r, c] = 1
    m[2, 3:8] = 1
    m[8, 3:8] = 1
    m[4:7, 5] = 0  # keep the center corridor open
    m[5, 2] = 1
    m[5, 8] = 1
    return m


@functools.lru_cache(maxsize=1)
def open_cells() -> np.ndarray:
    return np.argwhere(maze() == 0).astype(np.int32)  # (n_open, 2)


@functools.lru_cache(maxsize=1)
def cell_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(next_step, dist, vis):
    next_step[from, to]  flat cell index of the BFS step from->to
    dist[from, to]       BFS distance (float32; large when unreachable)
    vis[cell, facing, target]  bool: target visible straight ahead."""
    m = maze()
    n = SIZE * SIZE
    passable = (m.reshape(-1) == 0)
    # adjacency
    neighbors = [[] for _ in range(n)]
    for idx in range(n):
        if not passable[idx]:
            continue
        r, c = divmod(idx, SIZE)
        for dr, dc in FACING_DELTAS:
            rr, cc = r + dr, c + dc
            if 0 <= rr < SIZE and 0 <= cc < SIZE and m[rr, cc] == 0:
                neighbors[idx].append(rr * SIZE + cc)

    # BFS from every target: parent-toward-target gives next_step.
    next_step = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, n)).T.copy()
    # next_step[from, to]; default stay.
    dist = np.full((n, n), 1e4, dtype=np.float32)
    for target in range(n):
        if not passable[target]:
            continue
        d = np.full(n, -1, dtype=np.int64)
        d[target] = 0
        queue = [target]
        toward = np.arange(n, dtype=np.int32)
        while queue:
            cur = queue.pop(0)
            for nb in neighbors[cur]:
                if d[nb] < 0:
                    d[nb] = d[cur] + 1
                    toward[nb] = cur  # step from nb toward target
                    queue.append(nb)
        reach = d >= 0
        dist[reach, target] = d[reach].astype(np.float32)
        next_step[:, target] = np.where(reach, toward, np.arange(n))
        next_step[target, target] = target

    # Line of sight straight ahead per facing.
    vis = np.zeros((n, 4, n), dtype=bool)
    for idx in range(n):
        if not passable[idx]:
            continue
        r, c = divmod(idx, SIZE)
        for f, (dr, dc) in enumerate(FACING_DELTAS):
            rr, cc = r + dr, c + dc
            while 0 <= rr < SIZE and 0 <= cc < SIZE and m[rr, cc] == 0:
                vis[idx, f, rr * SIZE + cc] = True
                rr += dr
                cc += dc
    return next_step, dist, vis


def _sprite(kind: str) -> np.ndarray:
    """(CELL_PX, CELL_PX) additive gray sprite."""
    s = np.zeros((CELL_PX, CELL_PX), dtype=np.float32)
    if kind == "wall":
        s[:, :] = 130.0
    elif kind == "agent":
        s[1:-1, 1:-1] = 220.0
        s[3, 3] = 255.0
    elif kind == "skeleton":
        s[1:-1, 2:-2] = 250.0
        s[2, 1] = s[2, -2] = 250.0  # arms
    return s


@functools.lru_cache(maxsize=1)
def render_layers() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(wall_layer (84,84), agent_bank (n,84,84), skel_bank (n,84,84)) with
    n = SIZE*SIZE; per-cell additive contributions."""
    m = maze()
    wall = np.zeros((IMG, IMG), dtype=np.float32)
    wall_sprite = _sprite("wall")
    for r in range(SIZE):
        for c in range(SIZE):
            if m[r, c]:
                y, x = PAD + r * CELL_PX, PAD + c * CELL_PX
                wall[y : y + CELL_PX, x : x + CELL_PX] = wall_sprite
    n = SIZE * SIZE
    agent_bank = np.zeros((n, IMG, IMG), dtype=np.float32)
    skel_bank = np.zeros((n, IMG, IMG), dtype=np.float32)
    for idx in range(n):
        r, c = divmod(idx, SIZE)
        y, x = PAD + r * CELL_PX, PAD + c * CELL_PX
        agent_bank[idx, y : y + CELL_PX, x : x + CELL_PX] = _sprite("agent")
        skel_bank[idx, y : y + CELL_PX, x : x + CELL_PX] = _sprite("skeleton")
    return wall, agent_bank, skel_bank


@functools.lru_cache(maxsize=1)
def footstep_window() -> np.ndarray:
    """(WINDOW,) float32 base mono footstep snippet: two decaying noise
    bursts per window (the 2600 footstep cadence)."""
    rng = np.random.RandomState(1234)
    t = np.arange(WINDOW) / AUDIO_SR
    sig = np.zeros(WINDOW, dtype=np.float64)
    for onset in (0.0, 0.016):
        env = np.exp(-np.maximum(t - onset, 0) * 300.0) * (t >= onset)
        sig += env * rng.randn(WINDOW) * 0.8
    return (sig / np.abs(sig).max()).astype(np.float32)


@functools.lru_cache(maxsize=1)
def mfcc_resize_ops() -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Linear operators (W_rows, W_cols) lifting the per-window MFCC matrix
    (numcep, n_frames) to an (84, 84) plane by linear interpolation, so the
    device path is two small products."""
    p = SKELETON_PLUS_PARAMS
    n_frames = 1 + int(np.ceil(max(WINDOW - p.frame_len, 0) / p.frame_step))
    numcep = p.numcep

    def lin_matrix(n_in: int, n_out: int) -> np.ndarray:
        w = np.zeros((n_out, n_in), dtype=np.float32)
        if n_in == 1:
            w[:, 0] = 1.0
            return w
        src = np.linspace(0, n_in - 1, n_out)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = src - lo
        for i in range(n_out):
            w[i, lo[i]] += 1 - frac[i]
            w[i, hi[i]] += frac[i]
        return w

    return lin_matrix(numcep, IMG), lin_matrix(n_frames, IMG), (numcep, n_frames)


@functools.lru_cache(maxsize=1)
def silence_mfcc_stats() -> Tuple[float, float]:
    """(min, max) MFCC range over representative footstep windows, the
    FIXED normalisation of the audio planes to [-1, 1] (the reference
    min-max normalises per image, Minecraft.py:238-241; a streaming
    pipeline needs fixed statistics)."""
    base = footstep_window().astype(np.float64)
    vals = []
    for amp in (1.0, 0.3, 0.05, 0.0):
        feat = mfcc(base * amp * 32000.0, SKELETON_PLUS_PARAMS)
        vals.append(feat)
    allv = np.concatenate(vals)
    return float(allv.min()), float(allv.max())
