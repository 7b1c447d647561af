"""Skeleton+ on the device: a maze hunt with streaming stereo audio, batched;
port of ``mmtrl_tpu/envs/skeleton_plus.py``.

A behavioural model of the Skeleton+ 2600 cartridge (SkelPlus.txt §2):
the agent hunts a pursuing skeleton through a maze; the skeleton is
visible only in the line of sight ahead, and its footsteps are always
audible, volume for distance and front/back, stereo balance for left/right.
Five kills win; contact drains life; each new skeleton takes one more hit
and it speeds up over the episode.

Per step, on the envs' device:

1. the dynamics through the BFS tables (pursuit, distance, line of sight)
   of ``envs/skeleton_assets.py``;
2. the stereo synthesis: the base footstep window scaled by each channel's
   gain, plus noise, at the cartridge's 30,720 Hz;
3. the streaming MFCC of all 2N windows at once
   (``ops/mfcc.py::mfcc_tensor``) and its lift to 84x84 by two fixed
   matrices, TF32 kept out of every product;
4. the observation (N, 3, 84, 84) in [-1, 1]: the top-down frame, the left
   and the right MFCC planes under fixed statistics.

Three draws make the env random, each behind a hook that a test can
replace, as ``Minecraft2d``'s ``sampler``: ``reset_sampler`` (two distinct
open cells and a facing), ``step_sampler`` (the fire roll's uniform and the
respawn cell's index) and ``noise_sampler`` (the two channels' standard
normal noise).  By default they draw from the generator that ``reset`` and
``step`` are given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.base import Environment, StepResult
from mmtrl_tpu_torch.envs.skeleton_assets import (
    FACING_DELTAS,
    IMG,
    SIZE,
    WINDOW,
    cell_tables,
    footstep_window,
    maze,
    mfcc_resize_ops,
    open_cells,
    render_layers,
    silence_mfcc_stats,
)
from mmtrl_tpu_torch.ops.mfcc import SKELETON_PLUS_PARAMS, full_float32_matmul, mfcc_tensor

# Actions (the cartridge's joystick and fire button)
FORWARD, TURN_LEFT, TURN_RIGHT, FIRE, NOOP = range(5)

MAX_STEPS = 400
KILLS_TO_WIN = 5
START_LIFE = 3
REWARD_KILL = 10.0
REWARD_WIN = 50.0
REWARD_HIT_TAKEN = -5.0
REWARD_STEP = -0.01
FIRE_RANGE = 6
HIT_PROBABILITY = 0.8

# (cells (n, 2) long flat maze cells, distinct per row: agent, skeleton;
#  facing (n,) long in [0, 4))
ResetDraw = Tuple[torch.Tensor, torch.Tensor]
# (fire roll (n,) float32 uniform in [0, 1); respawn (n,) long index into
#  the open cells)
StepDraw = Tuple[torch.Tensor, torch.Tensor]
Sampler = Callable[[int, Optional[torch.Generator]], object]


@dataclasses.dataclass
class SkeletonState:
    agent: torch.Tensor  # (n,) long flat cell
    facing: torch.Tensor  # (n,) long 0..3 (N, E, S, W)
    skeleton: torch.Tensor  # (n,) long flat cell
    skel_hits: torch.Tensor  # (n,) long hits landed on the current skeleton
    kills: torch.Tensor  # (n,) long
    life: torch.Tensor  # (n,) long
    t: torch.Tensor  # (n,) long
    phase: torch.Tensor  # (n,) long footstep phase


class SkeletonPlusSim(Environment):
    def __init__(self, device: DeviceLike = None, reset_sampler: Optional[Sampler] = None,
                 step_sampler: Optional[Sampler] = None,
                 noise_sampler: Optional[Sampler] = None):
        self.device = dev = resolve_device(device)
        self.reset_sampler = reset_sampler or self.draw_reset
        self.step_sampler = step_sampler or self.draw_step
        self.noise_sampler = noise_sampler or self.draw_noise

        def tensor(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        next_step, dist, vis = cell_tables()
        self._next = tensor(next_step, torch.long)
        self._dist = tensor(dist)
        self._vis = tensor(vis)
        self._wall_map = tensor(maze().reshape(-1).astype(bool))
        wall, agent_bank, skel_bank = render_layers()
        self._wall, self._agent_bank, self._skel_bank = map(tensor, (wall, agent_bank, skel_bank))
        cells = open_cells()
        self._open = tensor(cells[:, 0] * SIZE + cells[:, 1], torch.long)
        self._deltas = tensor(FACING_DELTAS, torch.long)
        self._fdeltas = tensor(FACING_DELTAS, torch.float32)
        self._footstep = tensor(footstep_window())
        w_rows, w_cols, _ = mfcc_resize_ops()
        self._w_rows, self._w_cols_t = tensor(w_rows), tensor(w_cols.T)
        self._mfcc_lo, self._mfcc_hi = silence_mfcc_stats()

    # ---- draws -----------------------------------------------------------
    def draw_reset(self, n: int, generator: Optional[torch.Generator] = None) -> ResetDraw:
        """Two distinct open cells (uniform, without replacement) and a facing."""
        idx = torch.rand(n, self._open.shape[0], generator=generator,
                         device=self.device).argsort(dim=-1)[:, :2]
        facing = torch.randint(0, 4, (n,), generator=generator, device=self.device)
        return self._open[idx], facing

    def draw_step(self, n: int, generator: Optional[torch.Generator] = None) -> StepDraw:
        roll = torch.rand(n, generator=generator, device=self.device)
        respawn = torch.randint(0, self._open.shape[0], (n,), generator=generator,
                                device=self.device)
        return roll, respawn

    def draw_noise(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(n, 2, WINDOW) standard normals, the left and right channels'."""
        return torch.randn(n, 2, WINDOW, generator=generator, device=self.device)

    # ---- reset -----------------------------------------------------------
    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        cells, facing = self.reset_sampler(num_envs, generator)
        cells = cells.to(self.device, torch.long)
        zeros = torch.zeros(num_envs, dtype=torch.long, device=self.device)
        state = SkeletonState(
            agent=cells[:, 0], facing=facing.to(self.device, torch.long), skeleton=cells[:, 1],
            skel_hits=zeros, kills=zeros, life=torch.full_like(zeros, START_LIFE), t=zeros,
            phase=zeros,
        )
        return self._obs(state, self.noise_sampler(num_envs, generator)), state

    # ---- observation -----------------------------------------------------
    def _audio_gains(self, s: SkeletonState) -> torch.Tensor:
        """(n, 2) left and right footstep amplitudes (SkelPlus.txt:44-50),
        float32 as the JAX env computes them."""
        base = 1.0 / (1.0 + 0.7 * self._dist[s.agent, s.skeleton])
        dvec = torch.stack([s.skeleton // SIZE - s.agent // SIZE,
                            s.skeleton % SIZE - s.agent % SIZE], dim=-1).float()
        norm = torch.clamp(torch.sqrt((dvec * dvec).sum(-1)), min=1e-6)
        fvec = self._fdeltas[s.facing]
        frontness = (dvec * fvec).sum(-1) / norm  # +1 ahead, -1 behind
        base = base * (1.0 + 0.5 * frontness)
        # In (row, col) screen coordinates the right of facing (fr, fc) is
        # (fc, -fr): facing North (-1, 0) has East (0, 1) on its right.
        rightness = (dvec[:, 0] * fvec[:, 1] - dvec[:, 1] * fvec[:, 0]) / norm
        left = base * torch.clamp(1.0 - rightness, 0.2, 2.0)
        right = base * torch.clamp(1.0 + rightness, 0.2, 2.0)
        return torch.stack([left, right], dim=-1)

    def _audio_planes(self, gains: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """(n, 2, 84, 84): each channel's window through the streaming MFCC,
        lifted to 84x84 and normalised by the fixed statistics."""
        n = gains.shape[0]
        sig = (self._footstep * gains[..., None] + noise * 0.01) * 32000.0
        feat = mfcc_tensor(sig.reshape(2 * n, WINDOW), SKELETON_PLUS_PARAMS)
        feat = feat.transpose(1, 2)  # time along x, as the reference's swapaxes
        img = full_float32_matmul(full_float32_matmul(self._w_rows, feat), self._w_cols_t)
        img = (img - self._mfcc_lo) / (self._mfcc_hi - self._mfcc_lo)
        return torch.clamp(img * 2.0 - 1.0, -1.0, 1.0).reshape(n, 2, IMG, IMG)

    def _obs(self, s: SkeletonState, noise: torch.Tensor) -> torch.Tensor:
        """(n, 3, 84, 84) observation of ``s`` with the audio ``noise``
        ((n, 2, WINDOW) standard normals)."""
        visible = self._vis[s.agent, s.facing, s.skeleton]
        frame = (self._wall + self._agent_bank[s.agent]
                 + self._skel_bank[s.skeleton] * visible[:, None, None])
        frame = torch.clamp(frame, 0.0, 255.0) * (2.0 / 255.0) - 1.0
        planes = self._audio_planes(self._audio_gains(s), noise.to(self.device))
        return torch.cat([frame[:, None], planes], dim=1)

    # ---- step ------------------------------------------------------------
    def _step_env(self, state: SkeletonState, action: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> StepResult:
        n = action.shape[0]
        roll, respawn_idx = self.step_sampler(n, generator)
        action = action.to(self.device)

        # The agent's move or turn.
        delta = self._deltas[state.facing]
        fwd_cell = (state.agent // SIZE + delta[:, 0]) * SIZE + state.agent % SIZE + delta[:, 1]
        can_move = ~self._wall_map[fwd_cell]
        agent = torch.where((action == FORWARD) & can_move, fwd_cell, state.agent)
        facing = torch.where(action == TURN_LEFT, (state.facing + 3) % 4,
                             torch.where(action == TURN_RIGHT, (state.facing + 1) % 4,
                                         state.facing))

        # Fire: hits a skeleton in sight within range, not always ("not a
        # dead shot", SkelPlus.txt §2); each skeleton takes one more hit.
        in_sight = self._vis[agent, facing, state.skeleton]
        in_range = self._dist[agent, state.skeleton] <= FIRE_RANGE
        hit = (action == FIRE) & in_sight & in_range & (roll.to(self.device) < HIT_PROBABILITY)
        skel_hits = state.skel_hits + hit.long()
        killed = skel_hits >= 1 + state.kills
        kills = state.kills + killed.long()

        # Pursuit: one move every max(3 - t // 100, 1) steps; a killed
        # skeleton respawns at a random open cell.
        moves = state.t % torch.clamp(3 - state.t // 100, min=1) == 0
        skeleton = torch.where(moves, self._next[state.skeleton, agent], state.skeleton)
        skeleton = torch.where(killed, self._open[respawn_idx.to(self.device)], skeleton)
        skel_hits = torch.where(killed, 0, skel_hits)

        # Contact drains life.
        touched = (skeleton == agent) & ~killed
        life = state.life - touched.long()

        won = kills >= KILLS_TO_WIN
        new = SkeletonState(agent=agent, facing=facing, skeleton=skeleton, skel_hits=skel_hits,
                            kills=kills, life=life, t=state.t + 1, phase=(state.phase + 1) % 4)
        done = won | (life <= 0) | (new.t >= MAX_STEPS)
        reward = (REWARD_STEP + REWARD_KILL * killed.float() + REWARD_WIN * won.float()
                  + REWARD_HIT_TAKEN * touched.float())
        info: Dict[str, torch.Tensor] = {"kills": kills, "life": life}
        return self._obs(new, self.noise_sampler(n, generator)), new, reward, done, info

    # ---- spaces ----------------------------------------------------------
    @property
    def observation_space(self):
        return spaces.Box(-1.0, 1.0, (3, IMG, IMG))

    @property
    def action_space(self):
        return spaces.Discrete(5)

    @property
    def name(self):
        return "skeleton_plus"
