"""Two-player PONG on the repo's homebrew cartridge
(``native/homebrew/pong.bin``), both joysticks driven by agents; port of
``mmtrl_tpu/envs/pong_ma.py``.

The reference's multi-agent script (cleanrl/ppo_pettingzoo_ma_atari.py,
:150-159) trains one shared policy over both players of 2-player Pong.
Here the cartridge runs on the native 2600 core through
``native/atari/abi_env.cc``'s ``mmtrl_abi2`` entry points.

Each joint env holds two agent slots, interleaved ``[env0-p0, env0-p1,
env1-p0, ...]``.  Player 1's video plane is mirrored horizontally, so both
slots see "my paddle is on the left" and one policy plays both sides; the
audio tone encodes the ball's height, which the mirror keeps, so the MFCC
planes are shared.  Rewards are zero-sum: a slot's own score delta minus
the opponent's.  Episodes end at 21 points or the frame cap.
"""

from __future__ import annotations

import numpy as np
import torch

from mmtrl_tpu_torch.envs.homebrew_native import NativeHomebrew
from mmtrl_tpu_torch.envs.skeleton_native import FRAME_H, FRAME_W, NATIVE_DIR

NUM_AGENTS = 2
PONG_ROM = str(NATIVE_DIR / "homebrew" / "pong.bin")


class NativePong2P(NativeHomebrew):
    """A pool of ``num_envs`` joint cartridges, ``2 * num_envs`` agent slots.

    The host loop steps it by slot: ``_host_step`` takes interleaved slot
    actions (2n,) and returns per-slot rewards and done flags (2n,), while
    the frames and audio stay per joint env (n, ...); ``_obs`` expands them
    to slots.  A PPO batch is ``num_slots`` rows.
    """

    PREFIX = "mmtrl_abi2"

    def __init__(self, num_envs: int, rom_path: str = PONG_ROM, **kw):
        kw.setdefault("reward_mode", "score")
        super().__init__(num_envs=num_envs, rom_path=rom_path, **kw)
        self.num_joint = num_envs
        self.num_slots = NUM_AGENTS * num_envs
        # sticky actions repeat each player's own previous action
        self._sticky_prev = np.zeros(self.num_slots, np.int32)

    def _host_step(self, actions: np.ndarray):
        """(frames, audio, slot reward, zeros, done, win, own score,
        opponent's score) of one step of the (2n,) slot ``actions``: frames
        and audio per joint env, the rest per slot."""
        actions = np.ascontiguousarray(actions, dtype=np.int32)
        if self.repeat_action_probability > 0.0:
            m = self._sticky_rng.random(self.num_slots) < self.repeat_action_probability
            actions = np.where(m, self._sticky_prev, actions).astype(np.int32)
        n = self.num_joint
        frames = np.zeros((n, FRAME_H, FRAME_W), np.uint8)
        audio = np.zeros((n, 2, self.audio_len), np.float32)
        sd0, sd1, s0, s1 = (np.zeros(n, np.int32) for _ in range(4))
        done, win = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
        self._fn("step")(self._handle, actions, frames, audio, sd0, sd1, done, win, s0, s1)
        kd = np.stack([sd0 - sd1, sd1 - sd0], axis=1).reshape(-1)
        done2 = np.repeat(done, NUM_AGENTS)
        own = np.stack([s0, s1], axis=1).reshape(-1)
        opp = np.stack([s1, s0], axis=1).reshape(-1)
        if self.repeat_action_probability > 0.0:
            self._sticky_prev = np.where(done2.astype(bool), 0, actions).astype(np.int32)
        return frames, audio, kd, np.zeros_like(kd), done2, np.repeat(win, NUM_AGENTS), own, opp

    def _obs(self, frames, audio) -> torch.Tensor:
        """(2n, 3, 84, 84) slot observations of the joint envs' (n, 192, 160)
        frames and (n, 2, S) audio: player 1's video plane mirrored, the
        MFCC planes shared."""
        base = super()._obs(frames, audio)  # (n, 3, 84, 84)
        flipped = torch.cat([base[:, :1].flip(-1), base[:, 1:]], dim=1)
        return torch.stack([base, flipped], dim=1).reshape((-1,) + base.shape[1:])

    def step(self, state, action, generator=None):
        """Raises, as JAX's inherited ``v_step`` does: that one declares the
        joint envs' (n,) shapes for the per-slot (2n,) reward and done
        arrays of ``_host_step``, and ``io_callback`` rejects them ("Incorrect
        output shape").  ``reset`` is the inherited one and runs, as JAX's
        ``v_reset`` does: (2n, 3, 84, 84) slot observations, an (n,)
        counter.  The slot pool trains through the host loop
        (``scripts/ppo_ma_pong.py``)."""
        raise RuntimeError(f"{self.name}: the batched step has no slot surface: the "
                           f"per-slot arrays are ({self.num_slots},), the joint envs "
                           f"({self.num_joint},); step the pool through the host loop")

    @property
    def name(self) -> str:
        return "pong_ma_native"
