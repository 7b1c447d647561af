"""RL envs over the repo's homebrew 2600 cartridges (``native/homebrew/``);
port of ``mmtrl_tpu/envs/homebrew_native.py``.

The cartridges run through the generic RL-ABI adapter
(``native/atari/abi_env.cc``: $80 score, $81 lives, $82 status):

- RALLY (``rally.bin``): a wall-ball game whose audio channel 0 encodes the
  ball's height as pitch, so the stereo-MFCC planes carry game state;
- BRICK (``brick.bin``): a Breakout-class game whose brick-hit blips encode
  the struck row as pitch.

Observation synthesis and stepping are ``NativeSkeletonPlus``'s; the C-API
prefix, the reward (the ALE-style score delta) and the 6 actions differ.
The JAX env assembles a missing ROM from its ``.asm`` source with
``tools/asm6502.py``; both ROMs are committed, and a missing one raises
here.
"""

from __future__ import annotations

import os

import numpy as np

from mmtrl_tpu_torch.envs.skeleton_native import NATIVE_DIR, NativeSkeletonPlus

RALLY_ROM = str(NATIVE_DIR / "homebrew" / "rally.bin")
BRICK_ROM = str(NATIVE_DIR / "homebrew" / "brick.bin")


class NativeHomebrew(NativeSkeletonPlus):
    """A pool over a homebrew RL-ABI cartridge.

    Actions (abi_env.cc): 0 NOOP, 1 LEFT, 2 RIGHT, 3 UP, 4 DOWN, 5 FIRE.
    Reward: the score delta; ``reward_mode="win"`` adds +5 on reaching the
    game's win screen.
    """

    PREFIX = "mmtrl_abi"

    def __init__(self, num_envs: int, rom_path: str = RALLY_ROM, seed: int = 0,
                 frameskip: int = 8, episode_steps: int = 1500, reward_mode: str = "score",
                 repeat_action_probability: float = 0.0, device=None):
        super().__init__(num_envs=num_envs, rom_path=rom_path, seed=seed, frameskip=frameskip,
                         episode_steps=episode_steps, reward_mode=reward_mode,
                         repeat_action_probability=repeat_action_probability, device=device)
        self._rom_path = rom_path

    def _reward(self, kd, ld, win) -> np.ndarray:
        r = np.asarray(kd).astype(np.float32)
        if self.reward_mode == "win":
            r = r + np.float32(5.0) * np.asarray(win).astype(np.float32)
        return r

    @property
    def name(self) -> str:
        stem = os.path.splitext(os.path.basename(self._rom_path))[0]
        return f"{stem}_native"


class NativeBrick(NativeHomebrew):
    """The BRICK cartridge with its ROM as the default."""

    def __init__(self, num_envs: int, rom_path: str = BRICK_ROM, **kw):
        super().__init__(num_envs=num_envs, rom_path=rom_path, **kw)


def make_native_env(env_id: str, num_envs: int, rom_path: str = "", seed: int = 0,
                    frameskip: int = 8, episode_steps: int = 1500, reward_mode: str = "score",
                    repeat_action_probability: float = 0.0, device=None):
    """One factory for every native 2600 env.  Each family's reward modes
    differ (Skeleton+ 'shaped'/'kills', the homebrew games 'score'/'win'),
    so a script's default of the other family maps to this family's."""
    kw = dict(num_envs=num_envs, seed=seed, frameskip=frameskip, episode_steps=episode_steps,
              repeat_action_probability=repeat_action_probability, device=device)
    if env_id in ("rally_native", "brick_native"):
        default_rom = BRICK_ROM if env_id == "brick_native" else RALLY_ROM
        return NativeHomebrew(rom_path=rom_path or default_rom,
                              reward_mode="score" if reward_mode == "shaped" else reward_mode,
                              **kw)
    if env_id == "skeleton_plus_native":
        if rom_path:
            kw["rom_path"] = rom_path
        return NativeSkeletonPlus(reward_mode="shaped" if reward_mode == "score" else reward_mode,
                                  **kw)
    raise ValueError(f"unknown native env id: {env_id}")
