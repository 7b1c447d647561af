"""The native pool as the host loops step it (``algos/ppo/hostloop.py``,
``algos/dt/hostloop.py``): the C++ core emulates on the host, each step's
audio crosses to the device as its u8 code (``data/quant.py``), and the
observation is made on the device from the dequantised code, as the JAX
loops make it.  A two-player pool (``envs/pong_ma.py``) is stepped by agent
slot: its actions, rewards, done flags and observations have one row a
slot, as the JAX loop's ``cfg.num_envs`` rows are slots."""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from mmtrl_tpu_torch.data.quant import dequant_audio_u8, quant_audio_u8
from mmtrl_tpu_torch.envs.skeleton_native import NativeSkeletonPlus


def slot_count(env) -> int:
    """The rows a host loop steps: a multi-agent pool's ``num_slots``, else
    its ``num_envs``."""
    return getattr(env, "num_slots", env.num_envs)


class HostPool:
    """A native pool from a fresh reset.  ``host_s`` sums the seconds spent
    in the emulator."""

    def __init__(self, env: NativeSkeletonPlus):
        self.env = env
        self.frames, audio = env._host_reset()
        self.audio_u8 = quant_audio_u8(audio)
        self.done = np.zeros(slot_count(env), np.uint8)
        self.host_s = 0.0

    def obs(self) -> torch.Tensor:
        audio = dequant_audio_u8(torch.from_numpy(self.audio_u8).to(self.env.device))
        return self.env._obs(self.frames, audio)

    def done_tensor(self) -> torch.Tensor:
        """The done flags that precede the current observation, on the device."""
        return torch.from_numpy(self.done).to(self.env.device).bool()

    def step(self, action: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(reward, done, kills) of one pool step; keeps the new frames."""
        t0 = time.perf_counter()
        frames, audio, kd, ld, done, win, kills, _life = self.env._host_step(action)
        self.host_s += time.perf_counter() - t0
        self.frames, self.audio_u8, self.done = frames, quant_audio_u8(audio), done
        return self.env._reward(kd, ld, win), done, kills
