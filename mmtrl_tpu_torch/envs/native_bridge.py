"""Minecraft2d on the repo's C++ batched env engine (``native/envpool``);
port of ``mmtrl_tpu/envs/native_bridge.py``.

The EnvPool contract (reference: cleanrl/ppo_atari_envpool_xla_jax.py:
212-229): a pool of envs behind a handle, stepped by a ``(handle, action)
-> timestep`` call.  C++ owns the game logic across a thread pool and
returns compact (tile map, audio index) descriptors on the host; the
observation is made on the env's device with the render bank and MFCC
planes the device env (``envs/minecraft2d.py``) uses, so some 100 bytes an
env cross a step.  The library, ``native/build/libmmtrl_envpool.so``, is
built from ``native/envpool/gridworld.cc`` with ``g++`` at first use.

For the gridworld the device env is faster; the bridge is the protocol
for host-bound engines, held against the device env's render.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.envs.assets import GRID, IMG, audio_planes, minecraft_render_bank
from mmtrl_tpu_torch.envs.minecraft2d import render_frame
from mmtrl_tpu_torch.envs.skeleton_native import NATIVE_DIR, compile_library

LIB_PATH = NATIVE_DIR / "build" / "libmmtrl_envpool.so"
LIB_SOURCES = ("envpool/gridworld.cc",)  # native/Makefile's libmmtrl_envpool.so rule

_lib = None


def build_native() -> str:
    """The engine's library, compiled from the repo's source with the
    Makefile's flags when it is missing; its path."""
    return str(compile_library(LIB_PATH, LIB_SOURCES))


def load_native() -> ctypes.CDLL:
    """Load (building if needed) the engine and bind its C API."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        ptr = np.ctypeslib.ndpointer
        lib.mmtrl_make.restype = ctypes.c_int64
        lib.mmtrl_make.argtypes = [ctypes.c_int32, ctypes.c_uint64]
        lib.mmtrl_num_envs.restype = ctypes.c_int32
        lib.mmtrl_num_envs.argtypes = [ctypes.c_int64]
        lib.mmtrl_reset.restype = None
        lib.mmtrl_reset.argtypes = [ctypes.c_int64, ptr(np.int32, flags="C_CONTIGUOUS"),
                                    ptr(np.int32, flags="C_CONTIGUOUS")]
        lib.mmtrl_step.restype = None
        lib.mmtrl_step.argtypes = [
            ctypes.c_int64,
            ptr(np.int32, flags="C_CONTIGUOUS"),
            ptr(np.int32, flags="C_CONTIGUOUS"),
            ptr(np.int32, flags="C_CONTIGUOUS"),
            ptr(np.float32, flags="C_CONTIGUOUS"),
            ptr(np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.mmtrl_close.restype = None
        lib.mmtrl_close.argtypes = [ctypes.c_int64]
        _lib = lib
    return _lib


class NativeMinecraft2d:
    """A pool of ``num_envs`` gridworlds: ``obs = env.reset()``, then
    ``obs, rewards, dones = env.step(actions)``; the C++ pool resets done
    envs itself.  Observations, rewards and done flags are on ``device``
    (the card unless ``device="cpu"``)."""

    def __init__(self, num_envs: int, seed: int = 0, use_audio: bool = True,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.use_audio = use_audio
        self._handle = 0
        self._lib = load_native()
        self._handle = int(self._lib.mmtrl_make(num_envs, seed))
        self._bank = torch.tensor(minecraft_render_bank(), device=self.device)
        self._audio = torch.tensor(audio_planes(), device=self.device)

    def close(self):
        if self._handle:
            self._lib.mmtrl_close(self._handle)
            self._handle = 0

    # ---- host side ---------------------------------------------------------
    def _host_reset(self) -> Tuple[np.ndarray, np.ndarray]:
        tiles = np.zeros((self.num_envs, GRID * GRID), np.int32)
        audio = np.zeros(self.num_envs, np.int32)
        self._lib.mmtrl_reset(self._handle, tiles, audio)
        return tiles, audio

    def _host_step(self, actions: np.ndarray):
        """(tiles (N, 25) int32, audio index (N,) int32, rewards (N,)
        float32, dones (N,) uint8) of one pool step."""
        actions = np.ascontiguousarray(actions, dtype=np.int32)
        tiles = np.zeros((self.num_envs, GRID * GRID), np.int32)
        audio = np.zeros(self.num_envs, np.int32)
        rewards = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, np.uint8)
        self._lib.mmtrl_step(self._handle, actions, tiles, audio, rewards, dones)
        return tiles, audio, rewards, dones

    # ---- device side -------------------------------------------------------
    def _render(self, tiles, audio_idx) -> torch.Tensor:
        """(N, 2 or 1, 84, 84) observation of the (N, 25) tile maps and audio
        indices (arrays or tensors): the device env's frame (clipped to [0,
        255], then ``* 2/255 - 1``) and the MFCC plane of each index."""
        tiles = torch.as_tensor(tiles, device=self.device).long()
        frame = render_frame(self._bank, tiles)
        if not self.use_audio:
            return frame[:, None]
        audio_idx = torch.as_tensor(audio_idx, device=self.device).long()
        return torch.stack([frame, self._audio[audio_idx]], dim=1)

    # ---- public API --------------------------------------------------------
    def reset(self) -> torch.Tensor:
        return self._render(*self._host_reset())

    def step(self, actions) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(obs, rewards float32, dones bool) of one pool step; the actions
        (a tensor on any device, or an array) are copied to the host."""
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        tiles, audio, rewards, dones = self._host_step(actions)
        return (self._render(tiles, audio), torch.as_tensor(rewards, device=self.device),
                torch.as_tensor(dones.astype(bool), device=self.device))

    @property
    def observation_space(self):
        # the rendered planes lie in [-1, 1]
        return spaces.Box(-1.0, 1.0, (2 if self.use_audio else 1, IMG, IMG))

    @property
    def action_space(self):
        return spaces.Discrete(4)
