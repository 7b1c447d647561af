"""The raw native 2600 pool (``native/atari``), the ALE-equivalent path;
port of ``mmtrl_tpu/envs/atari_bridge.py``.

Each step gives per machine a (192, 160) colour-index video frame and a
(2, 524) stereo audio window at the TIA rate (about 31.4 kHz), with no
reward: the per-game adapters (``envs/skeleton_native.py``,
``envs/homebrew_native.py``) add reward and termination.  The frame's
resize and the streaming MFCC (``ops/mfcc.py::mfcc_tensor`` with
``SKELETON_PLUS_PARAMS``) belong to whoever consumes the stream; the pool
itself is host numpy, as in JAX.  It binds the ``mmtrl_atari_*`` entry
points of ``native/build/libmmtrl_atari.so``, which
``envs/skeleton_native.py`` builds from the repo's sources.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from mmtrl_tpu_torch.envs.skeleton_native import native_library

# Action bits: joystick and the console's reset switch
UP, DOWN, LEFT, RIGHT, FIRE, RESET_SWITCH = 0x01, 0x02, 0x04, 0x08, 0x10, 0x20

_bound = False


def load_native() -> ctypes.CDLL:
    """The 2600 library (built if needed) with its ``mmtrl_atari_*`` C API
    bound."""
    global _bound
    lib = native_library()
    if not _bound:
        ptr = np.ctypeslib.ndpointer
        lib.mmtrl_atari_make.restype = ctypes.c_int64
        lib.mmtrl_atari_make.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_uint64]
        lib.mmtrl_atari_frame_shape.restype = ctypes.c_int32
        lib.mmtrl_atari_frame_shape.argtypes = [ctypes.POINTER(ctypes.c_int32)] * 3
        lib.mmtrl_atari_step.restype = None
        lib.mmtrl_atari_step.argtypes = [
            ctypes.c_int64,
            ptr(np.uint8, flags="C_CONTIGUOUS"),
            ptr(np.uint8, flags="C_CONTIGUOUS"),
            ptr(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.mmtrl_atari_ram.restype = None
        lib.mmtrl_atari_ram.argtypes = [ctypes.c_int64, ptr(np.uint8, flags="C_CONTIGUOUS")]
        lib.mmtrl_atari_close.restype = None
        lib.mmtrl_atari_close.argtypes = [ctypes.c_int64]
        _bound = True
    return lib


class AtariPool:
    """``num_envs`` emulated 2600 machines on one ROM, one observation a
    frame step; the machines start a seed-dependent number of warmup
    frames apart."""

    def __init__(self, rom_path: str, num_envs: int, seed: int = 0):
        self._handle = 0
        self._lib = load_native()
        self.num_envs = num_envs
        self._handle = int(self._lib.mmtrl_atari_make(str(rom_path).encode(), num_envs, seed))
        if self._handle < 0:
            raise FileNotFoundError(f"cannot load ROM {rom_path!r}")
        h, w, alen = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
        self._lib.mmtrl_atari_frame_shape(ctypes.byref(h), ctypes.byref(w), ctypes.byref(alen))
        self.frame_shape = (h.value, w.value)
        self.audio_len = alen.value

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``actions`` (N,) uint8 bitmasks -> (frames (N, H, W) uint8 colour
        indices, audio (N, 2, audio_len) float32 in [0, 1])."""
        actions = np.ascontiguousarray(actions, dtype=np.uint8)
        frames = np.zeros((self.num_envs,) + self.frame_shape, np.uint8)
        audio = np.zeros((self.num_envs, 2, self.audio_len), np.float32)
        self._lib.mmtrl_atari_step(self._handle, actions, frames, audio)
        return frames, audio

    def ram(self) -> np.ndarray:
        """(N, 128) uint8 RIOT RAM of every machine."""
        out = np.zeros((self.num_envs, 128), np.uint8)
        self._lib.mmtrl_atari_ram(self._handle, out)
        return out

    def close(self):
        if self._handle > 0:
            self._lib.mmtrl_atari_close(self._handle)
            self._handle = 0
