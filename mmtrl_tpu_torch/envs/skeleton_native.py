"""Skeleton+ on the real ROM over the native 2600 core; port of
``mmtrl_tpu/envs/skeleton_native.py``.

The cartridge runs on the repo's C++ 2600 core (``native/atari``) behind
ctypes, with the per-game RAM adapter of ``native/atari/skel_env.cc``; the
library is built from the repo's sources at first use.  C++ owns emulation
across a thread pool and returns raw (frame, stereo window, reward
components) on the host; the observation is made on the env's device:

  video: (192, 160) TIA colour indices -> luma LUT -> two bilinear 84 x 84
         products;
  audio: (2, 524 * frameskip) TIA samples -> streaming MFCC
         (``ops/mfcc.py::mfcc_tensor``, winlen 0.010, winstep 0.003) ->
         84 x 84 planes, each min-max normalised to [-1, 1].

Observation (3, 84, 84) = [frame, MFCC-L, MFCC-R] in [-1, 1]; 5 actions
(FORWARD, TURN_LEFT, TURN_RIGHT, FIRE, NOOP).  Two surfaces step the pool:

- the host loops (``algos/ppo/hostloop.py``, ``algos/dt/hostloop.py``) call
  ``_host_reset``/``_host_step`` and ``_obs`` themselves;
- ``reset(num_envs)``/``step(state, action)``, the batched-env surface of
  the fused loops (``algos/ppo/core.py::make_recurrent_ppo``,
  ``utils/evaluate.py``): the JAX env's ``v_reset``/``v_step``, which reach
  the host through an ordered ``io_callback``.  Here the loop is Python, so
  each step copies the action to the host (one device -> host sync) and
  the arrays back.  The state is a step counter; the C++ pool resets done
  envs itself, so ``step`` has no auto-reset and its ``info`` no
  ``final_obs``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.envs import spaces
from mmtrl_tpu_torch.ops.mfcc import SKELETON_PLUS_PARAMS, mfcc_tensor

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "build" / "libmmtrl_atari.so"
# native/Makefile's libmmtrl_atari.so rule: its sources and flags.
LIB_SOURCES = ("atari/m6502.cc", "atari/atari_pool.cc", "atari/skel_env.cc", "atari/abi_env.cc")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-pthread")
# ROM lookup: $MMTRL_SKELETON_ROM, then a repo-local roms/ drop-in.
_ROM_CANDIDATES = (
    os.environ.get("MMTRL_SKELETON_ROM", ""),
    str(NATIVE_DIR.parent / "roms" / "SkelPlus.bin"),
)
DEFAULT_ROM = next((p for p in _ROM_CANDIDATES if p and os.path.exists(p)),
                   _ROM_CANDIDATES[-1])

IMG = 84
FRAME_H, FRAME_W = 192, 160
AUDIO_GAIN = 32000.0  # [0, 1] volumes -> the reference's int16-like scale

# Reward shaping of the simulator (envs/skeleton_plus.py), so returns are
# comparable across backends; "kills" is the ALE-style score delta.
REWARD_KILL = 10.0
REWARD_WIN = 50.0
REWARD_LIFE = 0.5  # per life point lost
REWARD_STEP = -0.01

_lib = None
_BOUND_PREFIXES = set()


def compile_library(lib_path: Path, sources, include_flags=()) -> Path:
    """``lib_path`` compiled from ``sources`` (relative to ``native/``) with
    ``native/Makefile``'s flags when it is missing.  The compiler writes a
    temporary file that is renamed into place, so processes building at
    once never load a half-written library.  Raises with the compiler's
    output when the build fails."""
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.tmp.{os.getpid()}")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, *include_flags, *sources, *LDFLAGS,
           "-o", str(tmp)]
    r = subprocess.run(cmd, cwd=NATIVE_DIR, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {lib_path} failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def build_native() -> Path:
    """``native/build/libmmtrl_atari.so``, built from the repo's sources when
    it is missing."""
    return compile_library(LIB_PATH, LIB_SOURCES, ("-Iatari",))


def native_library() -> ctypes.CDLL:
    """The 2600 library, built if needed and loaded once a process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build_native()))
    return _lib


def load_native(prefix: str = "mmtrl_skel") -> ctypes.CDLL:
    """Load (building if needed) the 2600 library and bind one adapter's C
    API.  Both adapters (``skel_env.cc`` for Skeleton+, ``abi_env.cc`` for
    the homebrew cartridges) export the same signatures under their own
    prefixes."""
    native_library()
    if prefix not in _BOUND_PREFIXES:
        ptr = np.ctypeslib.ndpointer

        def fn(name):
            return getattr(_lib, f"{prefix}_{name}")

        fn("make").restype = ctypes.c_int64
        fn("make").argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_uint64,
                               ctypes.c_int32, ctypes.c_int32]
        fn("shape").restype = ctypes.c_int32
        fn("shape").argtypes = [ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int32)] * 4
        fn("reset").restype = None
        fn("reset").argtypes = [ctypes.c_int64, ptr(np.uint8, flags="C_CONTIGUOUS"),
                                ptr(np.float32, flags="C_CONTIGUOUS")]
        fn("step").restype = None
        fn("step").argtypes = [
            ctypes.c_int64,
            ptr(np.int32, flags="C_CONTIGUOUS"),
            ptr(np.uint8, flags="C_CONTIGUOUS"),
            ptr(np.float32, flags="C_CONTIGUOUS"),
            ptr(np.int32, flags="C_CONTIGUOUS"),
            ptr(np.int32, flags="C_CONTIGUOUS"),
            ptr(np.uint8, flags="C_CONTIGUOUS"),
            ptr(np.uint8, flags="C_CONTIGUOUS"),
            ptr(np.int32, flags="C_CONTIGUOUS"),
            ptr(np.int32, flags="C_CONTIGUOUS"),
        ]
        fn("ram").restype = None
        fn("ram").argtypes = [ctypes.c_int64, ptr(np.uint8, flags="C_CONTIGUOUS")]
        fn("close").restype = None
        fn("close").argtypes = [ctypes.c_int64]
        _BOUND_PREFIXES.add(prefix)
    return _lib


def _lin_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation operator."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        w[:, 0] = 1.0
        return w
    src = np.linspace(0, n_in - 1, n_out)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    for i in range(n_out):
        w[i, lo[i]] += 1 - frac[i]
        w[i, hi[i]] += frac[i]
    return w


@functools.lru_cache(maxsize=1)
def _luma_lut() -> np.ndarray:
    """TIA colour index (COLUxx >> 1, 7 bits) -> grey level in [0, 255]:
    the low 3 bits are the luminance ramp, the hue is ignored."""
    idx = np.arange(128, dtype=np.float32)
    return (np.mod(idx, 8) * (255.0 / 7.0)).astype(np.float32)


class NativeSkeletonPlus:
    """A pool of ``num_envs`` emulated cartridges; the observation is made
    on ``device`` (the card unless ``device="cpu"``).  Not an
    ``envs/base.py::Environment``: that class's ``step`` would auto-reset
    through ``reset``, which restarts every cartridge, while the C++ pool
    resets only the envs that are done."""

    PREFIX = "mmtrl_skel"

    def _fn(self, name: str):
        return getattr(self._lib, f"{self.PREFIX}_{name}")

    def __init__(
        self,
        num_envs: int,
        rom_path: str = DEFAULT_ROM,
        seed: int = 0,
        frameskip: int = 8,
        episode_steps: int = 1500,
        reward_mode: str = "shaped",
        repeat_action_probability: float = 0.0,
        device: DeviceLike = None,
    ):
        if not os.path.exists(rom_path):
            raise FileNotFoundError(f"ROM not found at {rom_path!r}")
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.frameskip = frameskip
        self.episode_steps = episode_steps
        self.reward_mode = reward_mode
        # ALE-v5 sticky actions: with probability p the previous executed
        # action runs instead of the agent's; it restarts at noop with
        # each episode.
        self.repeat_action_probability = float(repeat_action_probability)
        self._sticky_rng = np.random.default_rng((seed << 8) ^ 0xA1E)
        self._sticky_prev = np.zeros(num_envs, np.int32)
        self._handle = 0
        self._lib = load_native(self.PREFIX)
        self._handle = int(self._fn("make")(rom_path.encode(), num_envs, seed, frameskip,
                                            episode_steps * frameskip))
        if self._handle < 0:
            raise RuntimeError(f"cannot load ROM {rom_path!r}")
        h, w, alen, nact = (ctypes.c_int32() for _ in range(4))
        self._fn("shape")(self._handle, ctypes.byref(h), ctypes.byref(w), ctypes.byref(alen),
                          ctypes.byref(nact))
        assert (h.value, w.value) == (FRAME_H, FRAME_W)
        self.audio_len = alen.value
        self._num_actions = nact.value

        # Constants of the observation synthesis, on the device.
        p = SKELETON_PLUS_PARAMS
        n_frames = 1 + int(np.ceil(max(self.audio_len - p.frame_len, 0) / p.frame_step))
        dev = self.device
        self._lut = torch.tensor(_luma_lut(), device=dev)
        self._w_rows = torch.tensor(_lin_matrix(FRAME_H, IMG), device=dev)
        self._w_cols = torch.tensor(_lin_matrix(FRAME_W, IMG), device=dev)
        self._m_rows = torch.tensor(_lin_matrix(p.numcep, IMG), device=dev)
        self._m_cols = torch.tensor(_lin_matrix(n_frames, IMG), device=dev)

    # ---- host side ---------------------------------------------------------
    def _host_reset(self) -> Tuple[np.ndarray, np.ndarray]:
        frames = np.zeros((self.num_envs, FRAME_H, FRAME_W), np.uint8)
        audio = np.zeros((self.num_envs, 2, self.audio_len), np.float32)
        self._fn("reset")(self._handle, frames, audio)
        self._sticky_prev[:] = 0
        return frames, audio

    def _host_step(self, actions: np.ndarray):
        """(frames, audio, kill delta, life delta, done, win, kills, life),
        numpy arrays over the pool; done envs are reset by the C++ pool."""
        actions = np.ascontiguousarray(actions, dtype=np.int32)
        if self.repeat_action_probability > 0.0:
            m = self._sticky_rng.random(self.num_envs) < self.repeat_action_probability
            actions = np.where(m, self._sticky_prev, actions).astype(np.int32)
        n = self.num_envs
        frames = np.zeros((n, FRAME_H, FRAME_W), np.uint8)
        audio = np.zeros((n, 2, self.audio_len), np.float32)
        kd, ld, kills, life = (np.zeros(n, np.int32) for _ in range(4))
        done, win = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
        self._fn("step")(self._handle, actions, frames, audio, kd, ld, done, win, kills, life)
        if self.repeat_action_probability > 0.0:
            self._sticky_prev = np.where(done.astype(bool), 0, actions)
        return frames, audio, kd, ld, done, win, kills, life

    def ram(self) -> np.ndarray:
        out = np.zeros((self.num_envs, 128), np.uint8)
        self._fn("ram")(self._handle, out)
        return out

    def close(self):
        if self._handle > 0:
            self._fn("close")(self._handle)
            self._handle = 0

    # ---- device side -------------------------------------------------------
    def _obs(self, frames, audio) -> torch.Tensor:
        """(N, 3, 84, 84) float32 observation on the env's device from the
        host's (N, 192, 160) frames and (N, 2, S) audio volumes in [0, 1]
        (arrays or tensors)."""
        frames = torch.as_tensor(frames, device=self.device)
        audio = torch.as_tensor(audio, device=self.device).float()
        gray = self._lut[frames.long()]  # (N, 192, 160)
        frame_plane = (self._w_rows @ gray @ self._w_cols.T) * (2.0 / 255.0) - 1.0

        sig = audio.reshape(-1, self.audio_len) * AUDIO_GAIN  # (N * 2, S)
        feats = mfcc_tensor(sig, SKELETON_PLUS_PARAMS).transpose(1, 2)  # (N * 2, 13, frames)
        planes = self._m_rows @ feats @ self._m_cols.T
        # Per-window min-max to [-1, 1] (the reference's normalisation,
        # Minecraft.py:238-241, per step).
        lo = planes.amin(dim=(1, 2), keepdim=True)
        hi = planes.amax(dim=(1, 2), keepdim=True)
        planes = (planes - lo) / torch.clamp(hi - lo, min=1e-6) * 2.0 - 1.0
        planes = planes.reshape(self.num_envs, 2, IMG, IMG)
        return torch.cat([frame_plane[:, None], planes], dim=1)

    def _reward(self, kd, ld, win) -> np.ndarray:
        """(N,) float32 host reward of one step's components."""
        kd, ld, win = (np.asarray(x).astype(np.float32) for x in (kd, ld, win))
        if self.reward_mode == "kills":
            return kd
        return (REWARD_KILL * kd + REWARD_LIFE * ld + REWARD_WIN * win
                + np.float32(REWARD_STEP)).astype(np.float32)

    # ---- batched-env surface of the fused loops ------------------------------
    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """(obs, state): the pool reset and its observation on the device,
        the state an int32 step counter at 0.  ``num_envs`` must be the
        pool's size.  ``generator`` is accepted and unused, as JAX ignores
        its keys: the C++ pool's per-env generators and the sticky-action
        generator draw the randomness, so a reset takes nothing from the
        run's generator."""
        if num_envs != self.num_envs:
            raise ValueError(f"{self.name}: a pool of {self.num_envs} envs cannot reset "
                             f"{num_envs}")
        obs = self._obs(*self._host_reset())
        return obs, torch.zeros(num_envs, dtype=torch.int32, device=self.device)

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """(obs, state + 1, reward, done, info) of one pool step under
        ``action`` (N,): the action is copied to the host (a device -> host
        sync), the pool steps and resets its done envs, and the observation
        is made on the device.  Reward float32 and done bool on the device,
        ``info = {"kills", "life"}`` int32; no ``final_obs``.  ``generator``
        is unused, as in ``reset``."""
        actions = np.asarray(action.detach().cpu(), dtype=np.int32)
        frames, audio, kd, ld, done, win, kills, life = self._host_step(actions)
        dev = self.device
        info: Dict[str, torch.Tensor] = {"kills": torch.as_tensor(kills, device=dev),
                                         "life": torch.as_tensor(life, device=dev)}
        return (self._obs(frames, audio), state + 1,
                torch.as_tensor(self._reward(kd, ld, win), device=dev),
                torch.as_tensor(done.astype(bool), device=dev), info)

    # ---- spaces ------------------------------------------------------------
    @property
    def observation_space(self):
        return spaces.Box(-1.0, 1.0, (3, IMG, IMG))

    @property
    def action_space(self):
        return spaces.Discrete(self._num_actions)

    @property
    def num_actions(self) -> int:
        return self._num_actions

    @property
    def name(self) -> str:
        return "skeleton_plus_native"
