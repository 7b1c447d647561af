"""Rollout video capture, the reference's gym.wrappers.RecordVideo
(reference: src/train.py:35,55 records episodes under videos/<run_name>);
port of ``mmtrl_tpu/utils/video.py``.

The envs on the card have no render() window: the policy's own
observation stream is the rendering (channel 0 is the video frame in every
multimodal env here, already in [-1, 1]).  ``record_episode`` rolls a
greedy episode out on the env's device and brings the observations to the
host in one copy; ``write_gif`` writes them as an animated GIF with its
own encoder (no PIL): GIF89a, a 256-level grey palette, LZW, the
NETSCAPE2.0 loop block and a graphic-control delay a frame.  The file
decodes to what the JAX package's PIL-written file decodes to: the same
NEAREST resize, and, as PIL writes it, consecutive equal frames merged
into one whose delay is their summed duration.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Callable, Optional

import numpy as np
import torch


def obs_to_frames(obs: np.ndarray) -> np.ndarray:
    """(T, C, H, W) observations in [-1, 1] -> (T, H, W) uint8 frames.

    Channel 0 is the video plane for the multimodal envs; vector
    observations are rendered as a 1-row stripe chart.
    """
    obs = np.asarray(obs, np.float32)
    if obs.ndim == 4:
        frames = obs[:, 0]
    elif obs.ndim == 3:  # (T, H, W)
        frames = obs
    else:  # vector obs: tile each dim into a column stripe
        t, d = obs.shape[0], int(np.prod(obs.shape[1:]))
        flat = obs.reshape(t, d)
        lo, hi = flat.min(), flat.max()
        norm = (flat - lo) / max(hi - lo, 1e-6) * 2.0 - 1.0
        frames = np.repeat(np.repeat(norm[:, None, :], 64, axis=1), max(1, 64 // d), axis=2)
    return ((np.clip(frames, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)


def _nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output pixel of PIL's NEAREST resize: the
    pixel centre's coordinate, accumulated in float64 as PIL's scaling loop
    accumulates it, then truncated."""
    scale = n_in / n_out
    out = np.empty(n_out, np.int64)
    pos = scale * 0.5
    for i in range(n_out):
        out[i] = min(int(pos), n_in - 1)
        pos += scale
    return out


def _lzw(pixels: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a stream of palette indices: codes from
    ``min_size + 1`` bits up to 12, packed least significant bit first, a
    clear code first and whenever the 4,096-code table fills."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc, nbits, width = clear, min_size + 1, min_size + 1
    table: dict = {}
    get = table.get
    next_code = end + 1
    prefix = pixels[0]
    for b in pixels[1:]:
        key = prefix << 8 | b
        code = get(key)
        if code is not None:
            prefix = code
            continue
        acc |= prefix << nbits
        nbits += width
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > 1 << width and width < 12:
                width += 1
        else:
            acc |= clear << nbits
            nbits += width
            table.clear()
            next_code, width = end + 1, min_size + 1
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
        prefix = b
    acc |= prefix << nbits
    nbits += width
    acc |= end << nbits
    nbits += width
    while nbits > 0:
        out.append(acc & 0xFF)
        acc >>= 8
        nbits -= 8
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _gif_bytes(frames_u8: np.ndarray, duration_ms: int, loop: int = 0) -> bytes:
    """(T, H, W) uint8 grey frames -> the bytes of an animated GIF89a.  A run
    of equal consecutive frames is one image shown for the run's summed
    duration, its delay in whole centiseconds (truncated), as PIL writes
    it; a lone distinct frame is a still image with that delay.  As in
    PIL's file, an image carries its delay in a graphic-control block when
    the delay is not 0, and a later image also when it leaves a grey level
    free (PIL's block for the transparent index of its delta frames), so
    that the delays PIL reads back agree even where they truncate to 0."""
    frames = np.ascontiguousarray(frames_u8, dtype=np.uint8)
    if frames.ndim != 3 or not len(frames):
        raise ValueError(f"expected (T, H, W) uint8 grey frames, got {frames.shape}")
    t, h, w = frames.shape
    same = np.all(frames[1:] == frames[:-1], axis=(1, 2))
    starts = np.flatnonzero(np.concatenate([[True], ~same]))
    counts = np.diff(np.append(starts, t))
    palette = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette,
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for i, (start, count) in enumerate(zip(starts, counts)):
        delay = int(duration_ms * int(count) / 10)
        if delay or (i and len(np.unique(frames[start])) < 256):
            out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(b"\x08" + _sub_blocks(_lzw(frames[start].tobytes())))
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(frames_u8: np.ndarray, path: str, fps: int = 15, size=(168, 168)) -> str:
    """(T, H, W) uint8 grey frames -> animated GIF at ``path``, looping
    forever, ``int(1000 / fps)`` ms a frame.

    ``size``: output (width, height) by NEAREST resize; None keeps the
    native resolution.  The JAX writer also takes (T, H, W, 3) colour
    frames, which PIL quantises to an adaptive palette; no observation
    here is a colour image, and this writer takes grey frames only.
    """
    frames = np.asarray(frames_u8)
    if size is not None:
        width, height = size
        frames = frames[:, _nearest_indices(frames.shape[1], height)][
            :, :, _nearest_indices(frames.shape[2], width)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_gif_bytes(frames, int(1000 / fps)))
    return path


def read_gif_header(path: str) -> dict:
    """(width, height, frame count, loop count, delays in ms) of a GIF, by
    walking its blocks: enough to check a written file without a decoder."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    info = {"width": width, "height": height, "frames": 0, "loop": None, "delays_ms": []}
    delay = None

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    while True:
        block = data[pos]
        if block == 0x3B:
            return info
        if block == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                delay = struct.unpack("<H", data[pos + 4:pos + 6])[0] * 10
            elif label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                info["loop"] = struct.unpack("<H", data[pos + 16:pos + 18])[0]
            pos = skip_sub_blocks(pos + 2)
        elif block == 0x2C:
            lflags = data[pos + 9]
            pos += 10 + (3 << ((lflags & 7) + 1) if lflags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)
            info["frames"] += 1
            info["delays_ms"].append(delay)
            delay = None
        else:
            raise ValueError(f"{path}: unknown block 0x{block:02x} at byte {pos}")


@torch.no_grad()
def record_episode(env, step_policy: Callable, params, generator: torch.Generator,
                   num_steps: int = 256, initial_carry: Optional[Any] = None) -> np.ndarray:
    """Greedy rollout collecting env 0's observations, (T, ...obs).

    ``step_policy(params, obs, done, carry, generator) -> (action, carry)``;
    carry is None for feedforward agents.  Resets and steps draw from
    ``generator`` (on the env's device); a native or gymnasium pool rolls
    its own batch size.  Each step stays on the env's device; the
    observations come to the host in one copy at the end."""
    n = getattr(env, "num_envs", 1)
    obs, state = env.reset(n, generator)
    done = torch.zeros(n, dtype=torch.bool, device=obs.device)
    traj = torch.empty((num_steps,) + tuple(obs.shape[1:]), dtype=obs.dtype, device=obs.device)
    carry = initial_carry
    for t in range(num_steps):
        traj[t] = obs[0]
        action, carry = step_policy(params, obs, done, carry, generator)
        obs, state, _, done, _ = env.step(state, action, generator)
    return traj.cpu().numpy()


def capture_video(env, step_policy: Callable, params, run_name: str,
                  generator: torch.Generator, tag: str = "final", num_steps: int = 256,
                  initial_carry: Optional[Any] = None, video_dir: str = "videos") -> str:
    traj = record_episode(env, step_policy, params, generator, num_steps, initial_carry)
    return write_gif(obs_to_frames(traj), os.path.join(video_dir, run_name, f"{tag}.gif"))
