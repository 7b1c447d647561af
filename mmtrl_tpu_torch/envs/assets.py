"""Procedural assets and the linearised render banks of Minecraft2d and
Doorpuzzle; port of ``mmtrl_tpu/envs/assets.py``, numpy only.

The reference renders each step on the host: paste 20x20 tiles on a 104x104
canvas, convert to gray, bicubic-resize to 84x84 with OpenCV, scale to
[-1, 1].  Everything after tile selection is linear in the tile placement,
so it is precomputed once into a contribution bank

    C[cell, tile] = resize84(gray(canvas with `tile` alone at `cell`))

and a frame is one einsum of the one-hot tile map against it.  OpenCV's
INTER_CUBIC resize (Minecraft2d) and INTER_NEAREST resize (Doorpuzzle) are
rebuilt here as numpy matrices with its arithmetic, so the port needs no
OpenCV.  Tiles and wavs are the JAX package's procedural
stand-ins, bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from mmtrl_tpu_torch.ops.mfcc import mfcc_image

CELL = 20  # tile pixel size (reference: Config.py:75 PIXEL_SIZE)
GRID = 5  # rows == cols (reference: Config.py:73-74)
BORDER = 2  # boundary pixels (reference: Minecraft.py:248)
IMG = 84  # network input (reference: Config.py:137-138)
CANVAS = GRID * CELL + 2 * BORDER  # 104

# Tile ids (render priority agent > good > bad > gem > stone,
# reference: Minecraft.py:301-320).
T_STONE, T_AGENT, T_GOOD, T_BAD, T_GEM = range(5)
N_TILES = 5

# Doorpuzzle simple-render tile ids and gray values (reference:
# Doorpuzzle.py:289-296; canvas background 125, boundary 0,
# Doorpuzzle.py:384-390).
DP_BG, DP_AGENT, DP_T1, DP_T2, DP_KEY1, DP_KEY2, DP_OBSTACLE = range(7)
DP_N_TILES = 7
DP_GRAY = {
    DP_BG: 128.0,
    DP_KEY1: 0.0,
    DP_T1: 50.0,
    DP_KEY2: 235.0,
    DP_T2: 185.0,
    DP_AGENT: 255.0,
    DP_OBSTACLE: 100.0,
}


def _stone_texture(rng: np.random.RandomState) -> np.ndarray:
    base = rng.randint(95, 135, size=(CELL, CELL, 1)).astype(np.float32)
    return np.repeat(base, 3, axis=2)


def _draw_disk(img, cy, cx, r, color):
    yy, xx = np.mgrid[0:CELL, 0:CELL]
    img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r**2] = color
    return img


def _draw_rect(img, y0, y1, x0, x1, color):
    img[y0:y1, x0:x1] = color
    return img


@functools.lru_cache(maxsize=1)
def minecraft_tiles() -> np.ndarray:
    """(N_TILES, CELL, CELL, 3) float32 RGB tiles in [0, 255]."""
    rng = np.random.RandomState(7)
    stone = _stone_texture(rng)

    agent = stone.copy()  # humanoid: head + torso + legs
    _draw_disk(agent, 5, 10, 3, (224.0, 172.0, 105.0))
    _draw_rect(agent, 8, 14, 7, 13, (40.0, 90.0, 200.0))
    _draw_rect(agent, 14, 18, 7, 9, (60.0, 40.0, 20.0))
    _draw_rect(agent, 14, 18, 11, 13, (60.0, 40.0, 20.0))

    good = stone.copy()  # gold pickaxe: bright diagonal + handle
    for i in range(4, 16):
        good[i, 19 - i] = (250.0, 200.0, 30.0)
        good[i, min(20 - i, 19)] = (250.0, 200.0, 30.0)
    _draw_rect(good, 10, 18, 9, 11, (130.0, 80.0, 30.0))

    bad = stone.copy()  # bronze shovel: vertical handle + blade
    _draw_rect(bad, 3, 13, 9, 11, (150.0, 95.0, 60.0))
    _draw_rect(bad, 13, 18, 7, 13, (180.0, 180.0, 190.0))

    gem = stone.copy()  # gold-flecked stone (always gold, audio disambiguates)
    flecks = np.random.RandomState(21)
    for _ in range(14):
        y, x = flecks.randint(2, CELL - 2, size=2)
        gem[y : y + 2, x : x + 2] = (245.0, 190.0, 40.0)

    return np.stack([stone, agent, good, bad, gem]).astype(np.float32)


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of OpenCV's INTER_CUBIC resize along one
    axis: a 4-tap cubic with a = -0.75 at half-pixel centres, no widening
    when shrinking, and the border pixel replicated."""
    a = -0.75
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        fx = (i + 0.5) * scale - 0.5
        sx = math.floor(fx)
        t = fx - sx
        c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
        c1 = ((a + 2) * t - (a + 3)) * t * t + 1
        c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
        for c, j in zip((c0, c1, c2, 1 - c0 - c1 - c2), range(sx - 1, sx + 3)):
            w[i, min(max(j, 0), n_in - 1)] += c
    return w.astype(np.float32)


def _gray(img: np.ndarray) -> np.ndarray:
    return (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    ).astype(np.float32)


@functools.lru_cache(maxsize=1)
def minecraft_render_bank() -> np.ndarray:
    """(GRID*GRID, N_TILES, IMG, IMG) float32 contribution bank.

    frame84 = einsum('pt,ptyx->yx', one_hot(tile_map), bank) * 2/255 - 1
    """
    tiles_gray = _gray(minecraft_tiles())  # (N_TILES, CELL, CELL)
    w = cubic_resize_matrix(CANVAS, IMG)  # square canvas: rows and cols alike
    bank = np.zeros((GRID * GRID, N_TILES, IMG, IMG), dtype=np.float32)
    for p in range(GRID * GRID):
        r, c = divmod(p, GRID)
        canvas = np.zeros((CANVAS, CANVAS), dtype=np.float32)
        y0, x0 = r * CELL + BORDER, c * CELL + BORDER
        for t in range(N_TILES):
            canvas[y0 : y0 + CELL, x0 : x0 + CELL] = tiles_gray[t]
            bank[p, t] = w @ canvas @ w.T
    return bank


def nearest_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 0/1 weights of OpenCV's INTER_NEAREST resize
    along one axis: output pixel ``i`` takes source pixel
    ``min(floor(i * n_in / n_out), n_in - 1)`` (no half-pixel centres)."""
    src = np.minimum(np.arange(n_out) * n_in // n_out, n_in - 1)
    w = np.zeros((n_out, n_in), dtype=np.float32)
    w[np.arange(n_out), src] = 1.0
    return w


@functools.lru_cache(maxsize=1)
def doorpuzzle_render_bank() -> np.ndarray:
    """(GRID*GRID, DP_N_TILES, IMG, IMG) float32 contribution bank of
    Doorpuzzle's simple render, which resizes with INTER_NEAREST
    (Doorpuzzle.py:377); the canvas base, ``doorpuzzle_base_frame``, is zero."""
    w = nearest_resize_matrix(CANVAS, IMG)
    bank = np.zeros((GRID * GRID, DP_N_TILES, IMG, IMG), dtype=np.float32)
    for p in range(GRID * GRID):
        r, c = divmod(p, GRID)
        canvas = np.zeros((CANVAS, CANVAS), dtype=np.float32)
        y0, x0 = r * CELL + BORDER, c * CELL + BORDER
        for t in range(DP_N_TILES):
            canvas[y0 : y0 + CELL, x0 : x0 + CELL] = DP_GRAY[t]
            bank[p, t] = w @ canvas @ w.T
    return bank


@functools.lru_cache(maxsize=1)
def doorpuzzle_base_frame() -> np.ndarray:
    """(IMG, IMG) resized base canvas: 125, with the 2 px boundary and the
    cell interiors (which the tiles overwrite) zeroed.  The 5 x 5 cells
    fill the whole interior, so it is zero everywhere, and the port's frame
    is the bank's sum alone where the reference adds it."""
    canvas = np.full((CANVAS, CANVAS), 125.0, dtype=np.float32)
    canvas[:BORDER, :] = 0.0
    canvas[:, :BORDER] = 0.0
    canvas[-BORDER:, :] = 0.0
    canvas[:, -BORDER:] = 0.0
    canvas[BORDER : CANVAS - BORDER, BORDER : CANVAS - BORDER] = 0.0  # the 5 x 5 cells
    w = nearest_resize_matrix(CANVAS, IMG)
    return w @ canvas @ w.T


AUDIO_SR = 16000
AUDIO_LEN = 1.0  # seconds


def _tone(freqs, decay=3.0, sr=AUDIO_SR, length=AUDIO_LEN) -> np.ndarray:
    t = np.arange(int(sr * length)) / sr
    sig = sum(np.sin(2 * np.pi * f * t) / (i + 1) for i, f in enumerate(freqs))
    return (sig * np.exp(-decay * t)).astype(np.float64)


@functools.lru_cache(maxsize=1)
def audio_waveforms() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(good, bad, noise) int16 waveforms standing in for the reference wavs."""
    good = _tone([523.25, 659.25, 783.99], decay=2.0)  # major-chord chime
    bad = np.sign(_tone([155.56], decay=1.0)) * np.exp(
        -1.5 * np.arange(int(AUDIO_SR * AUDIO_LEN)) / AUDIO_SR
    )  # low square-wave buzz
    noise = np.random.RandomState(42).randn(int(AUDIO_SR * AUDIO_LEN)) * 0.3

    def to_i16(x):
        return np.clip(x / (np.abs(x).max() + 1e-9) * 32000, -32768, 32767).astype(np.int16)

    return to_i16(good), to_i16(bad), to_i16(noise)


@functools.lru_cache(maxsize=1)
def audio_planes() -> np.ndarray:
    """(3, IMG, IMG) float32 MFCC planes: [good, bad, no_listen]."""
    return np.stack(
        [mfcc_image(w, AUDIO_SR, IMG) for w in audio_waveforms()]
    ).astype(np.float32)
