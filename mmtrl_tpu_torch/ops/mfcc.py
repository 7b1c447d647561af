"""MFCC features; port of ``mmtrl_tpu/ops/mfcc.py``.

The features follow python_speech_features' formulas (winlen 0.025,
winstep 0.01, numcep 13, nfilt 26, nfft next_pow2(frame_len), preemph 0.97,
ceplifter 22, appendEnergy, rectangular window).  ``mfcc`` is the numpy
path (float64, the init-time planes of ``mfcc_image``); ``mfcc_tensor`` the
tensor path, float32 on the signal's device, batched over leading dims: the
streaming stereo windows of the native 2600 envs, per step.  The JAX
package resizes the (13, frames) feature image with PIL's bicubic filter;
here that resize is rebuilt as two numpy matrices with PIL's arithmetic, so
the port needs no PIL.  ``log_mel_spectrogram`` (the Skeleton+ embedding
path's log-mel features) runs under numpy in float64 or torch in float32,
as JAX's runs under numpy or jnp.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch


def _round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@dataclasses.dataclass(frozen=True)
class MFCCParams:
    samplerate: int = 16000
    winlen: float = 0.025
    winstep: float = 0.01
    numcep: int = 13
    nfilt: int = 26
    nfft: Optional[int] = None
    lowfreq: float = 0.0
    highfreq: Optional[float] = None
    preemph: float = 0.97
    ceplifter: int = 22
    append_energy: bool = True

    @property
    def frame_len(self) -> int:
        return _round_half_up(self.winlen * self.samplerate)

    @property
    def frame_step(self) -> int:
        return _round_half_up(self.winstep * self.samplerate)

    @property
    def fft_size(self) -> int:
        return self.nfft if self.nfft is not None else _next_pow2(self.frame_len)

    @property
    def high(self) -> float:
        return self.highfreq if self.highfreq is not None else self.samplerate / 2.0


# Skeleton+ / ALE streaming audio parameters (reference: Config.py:87-89).
SKELETON_PLUS_PARAMS = MFCCParams(samplerate=30720, winlen=0.010, winstep=0.003)


def mel_filterbank(params: MFCCParams) -> np.ndarray:
    """(nfilt, nfft//2+1) triangular mel filterbank, psf bin quantization."""
    mel_points = np.linspace(
        hz_to_mel(params.lowfreq), hz_to_mel(params.high), params.nfilt + 2
    )
    bins = np.floor(
        (params.fft_size + 1) * mel_to_hz(mel_points) / params.samplerate
    ).astype(np.int64)
    fbank = np.zeros((params.nfilt, params.fft_size // 2 + 1), dtype=np.float64)
    for j in range(params.nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank


def dct2_ortho_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) M with x @ M == scipy dct(x, type=2, norm='ortho')[:n_out]."""
    k = np.arange(n_out, dtype=np.float64)[None, :]
    n = np.arange(n_in, dtype=np.float64)[:, None]
    m = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    scale = np.full((1, n_out), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4.0 * n_in))
    return m * scale


def lifter_coeffs(params: MFCCParams) -> np.ndarray:
    if params.ceplifter <= 0:
        return np.ones(params.numcep, dtype=np.float64)
    n = np.arange(params.numcep, dtype=np.float64)
    return 1.0 + (params.ceplifter / 2.0) * np.sin(np.pi * n / params.ceplifter)


def _num_frames(slen: int, params: MFCCParams) -> int:
    if slen <= params.frame_len:
        return 1
    return 1 + int(math.ceil((slen - params.frame_len) / float(params.frame_step)))


def mfcc(signal: np.ndarray, params: MFCCParams = MFCCParams()) -> np.ndarray:
    """(num_frames, numcep) float64 MFCC features of a 1-D signal."""
    sig = np.asarray(signal, dtype=np.float64)
    sig = np.concatenate([sig[:1], sig[1:] - params.preemph * sig[:-1]])
    nframes = _num_frames(sig.shape[0], params)
    flen, fstep = params.frame_len, params.frame_step
    pad = (nframes - 1) * fstep + flen - sig.shape[0]
    sig = np.concatenate([sig, np.zeros(max(pad, 0))])
    frames = sig[np.arange(nframes)[:, None] * fstep + np.arange(flen)[None, :]]
    spec = np.fft.rfft(frames, n=params.fft_size, axis=-1)
    pspec = (spec.real**2 + spec.imag**2) / params.fft_size
    eps = np.finfo(np.float64).eps
    energy = pspec.sum(axis=-1)
    energy = np.where(energy == 0, eps, energy)
    feat = pspec @ mel_filterbank(params).T
    feat = np.log(np.where(feat == 0, eps, feat))
    feat = feat @ dct2_ortho_matrix(params.nfilt, params.numcep)
    feat = feat * lifter_coeffs(params)
    if params.append_energy:
        feat = np.concatenate([np.log(energy)[:, None], feat[:, 1:]], axis=-1)
    return feat


def log_mel_spectrogram(signal, params: MFCCParams = MFCCParams(), xp: Any = np):
    """(num_frames, nfilt) log-mel features of a 1-D signal: float64 numpy
    with ``xp=np``; with ``xp=torch`` float32 on the signal's device (a
    tensor's, else the CPU), the projection in full float32."""
    if xp is np:
        sig = np.asarray(signal, dtype=np.float64)
    else:
        sig = torch.as_tensor(signal).to(torch.float32)
    sig = xp.concatenate([sig[:1], sig[1:] - params.preemph * sig[:-1]])
    slen = int(sig.shape[0])
    nframes = _num_frames(slen, params)
    pad = max((nframes - 1) * params.frame_step + params.frame_len - slen, 0)
    idx = np.arange(nframes)[:, None] * params.frame_step + np.arange(params.frame_len)[None, :]
    if xp is np:
        frames = np.concatenate([sig, np.zeros(pad)])[idx]
        spec = np.fft.rfft(frames, n=params.fft_size, axis=-1)
        pspec = (spec.real**2 + spec.imag**2) / params.fft_size
        feat = pspec @ mel_filterbank(params).T
        return np.log(np.where(feat == 0, np.finfo(np.float64).eps, feat))
    frames = torch.nn.functional.pad(sig, (0, pad))[torch.as_tensor(idx, device=sig.device)]
    spec = torch.fft.rfft(frames, n=params.fft_size, dim=-1)
    pspec = (spec.real**2 + spec.imag**2) / params.fft_size
    feat = full_float32_matmul(pspec, _tensor_constants(params, sig.device)[0])
    return torch.log(torch.where(feat == 0, torch.finfo(torch.float32).eps, feat))


@functools.lru_cache(maxsize=None)
def _tensor_constants(params: MFCCParams, device: torch.device):
    """(mel filterbank transposed, DCT matrix, lifter) as float32 on ``device``."""
    return tuple(
        torch.tensor(m, dtype=torch.float32, device=device)
        for m in (mel_filterbank(params).T, dct2_ortho_matrix(params.nfilt, params.numcep),
                  lifter_coeffs(params))
    )


def full_float32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with TF32 off whatever the global flag says.  JAX forces
    ``Precision.HIGHEST`` on the MFCC's two projections: reduced-precision
    products cost about 0.1 after the log, and TF32 is one.  The Skeleton+
    simulator lifts its cepstra to 84x84 through it too."""
    if not a.is_cuda:
        return a @ b
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def mfcc_tensor(signal: torch.Tensor, params: MFCCParams = MFCCParams()) -> torch.Tensor:
    """(..., num_frames, numcep) float32 MFCC features of the last axis of
    ``signal``, on its device: the JAX ``mfcc(..., xp=jnp)`` under ``vmap``."""
    sig = signal.float()
    sig = torch.cat([sig[..., :1], sig[..., 1:] - params.preemph * sig[..., :-1]], dim=-1)
    slen = sig.shape[-1]
    nframes = _num_frames(slen, params)
    flen, fstep = params.frame_len, params.frame_step
    pad = (nframes - 1) * fstep + flen - slen
    if pad > 0:
        sig = torch.nn.functional.pad(sig, (0, pad))
    idx = torch.as_tensor(np.arange(nframes)[:, None] * fstep + np.arange(flen)[None, :],
                          device=sig.device)
    frames = sig[..., idx]  # (..., nframes, flen)
    spec = torch.fft.rfft(frames, n=params.fft_size, dim=-1)
    pspec = (spec.real**2 + spec.imag**2) / params.fft_size
    eps = torch.finfo(torch.float32).eps
    energy = pspec.sum(dim=-1)
    energy = torch.where(energy == 0, eps, energy)
    fbank_t, dct_m, lifter = _tensor_constants(params, sig.device)
    feat = full_float32_matmul(pspec, fbank_t)
    feat = torch.log(torch.where(feat == 0, eps, feat))
    feat = full_float32_matmul(feat, dct_m) * lifter
    if params.append_energy:
        feat = torch.cat([torch.log(energy)[..., None], feat[..., 1:]], dim=-1)
    return feat


def bicubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of PIL's BICUBIC resize along one axis.

    PIL's cubic has a = -0.5 and support 2, widened by the downscale factor
    when shrinking (an antialiasing filter), sampled at half-pixel centres,
    cut at the image edge and normalised to sum to one per output pixel.
    """
    a = -0.5

    def cubic(x: float) -> float:
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        if x < 2.0:
            return (((x - 5.0) * x + 8.0) * x - 4.0) * a
        return 0.0

    scale = n_in / n_out
    widen = max(scale, 1.0)
    support = 2.0 * widen
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        taps = np.array([cubic((j - center + 0.5) / widen) for j in range(lo, hi)])
        w[i, lo:hi] = taps / taps.sum()
    return w


def pil_bicubic_resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL's BICUBIC resize of a float image (mode 'F'): the input is taken
    as float32, rows are resized first, and each pass sums in float64 and
    stores float32, as PIL does."""
    x = np.asarray(img, dtype=np.float32).astype(np.float64)
    tmp = (x @ bicubic_resize_matrix(x.shape[1], width).T).astype(np.float32)
    out = bicubic_resize_matrix(x.shape[0], height) @ tmp.astype(np.float64)
    return out.astype(np.float32)


def mfcc_image(signal: np.ndarray, samplerate: int, size: int = 84) -> np.ndarray:
    """wav -> (size, size) float32 MFCC image in [-1, 1]: mfcc, time along
    x, bicubic resize, min-max normalise (reference:
    environments/Minecraft/Minecraft.py:231-243)."""
    feat = np.swapaxes(mfcc(signal, MFCCParams(samplerate=samplerate)), 0, 1)
    img = pil_bicubic_resize(feat, size, size)
    lo, hi = img.min(), img.max()
    img = (img - lo) / (hi - lo)
    return (img * 2.0 - 1.0).astype(np.float32)
