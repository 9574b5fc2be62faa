"""The log-mel front end's constants and its power spectrum
(deepfake_tpu/ops/mel.py:38-127): librosa's defaults (periodic hann, n_fft
2048, power 2), the Slaney mel filterbank, and the STFT as two f32 matrix
products against DFT matrices with the window folded in.

The products run in full f32 on the card whatever the serving type
(``full_f32_matmul``): TF32 keeps ~3 decimal digits, enough to move the dB
values across a uint8 level of the mel image.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def hann_window(n: int) -> np.ndarray:
    """Periodic hann (scipy sym=False), librosa's default."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        safe = np.maximum(f, 1e-10)
        return np.where(f >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] Slaney-normalised triangular filterbank
    (librosa.filters.mel(htk=False, norm='slaney'))."""
    fmax = fmax or sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _windowed_dft_matrices(n_fft: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary DFT matrices with the hann window folded in,
    [n_fft, n_fft // 2 + 1] f32 on ``device``, made once."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    w = hann_window(n_fft)[:, None].astype(np.float64)
    return tuple(torch.from_numpy((f(ang) * w).astype(np.float32)).to(device)
                 for f in (np.cos, np.sin))


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matrix products in full f32 while the context is open (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def stft_power(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Windowed power spectrum of raw frames [..., n_fft] f32 ->
    [..., n_fft // 2 + 1], as two matrix products."""
    dft_re, dft_im = _windowed_dft_matrices(n_fft, frames.device)
    with full_f32_matmul():
        re, im = frames @ dft_re, frames @ dft_im
    return re * re + im * im
