"""Audio of a clip as 16 kHz mono float32 PCM, on the host
(deepfake_tpu/data/audio_io.py).

Backends, in order: a sidecar ``<name>.wav`` or ``<name>.npy`` next to the
video (what ``deepfake_tpu_torch.audio_preprocess --format pcm`` writes, and
``data/synthetic.py``), then the ``ffmpeg`` CLI, then a clear error. The
JAX package's native libav demuxer waits with the native ingest (ROADMAP A1).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import warnings

import numpy as np


def read_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """float32 mono waveform in [-1, 1]; a linear resample to ``target_sr``
    where the file's rate differs."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim == 2:
        y = y.mean(axis=1)
    if sr != target_sr:
        n_out = int(round(len(y) * target_sr / sr))
        xi = np.linspace(0, len(y) - 1, n_out)
        y = np.interp(xi, np.arange(len(y)), y).astype(np.float32)
    return y


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def has_sidecar(video_path: str) -> bool:
    """Whether a sidecar PCM file (.wav or .npy) exists for the clip."""
    base, _ = os.path.splitext(video_path)
    return any(os.path.exists(base + ext) for ext in (".wav", ".npy"))


def extract_wav(video_path: str, sample_rate: int = 16000) -> np.ndarray:
    """Video file -> float32 mono PCM at ``sample_rate``: the sidecar, else
    the ffmpeg CLI through a pipe (no temporary file), else raises."""
    base, _ = os.path.splitext(video_path)
    for ext in (".wav", ".npy"):
        sidecar = base + ext
        if os.path.exists(sidecar):
            if ext == ".npy":
                return np.load(sidecar).astype(np.float32)
            return read_wav(sidecar, sample_rate)
    if has_ffmpeg():
        cmd = ["ffmpeg", "-v", "quiet", "-i", video_path, "-f", "f32le", "-acodec", "pcm_f32le",
               "-ac", "1", "-ar", str(sample_rate), "-"]
        raw = subprocess.run(cmd, capture_output=True, check=True).stdout
        return np.frombuffer(raw, np.float32).copy()
    raise RuntimeError(
        f"no audio backend for {video_path}: provide a sidecar .wav/.npy or install ffmpeg")


_warned_truncate = False


def pad_to_bucket(y: np.ndarray, buckets_samples) -> np.ndarray:
    """Zero-pad a waveform to the smallest bucket that holds it, so that a
    batch has one of a few shapes (one CUDA graph each). A clip longer than
    the largest bucket is truncated to it, with a warning once per process:
    its scores then differ from the reference's, which pads to the batch's
    longest clip; a larger bucket (``data.wave_seconds_buckets``) covers it."""
    n = len(y)
    for b in sorted(buckets_samples):
        if n <= b:
            out = np.zeros(b, np.float32)
            out[:n] = y
            return out
    b = max(buckets_samples)
    global _warned_truncate
    if not _warned_truncate:
        _warned_truncate = True
        warnings.warn(
            f"waveform of {n} samples exceeds the largest bucket ({b}): TRUNCATING — scores "
            "for such clips diverge from the reference (which pads to the batch longest with "
            "no cap); add a larger tail bucket via cfg.data.wave_seconds_buckets to cover them")
    return y[:b].astype(np.float32)
