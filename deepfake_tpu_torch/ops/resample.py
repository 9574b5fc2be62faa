"""Polyphase windowed-sinc resampling on the device
(deepfake_tpu/ops/resample.py:31-87).

The reference's audio chain hands 16 kHz PCM to librosa.load, which
resamples it to 22.05 kHz before the mel transform; this is that second
stage. The filter is scipy.signal.resample_poly's default design (kaiser
window, beta 5, half length 10 max(up, down), cutoff 1 / max(up, down)), and
output m is

    y[m] = sum_t W[p(m), t] * x[q(m) - t],  md = (m + n_pre_remove) down,
    q = md // up,  p = md % up,

the direct-gather form of resample_poly's upfirdn and slice, with the input
zero-extended at both ends. The index and weight tables depend only on the
row length and the two rates: they are built once per (T, rates, device)
and the call is a gather and a weighted sum.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _design(up: int, down: int) -> Tuple[np.ndarray, int, int]:
    """(W [up, taps] f32, n_pre_remove, taps) for coprime up/down."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    h = (h * up).astype(np.float64)
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    taps = -(-len(h) // up)
    h = np.concatenate([h, np.zeros(taps * up - len(h))])
    W = h.reshape(taps, up).T.astype(np.float32)  # W[p, t] = h[t * up + p]
    return W, n_pre_remove, taps


def _rates(sr_in: int, sr_out: int) -> Tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


def resampled_length(length, sr_in: int, sr_out: int):
    """Valid samples after resampling, ceil(n up / down) (scipy's output
    length); an int or an integer tensor."""
    up, down = _rates(sr_in, sr_out)
    return (length * up + down - 1) // down


@functools.lru_cache(maxsize=16)
def _tables(T: int, sr_in: int, sr_out: int, device: torch.device):
    """Gather indices [n_out, taps] into the zero-padded row, their weights
    [n_out, taps] f32 on ``device``, and the row's (left, right) padding."""
    up, down = _rates(sr_in, sr_out)
    W, n_pre_remove, taps = _design(up, down)
    n_out = -(-T * up // down)
    md = (np.arange(n_out, dtype=np.int64) + n_pre_remove) * down
    q, p = md // up, md % up
    idx = q[:, None] - np.arange(taps, dtype=np.int64)[None, :]
    pad_lo = max(0, int(-idx.min()))
    pad_hi = max(0, int(idx.max()) - (T - 1))
    return (torch.from_numpy(idx + pad_lo).to(device), torch.from_numpy(W[p]).to(device),
            (pad_lo, pad_hi))


def resample(wave: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """[..., T] at ``sr_in`` -> [..., ceil(T sr_out / sr_in)] at ``sr_out``,
    in f32; the identity when the rates agree."""
    if sr_in == sr_out:
        return wave
    idx, weights, pad = _tables(wave.shape[-1], sr_in, sr_out, wave.device)
    x = F.pad(wave.float(), pad)
    return (x[..., idx] * weights).sum(dim=-1)
