"""Frame normalisation and train-time augmentation
(deepfake_tpu/ops/image.py:29-113).

The augmentation follows torchvision's RandomHorizontalFlip,
RandomVerticalFlip and RandomRotation(90) as the JAX package mirrors them:
each flip with p = 0.5, then a rotation by an angle drawn from U(-90, 90)
degrees about the frame's centre, nearest-neighbour with zero fill. One draw
serves every frame of a clip (``per_frame=False``), or each frame draws its
own (``per_frame=True``, the reference's per-frame quirk). The draws come
from an explicit ``torch.Generator`` on the frames' device; they cannot
match ``jax.random``'s, so ``augment_clip`` takes them as arguments and is
held against the JAX functions on the same draws.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from deepfake_tpu_torch.ops.mel import IMAGENET_MEAN, IMAGENET_STD


@functools.lru_cache(maxsize=4)
def imagenet_stats(device: torch.device):
    """The ImageNet mean and std on ``device``, copied there once (a CUDA
    graph cannot capture the copy)."""
    return torch.from_numpy(IMAGENET_MEAN).to(device), torch.from_numpy(IMAGENET_STD).to(device)


def normalize_imagenet(frames: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> f32 ImageNet-normalised."""
    x = frames.float() / 255.0
    mean, std = imagenet_stats(x.device)
    return (x - mean) / std


def rotate_nearest(frames: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Frames [..., H, W, C] rotated about their centres by ``angle`` degrees
    (one per frame: [...], f32), nearest-neighbour, zero fill: each output
    pixel reads the input at its inversely rotated, rounded (half to even)
    coordinate, or is 0 where that falls outside."""
    *lead, H, W, C = frames.shape
    x = frames.reshape(-1, H * W, C)
    n = x.shape[0]
    theta = (-angle.reshape(n).float() * math.pi / 180.0)[:, None, None]  # inverse mapping
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    y0 = (torch.arange(H, dtype=torch.float32, device=x.device) - cy)[None, :, None]
    x0 = (torch.arange(W, dtype=torch.float32, device=x.device) - cx)[None, None, :]
    src_y = torch.round(cy + y0 * cos - x0 * sin).to(torch.int64)
    src_x = torch.round(cx + y0 * sin + x0 * cos).to(torch.int64)
    valid = (src_y >= 0) & (src_y < H) & (src_x >= 0) & (src_x < W)
    idx = (src_y.clamp(0, H - 1) * W + src_x.clamp(0, W - 1)).reshape(n, H * W, 1)
    out = torch.gather(x, 1, idx.expand(n, H * W, C))
    out = torch.where(valid.reshape(n, H * W, 1), out, torch.zeros((), dtype=out.dtype,
                                                                  device=out.device))
    return out.reshape(*lead, H, W, C)


def augment_clip(frames: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor,
                 angle: torch.Tensor) -> torch.Tensor:
    """The draw-free core of the augmentation: frames [..., T, H, W, C] with
    one draw per frame, hflip and vflip bool [..., T] and angle [..., T]
    degrees: flip left-right, then upside-down, where drawn, then rotate."""
    f = lambda m: m[..., None, None, None]
    frames = torch.where(f(hflip), frames.flip(-2), frames)
    frames = torch.where(f(vflip), frames.flip(-3), frames)
    return rotate_nearest(frames, angle)


def draw_augmentation(gen: torch.Generator, batch: int, frames: int, per_frame: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hflip, vflip, angle), each [batch, frames], on ``gen``'s device: one
    draw a clip broadcast over its frames, or one a frame."""
    n = frames if per_frame else 1
    dev = gen.device
    hflip = torch.rand(batch, n, generator=gen, device=dev) < 0.5
    vflip = torch.rand(batch, n, generator=gen, device=dev) < 0.5
    angle = torch.rand(batch, n, generator=gen, device=dev) * 180.0 - 90.0
    return tuple(t.expand(batch, frames) for t in (hflip, vflip, angle))


def preprocess_clip_batch(frames_u8: torch.Tensor, gen: Optional[torch.Generator] = None,
                          per_frame: bool = False, rows=None) -> torch.Tensor:
    """uint8 [B, T, H, W, 3] -> f32 normalised, augmented when a generator
    is given (training). ``rows``: (n, index), where the B clips are the
    rows ``index`` of a batch of n (a data rank's share): the draws are the
    whole batch's, and each clip takes its row's."""
    x = normalize_imagenet(frames_u8)
    if gen is None:
        return x
    B, T = x.shape[:2]
    if rows is None:
        return augment_clip(x, *draw_augmentation(gen, B, T, per_frame))
    n, index = rows
    draws = draw_augmentation(gen, n, T, per_frame)
    index = torch.as_tensor(index, device=draws[0].device)
    return augment_clip(x, *(d[index] for d in draws))
