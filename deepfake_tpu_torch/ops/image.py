"""Frame normalisation (deepfake_tpu/ops/image.py:29-32). The train-time
augmentation there waits for fused training."""

from __future__ import annotations

import functools

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
