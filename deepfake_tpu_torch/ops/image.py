"""Frame normalisation (deepfake_tpu/ops/image.py:29-32). The train-time
augmentation there waits for fused training."""

from __future__ import annotations

import torch

from deepfake_tpu_torch.ops.mel import IMAGENET_MEAN, IMAGENET_STD


def normalize_imagenet(frames: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> f32 ImageNet-normalised."""
    x = frames.float() / 255.0
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x - mean) / std
