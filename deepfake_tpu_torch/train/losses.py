"""Losses (deepfake_tpu/train/losses.py:15-20)."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits, in the logits' type (the
    stable log-sigmoid form, as the JAX package computes it)."""
    labels = labels.to(logits.dtype)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
