"""Learning-rate schedule and optimizer (deepfake_tpu/train/schedule.py:18-43).

The cosine schedule is CosineAnnealingLR stepped once per optimizer step,
held at ``eta_min`` past ``t_max``. The optimizer is SGD with momentum and
coupled weight decay (the decay is added to the gradient before the momentum
buffer, on every parameter): torch.optim.SGD with ``weight_decay`` is that
optimizer, the optax chain add_decayed_weights -> sgd(momentum). The trainer
sets the rate of each step before it steps, so the first update uses lr(0).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


def cosine_annealing(lr0: float, t_max: int, eta_min: float = 0.0):
    def schedule(count: int) -> float:
        t = min(count, t_max)
        return eta_min + (lr0 - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t / t_max))

    return schedule


def make_schedule(learning_rate: float, t_max: int, schedule: str = "cosine"):
    """lr(step): cosine for ``schedule == "cosine"``, else constant."""
    if schedule == "cosine":
        return cosine_annealing(learning_rate, t_max)
    return lambda count: learning_rate


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   momentum: float = 0.9, weight_decay: float = 0.05) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           weight_decay=weight_decay)


def clip_by_global_norm(grads, max_norm: Optional[float]) -> None:
    """optax.clip_by_global_norm in place: every gradient times
    max_norm / max(global norm, max_norm)."""
    if not max_norm:
        return
    norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    factor = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
