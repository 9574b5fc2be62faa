"""Learning-rate schedule and optimizer (deepfake_tpu/train/schedule.py:18-43).

The cosine schedule is CosineAnnealingLR stepped once per optimizer step,
held at ``eta_min`` past ``t_max``. The optimizer is SGD with momentum and
coupled weight decay (the decay is added to the gradient before the momentum
buffer, on every parameter): the optax chain add_decayed_weights ->
sgd(momentum), and torch.optim.SGD with ``weight_decay``. ``SGD`` here is
that update written as foreach ops that read the rate from a device scalar,
so that one CUDA graph of a training step serves every step's rate
(torch.optim.SGD turns a tensor rate into a Python number, a host sync that
a capture refuses); its momentum buffers start at zero, as optax's trace
does, so the first update is d and every step runs one code path. The
trainer sets the rate of each step before it steps, so the first update
uses lr(0).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import torch
import torch.distributed


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


class SGD:
    """p -= lr * buf, buf = momentum * buf + (g + weight_decay * p), over
    ``params`` in place; ``lr`` is a device scalar of the parameters' type,
    written by ``set_lr`` before each step (``step`` reads it on the device)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], momentum: float = 0.9,
                 weight_decay: float = 0.05):
        self.params = [p for p in params if p.requires_grad]
        self.momentum, self.weight_decay = momentum, weight_decay
        self.bufs = [torch.zeros_like(p, memory_format=torch.preserve_format)
                     for p in self.params]
        p0 = self.params[0]
        self.lr = torch.zeros((), dtype=p0.dtype, device=p0.device)

    def set_lr(self, lr: float) -> None:
        self.lr.fill_(lr)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update with ``grads``, one a parameter, in its order."""
        d = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(self.bufs, self.momentum)
        torch._foreach_add_(self.bufs, d)
        torch._foreach_sub_(self.params, torch._foreach_mul(self.bufs, self.lr))


def clip_by_global_norm(grads, max_norm: Optional[float], sharded: Optional[List[bool]] = None,
                        group=None) -> None:
    """optax.clip_by_global_norm in place: every gradient times
    max_norm / max(global norm, max_norm). Under a mesh's model axis
    (``group``), the squares of the gradients ``sharded`` marks are summed
    over it and the replicated ones counted once."""
    if not max_norm:
        return
    sharded = sharded or [False] * len(grads)
    sq = lambda gs: sum((g.float().pow(2).sum() for g in gs), torch.zeros((), device=grads[0].device))
    split = sq([g for g, s in zip(grads, sharded) if s])
    if group is not None:
        torch.distributed.all_reduce(split, group=group)
    norm = torch.sqrt(sq([g for g, s in zip(grads, sharded) if not s]) + split)
    factor = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
