"""The reference's weight initialisation on the port's modules
(deepfake_tpu/utils/init.py:35-63, the reference's src/trainer.py:30-44):
xavier-normal conv weights with biases 0.3, kaiming-normal linear weights
(fan in, gain sqrt(2)) with biases 0, BatchNorm scales 1, every other bias
0; every draw from the caller's generator. SwinV2's ``qkv_weight`` (a linear
layer's weight held bare, the JAX ``qkv_kernel``) is drawn as a linear
weight."""

from __future__ import annotations

import math

import torch
from torch import nn

from deepfake_tpu_torch.models.layers import BatchNorm

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_BATCHNORMS = (BatchNorm, nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)


def _xavier_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    rf = w[0][0].numel()  # [out, in / groups, *k]
    std = math.sqrt(2.0 / (w.shape[1] * rf + w.shape[0] * rf))
    w.normal_(0.0, std, generator=generator)


def _kaiming_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    w.normal_(0.0, math.sqrt(2.0 / w.shape[1]), generator=generator)  # [out, in]


@torch.no_grad()
def apply_reference_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise ``model`` in place by the reference's rules; returns it."""
    for mod in model.modules():
        if isinstance(mod, _CONVS):
            _xavier_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.fill_(0.3)
        elif isinstance(mod, nn.Linear):
            _kaiming_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, _BATCHNORMS):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        else:
            for name, p in mod.named_parameters(recurse=False):
                if name == "qkv_weight":
                    _kaiming_normal_(p, generator)
                elif name == "bias" or name.endswith("_bias"):
                    p.zero_()
    return model
