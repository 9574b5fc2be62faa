"""Building blocks shared by the port's models (deepfake_tpu/models/layers.py).

Images run NCHW in ``torch.channels_last`` memory, so a [N, C, H, W] tensor
is NHWC in memory: the IRv2 block kernel reads it as flat frame-major rows
without a copy, and cuDNN takes it as is. Norm layers compute in f32 and
return the input's type, as flax's do.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """torch nn.GELU's exact erf form in f32; the tanh form in bf16, as the
    JAX package does for speed (layers.py:75-87)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 statistics. flax's default eps
    is 1e-6 (torch's is 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm with torch semantics over ``axis`` (running
    statistics; f32 arithmetic). The port serves only, so no batch
    statistics are taken. ``torch_batchnorm``'s default eps is 1e-5."""

    def __init__(self, features: int, eps: float = 1e-5, axis: int = 1):
        super().__init__()
        self.eps = eps
        self.axis = axis
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.axis] = -1
        s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        t = self.bias.float() - self.running_mean.float() * s
        return (x.float() * s.view(shape) + t.view(shape)).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (reference: src/utils.py:242-260)."""

    def __init__(self, in_features: int, hidden: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, out_features)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


Padding = Union[int, Sequence[int], str]


class ConvBnRelu(nn.Module):
    """Conv2d + BatchNorm(eps 1e-3) + ReLU (reference:
    src/models/InceptionResV2.py:6-16). ``padding`` is an int, an (h, w)
    pair, or "VALID"."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int], stride: int = 1,
                 padding: Padding = 0, bn_eps: float = 1e-3):
        super().__init__()
        if padding == "VALID":
            padding = 0
        self.conv = nn.Conv2d(cin, cout, tuple(kernel), stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(cout, eps=bn_eps)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


def max_pool_torch(x, window: int, stride: int, padding: int = 0):
    """torch.nn.MaxPool2d (layers.py:340)."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool_torch(x, window: int, stride: int, padding: int = 0,
                   count_include_pad: bool = True):
    """torch.nn.AvgPool2d; count_include_pad=False divides by the valid
    elements of each window (layers.py:351-364, the IRv2 stem)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in the spirit of the JAX package's init: conv
    and dense kernels lecun-normal (std 1/sqrt(fan_in)), biases zero, norm
    scales one, running mean 0 / var 1. Swin's res-post-norm scales start
    at one here, not zero as in training init, so that random weights push
    every attention block's output into the result."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (LayerNorm, BatchNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            if hasattr(mod, "init_extra"):
                mod.init_extra(generator)
    return model


def as_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view in channels_last memory (no copy when x is
    contiguous NHWC)."""
    return x.permute(0, 3, 1, 2)


def as_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC (free for channels_last memory)."""
    return x.permute(0, 2, 3, 1).contiguous()
