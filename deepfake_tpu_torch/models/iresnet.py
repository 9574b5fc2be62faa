"""Alternative video CNN backbones kept in the reference tree
(deepfake_tpu/models/iresnet.py:33-235).

* iResNet, the "improved ResNet": BatchNorm placed by block position
  (start, middle, end), MaxPool-assisted downsample shortcuts, every stage
  at stride 2, global average pool, no final fc (reference:
  src/models/IResNet.py:20-245). ``IResNet("bottleneck", (2, 2, 2, 2))`` is
  the reference's commented-out alternative (IResNet.py:337).
* Res34: a GroupNorm ResNet-34 variant with BatchNorm shortcuts, a
  LeakyReLU stem, exact-GELU block outputs, an optional ReZero ``alpha``,
  ``avg_pool 7`` and an ``fc`` to 1024 features, so 224^2 inputs only
  (reference: src/models/resnet34.py).

No modality wires either in, in the JAX package or here (the video branch
runs Inception-ResNet-v2); tests/test_alt_cnns.py holds the JAX models
against the reference. Inputs are NHWC float32, as in JAX; the convs run
NCHW in channels_last memory. Plain PyTorch (the JAX models have no Pallas
kernel). Submodule names follow the JAX parameter tree, so
``io/jax_weights.py::load_jax_variables`` carries JAX weights across. Every
ReLU is out of place: the reference's inplace ReLU would mutate an input
shared with a numpy array; the one place it changes the
result, the residual of an ``exclude_bn0`` block, is reproduced as the JAX
package does (the residual is relu(x)).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepfake_tpu_torch.models.layers import (
    BatchNorm, Conv2d, Dropout, Linear, as_nchw, avg_pool_torch, gelu_exact, max_pool_torch,
)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=bias)


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm: 4 groups here, eps 1e-6 (torch's default is
    1e-5), statistics in f32, the output in the input's type."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__(num_groups, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class _Block(nn.Module):
    """The shared shortcut of iResNet's blocks (iresnet.py:118-133):
    ``pool_conv`` (max-pool 3, stride, pad 1 -> 1x1 conv -> BatchNorm),
    ``conv`` (1x1 conv -> BatchNorm), ``pool`` (the max-pool alone) or
    ``none``."""

    def _shortcut(self, cin: int, cout: int, downsample: str) -> None:
        if downsample not in ("none", "pool_conv", "conv", "pool"):
            raise ValueError(f"downsample={downsample!r}")
        self.downsample = downsample
        if downsample in ("pool_conv", "conv"):
            self.ds_conv = _conv(cin, cout, 1)
            self.ds_bn = BatchNorm(cout)

    def _identity(self, x):
        if self.downsample == "pool_conv":
            return self.ds_bn(self.ds_conv(max_pool_torch(x, 3, self.stride, 1)))
        if self.downsample == "conv":
            return self.ds_bn(self.ds_conv(x))
        if self.downsample == "pool":
            return max_pool_torch(x, 3, self.stride, 1)
        return x


class BasicBlock(_Block):
    """Two 3x3 convs (iresnet.py:33-71). A start block convolves x first and
    normalises after conv2, before the residual add; a middle block
    normalises x first (``bn0``) unless ``exclude_bn0``, where the residual
    becomes relu(x); an end block normalises after the add, then ReLU."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: str = "none",
                 start_block: bool = False, end_block: bool = False, exclude_bn0: bool = False):
        super().__init__()
        self.stride = stride
        self.start_block, self.end_block, self.exclude_bn0 = start_block, end_block, exclude_bn0
        if not (start_block or exclude_bn0):
            self.bn0 = BatchNorm(inplanes)
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        if start_block or end_block:
            self.bn2 = BatchNorm(planes)
        self._shortcut(inplanes, planes, downsample)
        self.eval()

    def forward(self, x):
        if self.start_block:
            out = self.conv1(x)
        elif self.exclude_bn0:
            x = torch.relu(x)  # the reference's inplace ReLU: the residual is relu(x)
            out = self.conv1(x)
        else:
            out = self.conv1(torch.relu(self.bn0(x)))
        out = self.conv2(torch.relu(self.bn1(out)))
        if self.start_block:
            out = self.bn2(out)
        out = out + self._identity(x)
        if self.end_block:
            out = torch.relu(self.bn2(out))
        return out


class Bottleneck(_Block):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with the placements of BasicBlock
    (iresnet.py:74-115); ``bn3`` takes the start block's last conv or the
    end block's sum."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: str = "none",
                 start_block: bool = False, end_block: bool = False, exclude_bn0: bool = False):
        super().__init__()
        self.stride = stride
        self.start_block, self.end_block, self.exclude_bn0 = start_block, end_block, exclude_bn0
        if not (start_block or exclude_bn0):
            self.bn0 = BatchNorm(inplanes)
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        if start_block or end_block:
            self.bn3 = BatchNorm(planes * 4)
        self._shortcut(inplanes, planes * 4, downsample)
        self.eval()

    def forward(self, x):
        if self.start_block:
            out = self.conv1(x)
        elif self.exclude_bn0:
            x = torch.relu(x)  # the reference's inplace ReLU: the residual is relu(x)
            out = self.conv1(x)
        else:
            out = self.conv1(torch.relu(self.bn0(x)))
        out = self.conv2(torch.relu(self.bn1(out)))
        out = self.conv3(torch.relu(self.bn2(out)))
        if self.start_block:
            out = self.bn3(out)
        out = out + self._identity(x)
        if self.end_block:
            out = torch.relu(self.bn3(out))
        return out


class IResNet(nn.Module):
    """Frames NHWC [B, H, W, 3] -> features [B, 512 * expansion]
    (iresnet.py:136-175): a 7x7 stride-2 stem (``conv1``, ``bn1``, ReLU),
    four stages of ``layers`` blocks (``layer{i}_{j}``), each at stride 2:
    a start block (its shortcut ``pool_conv`` where the width changes, else
    ``pool``), middle blocks (the first without ``bn0``) and an end block;
    then the spatial mean and a Dropout at ``dropout`` in training. In
    training the BatchNorms take batch statistics."""

    def __init__(self, block: str = "bottleneck", layers: Sequence[int] = (2, 2, 2, 2),
                 dropout: float = 0.0):
        super().__init__()
        if block not in ("bottleneck", "basic"):
            raise ValueError(f"block={block!r}: expected 'bottleneck' or 'basic'")
        cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.blocks = []
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            out = planes * cls.expansion
            ds = "pool_conv" if inplanes != out else "pool"
            kinds = [dict(stride=2, downsample=ds, start_block=True)]
            kinds += [dict(exclude_bn0=j == 1) for j in range(1, n - 1)]
            kinds += [dict(end_block=True, exclude_bn0=n <= 2)]
            for j, kw in enumerate(kinds):
                name = f"layer{li + 1}_{j}"
                self.add_module(name, cls(inplanes if j == 0 else out, planes, **kw))
                self.blocks.append(name)
            inplanes = out
        self.drop = Dropout(dropout)
        self.eval()

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(as_nchw(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.drop(x.float().mean(dim=(2, 3)).to(x.dtype))


class Res34ResidualBlock(nn.Module):
    """conv1 (3x3, stride) -> gn1 -> conv2 -> gn2, plus the shortcut
    (``sc_conv`` 1x1 at the stride -> ``sc_bn``) or x, times ``alpha``
    (ReZero, initialised 0) where ``re_zero``; exact GELU of the sum
    (iresnet.py:178-204)."""

    def __init__(self, cin: int, features: int, stride: int = 1, has_shortcut: bool = False,
                 re_zero: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.gn1 = GroupNorm(4, features)
        self.conv2 = _conv(features, features, 3)
        self.gn2 = GroupNorm(4, features)
        self.has_shortcut = has_shortcut
        if has_shortcut:
            self.sc_conv = Conv2d(cin, features, 1, stride=stride, bias=False)
            self.sc_bn = BatchNorm(features)
        self.alpha = nn.Parameter(torch.zeros(1)) if re_zero else None
        self.eval()

    def forward(self, x):
        left = self.gn2(self.conv2(self.gn1(self.conv1(x))))
        right = self.sc_bn(self.sc_conv(x)) if self.has_shortcut else x
        if self.alpha is not None:
            right = right * self.alpha.to(right.dtype)
        return gelu_exact(left + right)


class Res34(nn.Module):
    """Images NHWC [B, 224, 224, 3] -> [B, out_channels] (iresnet.py:207-
    235): ``pre_conv`` (7x7, stride 2, bias) -> ``pre_gn`` -> LeakyReLU(0.01)
    -> max-pool 3/2, stages of 3, 4, 6 and 3 blocks at 128, 256, 512 and
    512 features (strides 1, 2, 2, 2; each stage's first block with a
    shortcut conv), ``avg_pool 7`` (the 7x7 map of a 224^2 input) and ``fc``."""

    def __init__(self, out_channels: int = 1024, re_zero: bool = False):
        super().__init__()
        self.pre_conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=True)
        self.pre_gn = GroupNorm(4, 64)
        self.blocks = []
        cin = 64
        for li, (feats, n, stride) in enumerate(((128, 3, 1), (256, 4, 2), (512, 6, 2),
                                                 (512, 3, 2))):
            for b in range(n):
                name = f"layer{li + 1}_{b}"
                self.add_module(name, Res34ResidualBlock(
                    cin, feats, stride if b == 0 else 1, has_shortcut=b == 0, re_zero=re_zero))
                self.blocks.append(name)
                cin = feats
        self.fc = Linear(512, out_channels)
        self.eval()

    def forward(self, x):
        if tuple(x.shape[1:3]) != (224, 224):
            raise ValueError(f"Res34 ends in avg_pool 7 on the 7x7 map of 224^2 inputs, got "
                             f"{tuple(x.shape[1:3])}")
        x = F.leaky_relu(self.pre_gn(self.pre_conv(as_nchw(x))), 0.01)
        x = max_pool_torch(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.fc(avg_pool_torch(x, 7, 7).flatten(1))
