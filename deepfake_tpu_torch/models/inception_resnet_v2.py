"""Inception-ResNet-v2 per-frame backbone (deepfake_tpu/models/inception_resnet_v2.py).

Stem -> 10x block A (scale .17) -> Reduction-A -> 20x block B (.10) ->
Reduction-B -> 9x block C (.20) + block C (scale 1, no ReLU) -> 1x1
ConvBnRelu to 1536 -> global average pool. Submodule names follow the JAX
parameter tree (``stem.f0``, ``a_3.b1_1``, ``c_9.conv`` ...), so
``io/jax_weights.py`` maps it leaf by leaf.

With ``fused_blocks`` the residual blocks A/B/C run through kernel K1
(ops/inception_block.py) exactly where the JAX model routes them to Pallas
(inception_resnet_v2.py:172, :292, :345): in eval mode only. Otherwise, and
always in training (batch statistics, autograd), they run as plain
convolutions, mirroring the JAX XLA path. In training a Dropout at
``drop_rate`` follows the global pool (JAX :399-401). Activations are NCHW
tensors in channels_last memory.

``quant`` (``model.irv2_quant``: None, "int8" or "int8_static") reaches
every ConvBnRelu (layers.py's int8 branch) and each residual block's plain
biased 1x1 (``_residual_conv`` :141-157: no BatchNorm, no ReLU, cast to
the compute type before ``x + scale * res``), in eval mode. As in JAX, a
block that runs K1 ignores it: with ``fused_blocks`` the 24 convs outside
the blocks run int8 (12 in the stem, 4 in Reduction A, 7 in Reduction B,
and ``conv``), without it all 244 (and 70, 100 and 50 in blocks A, B, C).
In dynamic mode each distinct activation is reduced and quantised once: a
tensor several convs read (the stem's pooled output, each reduction's
input, and without K1 each block's input for its branch heads) through
``quantize_shared``, and a conv whose input is another int8 conv's output
alone takes that conv's max from K7's epilogue (``out_amax``). With K1 on a
request then runs 7 maxima and 19 quantisations for its 24 convs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from deepfake_tpu_torch.models.layers import (
    Conv2d, ConvBnRelu, Dropout, Int8Owner, as_nchw, as_nhwc, avg_pool_torch, max_pool_torch,
    quantize_shared,
)
from deepfake_tpu_torch.ops.inception_block import (
    BlockWeights, TapConv, fold_bn, inception_block,
)


class Stem(nn.Module):
    """(reference: InceptionResV2.py:37-69) the plain f0 (no space-to-depth)."""

    def __init__(self):
        super().__init__()
        self.f0 = ConvBnRelu(3, 32, (3, 3), 2, "VALID")
        self.f1 = ConvBnRelu(32, 32, (3, 3), 1, "VALID")
        self.f2 = ConvBnRelu(32, 64, (3, 3), 1, 1)
        self.f4 = ConvBnRelu(64, 80, (1, 1))
        self.f5 = ConvBnRelu(80, 192, (3, 3), 1, "VALID")
        self.b0 = ConvBnRelu(192, 96, (1, 1))
        self.b1_0 = ConvBnRelu(192, 48, (1, 1))
        self.b1_1 = ConvBnRelu(48, 64, (5, 5), 1, 2)
        self.b2_0 = ConvBnRelu(192, 64, (1, 1))
        self.b2_1 = ConvBnRelu(64, 96, (3, 3), 1, 1)
        self.b2_2 = ConvBnRelu(96, 96, (3, 3), 1, 1)
        self.b3_1 = ConvBnRelu(192, 64, (1, 1))

    def forward(self, x):
        x = self.f1(*self.f0(x, out_amax=True), out_amax=True)
        x = max_pool_torch(self.f2(*x), 3, 2)
        x = max_pool_torch(self.f5(*self.f4(x, out_amax=True)), 3, 2)
        q = quantize_shared(x, (self.b0, self.b1_0, self.b2_0))
        b0 = self.b0(x, q)
        b1 = self.b1_1(*self.b1_0(x, q, out_amax=True))
        b2 = self.b2_2(*self.b2_1(*self.b2_0(x, q, out_amax=True), out_amax=True))
        b3 = self.b3_1(avg_pool_torch(x, 3, 1, 1, count_include_pad=False))
        return torch.cat([b0, b1, b2, b3], dim=1)  # 320


def _tap_conv(cbr: ConvBnRelu, dtype) -> TapConv:
    w = cbr.conv.weight  # [cout, cin, kh, kw]
    cout, cin, kh, kw = w.shape
    taps = w.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout)
    return TapConv(taps.to(dtype).contiguous(), _affine(cbr), kh, kw)


def _affine(cbr: ConvBnRelu) -> torch.Tensor:
    bn = cbr.bn
    return fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps).contiguous()


class _ResidualBlock(Int8Owner):
    """Shared structure of blocks A/B/C: a direct 1x1 branch, chains of
    ConvBnRelu, concat, a plain biased 1x1 ``conv`` and the scaled residual.
    ``direct`` names the 1x1 branch; ``chains`` name each chain's modules.
    With ``quant`` and not fused, ``conv`` runs int8 on the block's scalar
    ``res_act_amax`` (``int8_packed``: its weights per output channel, the
    bias as the shift)."""

    direct: str
    chains: Tuple[Tuple[str, ...], ...]

    def __init__(self, scale: float, relu: bool, fused: bool):
        super().__init__()
        self.scale = scale
        self.relu = relu
        self.fused = fused
        self.packed: Optional[BlockWeights] = None  # set by pack_weights()
        self.add_act_scale("res_act_amax")
        self.eval()

    def pack_weights(self, dtype: torch.dtype) -> BlockWeights:
        """Fold BN and lay the weights out for K1, in ``dtype`` (affines f32)."""
        heads = [getattr(self, self.direct)] + [getattr(self, ch[0]) for ch in self.chains]
        w_in = torch.cat([m.conv.weight.flatten(1).t() for m in heads], dim=1)
        a_in = torch.cat([_affine(m) for m in heads], dim=1)
        chains: List[List[TapConv]] = [
            [_tap_conv(getattr(self, name), dtype) for name in ch[1:]] for ch in self.chains]
        return BlockWeights(
            w_in=w_in.to(dtype).contiguous(), a_in=a_in.contiguous(),
            n_direct=getattr(self, self.direct).conv.out_channels, chains=chains,
            w_out=self.conv.weight.flatten(1).t().to(dtype).contiguous(),
            # a copy: .float() of an f32 parameter is the parameter itself,
            # which a later cast of the model would change under the kernel
            b_out=self.conv.bias.detach().to(torch.float32, copy=True),
            res_scale=self.scale, relu=self.relu)

    def pack_int8(self):
        from deepfake_tpu_torch.ops.int8_conv import Int8Weights

        return Int8Weights.from_folded(self.conv.weight.float(), self.conv.bias.float(), 1,
                                       (0, 0, 0, 0))

    def _residual(self, res):
        if self.int8_active((1, 1), 1, res.shape[1]):
            return self.int8_forward("res_act_amax", res, relu=False)[0]
        return self.conv(res)

    def _kernel_weights(self, x) -> BlockWeights:
        p = self.packed
        if p is not None and p.w_in.dtype == x.dtype and p.w_in.device == x.device:
            return p
        return self.pack_weights(x.dtype)

    def forward(self, x):
        if self.fused and not self.training and x.shape[2] == x.shape[3]:
            out = inception_block(as_nhwc(x), self._kernel_weights(x))
            return as_nchw(out)
        heads = [getattr(self, self.direct)] + [getattr(self, ch[0]) for ch in self.chains]
        q = quantize_shared(x, heads)
        parts = [heads[0](x, q)]
        for ch in self.chains:
            h = (x, q)
            for name in ch[:-1]:
                h = getattr(self, name)(*h, out_amax=True)
            parts.append(getattr(self, ch[-1])(*h))
        out = x + self.scale * self._residual(torch.cat(parts, dim=1))
        return torch.relu(out) if self.relu else out


class BlockA(_ResidualBlock):
    """(reference: InceptionResV2.py:72-94)"""

    direct = "b0"
    chains = (("b1_0", "b1_1"), ("b2_0", "b2_1", "b2_2"))

    def __init__(self, scale: float = 0.17, fused: bool = False, C: int = 320):
        super().__init__(scale, True, fused)
        self.b0 = ConvBnRelu(C, 32, (1, 1))
        self.b1_0 = ConvBnRelu(C, 32, (1, 1))
        self.b1_1 = ConvBnRelu(32, 32, (3, 3), 1, 1)
        self.b2_0 = ConvBnRelu(C, 32, (1, 1))
        self.b2_1 = ConvBnRelu(32, 48, (3, 3), 1, 1)
        self.b2_2 = ConvBnRelu(48, 64, (3, 3), 1, 1)
        self.conv = Conv2d(128, C, 1)


class BlockB(_ResidualBlock):
    """(reference: InceptionResV2.py:97-114)"""

    direct = "b0"
    chains = (("b1_0", "b1_1", "b1_2"),)

    def __init__(self, scale: float = 0.10, fused: bool = False, C: int = 1088):
        super().__init__(scale, True, fused)
        self.b0 = ConvBnRelu(C, 192, (1, 1))
        self.b1_0 = ConvBnRelu(C, 128, (1, 1))
        self.b1_1 = ConvBnRelu(128, 160, (1, 7), 1, (0, 3))
        self.b1_2 = ConvBnRelu(160, 192, (7, 1), 1, (3, 0))
        self.conv = Conv2d(384, C, 1)


class BlockC(_ResidualBlock):
    """(reference: InceptionResV2.py:143-163); ``activation=False`` is c_9."""

    direct = "b0"
    chains = (("b1_0", "b1_1", "b1_2"),)

    def __init__(self, scale: float = 0.20, activation: bool = True, fused: bool = False,
                 C: int = 2080):
        super().__init__(scale, activation, fused)
        self.b0 = ConvBnRelu(C, 192, (1, 1))
        self.b1_0 = ConvBnRelu(C, 192, (1, 1))
        self.b1_1 = ConvBnRelu(192, 224, (1, 3), 1, (0, 1))
        self.b1_2 = ConvBnRelu(224, 256, (3, 1), 1, (1, 0))
        self.conv = Conv2d(448, C, 1)


class ReductionA(nn.Module):
    """(reference: InceptionResV2.py:19-35) k,l,m,n = 256,256,384,384"""

    def __init__(self, C: int = 320):
        super().__init__()
        self.b0 = ConvBnRelu(C, 384, (3, 3), 2, "VALID")
        self.b1_0 = ConvBnRelu(C, 256, (1, 1))
        self.b1_1 = ConvBnRelu(256, 256, (3, 3), 1, 1)
        self.b1_2 = ConvBnRelu(256, 384, (3, 3), 2, "VALID")

    def forward(self, x):
        q = quantize_shared(x, (self.b0, self.b1_0))
        b1 = self.b1_2(*self.b1_1(*self.b1_0(x, q, out_amax=True), out_amax=True))
        return torch.cat([self.b0(x, q), b1, max_pool_torch(x, 3, 2)], dim=1)  # 1088


class ReductionB(nn.Module):
    """(reference: InceptionResV2.py:117-140)"""

    def __init__(self, C: int = 1088):
        super().__init__()
        self.b0_0 = ConvBnRelu(C, 256, (1, 1))
        self.b0_1 = ConvBnRelu(256, 384, (3, 3), 2, "VALID")
        self.b1_0 = ConvBnRelu(C, 256, (1, 1))
        self.b1_1 = ConvBnRelu(256, 288, (3, 3), 2, "VALID")
        self.b2_0 = ConvBnRelu(C, 256, (1, 1))
        self.b2_1 = ConvBnRelu(256, 288, (3, 3), 1, 1)
        self.b2_2 = ConvBnRelu(288, 320, (3, 3), 2, "VALID")

    def forward(self, x):
        q = quantize_shared(x, (self.b0_0, self.b1_0, self.b2_0))
        b0 = self.b0_1(*self.b0_0(x, q, out_amax=True))
        b1 = self.b1_1(*self.b1_0(x, q, out_amax=True))
        b2 = self.b2_2(*self.b2_1(*self.b2_0(x, q, out_amax=True), out_amax=True))
        return torch.cat([b0, b1, b2, max_pool_torch(x, 3, 2)], dim=1)  # 2080


class InceptionResNetV2(nn.Module):
    """Frames NHWC [F, H, W, 3] -> per-frame features [F, 1536]
    (reference: InceptionResV2.py:166-191)."""

    def __init__(self, fused_blocks: bool = False, drop_rate: float = 0.0,
                 quant: Optional[str] = None):
        super().__init__()
        if quant not in (None, "int8", "int8_static"):
            raise ValueError(f"quant={quant!r}: expected None, 'int8' or 'int8_static'")
        self.quant = quant
        self.stem = Stem()
        for i in range(10):
            self.add_module(f"a_{i}", BlockA(0.17, fused_blocks))
        self.red_a = ReductionA()
        for i in range(20):
            self.add_module(f"b_{i}", BlockB(0.10, fused_blocks))
        self.red_b = ReductionB()
        for i in range(9):
            self.add_module(f"c_{i}", BlockC(0.20, fused=fused_blocks))
        self.c_9 = BlockC(1.0, activation=False, fused=fused_blocks)
        self.conv = ConvBnRelu(2080, 1536, (1, 1))
        self.drop = Dropout(drop_rate)
        for m in self.modules():
            if isinstance(m, Int8Owner):
                m.quant = quant
        self.eval()

    def blocks(self) -> Sequence[_ResidualBlock]:
        return [m for m in self.children() if isinstance(m, _ResidualBlock)]

    def forward(self, x):
        x = self.stem(as_nchw(x).contiguous(memory_format=torch.channels_last))
        for name, m in self.named_children():
            if name not in ("stem", "conv", "drop"):
                x = m(x)
        x = self.conv(x)
        return self.drop(x.float().mean(dim=(2, 3)).to(x.dtype))
