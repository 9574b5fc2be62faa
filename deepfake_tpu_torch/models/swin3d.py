"""Video Swin Transformer (3D) and its classifier (mean or attention
pooling), for serving and training (deepfake_tpu/models/swin3d.py:438-1214; reference topology
embed 96, depths 2/2/18/2, heads 3/6/12/24, patch (2,4,4), window (8,7,7)).

Pre-norm blocks with scaled-dot window attention and a learned 3D
relative-position bias table; (D, H, W) padded to window multiples, a 3D
cyclic roll and the -100 shift mask on the padded volume; per-dim window
clamping (a dim <= its window takes the dim and shift 0), with the bias
index of the full window sliced [:N, :N] (the reference's quirk,
swin3d.py:441-444); spatial-only PatchMerging with norm before reduction;
mean pooling into Mlp -> sigmoid, or the attention-pooling head (convs
down to one token a frame, six encoder layers, an Mlp on the CLS token),
also returning the per-frame feature.

The model is built for one clip geometry (``input_size`` = frames, height,
width), so every block's window, shift, padding, mask and bias are fixed at
construction. Each block runs the plain roll -> partition -> attention ->
reverse -> roll. The JAX package's TPU layout work (window-resident stages,
composed-permutation gathers, the pre-windowed and channel-folded host
feeds, the fused merge; swin3d.py:85-285, :935-1068) only relayouts tokens
for the TPU and changes no number, so it is not carried over.

With ``kernels`` every block runs through the hand-written kernels, as the
JAX block with ``use_pallas`` runs through its Pallas kernels: K4
(ops/ln_linear_kernel.py) computes the pre-norm LayerNorm with the qkv
product, the proj product, and the MLP half (x + attn, LayerNorm, fc1, GELU,
fc2, the residual) in two launches; K3 (ops/window_attn3d_kernel.py) the
window attention. That covers the JAX package's QKV-fused route
(``pallas_window_attention_nhc_qkv``), its ``nhc`` route
(``pallas_window_attention_nhc``) and its MLP tail (``fused_mlp_tail``). The
JAX package picks among those per block by TPU memory and grid-step gates
(pallas_window_attn.py:534-545, :664-706; pallas_mlp.py:59-73) that change
no number; the port runs the one fused route in every block. Without
``kernels`` the block runs plain PyTorch: LayerNorm, Linear and
``ops/window_attn.scaled_window_attention`` (the JAX einsum route).

The modules are built in eval mode, the mode serving runs them in. In
training (``model.train()``) a block runs LayerNorm, the linear layers and
the MLP in PyTorch under autograd, as the JAX block does outside the
``deterministic`` kernel routes (swin3d.py:502, :612-616, :674), with
DropPath on both residual branches; its window attention goes through K5
(ops/window_attn3d_train.py, forward and backward, the JAX ``nhc_train``
route) with ``kernels``, else through the plain route. The [H, N, N] bias
is gathered from the table on every training forward, so its gradient
reaches the table. Linear layers cast their parameters to the activations'
type at use, so f32 masters train in bf16.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepfake_tpu_torch.models.layers import (
    BatchNorm, Conv2d, Dropout, DropPath, LayerNorm, Linear, Mlp, as_nchw, block_remat,
    gelu_exact, remat_block,
)
from deepfake_tpu_torch.ops.ln_linear_kernel import ln_linear, mlp_tail
from deepfake_tpu_torch.ops.window_attn import scaled_window_attention
from deepfake_tpu_torch.ops.window_attn3d_kernel import window_attn3d_tokens
from deepfake_tpu_torch.ops.window_attn3d_train import window_attn3d_train

Dims = Tuple[int, int, int]


def get_window_size(x_size, window_size, shift_size=None):
    """Clamp window (and shift) to the dims: a dim <= its window takes the
    dim and shift 0 (swin3d.py:44-53)."""
    ws = list(window_size)
    ss = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            ws[i] = x_size[i]
            if ss is not None:
                ss[i] = 0
    return (tuple(ws), tuple(ss)) if ss is not None else tuple(ws)


def window_partition_3d(x: torch.Tensor, ws: Dims) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]."""
    B, D, H, W, C = x.shape
    x = x.view(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], C)


def window_reverse_3d(win: torch.Tensor, ws: Dims, B: int, D: int, H: int, W: int) -> torch.Tensor:
    """Inverse of window_partition_3d."""
    x = win.view(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def relative_position_index_3d(ws: Dims) -> np.ndarray:
    """[N, N] index into the flattened 3D bias table (swin3d.py:71-82)."""
    coords = np.stack(
        np.meshgrid(np.arange(ws[0]), np.arange(ws[1]), np.arange(ws[2]), indexing="ij")
    ).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return rel.sum(-1)


def compute_mask_3d(Dp, Hp, Wp, ws, ss) -> np.ndarray:
    """Shift mask on the padded volume, [nW, N, N] of {0, -100} (swin3d.py:354-366)."""
    img = np.zeros((Dp, Hp, Wp), np.float32)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0] or None), slice(-ss[0] or Dp, None)):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1] or None), slice(-ss[1] or Hp, None)):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2] or None), slice(-ss[2] or Wp, None)):
                img[d, h, w] = cnt
                cnt += 1
    m = img.reshape(Dp // ws[0], ws[0], Hp // ws[1], ws[1], Wp // ws[2], ws[2])
    m = m.transpose(0, 2, 4, 1, 3, 5).reshape(-1, ws[0] * ws[1] * ws[2])
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention3D(nn.Module):
    """Scaled window attention with a 3D relative-position bias table.
    x [B_, N, C] -> [B_, N, C]. The table is sized by ``table_window`` (the
    configured window); a clamped ``window_size`` indexes it with the full
    window's index sliced [:N, :N], as the reference does. Under a mesh's
    model axis (``tp``, set by ``parallel.mesh.shard_model``) it computes its
    rank's heads: a column-parallel ``qkv`` of those heads' rows, the bias
    sliced to them (K5 takes [H_m, N, N]), a row-parallel ``proj``; it then
    takes the plain route outside training."""

    tp = None

    def __init__(self, dim: int, window_size: Dims, num_heads: int, table_window: Dims,
                 kernels: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.kernels = kernels
        wd, wh, ww = table_window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        N = math.prod(window_size)
        index = relative_position_index_3d(table_window)[:N, :N].reshape(-1)
        self.register_buffer("rel_index", torch.from_numpy(index), persistent=False)
        # [H, N, N] f32, a function of the table only: set by precompute_bias()
        # once the weights are final; not persistent, so weight loading stays strict
        self.register_buffer("bias_cache", None, persistent=False)

    def init_extra(self, generator: torch.Generator) -> None:
        # truncated normal(0.02) at two standard deviations, as flax's init
        self.relative_position_bias_table.normal_(0.0, 0.02, generator=generator).clamp_(
            -0.04, 0.04)

    def relative_bias(self) -> torch.Tensor:
        N = int(math.isqrt(self.rel_index.numel()))
        table = self.relative_position_bias_table.float()
        return table[self.rel_index].reshape(N, N, self.num_heads).permute(2, 0, 1).contiguous()

    def precompute_bias(self) -> None:
        self.bias_cache = self.relative_bias()

    def forward(self, x, mask: Optional[torch.Tensor] = None, norm: Optional[LayerNorm] = None):
        """``norm``, on the serving kernel route only: the pre-norm LayerNorm,
        applied to the window tokens inside K4's qkv launch."""
        B_, N, C = x.shape
        H = self.num_heads
        scale = (C // H) ** -0.5
        if self.training and self.bias_cache is not None:
            raise RuntimeError("bias_cache is an inference cache; a model in training "
                               "gathers its bias from the table (drop_inference_caches)")
        bias = self.bias_cache if self.bias_cache is not None else self.relative_bias()
        if self.tp is not None:  # this model rank's heads (parallel/mesh.py)
            bias = self.tp.take(bias)
            H = bias.shape[0]
            C = C // self.num_heads * H
        if self.kernels and self.training:
            return self.proj(window_attn3d_train(self.qkv(x), num_heads=H, bias=bias, mask=mask,
                                                 scale=scale))
        if self.kernels and self.tp is None:  # serving: K4 and K3 never take a split layer
            dt = x.dtype  # f32 masters (a trainer's eval) cast to nothing when serving
            ln = None if norm is None else (norm.weight.to(dt), norm.bias.to(dt), norm.eps)
            qkv = ln_linear(x, self.qkv.weight.to(dt), self.qkv.bias.to(dt), ln=ln)  # q|k|v
            out = window_attn3d_tokens(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:],
                                       num_heads=H, bias=bias, mask=mask, scale=scale)
            return ln_linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt))
        qkv = self.qkv(x)
        q, k, v = qkv.view(B_, N, 3, H, C // H).permute(2, 0, 3, 1, 4).unbind(0)
        out = scaled_window_attention(q, k, v, scale, bias, mask)
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))


class SwinBlock3D(nn.Module):
    """Pre-norm 3D Swin block on [B, D, H, W, C] of the fixed
    ``input_resolution`` (swin3d.py:589-688). ``drop_path``: the DropPath
    rate of both residual branches, in training."""

    def __init__(self, dim: int, input_resolution: Dims, num_heads: int,
                 window_size: Dims = (8, 7, 7), shift_size: Dims = (0, 0, 0),
                 mlp_ratio: float = 4.0, kernels: bool = False, drop_path: float = 0.0):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        ws, ss = get_window_size(self.input_resolution, window_size, shift_size)
        self.ws, self.ss = ws, ss
        self.pads = tuple((w - n % w) % w for n, w in zip(self.input_resolution, ws))
        self.kernels = kernels
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, ws, num_heads, tuple(window_size), kernels)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)
        mask = None
        if any(s > 0 for s in ss):
            Dp, Hp, Wp = (n + p for n, p in zip(self.input_resolution, self.pads))
            # {0, -100} is exact in bf16, the type K3's serving route reads
            mask = torch.from_numpy(compute_mask_3d(Dp, Hp, Wp, ws, ss)).to(torch.bfloat16)
        self.register_buffer("attn_mask", mask, persistent=False)
        self.eval()

    def forward(self, x):
        B, D, H, W, C = x.shape
        ws, ss = self.ws, self.ss
        pd, ph, pw = self.pads
        # serving on the kernel route norms the window tokens inside K4,
        # unless there is padding: padded tokens must stay zero after the norm
        # (the reference norms before padding, swin3d.py:602-616)
        fused = self.kernels and not self.training and self.attn.tp is None
        norm_in_kernel = fused and not any(self.pads)
        h = x if norm_in_kernel else self.norm1(x)
        if any(self.pads):
            h = F.pad(h, (0, 0, 0, pw, 0, ph, 0, pd))
        shifted = self.attn_mask is not None
        if shifted:
            h = torch.roll(h, (-ss[0], -ss[1], -ss[2]), dims=(1, 2, 3))
        Dp, Hp, Wp = h.shape[1:4]
        h = self.attn(window_partition_3d(h, ws), self.attn_mask,
                      self.norm1 if norm_in_kernel else None)
        h = window_reverse_3d(h, ws, B, Dp, Hp, Wp)
        if shifted:
            h = torch.roll(h, ss, dims=(1, 2, 3))
        h = h[:, :D, :H, :W]
        if fused:
            mlp, n2, dt = self.mlp, self.norm2, x.dtype
            cast = lambda *ts: [t.to(dt) for t in ts]
            return mlp_tail(x, h, (*cast(n2.weight, n2.bias), n2.eps),
                            *cast(mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias))
        x = x + self.drop_path(h)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging3D(nn.Module):
    """Spatial-only 2x2 merge; norm then reduction (swin3d.py:771-796)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W = x.shape[2:4]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2],
                       x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed3D(nn.Module):
    """Stride == kernel Conv3d patchify as space-to-depth plus one GEMM
    (swin3d.py:818-895), then patch norm. NTHWC in, [B, D', H', W', E] out.
    ``proj`` holds the flattened [pd, ph, pw, C] x E conv kernel."""

    def __init__(self, patch_size: Dims = (2, 4, 4), embed_dim: int = 96, in_chans: int = 3):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = Linear(math.prod(patch_size) * in_chans, embed_dim)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        pd, ph, pw = self.patch_size
        B, D, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, (pw - W % pw) % pw, 0, (ph - H % ph) % ph, 0, (pd - D % pd) % pd))
        Dp, Hp, Wp = x.shape[1:4]
        x = x.view(B, Dp // pd, pd, Hp // ph, ph, Wp // pw, pw, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(B, Dp // pd, Hp // ph, Wp // pw, pd * ph * pw * C)
        return self.norm(self.proj(x))


class SwinTransformer3D(nn.Module):
    """Clips [B, T, H, W, 3] of ``input_size`` -> [B, D', H', W', num_features].
    Block i of all the blocks has DropPath rate linspace(0, drop_path_rate,
    #blocks)[i] (swin3d.py:926); ``remat`` / ``remat_policy``: each stage's
    blocks checkpointed by ``stage_policy`` (swin3d.py:929-937)."""

    def __init__(self, input_size: Dims, patch_size: Dims = (2, 4, 4), embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: Dims = (8, 7, 7), mlp_ratio: float = 4.0,
                 kernels: bool = False, drop_path_rate: float = 0.0, remat: bool = False,
                 remat_policy: str = ""):
        super().__init__()
        self.input_size = tuple(input_size)
        self.patch_embed = PatchEmbed3D(patch_size, embed_dim)
        res = tuple(-(-n // p) for n, p in zip(input_size, patch_size))
        shift = tuple(w // 2 for w in window_size)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.stages = []
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i
            for j in range(depth):
                name = f"layers_{i}_blocks_{j}"
                block = SwinBlock3D(
                    dim, res, num_heads[i], tuple(window_size),
                    (0, 0, 0) if j % 2 == 0 else shift, mlp_ratio, kernels,
                    dpr[sum(depths[:i]) + j])
                block.remat = block_remat(remat, remat_policy, i)
                self.add_module(name, block)
                self.stages.append(name)
            if i < len(depths) - 1:
                name = f"layers_{i}_downsample"
                self.add_module(name, PatchMerging3D(dim))
                self.stages.append(name)
                res = (res[0], -(-res[1] // 2), -(-res[2] // 2))
        self.output_size = res  # (D', H', W') of the last stage
        self.norm = LayerNorm(embed_dim * 2 ** (len(depths) - 1))
        self.eval()

    def forward(self, x):
        if tuple(x.shape[1:4]) != self.input_size:
            raise ValueError(f"the model was built for clips of {self.input_size} "
                             f"(frames, height, width), got {tuple(x.shape[1:4])}")
        x = self.patch_embed(x)
        for name in self.stages:
            x = remat_block(getattr(self, name), x)
        return self.norm(x)


class TransformerEncoderLayer(nn.Module):
    """The attention-pooling head's encoder layer (swin3d.py:1130-1163):
    torch's post-norm nn.TransformerEncoderLayer with GELU as the JAX head
    writes it. ``in_proj`` gives q | k | v, ``nhead`` heads attend over the
    L tokens (scaled q, f32 softmax), then ``out_proj``, the residual and
    ``norm1``; ``linear1`` -> exact GELU -> ``linear2``, the residual and
    ``norm2`` (flax LayerNorms: eps 1e-6). In training a Dropout at ``drop``
    on the attention output, after the GELU and on the FFN's output."""

    def __init__(self, d_model: int = 512, nhead: int = 8, dim_feedforward: int = 2048,
                 drop: float = 0.1):
        super().__init__()
        self.nhead = nhead
        self.in_proj = Linear(d_model, 3 * d_model)
        self.out_proj = Linear(d_model, d_model)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)
        self.drop = Dropout(drop)

    def forward(self, x):
        B, L, C = x.shape
        H = self.nhead
        q, k, v = self.in_proj(x).view(B, L, 3, H, C // H).permute(2, 0, 3, 1, 4).unbind(0)
        a = torch.softmax(((q * (C // H) ** -0.5) @ k.transpose(-1, -2)).float(), dim=-1)
        o = (a.to(v.dtype) @ v).transpose(1, 2).reshape(B, L, C)
        x = self.norm1(x + self.drop(self.out_proj(o)))
        f = self.linear2(self.drop(gelu_exact(self.linear1(x))))
        return self.norm2(x + self.drop(f))


class PoolingMLP(nn.Module):
    """The classifier head (swin3d.py:1075-1127) on the backbone's
    [B, D', H', W', C], returning (logits, per-frame feature).

    ``pool="mean"``: the clip mean into Mlp(in, hidden, classes) with
    dropout ``classify_drop``, and the per-frame spatial mean as the
    feature. ``pool="Attention"``: each frame's map through ``down_conv1``
    (3x3 VALID, 512) -> ``down_bn1`` -> ``down_conv2`` (5x5 VALID) ->
    ``down_bn2`` -> exact GELU, which collapses the 7x7 map that 224^2 clips
    give to one 512-d token a frame (any other map raises); the ``cls``
    token prepended, ``pos_embedding`` [1, D' + 1, 512] added, six encoder
    layers ``enc_0`` ... ``enc_5`` attending over the D' + 1 tokens of a
    clip (the JAX axis fix, not the reference's batch-axis quirk:
    swin3d.py:1078-1085), ``projection`` = Mlp(512, 256, classes) on the
    CLS token, and the frame tokens as the feature. Plain PyTorch: the JAX
    head runs einsums, no Pallas kernel. Its BatchNorms take batch
    statistics in training. ``size``: the backbone's (D', H', W')."""

    def __init__(self, in_feature: int = 768, num_hidden: int = 128, num_classes: int = 1,
                 pool: str = "mean", classify_drop: float = 0.0,
                 size: Optional[Dims] = None):
        super().__init__()
        self.num_classes = num_classes
        self.pool = pool
        if pool == "mean":
            self.mlp = Mlp(in_feature, num_hidden, num_classes, drop=classify_drop)
        elif pool == "Attention":
            if size is None or tuple(size[1:]) != (7, 7):
                raise ValueError(f"pool='Attention' collapses a 7x7 map (224^2 clips) to one "
                                 f"token a frame; the backbone gives (D', H', W') = {size}")
            self.down_conv1 = Conv2d(in_feature, 512, 3)
            self.down_bn1 = BatchNorm(512)
            self.down_conv2 = Conv2d(512, 512, 5)
            self.down_bn2 = BatchNorm(512)
            self.cls = nn.Parameter(torch.zeros(1, 1, 512))
            self.pos_embedding = nn.Parameter(torch.zeros(1, size[0] + 1, 512))
            for i in range(6):
                self.add_module(f"enc_{i}", TransformerEncoderLayer(512, 8, 2048, classify_drop))
            self.projection = Mlp(512, 256, num_classes, drop=classify_drop)
        else:
            raise ValueError(f"pool={pool!r}: expected 'mean' or 'Attention'")
        self.eval()

    def init_extra(self, generator: torch.Generator) -> None:
        if self.pool == "Attention":  # flax's normal(1.0) initializers
            self.cls.normal_(0.0, 1.0, generator=generator)
            self.pos_embedding.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        if self.pool == "Attention":
            logits, feat = self._attention(x)
        else:
            xf = x.float()
            feat = xf.mean(dim=(2, 3)).to(x.dtype)  # [B, D', C]
            logits = self.mlp(xf.mean(dim=(1, 2, 3)).to(x.dtype))
        return (logits.squeeze(-1) if self.num_classes == 1 else logits), feat

    def _attention(self, x):
        B, D, H, W, C = x.shape
        if (H, W) != (7, 7):
            raise ValueError(f"pool='Attention' takes a 7x7 map (224^2 clips), got {H}x{W}")
        h = as_nchw(x.reshape(B * D, H, W, C))
        h = self.down_bn1(self.down_conv1(h))
        h = gelu_exact(self.down_bn2(self.down_conv2(h))).reshape(B, D, -1)
        h = torch.cat([self.cls.to(h.dtype).expand(B, 1, -1), h], dim=1)
        h = h + self.pos_embedding.to(h.dtype)
        for i in range(6):
            h = getattr(self, f"enc_{i}")(h)
        return self.projection(h[:, 0]), h[:, 1:]


class VideoClassifier(nn.Module):
    """Video Swin backbone + PoolingMLP: clips [B, T, H, W, 3] ->
    (sigmoid score [B], per-frame feature [B, D', C]; 512 wide with
    ``pool="Attention"``) (swin3d.py:1166-1214). The drop rates act in
    training only."""

    def __init__(self, input_size: Dims, num_classes: int = 1, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 18, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 patch_size: Dims = (2, 4, 4), window_size: Dims = (8, 7, 7),
                 num_hiddens: int = 128, pool: str = "mean", kernels: bool = False,
                 drop_path_rate: float = 0.0, classify_drop: float = 0.0, remat: bool = False,
                 remat_policy: str = ""):
        super().__init__()
        self.videoSwinT = SwinTransformer3D(input_size, patch_size, embed_dim, depths, num_heads,
                                            window_size, kernels=kernels,
                                            drop_path_rate=drop_path_rate, remat=remat,
                                            remat_policy=remat_policy)
        self.classifier = PoolingMLP(embed_dim * 2 ** (len(depths) - 1), num_hiddens,
                                     num_classes, pool, classify_drop,
                                     self.videoSwinT.output_size)
        self.eval()

    def forward(self, x, return_logits: bool = False):
        logits, feat = self.classifier(self.videoSwinT(x))
        return (logits if return_logits else torch.sigmoid(logits)), feat
