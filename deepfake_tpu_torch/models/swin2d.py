"""Swin Transformer V2 (2D), the spectrogram branch (deepfake_tpu/models/swin2d.py:41-571).

Cosine attention with a per-head logit_scale clamped at log(100); the
continuous relative position bias 16 * sigmoid(MLP(table)); qkv bias
[q_bias, 0, v_bias]; res-post-norm residuals; shifted windows with the -100
mask; PatchMerging's even/odd interleave. Each block runs the plain
roll -> partition -> attention -> reverse -> roll; the JAX package's
window-resident permutations (swin2d.py:466-546) are a TPU relayout trick
that computes the same thing.

With ``attn_kernel`` the attention runs through the kernels, which together
take every window the Pallas routes of swin2d.py:181-249 take. Windows of
N <= 64 tokens (window 8 and below) go to K2 (ops/window_attn_kernel.py):
token-major for B_ >= 2 (the Pallas ``pallas_window_attention_nhc_packed``),
head-major otherwise (``pallas_window_attention``'s ``_run``). Every larger
window goes to K6 (ops/window_attn_multihead.py), which reads q, k and v out
of the qkv tensor by strides in either layout: the Pallas routes' 64 < N <
128 cases (windows 9-11) and ``_run_multihead`` for N >= 128 (window 16 at
256^2, window 24 at 384^2). Otherwise it runs the plain path
``ops/window_attn.cosine_window_attention``.

In training (``model.train()``) every block has DropPath on both residual
branches (``linspace(0, drop_path_rate, blocks)``, swin2d.py:430,463), the
[H, N, N] bias is recomputed from the CPB-MLP on every forward (it gets a
gradient; ``bias_cache`` is ignored), and with ``attn_kernel`` the window
attention goes through K5 (ops/window_attn3d_train.py, forward and backward)
as the JAX training route does (swin2d.py:185-222): q and k L2-normalised
per head in f32, q times the clamped per-head scale, both cast to the
compute type and passed with v as K5's qkv at scale 1, the f32 bias and the
shift mask beside them. Without ``attn_kernel`` training takes the plain
path with the max-stabilised softmax. Linear and conv layers cast their
parameters to the activations' type at use, so f32 masters train in bf16.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepfake_tpu_torch.models.layers import (
    Conv2d, DropPath, LayerNorm, Linear, Mlp, as_nchw, block_remat, remat_block,
)
from deepfake_tpu_torch.ops.window_attn import cosine_window_attention, l2_normalize
from deepfake_tpu_torch.ops.window_attn3d_train import window_attn3d_train
from deepfake_tpu_torch.ops.window_attn_kernel import MAX_TOKENS as K2_MAX_TOKENS
from deepfake_tpu_torch.ops.window_attn_kernel import (
    window_attention_heads, window_attention_tokens,
)
from deepfake_tpu_torch.ops.window_attn_multihead import window_attention_multihead


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C]."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.view(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def relative_coords_table(ws: Tuple[int, int], pretrained_ws: Tuple[int, int]) -> np.ndarray:
    """Log-spaced relative coordinates, [1, 2Wh-1, 2Ww-1, 2]."""
    h = np.arange(-(ws[0] - 1), ws[0], dtype=np.float32)
    w = np.arange(-(ws[1] - 1), ws[1], dtype=np.float32)
    table = np.stack(np.meshgrid(h, w, indexing="ij"), axis=-1)[None]
    denom = ((pretrained_ws[0] - 1, pretrained_ws[1] - 1) if pretrained_ws[0] > 0
             else (ws[0] - 1, ws[1] - 1))
    table[..., 0] /= denom[0]
    table[..., 1] /= denom[1]
    table *= 8.0
    return (np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)).astype(np.float32)


def relative_position_index(ws: Tuple[int, int]) -> np.ndarray:
    """[N, N] index into the flattened bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 0] *= 2 * ws[1] - 1
    return rel.sum(-1)


def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Additive (-100) mask for shifted windows, [nW, N, N]."""
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, ws_] = cnt
            cnt += 1
    m = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA with cosine attention and the continuous relative bias.
    x [B_, N, C] -> [B_, N, C]. Under a mesh's model axis (``tp``, ``qkv_tp``,
    set by ``parallel.mesh.shard_model``) it computes its rank's heads: the
    qkv rows of those heads, the bias, logit scale and qkv bias sliced to
    them, and a row-parallel ``proj``."""

    tp = None
    qkv_tp = None

    def __init__(self, dim: int, window_size: Tuple[int, int], num_heads: int,
                 pretrained_window_size: Tuple[int, int] = (0, 0), attn_kernel: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.attn_kernel = attn_kernel
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.qkv_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.cpb_fc1 = nn.Linear(2, 512)
        self.cpb_fc2 = nn.Linear(512, num_heads, bias=False)
        self.proj = Linear(dim, dim)
        # a plain f32 attribute, not a buffer: casting the model to bf16
        # must not round the table the bias is computed from
        self.coords_table = torch.from_numpy(
            relative_coords_table(window_size, pretrained_window_size))
        self._table_on = self.coords_table  # its copy on the last device used
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)
        self.bias_cache: Optional[torch.Tensor] = None  # set by precompute_bias()
        self.eval()

    def init_extra(self, generator: torch.Generator) -> None:
        self.qkv_weight.normal_(0.0, 1.0 / math.sqrt(self.dim), generator=generator)
        self.logit_scale.fill_(math.log(10.0))
        self.q_bias.zero_()
        self.v_bias.zero_()

    def relative_bias(self) -> torch.Tensor:
        """16 * sigmoid(CPB-MLP(table)) gathered to [H, N, N], f32."""
        fc1, fc2 = self.cpb_fc1, self.cpb_fc2
        if self._table_on.device != fc1.weight.device:
            # copied once per device, not per forward: a CUDA graph capture
            # refuses a copy from pageable host memory
            self._table_on = self.coords_table.to(fc1.weight.device)
        table = self._table_on
        h = torch.relu(F.linear(table, fc1.weight.float(), fc1.bias.float()))
        t = F.linear(h, fc2.weight.float()).reshape(-1, self.num_heads)
        N = int(math.isqrt(self.rel_index.numel()))
        bias = t[self.rel_index].reshape(N, N, self.num_heads).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(bias).contiguous()

    def precompute_bias(self) -> None:
        self.bias_cache = self.relative_bias()

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        B_, N, _ = x.shape
        H = self.num_heads
        qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        bias = self.bias_cache
        if self.training or bias is None or bias.device != x.device:
            bias = self.relative_bias()
        scale = torch.exp(torch.clamp(self.logit_scale.float(), max=math.log(100.0)))
        if self.tp is not None:  # this model rank's heads (parallel/mesh.py)
            x, qkv_bias = self.qkv_tp.copy(x), self.qkv_tp.take(qkv_bias)
            bias, scale = self.tp.take(bias), self.tp.take(scale)
            H = bias.shape[0]
        qkv = F.linear(x, self.qkv_weight.to(x.dtype), qkv_bias.to(x.dtype))  # [B_, N, 3C]
        C = qkv.shape[-1] // 3
        if self.training and self.attn_kernel:
            out = self._train_kernel(qkv, bias, mask, scale)
        elif self.attn_kernel and N <= K2_MAX_TOKENS and B_ >= 2:
            out = window_attention_tokens(
                qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], num_heads=H, bias=bias,
                mask=mask, logit_scale=scale)
        else:
            heads = qkv.view(B_, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
            if self.attn_kernel and N > K2_MAX_TOKENS:
                # K6 reads q, k, v out of qkv by strides and writes [B_, N, C]
                out = window_attention_multihead(*heads.unbind(0), bias=bias, mask=mask,
                                                 logit_scale=scale)
            elif self.attn_kernel:
                out = window_attention_heads(*heads.contiguous().unbind(0), bias=bias, mask=mask,
                                             logit_scale=scale)
            else:
                out = cosine_window_attention(*heads.contiguous().unbind(0), scale, bias, mask,
                                              bounded=not self.training)
            out = out.transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)

    def _train_kernel(self, qkv, bias, mask, scale):
        """Cosine attention as scaled attention through K5 (swin2d.py:195-222):
        q^ s and k^ per head in f32, cast to the compute type, then K5 at
        scale 1; autograd carries the normalisation's and the scale's
        gradients, K5's backward the attention's and the bias's."""
        B_, N, C3 = qkv.shape
        C, H = C3 // 3, bias.shape[0]
        heads = lambda t: l2_normalize(t.reshape(B_, N, H, C // H).float())
        qn = (heads(qkv[..., :C]) * scale.reshape(1, 1, H, 1)).reshape(B_, N, C)
        kn = heads(qkv[..., C:2 * C]).reshape(B_, N, C)
        packed = torch.cat([qn.to(qkv.dtype), kn.to(qkv.dtype), qkv[..., 2 * C:]], dim=-1)
        return window_attn3d_train(packed, num_heads=H, bias=bias, mask=mask, scale=1.0)


class SwinBlock(nn.Module):
    """res-post-norm Swin block (reference: swin_transformer2d.py:199-306)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 pretrained_window_size: int = 0, attn_kernel: bool = False,
                 drop_path: float = 0.0):
        super().__init__()
        self.input_resolution = input_resolution
        ws, shift = window_size, shift_size
        if min(input_resolution) <= ws:
            ws, shift = min(input_resolution), 0
        self.ws, self.shift = ws, shift
        self.attn = WindowAttention(dim, (ws, ws), num_heads,
                                    (pretrained_window_size,) * 2, attn_kernel)
        self.norm1 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.norm2 = LayerNorm(dim)
        self.drop_path = DropPath(drop_path)
        H, W = input_resolution
        mask = torch.from_numpy(shift_attn_mask(H, W, ws, shift)) if shift > 0 else None
        self.register_buffer("attn_mask", mask, persistent=False)
        self.eval()

    def forward(self, x):
        H, W = self.input_resolution
        B, L, C = x.shape
        ws, shift = self.ws, self.shift
        h = x.view(B, H, W, C)
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        mask = None if self.attn_mask is None else self.attn_mask.float()
        h = window_reverse(self.attn(window_partition(h, ws), mask), ws, H, W)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(self.norm1(h.reshape(B, L, C)))
        return x + self.drop_path(self.norm2(self.mlp(x)))


class PatchMerging(nn.Module):
    """2x2 interleaved merge; reduction then norm (reference: :327-364)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.input_resolution = input_resolution
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim)

    def forward(self, x):
        H, W = self.input_resolution
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.norm(self.reduction(x.reshape(B, (H // 2) * (W // 2), 4 * C)))


class PatchEmbed(nn.Module):
    """4x4 conv patchify + norm (reference: :455-493). NHWC in."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96, in_chans: int = 3):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        y = self.proj(as_nchw(x))  # [B, E, H/p, W/p]
        return self.norm(y.flatten(2).transpose(1, 2))


class SwinTransformerV2(nn.Module):
    """Mel image NHWC [B, H, W, 3] -> sigmoid score, logits, or (``use_feat``)
    the pooled [B, num_features] feature (reference: swin_transformer2d.py:503-634).
    ``remat`` / ``remat_policy``: each stage's blocks checkpointed by
    ``stage_policy`` (swin2d.py:469-472)."""

    def __init__(self, img_size: int = 224, patch_size: int = 4, num_classes: int = 1000,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, pretrained_window_sizes: Sequence[int] = (0, 0, 0, 0),
                 use_feat: bool = False, attn_kernel: bool = False, drop_path_rate: float = 0.1,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__()
        self.num_classes = num_classes
        self.use_feat = use_feat
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        res = img_size // patch_size
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.stages = []
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i
            r = res // 2 ** i
            names = []
            for j in range(depth):
                name = f"layers_{i}_blocks_{j}"
                block = SwinBlock(
                    dim, (r, r), num_heads[i], window_size,
                    0 if j % 2 == 0 else window_size // 2, mlp_ratio,
                    pretrained_window_sizes[i], attn_kernel, dpr[sum(depths[:i]) + j])
                block.remat = block_remat(remat, remat_policy, i)
                self.add_module(name, block)
                names.append(name)
            if i < len(depths) - 1:
                name = f"layers_{i}_downsample"
                self.add_module(name, PatchMerging((r, r), dim))
                names.append(name)
            self.stages.extend(names)
        num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(num_features)
        if not use_feat:
            self.head = Mlp(num_features, 256, num_classes)
        self.eval()

    def forward(self, x, return_logits: bool = False):
        x = self.patch_embed(x)
        for name in self.stages:
            x = remat_block(getattr(self, name), x)
        x = self.norm(x).float().mean(dim=1).to(x.dtype)
        if self.use_feat:
            return x
        logits = self.head(x)
        if self.num_classes == 1:
            logits = logits.squeeze(-1)
        return logits if return_logits else torch.sigmoid(logits)
