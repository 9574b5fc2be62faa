"""Windowed attention in plain PyTorch: SwinV2 cosine attention and Video
Swin scaled attention.

Counterpart of deepfake_tpu/ops/window_attn.py:25-126, the JAX package's
einsum path. Shapes:

  q, k, v      [B_, H, N, D]   (B_ = batch * windows, windows batch-major)
  logit_scale  [H, 1, 1]       (already clamped at log(100) and exponentiated)
  bias         [H, N, N]       relative position bias (additive)
  mask         [nW, N, N] or None; window w uses mask[w % nW]
"""

from __future__ import annotations

from typing import Optional

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics over the last axis: x / max(|x|, eps)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def add_mask(attn: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """attn [B_, H, N, N] f32 plus mask [nW, N, N] tiled over B_."""
    if mask is None:
        return attn
    nW = mask.shape[0]
    B_, H, N, _ = attn.shape
    return (attn.view(B_ // nW, nW, H, N, N) + mask.float()[None, :, None]).view(B_, H, N, N)


def cosine_window_attention(q, k, v, logit_scale, bias, mask=None,
                            bounded: bool = True) -> torch.Tensor:
    """SwinV2 cosine attention as the JAX path computes it: L2-normalised q,
    k; logits times the per-head scale, plus bias and mask; an f32 softmax;
    PV in v's type. ``bounded`` (inference) takes the static shift
    exp(min(x - 24, 60)) (window_attn.py:31-56: cosine logits are bounded
    and every row's max is >= 0, so it equals the max-stabilised form up to
    f32 rounding); training passes ``bounded=False`` for the max-stabilised
    softmax (window_attn.py:70-89, swin2d.py:244-249), since a learned
    logit_scale past ln(68) would saturate the shift's clamp and zero those
    weights' gradients."""
    attn = l2_normalize(q.float()) @ l2_normalize(k.float()).transpose(-1, -2)
    attn = add_mask(attn * logit_scale.float() + bias.float()[None], mask)
    if not bounded:
        return torch.softmax(attn, dim=-1).to(v.dtype) @ v
    e = torch.exp(torch.clamp(attn - 24.0, max=60.0))
    return (e / e.sum(dim=-1, keepdim=True)).to(v.dtype) @ v


def scaled_window_attention(q, k, v, scale: float, bias, mask=None) -> torch.Tensor:
    """Video Swin scaled-dot attention as the JAX einsum path computes it
    (window_attn.py:96-126): ``q * scale`` in q's type, f32 logits, plus
    bias and mask, max-stabilised f32 softmax, the probabilities cast to
    v's type for PV."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    attn = add_mask(qs.float() @ k.float().transpose(-1, -2) + bias.float()[None], mask)
    return torch.softmax(attn, dim=-1).to(v.dtype) @ v
