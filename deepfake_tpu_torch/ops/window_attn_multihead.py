"""Large-window attention through kernel K6 (``csrc/window_attn_multihead.cu``).

Counterpart of the ``_run_multihead`` route of deepfake_tpu/ops/
pallas_window_attn.py ``pallas_window_attention`` (:179, taken for windows of
N >= 128 tokens), and of its ``_run``/``_run_packed`` routes and
``pallas_window_attention_nhc_packed`` for 64 < N < 128, above K2's range:
head-major q, k, v [B_, H, N, D], cosine (L2-normalised q
and k, logits times the per-head ``logit_scale``) or scaled (q times
``scale``), plus bias [H, N, N] and mask [nW, N, N] (window i uses mask
i % nW), the max-stabilised f32 softmax, f32 P V, one rounding to the input
type. SwinV2 takes it for every window of more than 64 tokens (9 x 9 and up:
16 x 16 at 256^2, 24 x 24 in the 384^2 fine-tunes).

``window_attention_multihead`` takes the plain version for CPU tensors
(``window_attention_heads_plain``, K2's, which computes this function at any
N) and launches K6 for CUDA tensors, or raises; ``.launches`` counts the
launches. K6 takes N >= 65, with no upper limit (K and V stream through
shared memory in key tiles), and head dims 1 to 128: 32
(every SwinV2-B head) on Hopper's wgmma, any other in bf16 through
mma.sync (csrc/window_attn_mma.cuh). Its bf16 wgmma kernel takes, per block, one head, one 64-row query tile and a group of
windows that read one mask index, which share a bias + mask tile
(``window_group`` chooses how many, ``block_windows`` lists the blocks: both
are K5's, in ops/window_attn3d_train.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from deepfake_tpu_torch.kernels import build
from deepfake_tpu_torch.ops.window_attn3d_train import window_group
from deepfake_tpu_torch.ops.window_attn_kernel import (
    _no_autograd, _on_cuda, _sm_count, check_head_dim, on_wgmma, window_attention_heads_plain,
)

MIN_TOKENS = 65
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.library("window_attn_multihead")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.k6_window_attn.argtypes = [
            i, i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, i, p, i, i, i, i, i, p]
        lib.k6_window_attn.restype = i
        lib.k6_consumers.argtypes = [i]
        lib.k6_consumers.restype = i
        lib.k6_error_string.argtypes = [i]
        lib.k6_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def consumers(n: int) -> int:
    """The warpgroups of a bf16 block at n tokens (4 at SwinV2's windows up
    to 16; fewer where the bias tile leaves less room), among which the
    kernel deals out the windows of the block's group."""
    return _lib().k6_consumers(n)


def _launch(q, k, v, out, *, bias, mask, logit_scale, scale, cosine):
    """K6 on head-major views q, k, v, out [B_, H, N, D] (any strides with
    the head dim contiguous; q, k and v share theirs). Raises before any
    launch for what the kernel does not take."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K6 takes f32 or bf16 q/k/v, got {q.dtype}")
    B_, H, N, D = q.shape
    if N < MIN_TOKENS:
        raise ValueError(f"K6 takes N >= {MIN_TOKENS}, got N={N}, D={D}")
    check_head_dim("K6", N, D)
    if not (q.stride() == k.stride() == v.stride()) or q.stride(-1) != 1 or out.stride(-1) != 1:
        raise ValueError("K6 needs q, k, v with one set of strides and the head dim contiguous")
    dev = q.device
    bias = bias.to(dev, torch.float32).contiguous()
    if bias.shape != (H, N, N):
        raise ValueError(f"bias must be [{H}, {N}, {N}], got {tuple(bias.shape)}")
    n_masks = 1
    if mask is not None:
        mask = mask.to(dev, torch.float32).contiguous()
        n_masks = mask.shape[0]
        if mask.shape[1:] != (N, N) or B_ % n_masks:
            raise ValueError(f"mask {tuple(mask.shape)} does not tile {B_} windows")
    if on_wgmma(q.dtype, D) and (any(t.data_ptr() % 16 for t in (q, k, v, out)) or any(
            s % 8 for s in (*q.stride()[:3], *out.stride()[:3]))):
        raise ValueError("K6's wgmma route needs 16-byte aligned q, k, v, out with strides "
                         "that are multiples of 8 elements")
    if cosine:
        scales = logit_scale.to(dev, torch.float32).reshape(H).contiguous()
    else:
        scales = torch.full((H,), float(scale), dtype=torch.float32, device=dev)
    group = 1
    if on_wgmma(q.dtype, D):
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        group = window_group(B_, H, N, n_masks, mask is not None, _sm_count(index),
                             consumers(N))
    lib = _lib()
    status = lib.k6_window_attn(
        _DTYPES[q.dtype], int(cosine), q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
        out.data_ptr(), *out.stride()[:3], bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, n_masks, scales.data_ptr(), B_, H, N, D,
        group, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, lib.k6_error_string, "k6_window_attn")


def window_attention_multihead(q, k, v, *, bias, mask=None, logit_scale=None,
                               scale: Optional[float] = None, cosine: bool = True):
    """Head-major q, k, v [B_, H, N, D] -> [B_, H, N, D]. q, k and v may be
    views of one [B_, N, 3C] qkv tensor (``qkv.view(B_, N, 3, H, D)`` permuted
    and unbound) with the head dim contiguous. On the card the result is a
    head-major view of a token-major [B_, N, H, D] tensor, so that
    ``out.transpose(1, 2).reshape(B_, N, H * D)`` copies nothing."""
    _no_autograd("window_attention_multihead", q, k, v, bias, logit_scale)
    if not _on_cuda("window_attention_multihead", q, k, v):
        return window_attention_heads_plain(q, k, v, bias=bias, mask=mask,
                                            logit_scale=logit_scale, scale=scale, cosine=cosine)
    B_, H, N, D = q.shape
    out = torch.empty(B_, N, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    _launch(q, k, v, out, bias=bias, mask=mask, logit_scale=logit_scale, scale=scale,
            cosine=cosine)
    window_attention_multihead.launches += 1
    return out


window_attention_multihead.launches = 0
