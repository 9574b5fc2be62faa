"""Window attention through kernel K2 (``csrc/window_attn.cu``).

Counterparts of deepfake_tpu/ops/pallas_window_attn.py
``pallas_window_attention`` (:1127, head-major [B_, H, N, D]; routes
``_run`` and ``_run_packed``) and ``pallas_window_attention_nhc_packed``
(:847, token-major [B_, N, C] with heads in channel slices). One CUDA kernel
serves both: the wrappers pass it the layout's strides.

Each wrapper takes its plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises; ``<wrapper>.launches`` counts kernel
launches. The plain versions compute what the kernel computes, at the
kernel's (and the Pallas kernels') cast points: q, k, v read as f32,
max-stabilised f32 softmax, f32 PV, one rounding to the input type at the
store.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepfake_tpu_torch.kernels import build
from deepfake_tpu_torch.ops.window_attn import add_mask, l2_normalize

MAX_TOKENS = 64
MAX_HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------- plain versions

def window_attention_heads_plain(q, k, v, *, bias, mask=None, logit_scale=None,
                                 scale: Optional[float] = None, cosine: bool = True):
    """Head-major [B_, H, N, D] attention: cosine (L2-normalised q, k times
    the per-head ``logit_scale``) or scaled (q times ``scale``)."""
    qf, kf = q.float(), k.float()
    if cosine:
        attn = l2_normalize(qf) @ l2_normalize(kf).transpose(-1, -2) * logit_scale.float()
    else:
        attn = (qf * scale) @ kf.transpose(-1, -2)
    attn = torch.softmax(add_mask(attn + bias.float()[None], mask), dim=-1)
    return (attn @ v.float()).to(v.dtype)


def window_attention_tokens_plain(q, k, v, *, num_heads: int, bias, mask=None,
                                  logit_scale=None, scale: Optional[float] = None,
                                  cosine: bool = True):
    """Token-major [B_, N, C] attention, heads in channel slices."""
    B_, N, C = q.shape
    heads = lambda t: t.reshape(B_, N, num_heads, C // num_heads).transpose(1, 2)
    out = window_attention_heads_plain(
        heads(q), heads(k), heads(v), bias=bias, mask=mask, logit_scale=logit_scale,
        scale=scale, cosine=cosine)
    return out.transpose(1, 2).reshape(B_, N, C)


# ---------------------------------------------------------------- CUDA kernel

def _lib():
    lib = build.library("window_attn")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.k2_window_attn.argtypes = [
            i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, i, p, i, i, i, i, i, p]
        lib.k2_window_attn.restype = i
        lib.k2_error_string.argtypes = [i]
        lib.k2_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(q, k, v, strides, out, out_strides, *, windows, heads, n, d, bias, mask,
            logit_scale, scale, cosine):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"window attention kernel takes f32 or bf16 q/k/v, got {q.dtype}")
    if n > MAX_TOKENS or d > MAX_HEAD_DIM:
        raise ValueError(
            f"window attention kernel takes N <= {MAX_TOKENS} and D <= {MAX_HEAD_DIM}, "
            f"got N={n}, D={d}")
    if not (q.stride(-1) == k.stride(-1) == v.stride(-1) == 1):
        raise ValueError("window attention kernel needs the head dim contiguous")
    dev = q.device
    bias = bias.to(dev, torch.float32).contiguous()
    if bias.shape != (heads, n, n):
        raise ValueError(f"bias must be [{heads}, {n}, {n}], got {tuple(bias.shape)}")
    n_masks = 1
    if mask is not None:
        mask = mask.to(dev, torch.float32).contiguous()
        n_masks = mask.shape[0]
        if mask.shape[1:] != (n, n) or windows % n_masks:
            raise ValueError(f"mask {tuple(mask.shape)} does not tile {windows} windows")
    if cosine:
        scales = logit_scale.to(dev, torch.float32).reshape(heads).contiguous()
    else:
        scales = torch.full((heads,), float(scale), dtype=torch.float32, device=dev)
    lib = _lib()
    status = lib.k2_window_attn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
        out.data_ptr(), *out_strides, bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, n_masks, scales.data_ptr(),
        int(cosine), windows, heads, n, d, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, lib.k2_error_string, "k2_window_attn")


def _no_autograd(name: str, *ts) -> None:
    """Raise when a kernel without a backward is called under autograd with
    an input that requires grad: its output would carry no gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() or "
                           "torch.inference_mode()")


def _on_cuda(name: str, *ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def window_attention_heads(q, k, v, *, bias, mask=None, logit_scale=None,
                           scale: Optional[float] = None, cosine: bool = True):
    """Head-major q, k, v [B_, H, N, D] (contiguous) -> [B_, H, N, D]."""
    if not _on_cuda("window_attention_heads", q, k, v):
        return window_attention_heads_plain(q, k, v, bias=bias, mask=mask,
                                            logit_scale=logit_scale, scale=scale, cosine=cosine)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("window_attention_heads: q, k, v must be contiguous")
    B_, H, N, D = q.shape
    out = torch.empty_like(q)
    strides = (H * N * D, N * D, D)
    _launch(q, k, v, strides, out, strides, windows=B_, heads=H, n=N, d=D, bias=bias,
            mask=mask, logit_scale=logit_scale, scale=scale, cosine=cosine)
    window_attention_heads.launches += 1
    return out


def window_attention_tokens(q, k, v, *, num_heads: int, bias, mask=None, logit_scale=None,
                            scale: Optional[float] = None, cosine: bool = True):
    """Token-major q, k, v [B_, N, C] -> [B_, N, C]. q, k, v may be column
    slices of one [B_, N, 3C] qkv tensor: they must share strides and keep
    channels contiguous."""
    if not _on_cuda("window_attention_tokens", q, k, v):
        return window_attention_tokens_plain(q, k, v, num_heads=num_heads, bias=bias,
                                             mask=mask, logit_scale=logit_scale, scale=scale,
                                             cosine=cosine)
    if not (q.stride() == k.stride() == v.stride()):
        raise ValueError("window_attention_tokens: q, k, v must share strides")
    B_, N, C = q.shape
    if C % num_heads:
        raise ValueError(f"C={C} is not a multiple of num_heads={num_heads}")
    D = C // num_heads
    out = torch.empty(B_, N, C, dtype=q.dtype, device=q.device)
    _launch(q, k, v, (q.stride(0), D, q.stride(1)), out, (N * C, D, C), windows=B_,
            heads=num_heads, n=N, d=D, bias=bias, mask=mask, logit_scale=logit_scale,
            scale=scale, cosine=cosine)
    window_attention_tokens.launches += 1
    return out


window_attention_heads.launches = 0
window_attention_tokens.launches = 0
