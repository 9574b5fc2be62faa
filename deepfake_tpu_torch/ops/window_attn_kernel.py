"""Window attention through kernel K2 (``csrc/window_attn.cu``).

Counterparts of deepfake_tpu/ops/pallas_window_attn.py
``pallas_window_attention`` (:1127, head-major [B_, H, N, D]; routes
``_run`` and ``_run_packed``) and ``pallas_window_attention_nhc_packed``
(:847, token-major [B_, N, C] with heads in channel slices). One CUDA kernel
serves both: the wrappers pass it the layout's strides.

Each wrapper takes its plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises; ``<wrapper>.launches`` counts kernel
launches. The plain versions compute what the kernel computes, at the
Pallas kernels' cast points: q, k, v read as f32, max-stabilised f32
softmax, f32 PV, one rounding to the input type at the store (the bf16
kernel rounds the weights to bf16 for PV on the tensor cores).

The bf16 kernel takes, per block, one head and a group of windows that read
one mask index (``window_group`` chooses how many; ``block_windows`` lists
the blocks).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from deepfake_tpu_torch.kernels import build
from deepfake_tpu_torch.ops.window_attn import add_mask, l2_normalize

MAX_TOKENS = 64
MAX_HEAD_DIM = 128
# the head dims K3, K5 and K6 take, as K2 does: 1 to 128 (on_wgmma says
# which of their bf16 kernels runs; above 128 waits for ROADMAP C1)
HEAD_DIMS = range(1, MAX_HEAD_DIM + 1)
# the head dim of the wgmma + TMA kernels of K3, K5 and K6
# (csrc/window_attn_mma.cuh wtile::mma::WGMMA_D)
WGMMA_HEAD_DIM = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 blocks resident on one SM (shared memory: ~67 KB a block at D = 32)
BLOCKS_PER_SM = 3


@functools.lru_cache(maxsize=None)
def window_group(windows: int, heads: int, n_masks: int, masked: bool, slots: int) -> int:
    """G, the windows a block of the bf16 kernel takes. Window w reads mask
    w % n_masks, so a masked launch has n_masks groups of windows that share
    one bias + mask tile, and an unmasked one a single group; a group's
    windows are split over ceil(per_group / G) blocks, each of which fills
    its tile once. The cost of a choice is waves x (G + 1), the tile counted
    as one window, with ``slots`` blocks resident at once (K3's planner)."""
    n_groups = n_masks if masked else 1
    per_group = windows // n_groups
    units = heads * n_groups
    best, group = None, 1
    for g in range(1, per_group + 1):
        splits = -(-per_group // g)
        if g > 1 and splits == -(-per_group // (g - 1)):
            continue  # the same split count as G - 1
        cost = -(-units * splits // slots) * (g + 1)
        if best is None or cost < best:
            best, group = cost, g
    return group


def block_windows(windows: int, heads: int, n_masks: int, masked: bool,
                  group: int) -> List[Tuple[int, List[int]]]:
    """The bf16 kernel's blocks in its order (block x = head + heads (mask
    index + n_groups split)): a list of (head, windows of the block). Every
    block of a masked launch takes windows of one mask index."""
    n_groups = n_masks if masked else 1
    per_group = windows // n_groups
    g = min(group, per_group)
    blocks = []
    for x in range(heads * n_groups * -(-per_group // g)):
        h, grp = x % heads, x // heads
        mi, b0 = grp % n_groups, (grp // n_groups) * g
        blocks.append((h, [mi + b * n_groups for b in range(b0, min(b0 + g, per_group))]))
    return blocks


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
            i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, i, p, i, i, i, i, i, i, p]
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
    group = 1
    if q.dtype == torch.bfloat16:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        group = window_group(windows, heads, n_masks, mask is not None,
                             BLOCKS_PER_SM * _sm_count(index))
    lib = _lib()
    status = lib.k2_window_attn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
        out.data_ptr(), *out_strides, bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, n_masks, scales.data_ptr(),
        int(cosine), windows, heads, n, d, group, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, lib.k2_error_string, "k2_window_attn")


def on_wgmma(dtype: torch.dtype, d: int) -> bool:
    """Whether K3, K5 or K6 runs its wgmma kernel for this dtype and head
    dim; every other bf16 head dim runs the mma.sync kernels of
    csrc/window_attn_mma.cuh (the C side splits by ``wtile::mma::on_wgmma``)."""
    return dtype == torch.bfloat16 and d == WGMMA_HEAD_DIM


def check_head_dim(kernel: str, n: int, d: int) -> None:
    """Raise for a head dim that K3, K5 or K6 does not take."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel} takes head dims {HEAD_DIMS.start} to {HEAD_DIMS.stop - 1} "
                         f"(above that: ROADMAP C1), got N={n}, D={d}")


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
