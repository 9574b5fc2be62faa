"""Video Swin window attention through kernel K3 (``csrc/window_attn3d.cu``).

Counterpart of deepfake_tpu/ops/pallas_window_attn.py
``pallas_window_attention_nhc`` (:709, token-major [B_, N, C] with heads in
channel slices), and, between K4's qkv and proj launches
(ops/ln_linear_kernel.py), of the attention inside
``pallas_window_attention_nhc_qkv`` (:548). Windows of any size (392 tokens
for (8,7,7) windows, 784 for (16,7,7)), head dims 8 to 128 in steps of 8.

On the card, bf16 runs on Hopper's wgmma and TMA: one block per (head, group
of windows that read one mask index, query tile of 64 rows), the group
sharing one bias + mask tile in shared memory (see the source's note); a
window of more than 512 tokens streams its keys in tiles, each warpgroup
filling the bias + mask of its own 64-key chunk; f32 runs the SIMT parity
kernel, which streams its keys at any N; bf16 at a head dim other than 32
(Video Swin's) runs a tensor-core kernel on mma.sync
(csrc/window_attn_mma.cuh) at the same cast points. The wrapper takes its
plain version for a CPU tensor and launches the kernel for a CUDA tensor,
or raises;
``window_attn3d_tokens.launches`` counts kernel launches. The plain version
keeps the Pallas kernel's cast points: q * bf16(scale) in q's type, f32
logits, + bias + mask, the static-shift softmax exp(min(x - 24, 60)) with
1/rowsum deferred to the PV output, the weights cast to q's type for PV.
"""

from __future__ import annotations

import ctypes

import torch

from deepfake_tpu_torch.kernels import build
from deepfake_tpu_torch.ops.window_attn import add_mask
from deepfake_tpu_torch.ops.window_attn_kernel import _no_autograd, _on_cuda, check_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------- plain versions

def window_attn3d_tokens_plain(q, k, v, *, num_heads: int, bias, mask=None, scale: float):
    """Token-major q, k, v [B_, N, C] (heads in channel slices) -> [B_, N, C],
    with the Pallas ``_nhc_kernel``'s cast points (mxu_bf16, no_max)."""
    B_, N, C = q.shape
    heads = lambda t: t.reshape(B_, N, num_heads, C // num_heads).transpose(1, 2)
    qs = heads(q) * torch.tensor(scale, dtype=q.dtype)
    attn = add_mask(qs.float() @ heads(k).float().transpose(-1, -2) + bias.float()[None], mask)
    e = torch.exp(torch.clamp(attn - 24.0, max=60.0))
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    out = (e.to(v.dtype).float() @ heads(v).float()) * r
    return out.to(v.dtype).transpose(1, 2).reshape(B_, N, C)


# ---------------------------------------------------------------- CUDA kernel

def _lib():
    lib = build.library("window_attn3d")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.k3_window_attn.argtypes = [
            i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, i, ctypes.c_float, i, i, i, i, p]
        lib.k3_window_attn.restype = i
        lib.k3_windows_per_block.argtypes = [i, i, i, i, i]
        lib.k3_windows_per_block.restype = i
        lib.k3_error_string.argtypes = [i]
        lib.k3_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(q, k, v, strides, out, out_strides, *, windows, heads, n, d, bias, mask, scale):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K3 takes f32 or bf16 q/k/v of one type, got {q.dtype}")
    check_head_dim("K3", n, d)
    if not (q.stride(-1) == k.stride(-1) == v.stride(-1) == 1):
        raise ValueError("K3 needs the head dim contiguous")
    bf16 = q.dtype == torch.bfloat16
    dev = q.device
    bias = bias.to(dev, torch.float32).contiguous()
    if bias.shape != (heads, n, n):
        raise ValueError(f"bias must be [{heads}, {n}, {n}], got {tuple(bias.shape)}")
    n_masks = 1
    if mask is not None:
        # the tensor-core route reads a bf16 mask ({0, -100} are exact), the
        # f32 route an f32 one
        mask = mask.to(dev, torch.bfloat16 if bf16 else torch.float32).contiguous()
        n_masks = mask.shape[0]
        if mask.shape[1:] != (n, n) or windows % n_masks:
            raise ValueError(f"mask {tuple(mask.shape)} does not tile {windows} windows")
    if bf16 and (any(t.data_ptr() % 16 for t in (q, k, v, out, bias))
                 or (mask is not None and mask.data_ptr() % 16)
                 or any(s % 8 for s in (*strides, *out_strides))):
        raise ValueError("K3's bf16 route needs 16-byte aligned q/k/v/out/bias/mask "
                         "and strides that are multiples of 8 elements")
    lib = _lib()
    status = lib.k3_window_attn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
        out.data_ptr(), *out_strides, bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, n_masks, float(scale),
        windows, heads, n, d, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, lib.k3_error_string, "k3_window_attn")


def windows_per_block(windows: int, heads: int, n: int, n_masks: int, masked: bool) -> int:
    """G: the windows one block of the bf16 route takes for a launch of these
    arguments (windows that share a mask index, or any windows without a
    mask), as the kernel's host code chooses it for this card. A diagnostic:
    chip_smoke.py's modelled L2 reads and the card tests read it; the
    launch path does not."""
    return _lib().k3_windows_per_block(windows, heads, n, n_masks, int(masked))


def window_attn3d_tokens(q, k, v, *, num_heads: int, bias, mask=None, scale: float):
    """Token-major q, k, v [B_, N, C] -> [B_, N, C] (#7). q, k, v may be
    column slices of one [B_, N, 3C] qkv tensor: they must share strides and
    keep channels contiguous. It has no backward, so it raises under
    autograd (training takes K5, ops/window_attn3d_train.py)."""
    _no_autograd("window_attn3d_tokens", q, k, v, bias)
    if not _on_cuda("window_attn3d_tokens", q, k, v):
        return window_attn3d_tokens_plain(q, k, v, num_heads=num_heads, bias=bias, mask=mask,
                                          scale=scale)
    if not (q.stride() == k.stride() == v.stride()):
        raise ValueError("window_attn3d_tokens: q, k, v must share strides")
    B_, N, C = q.shape
    if C % num_heads:
        raise ValueError(f"C={C} is not a multiple of num_heads={num_heads}")
    D = C // num_heads
    out = torch.empty(B_, N, C, dtype=q.dtype, device=q.device)
    _launch(q, k, v, (q.stride(0), D, q.stride(1)), out, (N * C, D, C), windows=B_,
            heads=num_heads, n=N, d=D, bias=bias, mask=mask, scale=scale)
    window_attn3d_tokens.launches += 1
    return out


window_attn3d_tokens.launches = 0
