"""The linear layers of a Video Swin block through kernel K4 (``csrc/ln_linear.cu``).

K4 computes one nn.Linear with what surrounds it in the block fused in:

  s = x (+ x2);  s = LayerNorm(s) (optional);  y = s @ W^T + b;
  y = GELU(y) (optional);  out = (res (+ res2)) + y (optional)

With K3 (ops/window_attn3d_kernel.py) it is the counterpart of two Pallas
kernels of deepfake_tpu:

  ops/pallas_window_attn.py:548 ``pallas_window_attention_nhc_qkv``
      (LayerNorm -> qkv -> attention -> proj):
      ``ln_linear(x, W_qkv, b_qkv, ln=...)`` -> K3 -> ``ln_linear(o, W_proj, b_proj)``
  ops/pallas_mlp.py:101 ``fused_mlp_tail``
      ((a + b) -> LayerNorm -> fc1 -> GELU -> fc2 -> + (a + b)): ``mlp_tail``,
      two launches.

The wrapper takes its plain version for a CPU tensor and launches the kernel
for a CUDA tensor, or raises; ``ln_linear.launches`` counts kernel launches.
The plain version keeps the Pallas kernels' cast points: s = x + x2 in the
input type; LayerNorm statistics in f32 with the fast variance
max(E[s^2] - E[s]^2, 0), (s - mu) * (rsqrt(var + eps) * scale) + bias rounded
to the input type; the product summed in f32 plus the bias, rounded once;
GELU (``gelu_exact``: tanh form in bf16, erf in f32) rounded; the residual
added in the input type.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deepfake_tpu_torch.kernels import build
from deepfake_tpu_torch.models.layers import gelu_exact
from deepfake_tpu_torch.ops.window_attn_kernel import _no_autograd, _on_cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PANEL_K = 1024  # csrc/ln_linear.cu tc::MAX_PANEL_K
# (scale, bias, eps) of a LayerNorm over the input's last axis
LN = Tuple[torch.Tensor, torch.Tensor, float]


# ---------------------------------------------------------------- plain version

def ln_linear_plain(x, weight, bias=None, *, x2=None, ln: Optional[LN] = None,
                    gelu: bool = False, res=None, res2=None):
    """x (+ x2) [..., K] -> [..., N] with ``weight`` [N, K] (nn.Linear's)."""
    s = x if x2 is None else x + x2
    if ln is not None:
        scale, shift, eps = ln
        sf = s.float()
        mu = sf.mean(-1, keepdim=True)
        var = torch.clamp((sf * sf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        s = ((sf - mu) * (torch.rsqrt(var + eps) * scale.float()) + shift.float()).to(x.dtype)
    y = s.float() @ weight.float().t()
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    if gelu:
        y = gelu_exact(y)
    if res is not None:
        y = (res if res2 is None else res + res2) + y
    return y


# ---------------------------------------------------------------- CUDA kernel

def _lib():
    lib = build.library("ln_linear")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.k4_ln_linear.argtypes = [
            i, p, p, i64, p, p, ctypes.c_float, p, p, i, i, i, i, p, p, i64, p, i64, p]
        lib.k4_ln_linear.restype = i
        lib.k4_error_string.argtypes = [i]
        lib.k4_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _rows(name: str, t: torch.Tensor, cols: int, like: Optional[torch.Tensor] = None):
    """t [..., cols] as a [rows, cols] view with contiguous columns (and the
    strides of ``like``, when given)."""
    if t.shape[-1] != cols:
        raise ValueError(f"K4: {name} has {t.shape[-1]} columns, expected {cols}")
    r = t.reshape(-1, cols)
    if r.stride(1) != 1 and cols > 1:
        raise ValueError(f"K4: {name} needs contiguous columns")
    if like is not None and (r.shape != like.shape or r.stride() != like.stride()):
        raise ValueError(f"K4: {name} must match the shape and strides of its partner")
    return r


def _check(x, weight, bias, x2, ln, res, res2):
    """Raise for what K4 does not take; returns the 2D operands."""
    dt = x.dtype
    if dt not in _DTYPES:
        raise ValueError(f"K4 takes f32 or bf16, got {dt}")
    others = [weight, bias, x2, res, res2] + (list(ln[:2]) if ln is not None else [])
    if any(t is not None and t.dtype != dt for t in others):
        raise ValueError(f"K4 takes every tensor in one type ({dt})")
    N, K = weight.shape
    if not weight.is_contiguous():
        raise ValueError("K4 needs a contiguous [N, K] weight")
    if any(t is not None and (t.shape != (n,) or not t.is_contiguous())
           for t, n in ((bias, N),) + (((ln[0], K), (ln[1], K)) if ln is not None else ())):
        raise ValueError("K4 needs contiguous 1D bias [N] and LayerNorm weights [K]")
    a = _rows("x", x, K)
    a2 = _rows("x2", x2, K, a) if x2 is not None else None
    r = _rows("res", res, N) if res is not None else None
    r2 = _rows("res2", res2, N, r) if res2 is not None else None
    if r is not None and r.shape[0] != a.shape[0]:
        raise ValueError(f"K4: res has {r.shape[0]} rows, x has {a.shape[0]}")
    if res2 is not None and res is None:
        raise ValueError("K4: res2 needs res")
    aligned = [a, weight, a2, bias] + (list(ln[:2]) if ln is not None else [])
    if dt == torch.bfloat16 and (
            K % 8 or N % 8 or a.stride(0) % 8 or (r is not None and r.stride(0) % 8)
            or any(t is not None and t.data_ptr() % 16 for t in aligned)):
        raise ValueError("K4's bf16 route needs K, N and row strides that are multiples of 8 "
                         "and 16-byte aligned x, x2, weight, bias and LayerNorm weights")
    if dt == torch.bfloat16 and (x2 is not None or ln is not None) and (
            K % 32 or K > MAX_PANEL_K):
        raise ValueError(f"K4's bf16 route with a sum or a LayerNorm holds x in shared memory: "
                         f"it needs K a multiple of 32 up to {MAX_PANEL_K}, got {K}")
    return a, a2, r, r2


def ln_linear(x, weight, bias=None, *, x2=None, ln: Optional[LN] = None, gelu: bool = False,
              res=None, res2=None):
    """x (+ x2) [..., K] -> [..., N]: the optional LayerNorm ``ln`` =
    (scale, bias, eps), the product with ``weight`` [N, K] plus ``bias``,
    the optional GELU and the optional residual ``res`` (+ ``res2``)
    [..., N]. x2 and res2 must share the strides of x and res. It has no
    backward, so it raises under autograd (the training route is plain
    PyTorch)."""
    _no_autograd("ln_linear", x, weight, bias, x2, res, res2, *(ln[:2] if ln is not None else ()))
    if not _on_cuda("ln_linear", x, weight):
        return ln_linear_plain(x, weight, bias, x2=x2, ln=ln, gelu=gelu, res=res, res2=res2)
    a, a2, r, r2 = _check(x, weight, bias, x2, ln, res, res2)
    M, K = a.shape
    N = weight.shape[0]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    status = lib.k4_ln_linear(
        _DTYPES[x.dtype], a.data_ptr(), ptr(a2), a.stride(0),
        ptr(ln[0] if ln is not None else None), ptr(ln[1] if ln is not None else None),
        float(ln[2]) if ln is not None else 0.0, weight.data_ptr(), ptr(bias), M, K, N,
        int(gelu), ptr(r), ptr(r2), r.stride(0) if r is not None else 0, out.data_ptr(), N,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, lib.k4_error_string, "k4_ln_linear")
    ln_linear.launches += 1
    return out.view(*x.shape[:-1], N)


ln_linear.launches = 0


def mlp_tail(x, h, ln: LN, w1, b1, w2, b2):
    """s + fc2(GELU(fc1(LayerNorm(s)))) with s = x + h, x and h [..., C]:
    the MLP half of a Swin block (``fused_mlp_tail``) as two launches of K4.
    s is formed in both launches and never stored; only the [rows, 4C]
    hidden tensor goes through device memory."""
    C = x.shape[-1]
    a, b = x.reshape(-1, C), h.reshape(-1, C)
    hid = ln_linear(a, w1, b1, x2=b, ln=ln, gelu=True)
    return ln_linear(hid, w2, b2, res=a, res2=b).view(x.shape)
