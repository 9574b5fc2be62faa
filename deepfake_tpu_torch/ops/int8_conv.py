"""int8 convolutions of the IRv2 trunk at serving: kernels K7 and K8.

Counterpart of the int8 branch of deepfake_tpu/models/layers.py
(``quantize_sym`` :187, ``int8_shape_allowed`` :198, ``act_scale_for``'s
scale rule :224, ``quantize_to`` :249, ``quant_conv`` :256), which the JAX
package leaves to XLA's int8 convolution. Here, in ``csrc/int8_conv.cu``:

* K8, two launches: ``act_amax`` (the per-tensor max |x| into a device
  scalar, zeroed in the stream first) and ``act_quantize`` (x to int8 at
  scale max(amax, 1e-12) / 127, the scale computed on the device from the
  scalar; static mode skips ``act_amax`` and passes the calibrated scalar);
* K7, ``int8_conv``: the int8 x int8 -> int32 implicit-GEMM convolution of
  NHWC activations and [Cout, KH, KW, Cin] weights, dequantised by
  ``amax``'s scale times the per-output-channel weight scale, plus a
  per-channel shift (the folded BatchNorm, or the conv bias), ReLU
  optional, cast to the output type.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises; ``.launches`` counts its launches. The
plain versions compute what the kernels compute, in the same order of
roundings, so the two agree to the bit: the quantisation divides (as
layers.py:251-253, never by a reciprocal) and rounds half to even; the
convolution is exact in float64 (|acc| <= K 127^2 < 2^53); the epilogue is
f32 ``acc * (xs * ws) + shift``, one rounding an operation. It is never an
int8 ``F.conv2d``, which wraps.

``int8_shape_allowed`` is the scope gate (``DEEPFAKE_TPU_INT8_SCOPE``):
``all`` (the default on the card: the TPU default ``pointwise`` came from
an XLA:TPU hang that does not apply here), ``wide`` or ``pointwise``; any
other value raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deepfake_tpu_torch.kernels import build
from deepfake_tpu_torch.ops.window_attn_kernel import _no_autograd, _on_cuda

SCOPES = ("pointwise", "wide", "all")
SCOPE_ENV = "DEEPFAKE_TPU_INT8_SCOPE"
AMAX_FLOOR = 1e-12
QMAX = 127.0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KERNEL = 7  # the widest IRv2 kernel side (1 x 7, 7 x 1)


def int8_scope() -> str:
    """The scope of ``DEEPFAKE_TPU_INT8_SCOPE``, ``all`` when unset; raises on
    any other value (the JAX gate reads an unknown value as ``all``)."""
    scope = os.environ.get(SCOPE_ENV, "all")
    if scope not in SCOPES:
        raise ValueError(f"{SCOPE_ENV}={scope!r}: expected one of {SCOPES}")
    return scope


def int8_shape_allowed(kernel: Sequence[int], stride: int, cin: int) -> bool:
    """Whether a conv of this shape takes the int8 path (layers.py:198-221):
    ``pointwise`` only 1x1 stride 1, ``wide`` stride 1 with cin >= 32,
    ``all`` every conv. A conv outside the scope runs its float path."""
    scope = int8_scope()
    if scope == "pointwise":
        return tuple(kernel) == (1, 1) and stride == 1
    if scope == "wide":
        return stride == 1 and cin >= 32
    return True


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in f32 (layers.py:247). The divisor is a
    tensor: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which rounds apart from the division K7 and K8 make."""
    qmax = torch.full((), QMAX, dtype=torch.float32, device=amax.device)
    return torch.clamp(amax.float(), min=AMAX_FLOOR) / qmax


def quantize_to(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8 (layers.py:249-254)."""
    return torch.round(x.float() / scale).clamp(-QMAX, QMAX).to(torch.int8)


def quantize_sym(x: torch.Tensor, dim=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation (layers.py:187-196): per tensor
    (``dim=None``) or with the max taken over ``dim`` (kept), so that
    x ~ q * scale. Returns (q int8, scale f32)."""
    ax = x.float().abs()
    amax = ax.amax() if dim is None else ax.amax(dim=dim, keepdim=True)
    scale = act_scale(amax)
    return quantize_to(x, scale), scale


@dataclass
class Int8Weights:
    """One int8 conv's operands, made once from the f32 weights: ``wq``
    [Cout, KH, KW, Cin] int8, ``ws`` [Cout] f32 scales, ``shift`` [Cout]
    f32 (the folded BatchNorm shift, or the conv bias), ``stride`` and
    ``pad`` (top, bottom, left, right)."""

    wq: torch.Tensor
    ws: torch.Tensor
    shift: torch.Tensor
    stride: int
    pad: Tuple[int, int, int, int]

    @classmethod
    def from_folded(cls, w: torch.Tensor, shift: torch.Tensor, stride: int,
                    pad: Tuple[int, int, int, int]) -> "Int8Weights":
        """``w`` [Cout, Cin, KH, KW] f32 (the BatchNorm gain folded in),
        quantised per output channel (over KH, KW, Cin: layers.py:316)."""
        wq, ws = quantize_sym(w.detach().permute(0, 2, 3, 1), dim=(1, 2, 3))
        # a copy: .float() of an f32 parameter (the residual conv's bias) is
        # the parameter itself, which a later cast of the model would change
        return cls(wq.contiguous(), ws.reshape(-1).contiguous(),
                   shift.detach().to(torch.float32, copy=True).contiguous(), stride, pad)


def out_size(H: int, W: int, kh: int, kw: int, stride: int,
             pad: Tuple[int, int, int, int]) -> Tuple[int, int]:
    return (H + pad[0] + pad[1] - kh) // stride + 1, (W + pad[2] + pad[3] - kw) // stride + 1


# ---------------------------------------------------------------- plain versions

def act_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the tensor, as a [1] f32 tensor."""
    return x.float().abs().amax().reshape(1)


def act_quantize_plain(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    return quantize_to(x, act_scale(amax.reshape(())))


def conv_acc_plain(xq: torch.Tensor, w: Int8Weights) -> torch.Tensor:
    """The int32 accumulator [F, Ho, Wo, Cout] of the int8 convolution, in
    float64 (exact: |acc| <= K 127^2 < 2^53)."""
    pt, pb, pl, pr = w.pad
    xd = F.pad(xq.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    wd = w.wq.permute(0, 3, 1, 2).double()
    if xd.is_cuda:
        # PyTorch's own im2col + GEMM: f64 products and sums, exact here
        with torch.backends.cudnn.flags(enabled=False):
            acc = F.conv2d(xd, wd, stride=w.stride)
    else:
        acc = F.conv2d(xd, wd, stride=w.stride)
    return acc.to(torch.int32).permute(0, 2, 3, 1)


def int8_conv_plain(xq: torch.Tensor, w: Int8Weights, amax: torch.Tensor, relu: bool,
                    dtype: torch.dtype) -> torch.Tensor:
    """NHWC int8 xq [F, H, W, Cin] -> [F, Ho, Wo, Cout] in ``dtype``: the
    integer convolution (``conv_acc_plain``), then acc * (xs * ws) + shift
    in f32, ReLU, the cast (layers.py:256-270, :329-330)."""
    out = conv_acc_plain(xq, w).float() * (act_scale(amax.reshape(())) * w.ws)
    out = out + w.shift
    if relu:
        out = torch.relu(out)
    return out.to(dtype).contiguous()


# ---------------------------------------------------------------- CUDA kernels

def _lib():
    lib = build.library("int8_conv")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.k7_int8_conv.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i,
                                     i, p]
        lib.k7_int8_conv.restype = i
        lib.k8_amax.argtypes = [i, p, i64, p, p]
        lib.k8_amax.restype = i
        lib.k8_quantize.argtypes = [i, p, i64, p, p, p]
        lib.k8_quantize.restype = i
        lib.k7_error_string.argtypes = [i]
        lib.k7_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_act(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty contiguous f32/bf16 tensor")


def _check_amax(name: str, amax: torch.Tensor, x: torch.Tensor) -> None:
    if amax.dtype != torch.float32 or amax.numel() != 1 or amax.device != x.device:
        raise ValueError(f"{name}: amax must be one f32 on x's device")


def act_amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the whole tensor as a [1] f32 tensor on x's device. A CPU
    tensor takes the plain version; a CUDA one launches K8's first kernel
    (the scalar zeroed in the stream, then the reduction) or raises."""
    _check_act("act_amax", x)
    if not _on_cuda("act_amax", x):
        return act_amax_plain(x)
    _no_autograd("act_amax", x)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    lib = _lib()
    build.check(lib.k8_amax(_DTYPES[x.dtype], x.data_ptr(), x.numel(), out.data_ptr(),
                            _stream(x)), lib.k7_error_string, "k8_amax")
    act_amax.launches += 1
    return out


act_amax.launches = 0


def act_quantize(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """x quantised to int8 (same shape) at scale max(amax, 1e-12) / 127, the
    scale read from the device scalar ``amax``: K8's second kernel on a
    CUDA tensor, the plain version on a CPU one."""
    _check_act("act_quantize", x)
    _check_amax("act_quantize", amax, x)
    if not _on_cuda("act_quantize", x, amax):
        return act_quantize_plain(x, amax)
    _no_autograd("act_quantize", x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _lib()
    build.check(lib.k8_quantize(_DTYPES[x.dtype], x.data_ptr(), x.numel(), amax.data_ptr(),
                                q.data_ptr(), _stream(x)), lib.k7_error_string, "k8_quantize")
    act_quantize.launches += 1
    return q


act_quantize.launches = 0


def check_conv(xq: torch.Tensor, w: Int8Weights, amax: torch.Tensor, dtype: torch.dtype,
               kernel: bool) -> Tuple[int, int]:
    """Raise for operands that do not fit, and (``kernel``) for a conv K7
    does not take; returns (Ho, Wo). K7 takes NHWC int8 activations with
    Cin a multiple of 16 or at most 4 (the RGB stem), kernel sides 1 to 7,
    stride 1 or 2, padding below the kernel side, and f32 or bf16 output:
    every IRv2 conv. The plain version takes any conv."""
    if xq.dtype != torch.int8 or xq.dim() != 4 or not xq.is_contiguous():
        raise ValueError("int8_conv: xq must be a contiguous [F, H, W, Cin] int8 tensor")
    cout, kh, kw, cin = w.wq.shape
    if (w.wq.dtype != torch.int8 or not w.wq.is_contiguous() or w.ws.shape != (cout,)
            or w.shift.shape != (cout,) or w.ws.dtype != torch.float32
            or w.shift.dtype != torch.float32):
        raise ValueError("int8_conv: weights must be contiguous int8 [Cout, KH, KW, Cin] "
                         "with f32 [Cout] scales and shift")
    if dtype not in _DTYPES:
        raise ValueError(f"int8_conv: output dtype {dtype} (f32 or bf16)")
    Fn, H, W, C = xq.shape
    if C != cin:
        raise ValueError(f"int8_conv: x has {C} channels, the weights {cin}")
    _check_amax("int8_conv", amax, xq)
    Ho, Wo = out_size(H, W, kh, kw, w.stride, w.pad)
    if Ho < 1 or Wo < 1 or min(w.pad) < 0 or w.stride < 1:
        raise ValueError(f"int8_conv: {kh}x{kw} stride {w.stride} pad {w.pad} on {H}x{W}")
    if kernel and (not (cin % 16 == 0 or cin <= 4) or not 1 <= kh <= MAX_KERNEL
            or not 1 <= kw <= MAX_KERNEL or w.stride not in (1, 2)
            or max(w.pad[:2]) >= kh or max(w.pad[2:]) >= kw):
        raise ValueError(
            f"int8_conv: unsupported conv: {kh}x{kw} stride {w.stride} pad {w.pad}, "
            f"Cin {cin} (a multiple of 16 or <= 4) on a {H}x{W} frame")
    return Ho, Wo


def int8_conv(xq: torch.Tensor, w: Int8Weights, amax: torch.Tensor, relu: bool,
              dtype: torch.dtype) -> torch.Tensor:
    """The int8 convolution of NHWC ``xq`` [F, H, W, Cin] with ``w``, its
    epilogue acc * (scale(amax) * ws) + shift [, ReLU] cast to ``dtype``:
    [F, Ho, Wo, Cout]. K7 on a CUDA tensor (raises for a shape it does not
    take), the plain version on a CPU one."""
    on_cuda = _on_cuda("int8_conv", xq, w.wq, w.ws, w.shift, amax)
    Ho, Wo = check_conv(xq, w, amax, dtype, kernel=on_cuda)
    for calls in _RECORDING:
        calls.append((xq, w, amax, relu, dtype))
    if not on_cuda:
        return int8_conv_plain(xq, w, amax, relu, dtype)
    Fn, H, W, C = xq.shape
    cout, kh, kw, _ = w.wq.shape
    out = torch.empty(Fn, Ho, Wo, cout, dtype=dtype, device=xq.device)
    lib = _lib()
    build.check(lib.k7_int8_conv(
        xq.data_ptr(), w.wq.data_ptr(), amax.data_ptr(), w.ws.data_ptr(), w.shift.data_ptr(),
        out.data_ptr(), _DTYPES[dtype], Fn, H, W, C, cout, kh, kw, w.stride, w.pad[0],
        w.pad[2], Ho, Wo, int(relu), _stream(xq)), lib.k7_error_string, "k7_int8_conv")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


# the lists that recorded_convs() fills, innermost last
_RECORDING: list = []


@contextlib.contextmanager
def recorded_convs():
    """While it runs, every ``int8_conv`` call is kept in the yielded list as
    (xq, w, amax, relu, dtype) (and still made): a model's int8 convs at the
    shapes its path gives them, for checks and timing conv by conv."""
    calls: list = []
    _RECORDING.append(calls)
    try:
        yield calls
    finally:
        _RECORDING.remove(calls)


def conv_key(xq: torch.Tensor, w: Int8Weights, relu: bool) -> Tuple:
    """A conv's shape: input [F, H, W, Cin], weights [Cout, KH, KW, Cin],
    stride, padding and ReLU."""
    return tuple(xq.shape), tuple(w.wq.shape), w.stride, w.pad, relu


def quantized_conv(x: torch.Tensor, w: Int8Weights, amax: Optional[torch.Tensor], relu: bool,
                   group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One int8 conv of NHWC ``x`` (f32/bf16), the output in x's type:
    ``amax`` the calibrated scalar (static mode), or None for this batch's
    (``act_amax``; with ``group``, its max over that process group: a
    batch split over a mesh's data axis takes the global batch's, as JAX's
    per-tensor max under GSPMD). Returns (the output, the amax used)."""
    if amax is None:
        amax = act_amax(x)
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return int8_conv(act_quantize(x, amax), w, amax, relu, x.dtype), amax
