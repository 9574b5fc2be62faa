"""int8 convolutions of the IRv2 trunk at serving: kernels K7 and K8.

Counterpart of the int8 branch of deepfake_tpu/models/layers.py
(``quantize_sym`` :187, ``int8_shape_allowed`` :198, ``act_scale_for``'s
scale rule :224, ``quantize_to`` :249, ``quant_conv`` :256), which the JAX
package leaves to XLA's int8 convolution. Here, in ``csrc/int8_conv.cu``:

* K8, two launches: ``act_amax`` (the per-tensor max |x| into a device
  scalar) and ``act_quantize`` (x to int8 at scale max(amax, 1e-12) / 127,
  the scale computed on the device from the scalar; static mode skips
  ``act_amax`` and passes the calibrated scalar); each a persistent stream
  over the tensor sized to the SMs;
* K7, ``int8_conv``: the int8 x int8 -> int32 implicit-GEMM convolution of
  NHWC activations and [Cout, KH, KW, Cin] weights, dequantised by
  ``amax``'s scale times the per-output-channel weight scale, plus a
  per-channel shift (the folded BatchNorm, or the conv bias), ReLU
  optional, cast to the output type; with ``out_amax`` also the max |out|
  of the values it stores, reduced in its epilogue, so that an int8
  consumer of its output skips ``act_amax``. ``plan`` lays each conv out for it
  on the host: s8 wgmma fed by TMA in column tiles (``n_tile``), row
  tiles (``row_box``) and channel chunks (``chunk_width``), or, at Cin = 3
  (the RGB stem), s8 wgmma on tiles the block gathers itself;
  ``tensor_maps`` describes the TMA boxes the kernel encodes from the
  plan.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises; ``.launches`` counts its launches. The
plain versions compute what the kernels compute, in the same order of
roundings, so the two agree to the bit: the quantisation divides (as
layers.py:251-253, never by a reciprocal) and rounds half to even; the
convolution is exact in float64 (|acc| <= K 127^2 < 2^53); the epilogue is
f32 ``acc * (xs * ws) + shift``, one rounding an operation. It is never an
int8 ``F.conv2d``, which wraps.

In dynamic mode ``quantized_conv`` takes what its caller already knows of
its input (``QInput``: the max from the producer's epilogue, or max and
int8 copy made once for a tensor several convs read, ``quantize_input``),
so that each distinct activation is reduced and quantised once a forward;
``per_conv_quantization`` restores one ``act_amax`` and one
``act_quantize`` a conv (the same kernels, composed as the first design
did; the same bits), for comparison.

``int8_shape_allowed`` is the scope gate (``DEEPFAKE_TPU_INT8_SCOPE``):
``all`` (the default on the card: the TPU default ``pointwise`` came from
an XLA:TPU hang that does not apply here), ``wide`` or ``pointwise``; any
other value raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
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

def _abs_max(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax().reshape(1)


def act_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the tensor, as a [1] f32 tensor."""
    return _abs_max(x)


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
                    dtype: torch.dtype, out_amax: bool = False):
    """NHWC int8 xq [F, H, W, Cin] -> [F, Ho, Wo, Cout] in ``dtype``: the
    integer convolution (``conv_acc_plain``), then acc * (xs * ws) + shift
    in f32, ReLU, the cast (layers.py:256-270, :329-330); with ``out_amax``
    (out, max |out| of the cast output as a [1] f32 tensor)."""
    out = conv_acc_plain(xq, w).float() * (act_scale(amax.reshape(())) * w.ws)
    out = out + w.shift
    if relu:
        out = torch.relu(out)
    out = out.to(dtype).contiguous()
    return (out, _abs_max(out)) if out_amax else out


# ---------------------------------------------------------------- K7 planning

# the column tile widths K7's Hopper route is built for (csrc/wgmma_ss.cuh's
# WgmmaS8): s8 wgmma takes N of 8, 16, 24 and the multiples of 16 up to 256;
# none above 224, K1's widest, beside a producer warp
N_TILES = (32, 48, 64, 80, 96, 128, 144, 160, 192, 208, 224)
TILE_ROWS = 128    # rows of a row tile: two wgmma M of 64
STAGE_BYTES = 128  # bytes of K a ring stage: four k32 steps
CHUNKS = (128, 64, 32)  # channel chunk widths (bytes), each swizzled at its width
TMA_BOX_MAX = 256  # the most elements a TMA box spans in one dimension
RGB_K, RGB_BN = 32, 64  # the RGB route: K <= one k32 step; its widest column tile


@dataclass(frozen=True)
class ConvPlan:
    """How K7 lays out one conv: ``kc`` the channel chunk in bytes (0: Cin
    is not a multiple of 16, and ``rgb`` says whether the RGB route takes
    it, in segments of ``box`` = (1, 1, bw) output pixels, or the byte
    route), ``bn`` the column tile, ``flat`` whether the rows are read flat
    (a 1x1 conv at stride 1, 128 rows a tile), else ``box`` = (bf, bh, bw),
    a row tile's output pixels; ``wide`` whether A comes through the
    wide-row map (an output pixel's KW taps of one kernel row are KW Cin
    contiguous bytes of an input row, one box row of 128-byte chunks,
    where the map's W step, stride Cin bytes, makes neighbouring rows
    overlap; ``box`` then covers the columns inside the frame), else one
    box a tap; ``border`` = (pl, pr), the border columns a wide-row stride-1
    conv reads a box a tap, in boxes of ``border_box`` = (bf, bh) of one
    column; ``halo``: the wide rows' box is bh + KH - 1 rows of bw (a
    multiple of 8) columns of one frame, whose KH taps along H read its
    rows from ky bw on (one load for all of them)."""

    kc: int
    bn: int
    flat: bool
    box: Tuple[int, int, int]
    wide: bool = False
    rgb: bool = False
    border: Tuple[int, int] = (0, 0)
    border_box: Tuple[int, int] = (1, 1)
    halo: bool = False


def column_parts(w_shape, stride: int, pad, W: int, Wo: int) -> Tuple[bool, int, int]:
    """(wide, pl, pr): whether K7 can read a conv's A through the wide-row
    map (csrc/int8_conv.cu checks the same: a tap conv with KW > 1, unpadded
    along W, or at stride 1 with a column whose receptive field lies inside
    the frame), and then the border columns left and right (a stride-1
    conv's padding along W), which it reads a box a tap."""
    _, kh, kw, _ = w_shape
    if (kh == kw == 1 and stride == 1) or kw == 1:
        return False, 0, 0
    if pad[2] == 0 and (Wo - 1) * stride + kw <= W:
        return True, 0, 0
    pr = Wo - 1 + kw - W - pad[2]
    if stride == 1 and Wo - pad[2] - pr >= 1:
        return True, pad[2], pr
    return False, 0, 0


def stages(cin: int, taps: int, kc: int) -> int:
    """Ring stages of 128 bytes a unit takes: taps of cin channels in chunks
    of kc bytes."""
    return -(-taps * -(-cin // kc) // (STAGE_BYTES // kc))


# the relative time of a ring stage by its chunk width: the TMA rows it loads
# (128 / kc boxes) take about 4 cycles for a row of 32 bytes and 8 for one of
# 128 on the H100 (PERF.md, K7's redesign)
STAGE_COST = {128: 8, 64: 11, 32: 16}


def k_cost(cin: int, taps: int, kc: int) -> int:
    return stages(cin, taps, kc) * STAGE_COST[kc]


def _two_stages_fit(stage_bytes: int, bn: int) -> bool:
    """Whether a block's shared memory holds a ring of two such stages beside
    the rest (csrc/int8_conv.cu::fixed_smem: alignment, the epilogue's
    staging, xs ws and shift, the row table, barriers; SMEM_MAX)."""
    fixed = 1024 + 2 * 64 * (bn + 8) * 2 + 2 * max(N_TILES) * 4 + TILE_ROWS * 4 + 16 * 8
    return 2 * -(-stage_bytes // 1024) * 1024 + fixed <= 232448


def halo_box(frames: int, ho: int, cols: int, kh: int, tc: int, bn: int):
    """The wide rows' halo box (1, bh, bw), bw a multiple of 8, bh bw <= 128,
    that loads the fewest rows of 128 bytes for the conv's ``cols`` columns
    (each unit: ceil(tc / 128) stages of (bh + kh - 1) bw rows of A and kh bn
    of W), with that count; None where no box fits a ring of two stages."""
    best = None
    for bw in range(8, TILE_ROWS + 1, 8):
        for bh in range(1, min(ho, TILE_ROWS // bw) + 1):
            if not _two_stages_fit((TILE_ROWS + (kh - 1) * bw + kh * bn) * 128, bn):
                continue
            units = frames * -(-ho // bh) * -(-cols // bw)
            rows = units * -(-tc // 128) * ((bh + kh - 1) * bw + kh * bn)
            if best is None or rows < best[0]:
                best = (rows, (1, bh, bw))
    return best


@functools.lru_cache(maxsize=None)
def n_tile(n: int) -> int:
    """The column tile of a conv with n outputs: the least built width >= n
    up to the widest, else the widest built width that splits n into
    equal tiles with one tile more than the fewest at most (256 = 2 x 128,
    288 = 2 x 144, 1536 = 8 x 192, 2080 = 10 x 208), else the width of the
    fewest tiles that pads n the least (1088 in 5 of 224)."""
    widest = max(N_TILES)
    if n <= widest:
        return min(w for w in N_TILES if w >= n)
    fewest = -(-n // widest)
    for count in (fewest, fewest + 1):
        if n % count == 0 and n // count in N_TILES:
            return n // count
    return min(N_TILES, key=lambda w: (-(-n // w), -(-n // w) * w))


@functools.lru_cache(maxsize=None)
def chunk_width(cin: int, taps: int) -> int:
    """The channel chunk (bytes) of the least ``k_cost``, the widest of those:
    32 for the 3x3s of 96 channels (27 chunks in 7 stages), 128 from 128
    channels up."""
    return min(CHUNKS, key=lambda kc: (k_cost(cin, taps, kc), -kc))


@functools.lru_cache(maxsize=None)
def row_box(frames: int, ho: int, wo: int) -> Tuple[int, int, int]:
    """A row tile's box of output pixels (bf, bh, bw), bf bh bw <= 128:
    whole output rows (a row wider than 128 in equal parts); of the boxes
    of bh rows of bf frames, the one that needs the fewest tiles (K1's
    rule, ops/inception_block.py::row_tile)."""
    bw = -(-wo // -(-wo // TILE_ROWS))
    best = None
    for bh in range(1, min(ho, TILE_ROWS // bw) + 1):
        bf = min(frames, TILE_ROWS // (bw * bh))
        tiles = -(-frames // bf) * -(-ho // bh) * -(-wo // bw)
        if best is None or tiles < best[0]:
            best = (tiles, (bf, bh, bw))
    return best[1]


@functools.lru_cache(maxsize=None)
def plan(x_shape: Tuple[int, int, int, int], w_shape: Tuple[int, int, int, int], stride: int,
         pad: Tuple[int, int, int, int]) -> ConvPlan:
    """K7's layout of a conv of NHWC input ``x_shape`` and [Cout, KH, KW,
    Cin] weights ``w_shape`` (shapes ``check_conv`` takes)."""
    Fn, H, W, cin = x_shape
    cout, kh, kw, _ = w_shape
    flat = kh == kw == 1 and stride == 1
    Ho, Wo = out_size(H, W, kh, kw, stride, pad)
    if cin % 16:
        if cin <= 4 and kh * kw * cin <= RGB_K:  # csrc/int8_conv.cu takes it the same
            bn = n_tile(cout) if cout <= RGB_BN else RGB_BN
            return ConvPlan(0, bn, False, (1, 1, -(-Wo // -(-Wo // TILE_ROWS))), rgb=True)
        return ConvPlan(0, 64, flat, (1, 1, TILE_ROWS))
    wide, pl, pr = column_parts(w_shape, stride, pad, W, Wo)
    kc = chunk_width(cin, kh * kw)
    # the wide rows where they cost less, their border columns a box a tap
    if wide and (k_cost(kw * cin, kh, 128) * (Wo - pl - pr) + k_cost(cin, kh * kw, 128) * (pl + pr)
                 < k_cost(cin, kh * kw, kc) * Wo):
        kc, bn, cols = max(CHUNKS), n_tile(cout), Wo - pl - pr
        border = dict(border=(pl, pr), border_box=row_box(Fn, Ho, 1)[:2]) if pl + pr else {}
        box = row_box(Fn, Ho, cols)
        # the halo where it loads fewer rows (stride 1: a tap along H is a row)
        halo = halo_box(Fn, Ho, cols, kh, kw * cin, bn) if stride == 1 and kh > 1 else None
        units = -(-Fn // box[0]) * -(-Ho // box[1]) * -(-cols // box[2])
        if halo and halo[0] < units * kh * -(-kw * cin // 128) * (math.prod(box) + bn):
            return ConvPlan(kc, bn, False, halo[1], True, halo=True, **border)
        return ConvPlan(kc, bn, False, box, True, **border)
    box = (1, 1, TILE_ROWS) if flat else row_box(Fn, Ho, Wo)
    return ConvPlan(kc, n_tile(cout), flat, box)


def tensor_maps(x_shape, w_shape, stride: int, pad, p: ConvPlan) -> dict:
    """The TMA maps K7 encodes for a plan (csrc/int8_conv.cu::k7_int8_conv),
    each {"dims", "strides" (bytes, of dims 1 on), "box", "elem"
    (traversal strides)}, innermost first: "a" the activations (flat rows
    [M, Cin]; (Cin, W, H, F) with the conv's stride in W and H; or wide
    rows (KW Cin, (W - KW) / stride + 1, H, F), the W step stride Cin
    bytes), "a2" the border columns' (Cin, W, H, F) where the plan has
    them, "w" the weights [Cout, K]; int8 elements."""
    Fn, H, W, cin = x_shape
    cout, kh, kw, _ = w_shape
    K = kh * kw * cin
    bf, bh, bw = p.box
    maps = dict(w=dict(dims=(K, cout), strides=(K,), box=(p.kc, p.bn), elem=(1, 1)))
    by_tap = lambda bf, bh, bw: dict(dims=(cin, W, H, Fn), strides=(cin, cin * W, cin * W * H),
                                     box=(p.kc, bw * stride, bh * stride, bf),
                                     elem=(1, stride, stride, 1))
    if p.flat:
        maps["a"] = dict(dims=(cin, Fn * H * W), strides=(cin,), box=(p.kc, TILE_ROWS),
                         elem=(1, 1))
    elif p.wide:
        rows = bh + kh - 1 if p.halo else bh * stride
        maps["a"] = dict(dims=(kw * cin, (W - kw) // stride + 1, H, Fn),
                         strides=(stride * cin, cin * W, cin * W * H),
                         box=(p.kc, bw, rows, bf), elem=(1, 1, stride, 1))
        if sum(p.border):
            maps["a2"] = by_tap(*p.border_box, 1)
    else:
        maps["a"] = by_tap(bf, bh, bw)
    return maps


# ---------------------------------------------------------------- CUDA kernels

def _lib():
    return bind(build.library("int8_conv"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded K7/K8 library."""
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.k7_int8_conv.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i,
                                     i, i, i, i, i, i, i, i, i, i, p, p]
        lib.k7_int8_conv.restype = i
        lib.k8_amax.argtypes = [i, p, i64, p, i, p]
        lib.k8_amax.restype = i
        lib.k8_quantize.argtypes = [i, p, i64, p, p, i, p]
        lib.k8_quantize.restype = i
        lib.k7_error_string.argtypes = [i]
        lib.k7_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(x: torch.Tensor) -> int:
    return _sm_count(x.device.index if x.device.index is not None
                     else torch.cuda.current_device())


def _check_act(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty contiguous f32/bf16 tensor")


def _check_amax(name: str, amax: torch.Tensor, x: torch.Tensor) -> None:
    if amax.dtype != torch.float32 or amax.numel() != 1 or amax.device != x.device:
        raise ValueError(f"{name}: amax must be one f32 on x's device")


def act_amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the whole tensor as a [1] f32 tensor on x's device. A CPU
    tensor takes the plain version; a CUDA one launches K8's first kernel
    (one launch: the last block writes the scalar) or raises."""
    _check_act("act_amax", x)
    if not _on_cuda("act_amax", x):
        return act_amax_plain(x)
    _no_autograd("act_amax", x)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    lib = _lib()
    build.check(lib.k8_amax(_DTYPES[x.dtype], x.data_ptr(), x.numel(), out.data_ptr(), _sms(x),
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
                                q.data_ptr(), _sms(x), _stream(x)), lib.k7_error_string,
                "k8_quantize")
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
              dtype: torch.dtype, out_amax: bool = False):
    """The int8 convolution of NHWC ``xq`` [F, H, W, Cin] with ``w``, its
    epilogue acc * (scale(amax) * ws) + shift [, ReLU] cast to ``dtype``:
    [F, Ho, Wo, Cout]; with ``out_amax`` (out, max |out| as a [1] f32
    tensor, reduced in K7's epilogue). K7 on a CUDA tensor (raises for a
    shape it does not take), the plain version on a CPU one."""
    on_cuda = _on_cuda("int8_conv", xq, w.wq, w.ws, w.shift, amax)
    Ho, Wo = check_conv(xq, w, amax, dtype, kernel=on_cuda)
    for calls in _RECORDING:
        calls.append((xq, w, amax, relu, dtype, out_amax))
    if not on_cuda:
        return int8_conv_plain(xq, w, amax, relu, dtype, out_amax)
    Fn, H, W, C = xq.shape
    cout, kh, kw, _ = w.wq.shape
    out = torch.empty(Fn, Ho, Wo, cout, dtype=dtype, device=xq.device)
    o_max = torch.empty(1, dtype=torch.float32, device=xq.device) if out_amax else None
    p = plan(tuple(xq.shape), tuple(w.wq.shape), w.stride, tuple(w.pad))
    # TMA reads from 16-byte aligned addresses; the byte route from any
    kc = p.kc if xq.data_ptr() % 16 == 0 and w.wq.data_ptr() % 16 == 0 else 0
    lib = _lib()
    build.check(lib.k7_int8_conv(
        xq.data_ptr(), w.wq.data_ptr(), amax.data_ptr(), w.ws.data_ptr(), w.shift.data_ptr(),
        out.data_ptr(), _DTYPES[dtype], Fn, H, W, C, cout, kh, kw, w.stride, w.pad[0],
        w.pad[2], Ho, Wo, int(relu), kc, 2 if p.halo else int(p.wide), p.bn, *p.box,
        *p.border_box, _sms(xq), None if o_max is None else o_max.data_ptr(), _stream(xq)),
        lib.k7_error_string, "k7_int8_conv")
    int8_conv.launches += 1
    return (out, o_max) if out_amax else out


int8_conv.launches = 0


# the lists that recorded_convs() fills, innermost last
_RECORDING: list = []


@contextlib.contextmanager
def recorded_convs():
    """While it runs, every ``int8_conv`` call is kept in the yielded list as
    (xq, w, amax, relu, dtype, out_amax) (and still made): a model's int8
    convs at the shapes its path gives them, for checks and timing conv by
    conv."""
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


# the per-conv route's switch (per_conv_quantization)
_PER_CONV = [False]


@contextlib.contextmanager
def per_conv_quantization():
    """While it runs, every dynamic int8 conv takes its input's max and int8
    copy itself (``act_amax``, ``act_quantize``): ``quantize_input`` and
    ``quantized_conv`` ignore what a caller knows and ask K7 for no output
    max. The same kernels composed as the first design did, and the same
    bits; a comparison for the shared route (a CUDA graph captured inside
    it keeps this route)."""
    before = _PER_CONV[0]
    _PER_CONV[0] = True
    try:
        yield
    finally:
        _PER_CONV[0] = before


@dataclass
class QInput:
    """What is known of an activation's int8 form in dynamic mode:
    ``amax``, its max |x| ([1] f32 on x's device; over the mesh's data axis
    where there is one), and ``q``, x quantised at that scale (NHWC int8),
    where it is made."""

    amax: torch.Tensor
    q: Optional[torch.Tensor] = None


def _reduced(amax: torch.Tensor, group) -> torch.Tensor:
    """``amax`` as its max over ``group`` (a batch split over a mesh's data
    axis takes the global batch's, as JAX's per-tensor max under GSPMD)."""
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax


def quantize_input(x: torch.Tensor, group=None) -> Optional[QInput]:
    """An activation that several dynamic int8 convs read, reduced and
    quantised once (NHWC ``x``); None on the per-conv route."""
    if _PER_CONV[0]:
        return None
    amax = _reduced(act_amax(x), group)
    return QInput(amax, act_quantize(x, amax))


def quantized_conv(x: torch.Tensor, w: Int8Weights, amax: Optional[torch.Tensor], relu: bool,
                   group=None, x_q: Optional[QInput] = None, out_amax: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, Optional[QInput]]:
    """One int8 conv of NHWC ``x`` (f32/bf16), the output in x's type:
    ``amax`` the calibrated scalar (static mode), or None for this batch's:
    ``x_q``'s where the caller knows it, else ``act_amax`` (over ``group``),
    and ``x_q.q`` as the int8 input where it is made. ``out_amax`` (dynamic
    consumers of the output): K7 also reduces the output's max. Returns (the
    output, the amax used, the output's ``QInput`` or None)."""
    if _PER_CONV[0]:
        x_q, out_amax = None, False
    xq = None
    if amax is None:
        if x_q is None:
            x_q = QInput(_reduced(act_amax(x), group))
        amax, xq = x_q.amax, x_q.q
    if xq is None:
        xq = act_quantize(x, amax)
    if not out_amax:
        return int8_conv(xq, w, amax, relu, x.dtype), amax, None
    out, o_max = int8_conv(xq, w, amax, relu, x.dtype, out_amax=True)
    return out, amax, QInput(_reduced(o_max, group))
