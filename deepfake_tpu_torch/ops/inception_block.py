"""Inception-ResNet-v2 residual block (A, B or C) at inference: kernel K1.

Counterpart of deepfake_tpu/ops/pallas_inception.py (fused_inception_block_a
:229, fused_inception_block :149, fold_bn :249). One block is

    x -> 1x1 convs of every branch at once (folded BN, ReLU)
      -> each branch's chain of tap convs (1xK, Kx1 or KxK; folded BN, ReLU)
      -> concat -> plain biased 1x1 -> out = x + T(res_scale * res) [-> ReLU]

on flat frame-major rows ``[frames * H * W, C]`` (NHWC). ``BlockWeights``
holds one block's weights folded and laid out for the kernel;
``inception_block`` runs it: on a CPU tensor through the plain version
(``inception_block_plain``), on a CUDA tensor through the CUDA kernel in
``csrc/inception_block.cu`` (one shifted-GEMM launch per conv; f32 on SIMT
FMAs, bf16 on Hopper's wgmma with TMA loads) and nowhere else.
Intermediates are stored in the input type between launches, which is where
the Pallas kernel casts them (``.astype(d)`` before each dot).

The bf16 launches are planned here: ``n_tile`` gives a conv's column tile,
``row_tile`` the box of output pixels a row tile covers (the frame halo of
a tap comes from the tensor map's zero fill, so a tile is whole rows of
pixels of one or more frames).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from deepfake_tpu_torch.kernels import build


@dataclass
class TapConv:
    """One conv of a branch chain: taps ``[kh * kw, cin, cout]`` in (ky, kx)
    row-major order, folded BN ``affine [2, cout]`` (f32, row 0 scale)."""

    w: torch.Tensor
    affine: torch.Tensor
    kh: int
    kw: int
    # the bf16 kernel's K-major copy of w, [kh * kw * cout, cin]: made at
    # the first bf16 launch on the card
    w_kmajor: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)


@dataclass
class BlockWeights:
    """One residual block, folded for inference.

    ``w_in [C, n_in]``/``a_in [2, n_in]``: every branch's first 1x1 conv side
    by side; the first ``n_direct`` columns are the 1x1 branch that goes
    straight to the concat, the rest feed ``chains`` in order (each chain
    takes as many columns as its first conv's ``cin``). ``w_out [n_cat, C]``
    and ``b_out [C]`` (f32) are the final plain 1x1 conv over the concat
    ``[direct | chain outputs...]``."""

    w_in: torch.Tensor
    a_in: torch.Tensor
    n_direct: int
    chains: List[List[TapConv]]
    w_out: torch.Tensor
    b_out: torch.Tensor
    res_scale: float
    relu: bool
    # K-major copies of w_in and w_out for the bf16 kernel (as TapConv's)
    w_in_kmajor: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)
    w_out_kmajor: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)


def fold_bn(scale, bias, mean, var, eps: float) -> torch.Tensor:
    """BatchNorm running stats -> affine [2, cout] f32 with
    ``affine[0] * y + affine[1] == bn(y)`` at inference
    (pallas_inception.py:249-257)."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return torch.stack([s, bias.float() - mean.float() * s])


# ---------------------------------------------------------------- plain version

def _taps_plain(h: torch.Tensor, w: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """sum over taps of the zero-padded shifted frame times that tap's
    weights; h [F, H, W, cin] f32, w [kh * kw, cin, cout] f32."""
    _, H, W, _ = h.shape
    ph, pw = kh // 2, kw // 2
    hp = F.pad(h, (0, 0, pw, pw, ph, ph))
    acc = None
    for t in range(kh * kw):
        dy, dx = divmod(t, kw)
        term = hp[:, dy:dy + H, dx:dx + W, :] @ w[t]
        acc = term if acc is None else acc + term
    return acc


def inception_block_plain(x: torch.Tensor, blk: BlockWeights) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 arithmetic, with the
    stored intermediates rounded to ``x.dtype`` where the kernel stores them.
    x [F, H, W, C] -> same shape and type."""
    d, f32 = x.dtype, torch.float32
    stored = lambda t: t.to(d).to(f32)
    affine_relu = lambda t, a: torch.relu(t * a[0] + a[1])
    h = stored(affine_relu(x.float() @ blk.w_in.float(), blk.a_in))
    parts = [h[..., :blk.n_direct]]
    col = blk.n_direct
    for chain in blk.chains:
        cin = chain[0].w.shape[1]
        t = h[..., col:col + cin]
        col += cin
        for conv in chain:
            t = stored(affine_relu(_taps_plain(t, conv.w.float(), conv.kh, conv.kw), conv.affine))
        parts.append(t)
    res = torch.cat(parts, dim=-1) @ blk.w_out.float() + blk.b_out
    out = x.float() + stored(blk.res_scale * res)
    if blk.relu:
        out = torch.relu(out)
    return out.to(d)


# ---------------------------------------------------------------- bf16 planning

# the column tile widths the bf16 kernel is built for (csrc/wgmma_ss.cuh);
# none above 224: a thread holds BN / 2 accumulators, and beside a producer
# warp ptxas gives it at most 168 registers (at 256 it spilled)
N_TILES = (16, 32, 48, 64, 96, 128, 136, 160, 192, 208, 224)
TILE_ROWS = 128  # rows of a row tile: two wgmma M of 64


@functools.lru_cache(maxsize=None)
def n_tile(n: int, widest: int = max(N_TILES)) -> int:
    """The column tile of a conv with n outputs: n itself up to ``widest``
    (the least built width >= n where n is not one), else the widest built
    width that splits n into equal tiles (256 = 2 x 128, 320 = 2 x 160, 1088
    = 8 x 136, 2080 = 10 x 208), else the widest built width with a ragged
    last tile."""
    if n <= widest:
        return min(w for w in N_TILES if w >= n)
    for count in range(-(-n // widest), n // 8 + 1):
        if n % count == 0 and n // count in N_TILES and n // count <= widest:
            return n // count
    return max(w for w in N_TILES if w <= widest)


@functools.lru_cache(maxsize=None)
def row_tile(frames: int, h: int, w: int, kh: int, kw: int):
    """(geometry, box) of a conv's row tiles: the rows are read as
    ``geometry`` = (frames, rows, columns) of pixels, a tile is a ``box`` =
    (bf, bh, bw) of them, bf bh bw <= 128. A 1 x 1 conv reads its rows flat
    (1, 1, R) in tiles of 128; a tap conv reads whole frames in tiles of
    whole pixel rows (a row wider than 128 in equal parts), and of the boxes
    of bh rows of bf frames it takes the one that needs the fewest tiles
    (the most rows of work used)."""
    if kh == 1 and kw == 1:
        rows = frames * h * w
        return (1, 1, rows), (1, 1, min(TILE_ROWS, rows))
    bw = -(-w // -(-w // TILE_ROWS))  # whole rows, or a row in equal parts above 128
    best = None
    for bh in range(1, min(h, TILE_ROWS // bw) + 1):
        bf = min(frames, TILE_ROWS // (bw * bh))
        tiles = -(-frames // bf) * -(-h // bh) * -(-w // bw)
        if best is None or tiles < best[0]:
            best = (tiles, (bf, bh, bw))
    return (frames, h, w), best[1]


# ---------------------------------------------------------------- CUDA kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    return bind(build.library("inception_block"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded K1 library."""
    if not getattr(lib, "_typed", False):
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.k1_shifted_gemm.argtypes = [
            i, p, i64, i, p, i, i, i, i, i, i, i, p, p, p, i64, f, i, p, i64, i, p, i64, p]
        lib.k1_shifted_gemm.restype = i
        lib.k1_conv_bf16.argtypes = [
            p, i64, i, p, i, i, i, i, i, i, i, i, i, i, i, i, p, p, p, i64, f, i, p, i64, i, p,
            i64, p]
        lib.k1_conv_bf16.restype = i
        lib.k1_error_string.argtypes = [i]
        lib.k1_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t: torch.Tensor, col: int = 0) -> int:
    return t.data_ptr() + col * t.element_size()


def _kmajor(w: torch.Tensor) -> torch.Tensor:
    """[taps, cin, cout] -> [taps * cout, cin]: the layout the bf16 kernel's
    weight tiles are loaded from."""
    taps, cin, cout = w.shape
    return w.transpose(1, 2).reshape(taps * cout, cin).contiguous()


def _launch(lib, stream, dt, a, a_col, k, w, kh, kw, rows, hw: Tuple[int, int], n, *,
            w_kmajor=None, affine=None, bias=None, x=None, res_scale=0.0, relu=False,
            out0, out0_col=0, nsplit=None, out1=None):
    """One shifted-GEMM launch. ``a``/``out*`` are 2-D row-major buffers
    read or written from column ``*_col``; the row stride is their width.
    ``w_kmajor``: the bf16 kernel's copy of ``w`` (``_kmajor``)."""
    mode = 0 if affine is not None else 1
    nsplit = n if nsplit is None else nsplit
    if dt == _DTYPES[torch.bfloat16]:
        if (k % 8 or n % 8 or a.shape[1] % 8 or _ptr(a, a_col) % 16 or w.data_ptr() % 16
                or out0.shape[1] % 8 or _ptr(out0, out0_col) % 16 or (nsplit < n and nsplit % 8)):
            # TMA reads rows in 16-byte runs; the epilogue writes 8 columns at once
            raise ValueError(f"inception_block (bf16): k={k}, n={n}, the row width "
                             f"{a.shape[1]} and the column offset {a_col} must be multiples of 8")
        geom, box = row_tile(rows // (hw[0] * hw[1]), hw[0], hw[1], kh, kw)
        wt = _kmajor(w) if w_kmajor is None else w_kmajor
        index = a.device.index if a.device.index is not None else torch.cuda.current_device()
        status = lib.k1_conv_bf16(
            _ptr(a, a_col), a.shape[1], k, wt.data_ptr(), kh, kw, *geom, *box, n, n_tile(n),
            _sm_count(index), mode, affine[0].data_ptr() if mode == 0 else None,
            affine[1].data_ptr() if mode == 0 else bias.data_ptr(),
            x.data_ptr() if x is not None else None, x.shape[-1] if x is not None else 0,
            float(res_scale), int(relu), _ptr(out0, out0_col), out0.shape[1], nsplit,
            out1.data_ptr() if out1 is not None else None,
            out1.shape[1] if out1 is not None else 0, stream)
        build.check(status, lib.k1_error_string, "k1_conv_bf16")
        return
    status = lib.k1_shifted_gemm(
        dt, _ptr(a, a_col), a.shape[1], k, w.data_ptr(), kh, kw, rows, hw[0], hw[1], n, mode,
        affine[0].data_ptr() if mode == 0 else None,
        affine[1].data_ptr() if mode == 0 else bias.data_ptr(),
        x.data_ptr() if x is not None else None, x.shape[-1] if x is not None else 0,
        float(res_scale), int(relu),
        _ptr(out0, out0_col), out0.shape[1], nsplit,
        out1.data_ptr() if out1 is not None else None, out1.shape[1] if out1 is not None else 0,
        stream)
    build.check(status, lib.k1_error_string, "k1_shifted_gemm")


def _kmajor_weights(blk: BlockWeights) -> None:
    """Make the bf16 kernel's K-major weight copies once per BlockWeights."""
    if blk.w_in_kmajor is None:
        blk.w_in_kmajor = _kmajor(blk.w_in[None])
        blk.w_out_kmajor = _kmajor(blk.w_out[None])
    for chain in blk.chains:
        for conv in chain:
            if conv.w_kmajor is None:
                conv.w_kmajor = _kmajor(conv.w)


def _check_weights(blk: BlockWeights, x: torch.Tensor) -> None:
    C = x.shape[-1]
    tensors = [blk.w_in, blk.w_out] + [c.w for ch in blk.chains for c in ch]
    f32s = [blk.a_in, blk.b_out] + [c.affine for ch in blk.chains for c in ch]
    for t in tensors:
        if t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError("block weights must be contiguous, in x's dtype and on its device")
    for t in f32s:
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError("block affines and bias must be contiguous f32 on x's device")
    if blk.w_in.shape[0] != C or blk.w_out.shape[1] != C or blk.b_out.shape != (C,):
        raise ValueError(f"block weights do not match C={C}")


def inception_block(x: torch.Tensor, blk: BlockWeights) -> torch.Tensor:
    """One residual block on NHWC frames x [F, H, W, C] -> same shape.

    A CPU tensor takes the plain version; a CUDA tensor launches K1 (one
    launch per conv of the block) or raises. ``inception_block.launches``
    counts the block calls that went through the kernel."""
    if x.dtype not in _DTYPES or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("inception_block: x must be a contiguous [F, H, W, C] f32/bf16 tensor")
    _check_weights(blk, x)
    if x.device.type == "cpu":
        return inception_block_plain(x, blk)
    if x.device.type != "cuda":
        raise ValueError(f"inception_block: unsupported device {x.device}")
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dt = _DTYPES[x.dtype]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        _kmajor_weights(blk)
    Fn, H, W, C = x.shape
    R = Fn * H * W
    hw = (H, W)
    xr = x.view(R, C)
    n_in, n_cat = blk.w_in.shape[1], blk.w_out.shape[0]
    cat = torch.empty(R, n_cat, dtype=x.dtype, device=x.device)
    heads = torch.empty(R, n_in - blk.n_direct, dtype=x.dtype, device=x.device)
    _launch(lib, stream, dt, xr, 0, C, blk.w_in, 1, 1, R, hw, n_in,
            w_kmajor=blk.w_in_kmajor if bf16 else None, affine=blk.a_in,
            out0=cat, nsplit=blk.n_direct, out1=heads)
    col_in, col_out = 0, blk.n_direct
    for chain in blk.chains:
        src, src_col = heads, col_in
        col_in += chain[0].w.shape[1]
        for i, conv in enumerate(chain):
            _, cin, cout = conv.w.shape
            if i == len(chain) - 1:
                dst, dst_col = cat, col_out
            else:
                dst, dst_col = torch.empty(R, cout, dtype=x.dtype, device=x.device), 0
            _launch(lib, stream, dt, src, src_col, cin, conv.w, conv.kh, conv.kw, R, hw, cout,
                    w_kmajor=conv.w_kmajor if bf16 else None, affine=conv.affine, out0=dst,
                    out0_col=dst_col)
            src, src_col = dst, dst_col
        col_out += chain[-1].w.shape[2]
    out = torch.empty_like(x)
    _launch(lib, stream, dt, cat, 0, n_cat, blk.w_out, 1, 1, R, hw, C,
            w_kmajor=blk.w_out_kmajor if bf16 else None, bias=blk.b_out, x=xr,
            res_scale=blk.res_scale, relu=blk.relu, out0=out.view(R, C))
    inception_block.launches += 1
    return out


inception_block.launches = 0
