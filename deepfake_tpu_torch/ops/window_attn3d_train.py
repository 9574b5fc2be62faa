"""Video Swin training window attention through kernel K5
(``csrc/window_attn3d_train.cu``), forward and backward.

Counterpart of deepfake_tpu/ops/pallas_window_attn.py
``pallas_window_attention_nhc_train`` (:1074), a custom_vjp whose forward is
the token-major kernel with the max-stabilised softmax and whose backward is
a Pallas kernel of its own (``_nhc_bwd_kernel``). Token-major q, k, v [B_, N,
C] with heads in channel slices, windows of any size (392 tokens for (8,7,7)
windows, 784 for (16,7,7); above 512 the bf16 kernels stream the window in
tiles of keys or queries), head dims 1 to 128 (32, Video
Swin's, on Hopper's wgmma; any other in bf16 through mma.sync, forward and
backward, csrc/window_attn_mma.cuh).

``window_attn3d_train(qkv, ...)`` takes the [B_, N, 3C] qkv tensor and is a
``torch.autograd.Function``: for a CPU tensor it runs the plain versions
below, for a CUDA tensor it launches K5 (``window_attn3d_train_fwd`` and
``window_attn3d_train_bwd``, each counting its launches in ``.launches``) or
raises. The gradient comes back as one [B_, N, 3C] tensor (dq | dk | dv) and
a dbias [H, N, N] f32 summed over the windows; mask and scale get none.

The plain versions keep the Pallas kernels' cast points (cfg defaults
``no_max=False``, ``mxu_bf16=False``): q, k, v in f32, (q * scale) k^T + bias
(f32) + mask, the max-stabilised f32 softmax, PV in f32, the output cast to
q's type. The backward recomputes the weights from q, k and the bias cast to
q's type (``_nhc_train_bwd`` passes ``bias.astype(q.dtype)``), then dV = P^T
dO, dP = dO V^T, dS = P (dP - rowsum(dP P)), dQ = dS K s, dK = dS^T Q s, all
in f32; dq, dk, dv are cast to q's type and dbias stays f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepfake_tpu_torch.kernels import build
from deepfake_tpu_torch.ops.window_attn import add_mask
from deepfake_tpu_torch.ops.window_attn_kernel import _on_cuda, check_head_dim, on_wgmma

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64  # rows of a bf16 block, queries or keys (hop::BM, csrc/window_attn_tile.cuh wtile::BM)


# ---------------------------------------------------------------- plain versions

def _heads(t, num_heads: int):
    B_, N, C = t.shape
    return t.float().reshape(B_, N, num_heads, C // num_heads).transpose(1, 2)


def _weights(qh, kh, bias, mask, scale: float):
    """Softmax weights [B_, H, N, N] f32 from f32 head-major q, k."""
    logits = add_mask((qh * scale) @ kh.transpose(-1, -2) + bias.float()[None], mask)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def window_attn3d_train_fwd_plain(q, k, v, *, num_heads: int, bias, mask=None, scale: float):
    """Token-major q, k, v [B_, N, C] -> out [B_, N, C] in q's type."""
    B_, N, C = q.shape
    p = _weights(_heads(q, num_heads), _heads(k, num_heads), bias, mask, scale)
    out = p @ _heads(v, num_heads)
    return out.transpose(1, 2).reshape(B_, N, C).to(q.dtype)


def window_attn3d_train_bwd_plain(q, k, v, dout, *, num_heads: int, bias, mask=None,
                                  scale: float):
    """(dq, dk, dv) [B_, N, C] in q's type and dbias [H, N, N] f32 for the
    output gradient ``dout`` [B_, N, C]."""
    B_, N, C = q.shape
    qh, kh, vh, oh = (_heads(t, num_heads) for t in (q, k, v, dout.to(q.dtype)))
    p = _weights(qh, kh, bias.to(q.dtype), mask, scale)
    dv = p.transpose(-1, -2) @ oh
    dp = oh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    tok = lambda t: t.transpose(1, 2).reshape(B_, N, C).to(q.dtype)
    return tok(dq), tok(dk), tok(dv), ds.sum(dim=0)


# ---------------------------------------------------------------- CUDA kernel

def _lib():
    lib = build.library("window_attn3d_train")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.k5_fwd.argtypes = [
            i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, i, ctypes.c_float, i, i, i, i, i, p]
        lib.k5_fwd.restype = i
        lib.k5_bwd.argtypes = [
            i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, p, i64, i64, i64, p, p, i, p, p,
            ctypes.c_float, i, i, i, i, i, p]
        lib.k5_bwd.restype = i
        lib.k5_stats_stride.argtypes = [i]
        lib.k5_stats_stride.restype = i
        lib.k5_error_string.argtypes = [i]
        lib.k5_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(qkv, num_heads: int, bias, mask):
    """Raise for what K5 does not take; returns (B_, N, C, D, mask as bf16)."""
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"K5 takes f32 or bf16 qkv, got {qkv.dtype}")
    B_, N, C3 = qkv.shape
    if C3 % 3 or (C3 // 3) % num_heads:
        raise ValueError(f"K5: qkv width {C3} is not 3 x num_heads x head dim")
    C = C3 // 3
    D = C // num_heads
    check_head_dim("K5", N, D)
    if qkv.stride(-1) != 1:
        raise ValueError("K5 needs the channels of qkv contiguous")
    if tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias must be [{num_heads}, {N}, {N}], got {tuple(bias.shape)}")
    if mask is not None:
        # the kernels read the mask in bf16: the shift mask's {0, -100} are exact
        mask = mask.to(qkv.device, torch.bfloat16).contiguous()
        if mask.shape[1:] != (N, N) or B_ % mask.shape[0]:
            raise ValueError(f"mask {tuple(mask.shape)} does not tile {B_} windows")
    if on_wgmma(qkv.dtype, D) and (qkv.data_ptr() % 16 or any(
            s % 8 for s in qkv.stride()[:2])):
        raise ValueError("K5's wgmma route needs a 16-byte aligned qkv with strides that are "
                         "multiples of 8 elements")
    return B_, N, C, D, mask


def window_attn3d_train_fwd(qkv, *, num_heads: int, bias, mask=None, scale: float):
    """K5's forward on the card: qkv [B_, N, 3C] -> out [B_, N, C]."""
    B_, N, C, D, mask = _check(qkv, num_heads, bias, mask)
    dev = qkv.device
    out = torch.empty(B_, N, C, dtype=qkv.dtype, device=dev)
    bias = bias.detach().to(dev, torch.float32).contiguous()
    n_masks = mask.shape[0] if mask is not None else 1
    group = _group(qkv, num_heads, N, n_masks, mask is not None)
    lib = _lib()
    status = lib.k5_fwd(
        _DTYPES[qkv.dtype], qkv.data_ptr(), qkv[..., C:].data_ptr(), qkv[..., 2 * C:].data_ptr(),
        qkv.stride(0), D, qkv.stride(1), out.data_ptr(), N * C, D, C, bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, n_masks, float(scale), B_, num_heads, N,
        D, group, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, lib.k5_error_string, "k5_fwd")
    window_attn3d_train_fwd.launches += 1
    return out


window_attn3d_train_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def window_group(windows: int, heads: int, n: int, n_masks: int, masked: bool, sms: int,
                 consumers: int = 1) -> int:
    """G, the windows a block of a bf16 launch takes (K5's forward and both
    launches of its backward; K6, whose block deals its windows out to
    ``consumers`` warpgroups). Window w reads mask w % n_masks, so a masked
    launch has n_masks groups of windows that share one bias + mask tile,
    and an unmasked one a single group; a group's windows are split over
    ceil(per_group / G) blocks, each of which builds its tile once. The cost
    of a choice is waves x (ceil(G / consumers) + 1), the tile counted as
    one window (K3's planner, on ``sms`` SMs)."""
    per_group = windows // (n_masks if masked else 1)
    units = heads * -(-n // _TILE) * (n_masks if masked else 1)
    best, group = None, 1
    for g in range(1, per_group + 1):
        splits = -(-per_group // g)
        if g > 1 and splits == -(-per_group // (g - 1)):
            continue  # the same split count as G - 1
        cost = -(-units * splits // sms) * (-(-g // consumers) + 1)
        if best is None or cost < best:
            best, group = cost, g
    return group


def block_windows(windows: int, heads: int, n: int, n_masks: int, masked: bool, group: int):
    """The blocks of the bf16 forward and of either bf16 backward launch (and
    of K6's), in the kernels' order (block x = tile + tiles (head + heads
    (mask index + n_groups split))): a list of (head, tile, windows of the
    block). Every block of a masked launch takes windows of one mask index."""
    n_groups = n_masks if masked else 1
    per_group = windows // n_groups
    g = min(group, per_group)
    tiles = -(-n // _TILE)
    blocks = []
    for x in range(tiles * heads * n_groups * -(-per_group // g)):
        tile, h, grp = x % tiles, (x // tiles) % heads, x // tiles // heads
        mi, split = grp % n_groups, grp // n_groups
        b0 = split * g
        blocks.append((h, tile, [mi + b * n_groups for b in range(b0, min(b0 + g, per_group))]))
    return blocks


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _group(qkv, num_heads: int, n: int, n_masks: int, masked: bool) -> int:
    """G for a bf16 launch on qkv's card (1 for f32, whose SIMT kernels take
    one window a block)."""
    if qkv.dtype != torch.bfloat16:
        return 1
    dev = qkv.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return window_group(qkv.shape[0], num_heads, n, n_masks, masked, _sm_count(index))


def window_attn3d_train_bwd(qkv, dout, *, num_heads: int, bias, mask=None, scale: float):
    """K5's backward on the card: (dqkv [B_, N, 3C] in qkv's type, dbias
    [H, N, N] f32)."""
    B_, N, C, D, mask = _check(qkv, num_heads, bias, mask)
    dev = qkv.device
    dt = qkv.dtype
    dout = dout.to(dt).contiguous()
    # the Pallas backward's cast point: the bias in the compute type
    bias_c = bias.detach().to(dev, dt).contiguous()
    dbias = torch.zeros(num_heads, N, N, dtype=torch.float32, device=dev)
    n_masks = mask.shape[0] if mask is not None else 1
    lib = _lib()
    group = _group(qkv, num_heads, N, n_masks, mask is not None)
    # the f32 SIMT kernel and bf16's mma.sync kernel (D != 32) add into f32
    # gradients; the wgmma kernels write bf16
    if on_wgmma(dt, D):
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        # three rows a (window, head): max, -log2 sum, rowsum(dP P) (hop::STATS)
        stats = torch.empty(B_ * num_heads * 3 * lib.k5_stats_stride(N), dtype=torch.float32,
                            device=dev)
        if dout.data_ptr() % 16:
            raise ValueError("K5's bf16 backward needs a 16-byte aligned dout")
    else:
        dqkv = torch.zeros(qkv.shape, dtype=torch.float32, device=dev)  # it adds dk, dv
        stats = None
    status = lib.k5_bwd(
        _DTYPES[dt], qkv.data_ptr(), qkv[..., C:].data_ptr(), qkv[..., 2 * C:].data_ptr(),
        qkv.stride(0), D, qkv.stride(1), dout.data_ptr(), N * C, D, C,
        dqkv.data_ptr(), dqkv[..., C:].data_ptr(), dqkv[..., 2 * C:].data_ptr(), N * 3 * C, D,
        3 * C, bias_c.data_ptr(), mask.data_ptr() if mask is not None else None, n_masks,
        stats.data_ptr() if stats is not None else None, dbias.data_ptr(), float(scale),
        B_, num_heads, N, D, group, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, lib.k5_error_string, "k5_bwd")
    window_attn3d_train_bwd.launches += 1
    return dqkv.to(dt), dbias


window_attn3d_train_bwd.launches = 0


# ---------------------------------------------------------------- autograd

def _split(qkv):
    C = qkv.shape[-1] // 3
    return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]


class WindowAttn3DTrain(torch.autograd.Function):
    """out = attention(qkv); gradients for qkv and bias."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads: int, scale: float):
        kw = dict(num_heads=num_heads, bias=bias, mask=mask, scale=scale)
        ctx.save_for_backward(qkv, bias, mask)
        ctx.num_heads, ctx.scale = num_heads, scale
        if _on_cuda("window_attn3d_train", qkv, bias):
            return window_attn3d_train_fwd(qkv, **kw)
        return window_attn3d_train_fwd_plain(*_split(qkv), **kw)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        kw = dict(num_heads=ctx.num_heads, bias=bias, mask=mask, scale=ctx.scale)
        if _on_cuda("window_attn3d_train", qkv, bias, dout):
            dqkv, dbias = window_attn3d_train_bwd(qkv, dout, **kw)
        else:
            dq, dk, dv, dbias = window_attn3d_train_bwd_plain(*_split(qkv), dout, **kw)
            dqkv = torch.cat([dq, dk, dv], dim=-1)
        return dqkv, dbias.to(bias.dtype), None, None, None


def window_attn3d_train(qkv, *, num_heads: int, bias, mask=None, scale: float):
    """Token-major window attention for training: qkv [B_, N, 3C] (q | k | v,
    heads in channel slices), bias [H, N, N], mask [nW, N, N] or None ->
    out [B_, N, C], differentiable in qkv and bias."""
    return WindowAttn3DTrain.apply(qkv, bias, mask, num_heads, scale)
