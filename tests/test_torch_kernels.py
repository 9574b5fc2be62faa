"""The port's kernel modules against the JAX package's Pallas kernels.

K1 (deepfake_tpu_torch/ops/inception_block.py), K2
(deepfake_tpu_torch/ops/window_attn_kernel.py), K3
(deepfake_tpu_torch/ops/window_attn3d_kernel.py), K4
(deepfake_tpu_torch/ops/ln_linear_kernel.py), K5
(deepfake_tpu_torch/ops/window_attn3d_train.py) and K6
(deepfake_tpu_torch/ops/window_attn_multihead.py) run here, on the CPU, through
their plain versions; the Pallas kernels run in interpret mode, as
tests/test_pallas_inception.py and tests/test_pallas_kernels.py run them.
Weights go across with load_jax_variables. All f32, and K5 in bf16 too.

tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_tpu.models import inception_resnet_v2 as jirv2
from deepfake_tpu.models.swin2d import shift_attn_mask
from deepfake_tpu.models.swin3d import compute_mask_3d
from deepfake_tpu.ops.pallas_mlp import fused_mlp_tail
from deepfake_tpu.ops.pallas_window_attn import (
    pallas_window_attention, pallas_window_attention_nhc, pallas_window_attention_nhc_packed,
    pallas_window_attention_nhc_qkv, pallas_window_attention_nhc_train,
)
from deepfake_tpu_torch.io.jax_weights import load_jax_variables
from deepfake_tpu_torch.models import inception_resnet_v2 as tirv2
from deepfake_tpu_torch.models.layers import as_nchw, as_nhwc
from deepfake_tpu_torch.ops.ln_linear_kernel import ln_linear, mlp_tail
from deepfake_tpu_torch.ops.window_attn import scaled_window_attention
from deepfake_tpu_torch.ops.window_attn3d_kernel import window_attn3d_tokens
from deepfake_tpu_torch.ops.window_attn3d_train import window_attn3d_train
from deepfake_tpu_torch.ops.window_attn_kernel import (
    window_attention_heads, window_attention_tokens,
)
from deepfake_tpu_torch.ops.window_attn_multihead import window_attention_multihead

from tests.torch_port_helpers import random_variables

BLOCKS = [
    # (block kind, channels C, frame side S, kwargs): S as
    # tests/test_pallas_inception.py runs the Pallas blocks
    ("A", 320, 9, {}),
    ("B", 1088, 4, {}),
    ("C", 2080, 5, {}),
    ("C", 2080, 5, dict(scale=1.0, activation=False)),  # c_9
]


def _block_pair(kind, C, kw):
    jcls = getattr(jirv2, f"Block{kind}")
    tcls = getattr(tirv2, f"Block{kind}")
    return jcls(use_pallas=True, **kw), tcls(fused=True, C=C, **kw)


@pytest.mark.parametrize("kind,C,S,kw", BLOCKS, ids=["A_S9", "B_S4", "C_S5", "c9_S5"])
def test_k1_plain_matches_pallas_block(kind, C, S, kw):
    """Port block on the K1 route (plain version on the CPU) == JAX block on
    its Pallas route (interpret mode): max relative error <= 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, S, S, C)).astype(np.float32) * 0.5
    jblock, tblock = _block_pair(kind, C, kw)
    variables = random_variables(jblock, jnp.asarray(x), seed=1)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    load_jax_variables(tblock, variables)
    with torch.inference_mode():
        got = as_nhwc(tblock(as_nchw(torch.from_numpy(x)))).numpy()
    rel = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
    assert rel <= 1e-5, rel


def _attn_inputs(B_, H, N, D, seed, masked):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = mk(B_, H, N, D), mk(B_, H, N, D), mk(B_, H, N, D)
    bias = 16.0 / (1.0 + np.exp(-mk(H, N, N)))
    mask = shift_attn_mask(14, 14, 7, 3) if masked else None  # nW = 4
    logit_scale = np.exp(np.minimum(mk(H, 1, 1) * 0.5 + np.log(10.0), np.log(100.0)))
    return q, k, v, bias, mask, logit_scale.astype(np.float32)


@pytest.mark.parametrize("B_,masked", [(8, True), (1, False)], ids=["shifted_nW4", "single"])
@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "scaled"])
def test_k2_plain_heads_matches_pallas(B_, masked, cosine):
    """Head-major K2 (plain on the CPU) == pallas_window_attention (routes
    _run_packed at B_=8 and _run at B_=1): max abs error <= 1e-5."""
    q, k, v, bias, mask, ls = _attn_inputs(B_, 2, 49, 8, 3, masked)
    kw = dict(logit_scale=ls) if cosine else dict(scale=0.35)
    j = lambda a: None if a is None else jnp.asarray(a)
    want = np.asarray(pallas_window_attention(
        j(q), j(k), j(v), bias=j(bias), mask=j(mask), cosine=cosine,
        **{n: j(a) if n == "logit_scale" else a for n, a in kw.items()}))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = window_attention_heads(t(q), t(k), t(v), bias=t(bias), mask=t(mask), cosine=cosine,
                                 **{n: t(a) if n == "logit_scale" else a for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_k2_plain_tokens_matches_pallas_nhc_packed():
    """Token-major K2 (plain on the CPU) == pallas_window_attention_nhc_packed
    with a shift mask, nW=4, N=49: max abs error <= 1e-5."""
    B_, H, N, D = 8, 4, 49, 8
    q, k, v, bias, mask, ls = _attn_inputs(B_, H, N, D, 5, True)
    tok = lambda a: a.transpose(0, 2, 1, 3).reshape(B_, N, H * D)
    want = np.asarray(pallas_window_attention_nhc_packed(
        jnp.asarray(tok(q)), jnp.asarray(tok(k)), jnp.asarray(tok(v)), num_heads=H,
        bias=jnp.asarray(bias), mask=jnp.asarray(mask), cosine=True,
        logit_scale=jnp.asarray(ls)))
    # q, k, v as column slices of one qkv tensor, as SwinV2 passes them
    qkv = torch.from_numpy(np.concatenate([tok(q), tok(k), tok(v)], axis=-1))
    C = H * D
    got = window_attention_tokens(
        qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], num_heads=H,
        bias=torch.from_numpy(bias), mask=torch.from_numpy(mask),
        logit_scale=torch.from_numpy(ls))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_k2_rejects_large_windows_on_card_only_shapes():
    """N=392 (3D windows) is not K2's: the CUDA wrapper raises before any
    launch. On the CPU the plain version still serves it."""
    from deepfake_tpu_torch.ops.window_attn_kernel import _launch

    q = torch.zeros(1, 1, 392, 32)
    with pytest.raises(ValueError, match="N <= 64"):
        _launch(q, q, q, (0, 0, 0), q, (0, 0, 0), windows=1, heads=1, n=392, d=32,
                bias=torch.zeros(1, 392, 392), mask=None, logit_scale=torch.ones(1),
                scale=None, cosine=True)


def test_k1_bf16_rejects_channels_it_cannot_chunk():
    """K1's tensor-core path copies 16-byte chunks of 8 bf16 channels: the
    wrapper raises before any launch for a width that is not a multiple of
    8 (every IRv2 width is)."""
    from deepfake_tpu_torch.ops.inception_block import _launch

    a = torch.zeros(16, 20, dtype=torch.bfloat16)
    w = torch.zeros(1, 20, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        _launch(None, None, 1, a, 0, 20, w, 1, 1, 16, (4, 4), 8,
                affine=torch.zeros(2, 8), out0=torch.zeros(16, 8, dtype=torch.bfloat16))


# the fused path's IRv2 blocks (kind, frame side) and the frame counts of a
# b8 request (256) and of one that leaves partial row tiles (33)
K1_FUSED = [("A", 25), ("B", 12), ("C", 5), ("c9", 5)]


def _k1_convs(kind):
    """(kh, kw, cin, cout) of every conv of a block, in launch order, and
    the in-conv's split column."""
    block = {"A": lambda: tirv2.BlockA(0.17, True), "B": lambda: tirv2.BlockB(0.10, True),
             "C": lambda: tirv2.BlockC(0.20, True, True),
             "c9": lambda: tirv2.BlockC(1.0, False, True)}[kind]()
    blk = block.pack_weights(torch.bfloat16)
    C, n_in = blk.w_in.shape
    convs = [(1, 1, C, n_in)]
    convs += [(c.kh, c.kw, c.w.shape[1], c.w.shape[2]) for ch in blk.chains for c in ch]
    convs.append((1, 1, blk.w_out.shape[0], C))
    return convs, blk.n_direct


@pytest.mark.parametrize("kind,side", K1_FUSED, ids=[k for k, _ in K1_FUSED])
def test_k1_column_tiles_cover_every_conv(kind, side):
    """Every conv of blocks A, B, C and c_9 gets column tiles that cover its
    n outputs exactly, each a built width (a multiple of 8, <= 256: a wgmma
    N and a TMA box dimension); the in-conv's split column falls on an
    8-column run, as the epilogue writes 8 columns at once."""
    from deepfake_tpu_torch.ops.inception_block import N_TILES, n_tile

    convs, n_direct = _k1_convs(kind)
    for kh, kw, cin, n in convs:
        bn = n_tile(n)
        assert bn in N_TILES and bn % 8 == 0 and bn <= 256, (kh, kw, n, bn)
        assert n % bn == 0, (kh, kw, n, bn)
    assert n_direct % 8 == 0
    assert n_tile(1088) == 136 and n_tile(2080) == 208 and n_tile(320) == 160


@pytest.mark.parametrize("frames", [256, 33])
@pytest.mark.parametrize("kind,side", K1_FUSED, ids=[k for k, _ in K1_FUSED])
def test_k1_row_tiles_are_tma_boxes_that_cover_the_frames(kind, side, frames):
    """Every conv's row tile is a TMA box within 256 elements a dimension
    whose inner extent (64 channels of bf16) is a 16-byte multiple, at most
    128 rows (two wgmma M of 64); the tiles cover every output pixel once;
    a tap conv's tiles are whole pixel rows."""
    from deepfake_tpu_torch.ops.inception_block import n_tile, row_tile

    convs, _ = _k1_convs(kind)
    for kh, kw, cin, n in convs:
        (fr, hh, ww), (bf, bh, bw) = row_tile(frames, side, side, kh, kw)
        assert fr * hh * ww == frames * side * side
        box = (64, bw, bh, bf)
        assert all(1 <= d <= 256 for d in box) and box[0] * 2 % 16 == 0
        assert bf * bh * bw <= 128
        assert n_tile(n) * 2 % 16 == 0  # the weights' and the residual's boxes
        if (kh, kw) != (1, 1):
            assert (fr, hh, ww) == (frames, side, side) and bw == side
        covered = np.zeros((fr, hh, ww), np.int32)
        for f0 in range(0, fr, bf):
            for i0 in range(0, hh, bh):
                for j0 in range(0, ww, bw):
                    covered[f0:f0 + bf, i0:i0 + bh, j0:j0 + bw] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("batch", [8, 1, 3])
def test_k2_window_groups_cover_every_window_once(batch):
    """The bf16 K2 launch's blocks (window_group, block_windows) at every
    SwinV2-B stage of a window-7 request, shifted and not, and at the audio
    preset's window-8 stage: every (window, head) is taken by one block,
    and a masked block's windows all read one mask index."""
    from deepfake_tpu_torch.ops.window_attn_kernel import block_windows, window_group

    stages = [(56, 4), (28, 8), (14, 16), (7, 32)]  # (resolution, heads) at 224
    cases = []
    for res, H in stages:
        nW = (res // 7) ** 2
        cases.append((batch * nW, H, nW, False))
        if res > 7:
            cases.append((batch * nW, H, nW, True))
    cases.append((batch, 32, 1, False))  # audio stage 3: one 8 x 8 window an image
    for windows, heads, n_masks, masked in cases:
        group = window_group(windows, heads, n_masks, masked, 3 * 132)
        assert 1 <= group <= windows
        seen = np.zeros((windows, heads), np.int32)
        for h, ws in block_windows(windows, heads, n_masks, masked, group):
            assert 1 <= len(ws) <= group
            if masked:
                assert len({w % n_masks for w in ws}) == 1
            for w in ws:
                seen[w, h] += 1
        assert (seen == 1).all(), (windows, heads, masked)


# (windows B_, heads, N, masks, masked): K6's launches on SwinV2-B's audio
# path at window 16, 256^2 (b8 stages 0-2, shifted and not, and b1), and off
# it at windows 9-11, 24 and 32 (b8 of a 2x2-window grid, shifted)
K6_SCHEDULES = {
    "b8_stage0_shifted": (128, 4, 256, 16, True), "b8_stage0": (128, 4, 256, 16, False),
    "b8_stage1_shifted": (32, 8, 256, 4, True), "b8_stage1": (32, 8, 256, 4, False),
    "b8_stage2": (8, 16, 256, 1, False), "b1_stage0_shifted": (16, 4, 256, 16, True),
    "b1_stage2": (1, 16, 256, 1, False), "w9": (32, 4, 81, 4, True), "w10": (32, 4, 100, 4, True),
    "w11": (32, 4, 121, 4, True), "w24": (32, 4, 576, 4, True), "w32": (32, 4, 1024, 4, True),
}


@pytest.mark.parametrize("consumers", [4, 2, 1])
@pytest.mark.parametrize("B_,H,N,n_masks,masked", list(K6_SCHEDULES.values()),
                         ids=list(K6_SCHEDULES))
def test_k6_window_groups_cover_every_window_once(B_, H, N, n_masks, masked, consumers):
    """K6's bf16 schedule: with G from window_group for a block of
    ``consumers`` warpgroups, every (window, head, 64-row query tile) falls in
    exactly one block, a masked block takes only windows of one mask index
    (they share its bias + mask tile), and the kernel's deal-out of a block's
    windows to its warpgroups (warpgroup c takes windows c, c + consumers,
    ...: ceil((nw - c) / consumers) of them) gives each window to one."""
    from collections import Counter

    from deepfake_tpu_torch.ops.window_attn3d_train import block_windows, window_group

    g = window_group(B_, H, N, n_masks, masked, 132, consumers)
    blocks = block_windows(B_, H, N, n_masks, masked, g)
    seen = Counter((w, h, tile) for h, tile, ws in blocks for w in ws)
    tiles = -(-N // 64)
    assert set(seen) == {(w, h, t) for w in range(B_) for h in range(H) for t in range(tiles)}
    assert max(seen.values()) == 1
    for _, _, ws in blocks:
        assert 0 < len(ws) <= g
        if masked:
            assert len({w % n_masks for w in ws}) == 1
        nw = len(ws)
        dealt = Counter()
        for c in range(consumers):
            mine = (nw - c + consumers - 1) // consumers if nw > c else 0
            dealt.update(ws[c + j * consumers] for j in range(mine))
        assert dealt == Counter(ws)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of handing back a
    plain path."""
    from deepfake_tpu_torch.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("window_attn")


def test_k2_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    """Only a CPU tensor selects the plain version; any other device that is
    not CUDA raises rather than running the plain path."""
    q = torch.zeros(2, 1, 49, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        window_attention_heads(q, q, q, bias=torch.zeros(1, 49, 49), logit_scale=torch.ones(1))


def _k6_inputs(B_, H, N, seed, masked):
    """D = 32; cosine inputs as SwinV2 makes them: bias 16 sigmoid(.), logit
    scales around SwinV2's initial 10 (clamped at 100, as the K2 test draws
    them); the mask of a 32x32 token grid in 16x16 windows shifted by 8
    (4 windows, N = 256)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = mk(B_, H, N, 32), mk(B_, H, N, 32), mk(B_, H, N, 32)
    bias = (16.0 / (1.0 + np.exp(-mk(H, N, N)))).astype(np.float32)
    mask = shift_attn_mask(32, 32, 16, 8) if masked else None
    logit_scale = np.exp(np.minimum(mk(H, 1, 1) * 0.5 + np.log(10.0), np.log(100.0)))
    return q, k, v, bias, mask, logit_scale.astype(np.float32)


@pytest.mark.parametrize("N,cosine,masked", [(256, True, True), (392, False, False)],
                         ids=["cosine_N256_shifted_nW4", "scaled_N392"])
def test_k6_plain_matches_pallas_multihead(N, cosine, masked):
    """K6 (plain version on the CPU) == pallas_window_attention on its
    _run_multihead route (N >= 128; interpret mode) at B_=8, H=4 (one head
    group of 4): cosine at N=256 with 4 shift masks, scaled at N=392
    without a mask: max abs error <= 1e-5. (At logit scales near the clamp,
    100, both f32 computations sit ~1.5e-5 from a float64 one: the card's
    test holds K6 there to 1e-5 of the largest |output|.)"""
    from deepfake_tpu.ops import pallas_window_attn as P

    q, k, v, bias, mask, ls = _k6_inputs(8, 4, N, 35, masked)
    kw = dict(logit_scale=ls) if cosine else dict(scale=32 ** -0.5)
    j = lambda a: None if a is None or np.isscalar(a) else jnp.asarray(a)
    runs = []
    run = P._run_multihead
    try:
        P._run_multihead = lambda *a, **k: runs.append(k["Gh"]) or run(*a, **k)
        want = np.asarray(P.pallas_window_attention(
            j(q), j(k), j(v), bias=j(bias), mask=j(mask), cosine=cosine,
            **{n: j(a) if n == "logit_scale" else a for n, a in kw.items()}))
    finally:
        P._run_multihead = run
    assert runs == [4]
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = window_attention_multihead(
        t(q), t(k), t(v), bias=t(bias), mask=t(mask), cosine=cosine,
        **{n: t(a) if n == "logit_scale" else a for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("N,side,ws,route", [(100, 20, 10, "_run"), (576, 48, 24, "_run_multihead")],
                         ids=["window10_N100", "window24_N576"])
def test_k6_plain_matches_pallas_above_k2_range(N, side, ws, route):
    """K6's range above K2's (plain version on the CPU) against
    pallas_window_attention in interpret mode at the two window sizes the
    port took no kernel for before: window 10 (N = 100, the Pallas ``_run``
    route) and window 24 (N = 576, ``_run_multihead``), cosine with the
    shift masks of a 2x2-window grid, B_ = 4, H = 2: max abs error <= 1e-5."""
    from deepfake_tpu.ops import pallas_window_attn as P

    rng = np.random.default_rng(36)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = mk(4, 2, N, 32), mk(4, 2, N, 32), mk(4, 2, N, 32)
    bias = (16.0 / (1.0 + np.exp(-mk(2, N, N)))).astype(np.float32)
    mask = shift_attn_mask(side, side, ws, ws // 2)
    ls = np.exp(np.minimum(mk(2, 1, 1) * 0.5 + np.log(10.0), np.log(100.0))).astype(np.float32)
    assert mask.shape == (4, N, N)
    runs = []
    run = getattr(P, route)
    try:
        setattr(P, route, lambda *a, **kw: runs.append(route) or run(*a, **kw))
        want = np.asarray(P.pallas_window_attention(
            *(jnp.asarray(a) for a in (q, k, v)), bias=jnp.asarray(bias),
            mask=jnp.asarray(mask), logit_scale=jnp.asarray(ls), cosine=True))
    finally:
        setattr(P, route, run)
    assert runs == [route]
    t = torch.from_numpy
    got = window_attention_multihead(t(q), t(k), t(v), bias=t(bias), mask=t(mask),
                                     logit_scale=t(ls))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_k6_rejects_what_it_does_not_take(monkeypatch):
    """K6's launch checks raise before any launch for N <= 64 (K2's
    windows), a head dim outside 1-128, q, k, v of different strides and a
    mask that does not tile the windows; windows of 65 to 1024 tokens and
    head dims 1 to 128 pass every check and reach the kernel library (no
    upper limit on N)."""
    from deepfake_tpu_torch.ops import window_attn_multihead as k6

    class Reached(Exception):
        pass

    def library():
        raise Reached

    monkeypatch.setattr(k6, "_lib", library)

    def launch(n, d, mask=None, windows=1, k=None):
        q = torch.zeros(windows, 1, n, d)
        k6._launch(q, q if k is None else k, q, q, bias=torch.zeros(1, n, n), mask=mask,
                   logit_scale=torch.ones(1), scale=None, cosine=True)

    with pytest.raises(ValueError, match="N >= 65"):
        launch(64, 32)
    for d in (129, 136):
        with pytest.raises(ValueError, match="head dims 1 to 128"):
            launch(256, d)
    for d in (1, 4, 8, 12, 16, 20, 36, 48, 64, 128):
        with pytest.raises(Reached):
            launch(256, d)
    with pytest.raises(ValueError, match="one set of strides"):
        launch(256, 32, k=torch.zeros(1, 256, 1, 32).transpose(1, 2))
    with pytest.raises(ValueError, match="does not tile 3 windows"):
        launch(256, 32, mask=torch.zeros(2, 256, 256), windows=3)
    for n in (65, 81, 121, 640, 1024):
        with pytest.raises(Reached):
            launch(n, 32)


def test_k6_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    """A CPU tensor selects the plain version and counts no launch; any
    other device that is not CUDA raises rather than running the plain path;
    an input that requires grad raises under autograd (K6 has no backward)."""
    q = torch.zeros(2, 1, 256, 32)
    kw = dict(bias=torch.zeros(1, 256, 256), logit_scale=torch.ones(1, 1, 1))
    before = window_attention_multihead.launches
    out = window_attention_multihead(q, q, q, **kw)
    assert out.shape == q.shape and window_attention_multihead.launches == before
    m = torch.zeros(2, 1, 256, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        window_attention_multihead(m, m, m, **kw)
    with pytest.raises(RuntimeError, match="has no backward"):
        window_attention_multihead(q.clone().requires_grad_(), q, q, **kw)
    with torch.no_grad():
        window_attention_multihead(q.clone().requires_grad_(), q, q, **kw)


# N: (token grid, window, shift) of the shift mask, 4 windows each: Video
# Swin-S's (8,7,7) windows on an 8x14x14 grid, and Video Swin-B's (16,7,7)
# Something-Something v2 window on 16 temporal tokens (the temporal shift
# clamps to 0)
ATTN3D_MASKS = {392: ((8, 14, 14), (8, 7, 7), (4, 3, 3)),
                784: ((16, 14, 14), (16, 7, 7), (0, 3, 3))}


def _attn3d_inputs(B_, H, seed, masked, N=392):
    """N = 392 ((8,7,7) windows) or 784 ((16,7,7)), D = 32, and the shift
    mask of ATTN3D_MASKS[N]."""
    D = 32
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = mk(B_, H, N, D), mk(B_, H, N, D), mk(B_, H, N, D)
    bias = 0.5 * mk(H, N, N)
    grid, ws, ss = ATTN3D_MASKS[N]
    mask = compute_mask_3d(*grid, ws, ss) if masked else None
    return q, k, v, bias, mask


@pytest.mark.parametrize("masked,B_,N", [(True, 4, 392), (False, 4, 392), (True, 8, 392),
                                         (True, 12, 392), (True, 4, 784), (False, 2, 784)],
                         ids=["shifted_nW4", "unshifted", "shifted_b2", "shifted_b3",
                              "n784_shifted_nW4", "n784_unshifted"])
def test_k3_plain_tokens_matches_pallas_nhc(masked, B_, N):
    """Token-major K3 (plain on the CPU) == pallas_window_attention_nhc
    (interpret mode; static-shift softmax, deferred 1/rowsum) at N=392, H=4
    (N=784, the (16,7,7) window: H=2), q, k, v as column slices of one qkv
    tensor: max abs error <= 2e-5. The batch layouts the kernel's window
    groups rely on: b1 (B_ = nW = 4), b2 and an odd batch (B_ = 3 nW),
    window w reading mask w % nW."""
    H, D = (4 if N == 392 else 2), 32
    q, k, v, bias, mask = _attn3d_inputs(B_, H, 30, masked, N)
    tok = lambda a: a.transpose(0, 2, 1, 3).reshape(B_, N, H * D)
    j = lambda a: None if a is None else jnp.asarray(a)
    want = np.asarray(pallas_window_attention_nhc(
        j(tok(q)), j(tok(k)), j(tok(v)), num_heads=H, bias=j(bias), mask=j(mask),
        scale=D ** -0.5))
    qkv = torch.from_numpy(np.concatenate([tok(q), tok(k), tok(v)], axis=-1))
    C = H * D
    got = window_attn3d_tokens(
        qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], num_heads=H,
        bias=torch.from_numpy(bias), mask=None if mask is None else torch.from_numpy(mask),
        scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_k3_static_shift_at_huge_logits_matches_pallas_nhc():
    """A window of one token repeated at ~2e6 (what a diverging training run
    from the init's zero biases gives its zero-filled corners) has every
    logit near +-1e12. The static-shift softmax exp(min(x - 24, 60)) of the
    Pallas kernel underflows a row near -1e12 to 0 / 0, and K3's plain
    version does the same (NaN where the reference is NaN, equal to 2e-5
    relative elsewhere); the max-stabilised plain route stays finite."""
    rng = np.random.default_rng(66)
    B_, H, N, D = 2, 2, 392, 32
    C = H * D
    qkv = np.repeat(2e6 * rng.standard_normal((B_, 1, 3 * C)), N, axis=1).astype(np.float32)
    bias = (0.02 * rng.standard_normal((H, N, N))).astype(np.float32)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    want = np.asarray(pallas_window_attention_nhc(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=H, bias=jnp.asarray(bias),
        mask=None, scale=D ** -0.5))
    t = torch.from_numpy(qkv)
    got = window_attn3d_tokens(t[..., :C], t[..., C:2 * C], t[..., 2 * C:], num_heads=H,
                               bias=torch.from_numpy(bias), mask=None, scale=D ** -0.5).numpy()
    assert np.isnan(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=0)
    heads = lambda a: torch.from_numpy(a).reshape(B_, N, H, D).transpose(1, 2)
    plain = scaled_window_attention(heads(q), heads(k), heads(v), D ** -0.5,
                                    torch.from_numpy(bias))
    assert bool(torch.isfinite(plain).all())


def test_k3_rejects_what_it_does_not_take(monkeypatch):
    """The CUDA wrapper raises before any launch for a head dim outside
    1-128, a non-contiguous head dim and a mask that does not tile the
    windows; a window of N = 784 and head dims 1 to 128 pass its checks (K3
    takes any N and every such head dim)."""
    from deepfake_tpu_torch.ops.window_attn3d_kernel import _launch

    def launch(q, n, d, mask=None, windows=1):
        _launch(q, q, q, (0, 0, 0), q, (0, 0, 0), windows=windows, heads=1, n=n, d=d,
                bias=torch.zeros(1, n, n), mask=mask, scale=1.0)

    # N = 784 ((16,7,7) windows) passes the checks and reaches the library
    # (a stand-in here, which records the call)
    from deepfake_tpu_torch.ops import window_attn3d_kernel

    calls = []

    class Lib:
        k3_error_string = None

        def k3_window_attn(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(window_attn3d_kernel, "_lib", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0}))
    launch(torch.zeros(1, 784, 32), 784, 32)
    assert len(calls) == 1 and calls[0][-3:-1] == (784, 32)
    dims = (1, 4, 12, 16, 20, 36, 48, 64, 128)
    for d in dims:
        launch(torch.zeros(1, 392, d), 392, d)
    assert [c[-3:-1] for c in calls[1:]] == [(392, d) for d in dims]
    monkeypatch.undo()
    for d in (129, 136):
        with pytest.raises(ValueError, match="head dims 1 to 128"):
            launch(torch.zeros(1, 392, d), 392, d)
    with pytest.raises(ValueError, match="head dim contiguous"):
        launch(torch.zeros(1, 32, 392).transpose(1, 2), 392, 32)
    with pytest.raises(ValueError, match="does not tile 3 windows"):
        launch(torch.zeros(3, 392, 32), 392, 32, mask=torch.zeros(2, 392, 392), windows=3)
    with pytest.raises(ValueError, match="f32 or bf16"):
        launch(torch.zeros(1, 392, 32, dtype=torch.float16), 392, 32)


def test_k3_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    """A CPU tensor selects the plain version and counts no launch; any
    other device that is not CUDA raises rather than running the plain path."""
    q = torch.zeros(2, 392, 32)
    before = window_attn3d_tokens.launches
    out = window_attn3d_tokens(q, q, q, num_heads=1, bias=torch.zeros(1, 392, 392), scale=0.2)
    assert out.shape == q.shape and window_attn3d_tokens.launches == before
    m = torch.zeros(2, 392, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        window_attn3d_tokens(m, m, m, num_heads=1, bias=torch.zeros(1, 392, 392), scale=0.2)


def _two_bf16_ulps(want: np.ndarray) -> float:
    """Two bf16 ulps of the largest |value| of ``want``."""
    return 2.0 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked,B_,N", [(True, 4, 392), (False, 4, 392), (True, 8, 392),
                                         (True, 12, 392), (True, 4, 784), (False, 2, 784)],
                         ids=["shifted_nW4", "unshifted", "shifted_b2", "shifted_b3",
                              "n784_shifted_nW4", "n784_unshifted"])
def test_k5_plain_fwd_bwd_match_pallas_nhc_train(masked, B_, N, dtype):
    """K5's autograd Function (plain forward and backward on the CPU) ==
    pallas_window_attention_nhc_train under jax.vjp (interpret mode: the
    token-major forward with the max-stabilised softmax, the Pallas
    backward) at N=392, H=2, on one output gradient: out, dq, dk, dv and
    dbias within atol 2e-4 / rtol 1e-4 in f32. In bf16, out, dq, dk and dv
    within two bf16 ulps of each tensor's largest |value|; dbias, f32 on
    both sides and summed from the same bf16 inputs, within rtol 1e-4 (atol
    1e-5 of its largest |value|), which holds the backward to the bias
    rounded to bf16 where the forward reads it in f32. The batch layouts the
    bf16 backward's window groups rely on: b1 (B_ = nW = 4), b2 and an odd
    batch (B_ = 3 nW), window w reading mask w % nW, and dbias summed over
    every window. The same at N = 784, Video Swin-B's (16,7,7) window."""
    H, D = 2, 32
    C = H * D
    q, k, v, bias, mask = _attn3d_inputs(B_, H, 31, masked, N)
    tok = lambda a: a.transpose(0, 2, 1, 3).reshape(B_, N, C)
    g = np.random.default_rng(32).standard_normal((B_, N, C)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jmask = None if mask is None else jnp.asarray(mask)

    def attn(q, k, v, b):
        return pallas_window_attention_nhc_train(q, k, v, num_heads=H, bias=b, mask=jmask,
                                                 scale=D ** -0.5)

    out, vjp = jax.vjp(attn, *(jnp.asarray(tok(a), jdt) for a in (q, k, v)), jnp.asarray(bias))
    want = [out, *vjp(jnp.asarray(g, jdt))]

    tdt = getattr(torch, dtype)
    qkv = torch.from_numpy(np.concatenate([tok(q), tok(k), tok(v)], -1)).to(tdt).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    got_out = window_attn3d_train(qkv, num_heads=H, bias=tbias, scale=D ** -0.5,
                                  mask=None if mask is None else torch.from_numpy(mask))
    got_out.backward(torch.from_numpy(g).to(tdt))
    got = [got_out, *qkv.grad.split(C, dim=-1), tbias.grad]
    assert tbias.grad.dtype == torch.float32
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4, err_msg=name)
        elif name == "dbias":
            np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), rtol=1e-4)
        else:
            err = np.abs(a - b).max()
            assert err <= _two_bf16_ulps(b), (name, err, _two_bf16_ulps(b))


def _dense(rng, cin, cout):
    """A JAX Dense kernel [cin, cout] and bias, lecun-normal and ~0.1."""
    w = (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)
    return w, (0.1 * rng.standard_normal(cout)).astype(np.float32)


def _norm(rng, c):
    return ((1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


@pytest.mark.parametrize("C,H,masked", [(64, 2, True), (256, 8, False)],
                         ids=["one_group_ln_proj_shifted", "two_groups_ln_unshifted"])
def test_k4_k3_plain_match_pallas_qkv_fused(C, H, masked):
    """pallas_window_attention_nhc_qkv (interpret mode; LayerNorm, qkv,
    attention and, for a single head group, proj in one kernel) == K4's
    LayerNorm + qkv launch, K3, and K4's proj launch (plain versions on the
    CPU) at N=392, B_=4: max abs error <= 2e-5. At H=8 the Pallas kernel
    runs two head groups and leaves proj to its caller, so the attention
    output is compared before proj."""
    B_, N, D = 4, 392, 32
    rng = np.random.default_rng(33)
    x = rng.standard_normal((B_, N, C)).astype(np.float32)
    (lw, lb), (wq, bq), (wp, bp) = _norm(rng, C), _dense(rng, C, 3 * C), _dense(rng, C, C)
    bias = (0.5 * rng.standard_normal((H, N, N))).astype(np.float32)
    mask = compute_mask_3d(8, 14, 14, (8, 7, 7), (4, 3, 3)) if masked else None
    j = jnp.asarray
    want, projected = pallas_window_attention_nhc_qkv(
        j(x), j(wq), j(bq), num_heads=H, bias=j(bias), mask=None if mask is None else j(mask),
        scale=D ** -0.5, ln=(j(lw), j(lb)), proj=(j(wp), j(bp)))
    assert projected == (H == 2)
    t = torch.from_numpy
    qkv = ln_linear(t(x), t(wq.T.copy()), t(bq), ln=(t(lw), t(lb), 1e-6))
    got = window_attn3d_tokens(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], num_heads=H,
                               bias=t(bias), mask=None if mask is None else t(mask),
                               scale=D ** -0.5)
    if projected:
        got = ln_linear(got, t(wp.T.copy()), t(bp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("L,C", [(256, 64), (96, 96)], ids=["L256_C64", "L96_C96"])
def test_k4_plain_mlp_tail_matches_pallas(L, C):
    """fused_mlp_tail (interpret mode: a + b, LayerNorm, fc1, exact GELU,
    fc2, + (a + b)) == mlp_tail, two launches of K4 (plain versions on the
    CPU): max abs error <= 2e-5."""
    rng = np.random.default_rng(34)
    a, b = (rng.standard_normal((L, C)).astype(np.float32) for _ in range(2))
    (lw, lb), (w1, b1), (w2, b2) = _norm(rng, C), _dense(rng, C, 4 * C), _dense(rng, 4 * C, C)
    j = jnp.asarray
    want = fused_mlp_tail(j(a), j(b), j(lw), j(lb), j(w1), j(b1), j(w2), j(b2))
    t = torch.from_numpy
    got = mlp_tail(t(a), t(b), (t(lw), t(lb), 1e-6), t(w1.T.copy()), t(b1), t(w2.T.copy()),
                   t(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_k4_rejects_what_it_does_not_take():
    """The CUDA wrapper's checks raise before any launch: a type it does not
    take, mixed types, a weight that does not fit, partners of different
    strides, bf16 widths that are not multiples of 8, and a bf16 prologue
    over a K that is not a multiple of 32."""
    from deepfake_tpu_torch.ops.ln_linear_kernel import _check

    x, w = torch.zeros(4, 16), torch.zeros(8, 16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        _check(x.half(), w.half(), None, None, None, None, None)
    with pytest.raises(ValueError, match="one type"):
        _check(x, w.bfloat16(), None, None, None, None, None)
    with pytest.raises(ValueError, match="columns, expected 16"):
        _check(torch.zeros(4, 12), w, None, None, None, None, None)
    with pytest.raises(ValueError, match="bias"):
        _check(x, w, torch.zeros(7), None, None, None, None)
    with pytest.raises(ValueError, match="shape and strides"):
        _check(x, w, None, torch.zeros(4, 32)[:, :16], None, None, None)
    with pytest.raises(ValueError, match="contiguous columns"):
        _check(x, w, None, torch.zeros(16, 4).t(), None, None, None)
    with pytest.raises(ValueError, match="res has 3 rows"):
        _check(x, w, None, None, None, torch.zeros(3, 8), None)
    with pytest.raises(ValueError, match="multiples of 8"):
        _check(torch.zeros(4, 12).bfloat16(), torch.zeros(8, 12).bfloat16(), None, None, None,
               None, None)
    xb = torch.zeros(4, 48).bfloat16()
    with pytest.raises(ValueError, match="multiple of 32"):
        _check(xb, torch.zeros(8, 48).bfloat16(), None, xb, None, None, None)


def test_k4_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    """A CPU tensor selects the plain version and counts no launch; any
    other device that is not CUDA raises rather than running the plain path."""
    x, w = torch.ones(3, 5, 16), torch.ones(8, 16)
    before = ln_linear.launches
    out = ln_linear(x, w, torch.zeros(8), gelu=True)
    assert out.shape == (3, 5, 8) and ln_linear.launches == before
    m = torch.zeros(3, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        ln_linear(m, torch.zeros(8, 16, device="meta"))
