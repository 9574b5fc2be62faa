"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU (a CUDA kernel
has no CPU mode). Imports nothing of JAX, so it runs on a machine with the
card and PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances for K1 and K2, on max |kernel - plain| / max(|plain|, 1): f32
with TF32 off, 1e-4 (summation order and rsqrt rounding; K2's logits reach
~116 and amplify them); bf16 2e-2 (one bf16 rounding of a stored value,
where the two sides may round apart by an ulp; K2 also rounds its weights
to bf16 for P V on the tensor cores, ~2^-9 of each). For K3, on max |kernel -
plain|: f32 1e-5; bf16 two bf16 ulps of the largest output (the weights
are rounded to bf16 for PV on both sides, and a weight whose f32 value
sits at a rounding boundary may round apart). For K4, on max |kernel -
plain| / max(|plain|, 1): f32 1e-5 (summation order); bf16 two bf16 ulps of
the largest output (each of the LayerNorm output, the product, the GELU and
the residual sum is rounded to bf16 on both sides and may round apart by an
ulp). For K5, forward and backward: f32 1e-5 of max(|plain|, 1) (summation
order; dk, dv and dbias are summed with atomics in the SIMT route); bf16 out,
dq, dk and dv within two bf16 ulps of the largest |output| (the kernel feeds
P and dS to the tensor cores in bf16, the plain version keeps them f32);
dbias (f32) within 1e-2 of its largest |value|. For K6: f32 1e-5 of
max(|plain|, 1) (summation order; cosine logits reach 100 x q^.k^ and
amplify it); bf16 two bf16 ulps of the largest |output| (the weights are
rounded to bf16 for P V on the card, not in the plain version; q^.k^ is
taken as a split bf16 hi/lo product, so the logits keep ~16 bits).
"""

import math

import pytest
import torch

from deepfake_tpu_torch.models import inception_resnet_v2 as irv2
from deepfake_tpu_torch.models.layers import BatchNorm, init_weights
from deepfake_tpu_torch.models.swin2d import shift_attn_mask
from deepfake_tpu_torch.ops.inception_block import inception_block, inception_block_plain
from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size
from deepfake_tpu_torch.ops.ln_linear_kernel import (
    MLP_TAIL_WIDTHS, ln_linear, ln_linear_plain, mlp_tail, mlp_tail_plain,
)
from deepfake_tpu_torch.ops.window_attn3d_kernel import (
    window_attn3d_tokens, window_attn3d_tokens_plain, windows_per_block,
)
from deepfake_tpu_torch.ops.window_attn3d_train import (
    window_attn3d_train, window_attn3d_train_bwd, window_attn3d_train_bwd_plain,
    window_attn3d_train_fwd, window_attn3d_train_fwd_plain, window_group,
)
from deepfake_tpu_torch.ops.window_attn_kernel import (
    window_attention_heads, window_attention_heads_plain, window_attention_tokens,
    window_attention_tokens_plain,
)
from deepfake_tpu_torch.ops.window_attn_multihead import window_attention_multihead

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    d = (got.float() - want.float()).abs()
    return (d / want.float().abs().clamp(min=1.0)).max().item()


def _block(kind, dev, gen):
    block = {"A": lambda: irv2.BlockA(0.17, True), "B": lambda: irv2.BlockB(0.10, True),
             "C": lambda: irv2.BlockC(0.20, True, True),
             "c9": lambda: irv2.BlockC(1.0, False, True)}[kind]()
    block = init_weights(block.to(dev), gen)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen, device=dev))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen, device=dev))
        block.conv.bias.copy_(0.1 * torch.randn(block.conv.bias.numel(), generator=gen,
                                                device=dev))
    return block


# (block, side, frames): small frames; the fused path's sides (A 25, B 12,
# C 5) at 33 frames, which leave a partial last row tile in every conv (the
# bf16 tap convs' boxes take 1 x 5 x 25, 5 x 2 x 12 and 5 x 5 x 5 pixels, the
# 1 x 1 convs 128 flat rows); block A's second branch reads its input from
# a column slice (channels 32-63) of the in-conv's second output, and every
# branch's last conv writes a column slice of the concat buffer
K1_CASES = {
    "A_S9": ("A", 9, 6), "B_S4": ("B", 4, 6), "C_S5": ("C", 5, 6), "c9_S5": ("c9", 5, 6),
    "A_S25": ("A", 25, 6), "A_S25_F33": ("A", 25, 33), "B_S12_F33": ("B", 12, 33),
    "C_S5_F33": ("C", 5, 33), "c9_S5_F33": ("c9", 5, 33),
    "A_S130_wide": ("A", 130, 2),  # pixel rows wider than a tile, split in two
}


def _k1_case(dev, kind, S, frames, dtype):
    gen = torch.Generator(dev).manual_seed(0)
    block = _block(kind, dev, gen)
    blk = block.pack_weights(dtype)
    C = block.conv.out_channels
    x = (0.5 * torch.randn(frames, S, S, C, generator=gen, device=dev)).to(dtype)
    return x, blk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,S,frames", list(K1_CASES.values()), ids=list(K1_CASES))
def test_k1_kernel_matches_plain(cuda_device, kind, S, frames, dtype, tol):
    x, blk = _k1_case(cuda_device, kind, S, frames, dtype)
    before = inception_block.launches
    got = inception_block(x, blk).float()
    torch.cuda.synchronize()
    assert inception_block.launches == before + 1
    want = inception_block_plain(x, blk).float()
    rel = _rel_err(got, want)
    assert math.isfinite(rel) and rel <= tol, rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k1_is_deterministic(cuda_device, dtype):
    """K1 has no atomics: two calls on the same inputs give the same bits."""
    x, blk = _k1_case(cuda_device, *K1_CASES["B_S12_F33"], dtype)
    a = inception_block(x, blk)
    b = inception_block(x, blk)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(a.view(bits), b.view(bits))


# (B_, H, shift mask (side, window, shift) or None, N, D, cosine): SwinV2-B's
# stage shapes at window 7, b1's single window (head-major only), K2's range
# (N = 16 and 64, D = 12, 16, 48, 64, 72, 96 and 128; D = 12 is no multiple
# of 8, so the kernel loads q, k, v with its threads, not by TMA; above 64
# the instance with two 64-column operands), the audio preset's
# stage 3 (window 8, N = 64, H = 32), batches that are no multiple of the
# window group, and scaled logits
K2_CASES = {
    "shifted_nW4": (8, 4, (14, 7, 3), 49, 32, True),
    "stage2": (32, 16, None, 49, 32, True),
    "single_window": (1, 32, None, 49, 32, True),
    "n16_shifted": (12, 4, (8, 4, 2), 16, 32, True),
    "n64_shifted_d64": (8, 2, (16, 8, 4), 64, 64, True),
    "audio_stage3": (8, 32, None, 64, 32, True),
    "odd_batch": (13, 4, None, 49, 32, True),
    "d16": (7, 3, None, 49, 16, True),
    "d48_n36": (5, 2, None, 36, 48, True),
    "d12_thread_loads": (6, 2, None, 49, 12, True),
    "d128_shifted": (8, 2, (14, 7, 3), 49, 128, True),
    "d96_scaled": (6, 2, None, 49, 96, False),
    "d72_n64": (4, 2, (16, 8, 4), 64, 72, True),
    "scaled_shifted": (8, 4, (14, 7, 3), 49, 32, False),
    "scaled_n64": (6, 8, None, 64, 32, False),
}


def _k2_case(dev, B_, H, mask_spec, N, D, cosine, dtype, seed=1):
    gen = torch.Generator(dev).manual_seed(seed)
    C = H * D
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(dtype)
    bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=dev))
    mask = None
    if mask_spec:
        side, ws, shift = mask_spec
        mask = torch.from_numpy(shift_attn_mask(side, side, ws, shift)).to(dev)
    if cosine:
        ls = torch.exp(torch.clamp(math.log(10.0) + 0.3 * torch.randn(
            H, 1, 1, generator=gen, device=dev), max=math.log(100.0)))
        kw = dict(bias=bias, mask=mask, logit_scale=ls)
    else:
        kw = dict(bias=bias, mask=mask, scale=D ** -0.5, cosine=False)
    return qkv, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,H,mask_spec,N,D,cosine", list(K2_CASES.values()), ids=list(K2_CASES))
def test_k2_kernel_matches_plain(cuda_device, B_, H, mask_spec, N, D, cosine, dtype, tol):
    qkv, kw = _k2_case(cuda_device, B_, H, mask_spec, N, D, cosine, dtype)
    C = H * D
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if B_ > 1:
        before = window_attention_tokens.launches
        got = window_attention_tokens(q, k, v, num_heads=H, **kw)
        torch.cuda.synchronize()
        assert window_attention_tokens.launches == before + 1
        want = window_attention_tokens_plain(q, k, v, num_heads=H, **kw)
        assert _rel_err(got, want) <= tol
    hq, hk, hv = (t.reshape(B_, N, H, D).transpose(1, 2).contiguous() for t in (q, k, v))
    before = window_attention_heads.launches
    got = window_attention_heads(hq, hk, hv, **kw)
    torch.cuda.synchronize()
    assert window_attention_heads.launches == before + 1
    want = window_attention_heads_plain(hq, hk, hv, **kw)
    assert _rel_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k2_is_deterministic(cuda_device, dtype):
    """K2 has no atomics: two calls on the same inputs give the same bits."""
    qkv, kw = _k2_case(cuda_device, *K2_CASES["shifted_nW4"], dtype)
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    a = window_attention_tokens(q, k, v, num_heads=4, **kw)
    b = window_attention_tokens(q, k, v, num_heads=4, **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.cuda
def test_k2_raises_for_windows_it_does_not_take(cuda_device):
    q = torch.zeros(1, 1, 392, 32, device=cuda_device)
    with pytest.raises(ValueError, match="N <= 64"):
        window_attention_heads(q, q, q, bias=torch.zeros(1, 392, 392), logit_scale=torch.ones(1))


def k3_tolerance(want: torch.Tensor) -> float:
    """1e-5 in f32; in bf16 two ulps of the largest |output|."""
    if want.dtype == torch.float32:
        return 1e-5
    return 2.0 * 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)


def _k3_case(dev, B_, H, masked, N, dtype):
    """q, k, v as column slices of one qkv tensor, bias [H, N, N], and the
    shift mask of a 16x14x14 (N = 392: 8 windows) or 4x14x14 (N = 196: 4
    windows) token grid, or None."""
    gen = torch.Generator(dev).manual_seed(2)
    C = 32 * H
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(dtype)
    bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
    mask = None
    if masked:
        grid = {392: (16, 14, 14), 196: (4, 14, 14)}[N]
        ws = (8, 7, 7) if N == 392 else (4, 7, 7)
        mask = torch.from_numpy(compute_mask_3d(*grid, ws, (4, 3, 3))).to(dev)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    return q, k, v, dict(num_heads=H, bias=bias, mask=mask, scale=32 ** -0.5)


# (B_, H, masked, N): Video Swin-S stage shapes (the mask has 8 windows at N =
# 392, so stage0_shifted groups 32 windows a mask index and b1 one); b3 an
# odd batch; ungrouped an unmasked launch whose B_ (prime) is not a multiple
# of the windows a block takes; N = 196 and 512 through the same schedule
# (N = 512 with one ring stage)
K3_CASES = {"stage0_shifted": (256, 3, True, 392), "stage2": (64, 12, False, 392),
            "stage3_shifted": (16, 24, True, 392), "clamped_196": (8, 2, True, 196),
            "n512": (3, 1, False, 512), "stage2_shifted_b1": (8, 12, True, 392),
            "stage2_shifted_b3": (24, 12, True, 392), "ungrouped": (1021, 3, False, 392)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,H,masked,N", list(K3_CASES.values()), ids=list(K3_CASES))
def test_k3_tokens_kernel_matches_plain(cuda_device, B_, H, masked, N, dtype):
    q, k, v, kw = _k3_case(cuda_device, B_, H, masked, N, dtype)
    if B_ == 1021:
        g = windows_per_block(B_, H, N, 1, False)
        assert g > 1 and B_ % g, g
    before = window_attn3d_tokens.launches
    got = window_attn3d_tokens(q, k, v, **kw)
    torch.cuda.synchronize()
    assert window_attn3d_tokens.launches == before + 1
    want = window_attn3d_tokens_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= k3_tolerance(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_is_deterministic(cuda_device, dtype):
    """K3 has no atomics: two calls on the same inputs give the same bits."""
    q, k, v, kw = _k3_case(cuda_device, *K3_CASES["stage0_shifted"], dtype)
    a = window_attn3d_tokens(q, k, v, **kw)
    b = window_attn3d_tokens(q, k, v, **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(a.view(bits), b.view(bits))


# Windows of more than 512 tokens, which K3 and K5 stream in key (or query)
# tiles: N (token grid, window, shift): (5, 11, 11) = 605 (N % 8 != 0: K3's
# and K5's forward fill the bias + mask slices with their threads, not by
# TMA), (10, 8, 8) = 640, Video Swin-B's Something-Something v2 window
# (16, 7, 7) = 784 on a 32-frame clip's 16 temporal tokens (the temporal
# shift clamps to 0), and (16, 8, 8) = 1024; each shifted (4 masks: B_ = 8
# is two clips) or not
LONG_WINDOWS = {605: ((5, 22, 22), (5, 11, 11), (2, 5, 5)),
                640: ((10, 16, 16), (10, 8, 8), (5, 4, 4)),
                784: ((16, 14, 14), (16, 7, 7), (8, 3, 3)),
                1024: ((16, 16, 16), (16, 8, 8), (8, 4, 4))}


def _long_window_case(dev, N, shifted, dtype, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    B_, H = 8, 2
    C = 32 * H
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(dtype)
    dout = torch.randn(B_, N, C, generator=gen, device=dev).to(dtype)
    bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
    mask = None
    if shifted:
        grid, window, shift = LONG_WINDOWS[N]
        ws, ss = get_window_size(grid, window, shift)
        assert ws[0] * ws[1] * ws[2] == N and ss[0] == 0 and ss[1] > 0
        mask = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev)
        assert B_ % mask.shape[0] == 0
    return qkv, dout, dict(num_heads=H, bias=bias, mask=mask, scale=32 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shifted", [True, False], ids=["shifted", "unshifted"])
@pytest.mark.parametrize("N", sorted(LONG_WINDOWS), ids=[f"n{n}" for n in sorted(LONG_WINDOWS)])
def test_k3_k5_long_windows_match_plain(cuda_device, N, shifted, dtype):
    """K3, K5's forward and backward, and K5 through its autograd Function at
    N > 512, against the plain versions in the tolerances above."""
    qkv, dout, kw = _long_window_case(cuda_device, N, shifted, dtype, seed=21)
    C = qkv.shape[-1] // 3
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    before = (window_attn3d_tokens.launches, window_attn3d_train_fwd.launches,
              window_attn3d_train_bwd.launches)
    got3 = window_attn3d_tokens(q, k, v, **kw)
    out = window_attn3d_train_fwd(qkv, **kw)
    dqkv, dbias = window_attn3d_train_bwd(qkv, dout, **kw)
    torch.cuda.synchronize()
    assert (window_attn3d_tokens.launches, window_attn3d_train_fwd.launches,
            window_attn3d_train_bwd.launches) == tuple(b + 1 for b in before)
    want3 = window_attn3d_tokens_plain(q, k, v, **kw)
    err = (got3.float() - want3.float()).abs().max().item()
    assert math.isfinite(err) and err <= k3_tolerance(want3), ("k3", err)
    want = [window_attn3d_train_fwd_plain(q, k, v, **kw),
            *window_attn3d_train_bwd_plain(q, k, v, dout, **kw)]
    got = [out, *dqkv.split(C, dim=-1), dbias]
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        tol = k5_tolerance(b, dbias=name == "dbias" and dtype == torch.bfloat16)
        assert math.isfinite(err) and err <= tol, (name, err, tol)
    x, b_ = qkv.clone().requires_grad_(), kw["bias"].clone().requires_grad_()
    o = window_attn3d_train(x, bias=b_, num_heads=kw["num_heads"], mask=kw["mask"],
                            scale=kw["scale"])
    o.backward(dout)
    torch.cuda.synchronize()
    assert torch.equal(o.detach(), out)
    big = dqkv.float().abs().max().item()
    assert torch.allclose(x.grad.float(), dqkv.float(), rtol=0, atol=1e-5 * big)
    assert (b_.grad - dbias).abs().max().item() <= 1e-5 * dbias.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_k5_forward_is_deterministic_n784(cuda_device, dtype):
    """No atomics in K3 or K5's forward at N = 784 either: two calls, the
    same bits."""
    qkv, _, kw = _long_window_case(cuda_device, 784, True, dtype, seed=22)
    C = qkv.shape[-1] // 3
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    a, b = window_attn3d_tokens(q, k, v, **kw), window_attn3d_tokens(q, k, v, **kw)
    c, d = window_attn3d_train_fwd(qkv, **kw), window_attn3d_train_fwd(qkv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(bits), b.view(bits)) and torch.equal(c.view(bits), d.view(bits))


def k4_tolerance(want: torch.Tensor) -> float:
    """1e-5 of max(|plain|, 1) in f32; in bf16 two ulps of the largest |output|."""
    big = want.float().abs().max().item()
    if want.dtype == torch.float32:
        return 1e-5 * max(big, 1.0)
    return 2.0 * 2.0 ** (math.floor(math.log2(big)) - 7)


# (rows, K, N, role): Video Swin-S stage 0 and stage 3 widths, and the whole
# MLP tail (mlp_tail: one launch at C <= 384, two at 768) at the four stage
# widths; Video Swin-L's stage 3 (C = 1536: rows too wide for a panel, the
# LayerNorm applied to each A atom as it lands) and K = 1056 (a partial last
# 64-column atom); the row counts are not multiples of the 64-row tile
K4_CASES = [(4100, 96, 288, "ln_qkv"), (4100, 96, 96, "proj"), (4100, 96, 384, "sum_ln_fc1_gelu"),
            (4100, 384, 96, "fc2_residual_pair"), (1000, 768, 2304, "ln_qkv"),
            (1000, 3072, 768, "fc2_residual_pair"), (4100, 96, 96, "mlp_tail"),
            (2050, 192, 192, "mlp_tail"), (1000, 384, 384, "mlp_tail"),
            (1000, 768, 768, "mlp_tail"), (1000, 1536, 4608, "ln_qkv"),
            (1000, 1536, 6144, "sum_ln_fc1_gelu"), (1000, 6144, 1536, "fc2_residual_pair"),
            (1000, 1536, 1536, "mlp_tail"), (200, 1056, 96, "sum_ln_fc1_gelu")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,role", K4_CASES,
                         ids=[f"{r}_{m}x{k}x{n}" for m, k, n, r in K4_CASES])
def test_k4_kernel_matches_plain(cuda_device, M, K, N, role, dtype):
    gen = torch.Generator(cuda_device).manual_seed(4)
    rnd = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=gen, device=cuda_device)).to(dtype)
    x = rnd(M, K)
    if role == "mlp_tail":
        C = K
        h = rnd(M, C)
        args = ((1 + rnd(C, scale=0.2), rnd(C, scale=0.5), 1e-6), rnd(4 * C, C, scale=C ** -0.5),
                rnd(4 * C, scale=0.5), rnd(C, 4 * C, scale=(4 * C) ** -0.5), rnd(C, scale=0.5))
        one = dtype == torch.bfloat16 and C in MLP_TAIL_WIDTHS
        before = mlp_tail.launches, ln_linear.launches
        got = mlp_tail(x, h, *args)
        torch.cuda.synchronize()
        assert (mlp_tail.launches, ln_linear.launches) == (
            before[0] + one, before[1] + 2 * (not one))
        want = mlp_tail_plain(x, h, *args)
        err = (got.float() - want.float()).abs().max().item()
        assert math.isfinite(err) and err <= k4_tolerance(want), err
        return
    w, b = rnd(N, K, scale=K ** -0.5), rnd(N, scale=0.5)
    kw = {}
    if role in ("ln_qkv", "sum_ln_fc1_gelu"):
        kw["ln"] = (1 + rnd(K, scale=0.2), rnd(K, scale=0.5), 1e-6)
    if role == "sum_ln_fc1_gelu":
        kw.update(x2=rnd(M, K), gelu=True)
    if role == "fc2_residual_pair":
        kw.update(res=rnd(M, N), res2=rnd(M, N))
    before = ln_linear.launches
    got = ln_linear(x, w, b, **kw)
    torch.cuda.synchronize()
    assert ln_linear.launches == before + 1
    want = ln_linear_plain(x, w, b, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= k4_tolerance(want), err


@pytest.mark.cuda
def test_k4_raises_for_shapes_it_does_not_take(cuda_device):
    x = torch.zeros(4, 12, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_linear(x, torch.zeros(8, 12, device=cuda_device, dtype=torch.bfloat16))


def k5_tolerance(want: torch.Tensor, dbias: bool = False) -> float:
    big = want.float().abs().max().item()
    if dbias:
        return 1e-2 * big
    if want.dtype == torch.float32:
        return 1e-5 * max(big, 1.0)
    return 2.0 * 2.0 ** (math.floor(math.log2(big)) - 7)


# (B_, H, N, token grid or None): the Video Swin-S stages at b8 x 32 frames of
# 224 (grid (16, 56 / 2^i, 56 / 2^i)), shifted and not, and at b1 (B_ = nW:
# one window per mask index, so a group shares nothing); an odd batch (B_ =
# 3 nW); an unmasked prime B_ that no window group divides; windows clamped
# to 196 and 98 tokens (the last 64-row tile partial); N = 512 (launch 1
# without its dbias slab)
K5_CASES = [(1024, 3, 392, (16, 56, 56)), (1024, 3, 392, None), (256, 6, 392, (16, 28, 28)),
            (256, 6, 392, None), (64, 12, 392, None), (64, 12, 392, (16, 14, 14)),
            (16, 24, 392, (16, 7, 7)), (16, 24, 392, None), (128, 3, 392, (16, 56, 56)),
            (24, 12, 392, (16, 14, 14)), (1021, 3, 392, None), (8, 2, 196, (4, 14, 14)),
            (3, 1, 512, None), (128, 3, 392, None), (32, 6, 392, (16, 28, 28)),
            (32, 6, 392, None), (8, 12, 392, (16, 14, 14)), (8, 12, 392, None),
            (2, 24, 392, (16, 7, 7)), (2, 24, 392, None), (8, 2, 98, (2, 14, 14))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,H,N,grid", K5_CASES, ids=[
    "stage0_shifted", "stage0", "stage1_shifted", "stage1", "stage2", "stage2_shifted",
    "stage3_shifted", "stage3", "b1_stage0_shifted", "b3_stage2_shifted", "ungrouped_1021",
    "clamped_196", "n512", "b1_stage0", "b1_stage1_shifted", "b1_stage1", "b1_stage2_shifted",
    "b1_stage2", "b1_stage3_shifted", "b1_stage3", "clamped_98"])
def test_k5_kernel_matches_plain(cuda_device, B_, H, N, grid, dtype):
    gen = torch.Generator(cuda_device).manual_seed(5)
    C = 32 * H
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=cuda_device).to(dtype)
    dout = torch.randn(B_, N, C, generator=gen, device=cuda_device).to(dtype)
    bias = 0.5 * torch.randn(H, N, N, generator=gen, device=cuda_device)
    mask = None
    if grid is not None:
        ws, ss = get_window_size(grid, (8, 7, 7), (4, 3, 3))
        mask = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(cuda_device, torch.bfloat16)
        assert B_ % mask.shape[0] == 0 and ws[0] * ws[1] * ws[2] == N
    kw = dict(num_heads=H, bias=bias, mask=mask, scale=32 ** -0.5)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    before = window_attn3d_train_fwd.launches, window_attn3d_train_bwd.launches
    out = window_attn3d_train_fwd(qkv, **kw)
    dqkv, dbias = window_attn3d_train_bwd(qkv, dout, **kw)
    torch.cuda.synchronize()
    assert (window_attn3d_train_fwd.launches, window_attn3d_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = [window_attn3d_train_fwd_plain(q, k, v, **kw),
            *window_attn3d_train_bwd_plain(q, k, v, dout, **kw)]
    got = [out, *dqkv.split(C, dim=-1), dbias]
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        tol = k5_tolerance(b, dbias=name == "dbias" and dtype == torch.bfloat16)
        assert math.isfinite(err) and err <= tol, (name, err, tol)
    if B_ == 1021:  # a prime: a bf16 launch's last block of the group takes fewer windows
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        g = window_group(B_, H, N, 1, False, sms)
        assert g > 1 and B_ % g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_autograd_function_launches_the_kernels(cuda_device, dtype):
    """Through the autograd Function a CUDA tensor runs K5 both ways, and the
    gradients are the kernels' own: dq | dk | dv in one tensor, dbias f32."""
    gen = torch.Generator(cuda_device).manual_seed(6)
    B_, H, N = 16, 2, 392
    C = 32 * H
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=cuda_device).to(dtype)
    bias = 0.5 * torch.randn(H, N, N, generator=gen, device=cuda_device)
    dout = torch.randn(B_, N, C, generator=gen, device=cuda_device).to(dtype)
    kw = dict(num_heads=H, mask=None, scale=32 ** -0.5)
    before = window_attn3d_train_fwd.launches, window_attn3d_train_bwd.launches
    x, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    window_attn3d_train(x, bias=b, **kw).backward(dout)
    torch.cuda.synchronize()
    assert (window_attn3d_train_fwd.launches, window_attn3d_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    dqkv, dbias = window_attn3d_train_bwd(qkv, dout, bias=bias, **kw)
    assert x.grad.shape == qkv.shape and b.grad.dtype == torch.float32
    big = dqkv.float().abs().max().item()
    assert torch.allclose(x.grad.float(), dqkv.float(), rtol=0, atol=1e-5 * big)
    assert (b.grad - dbias).abs().max().item() <= 1e-5 * dbias.abs().max().item()


def _k5_inputs(dev, B_, H, N, grid, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    C = 32 * H
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
    bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
    mask = None
    if grid is not None:
        ws, ss = get_window_size(grid, (8, 7, 7), (4, 3, 3))
        mask = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
        assert B_ % mask.shape[0] == 0 and ws[0] * ws[1] * ws[2] == N
    return qkv, dict(num_heads=H, bias=bias, mask=mask, scale=32 ** -0.5)


@pytest.mark.cuda
def test_k5_forward_is_deterministic(cuda_device):
    """Two bf16 forward launches on the same inputs give the same bits."""
    qkv, kw = _k5_inputs(cuda_device, 1024, 3, 392, (16, 56, 56), seed=12)
    a = window_attn3d_train_fwd(qkv, **kw)
    b = window_attn3d_train_fwd(qkv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_k5_autograd_forward_and_backward_match_plain(cuda_device):
    """Through WindowAttn3DTrain.apply at a shifted b8 stage-2 shape, bf16:
    the forward (the new kernel) and the gradients of its backward against
    the plain versions, in the tolerances above."""
    B_, H, N = 64, 12, 392
    C = 32 * H
    qkv, kw = _k5_inputs(cuda_device, B_, H, N, (16, 14, 14), seed=13)
    gen = torch.Generator(cuda_device).manual_seed(14)
    dout = torch.randn(B_, N, C, generator=gen, device=cuda_device).to(torch.bfloat16)
    x = qkv.clone().requires_grad_()
    b = kw["bias"].clone().requires_grad_()
    before = window_attn3d_train_fwd.launches, window_attn3d_train_bwd.launches
    out = window_attn3d_train(x, bias=b, num_heads=H, mask=kw["mask"], scale=kw["scale"])
    out.backward(dout)
    torch.cuda.synchronize()
    assert (window_attn3d_train_fwd.launches, window_attn3d_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    want = [window_attn3d_train_fwd_plain(q, k, v, **kw),
            *window_attn3d_train_bwd_plain(q, k, v, dout, **kw)]
    got = [out.detach(), *x.grad.split(C, dim=-1), b.grad]
    for name, g_, w_ in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = (g_.float() - w_.float()).abs().max().item()
        assert math.isfinite(err) and err <= k5_tolerance(w_, dbias=name == "dbias"), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("N,grid", [(392, (8, 14, 14)), (784, (16, 14, 14))],
                         ids=["n392", "n784_streamed"])
@pytest.mark.parametrize("D", [32, 64], ids=["d32", "d64"])
def test_k5_huge_logits_match_plain(cuda_device, N, grid, D):
    """Logits of ~1e12, as a diverging training run gives them (Video
    Swin-S from the init's zero biases, whose augmented clips' zero-filled
    windows reach the second step with every token equal at ~2e6): windows
    of one repeated token, where every weight is 1/N, and windows of
    distinct tokens at ~1e4 (logits ~1e8, nearly one-hot), bf16. Every
    gradient is finite; out and dv, which no cancellation touches, hold the
    plain version's tolerance; dq, dk and dbias, where dS = P (dP - D) is a
    cancellation, stay within 2^-6 of their terms' size."""
    gen = torch.Generator(cuda_device).manual_seed(21)
    B_, H = 4, 2
    C = D * H
    same = 2e6 * torch.randn(B_ // 2, 1, 3 * C, generator=gen, device=cuda_device)
    spread = 1e4 * torch.randn(B_ // 2, N, 3 * C, generator=gen, device=cuda_device)
    qkv = torch.cat([same.expand(-1, N, -1), spread]).to(torch.bfloat16)
    dout = torch.randn(B_, N, C, generator=gen, device=cuda_device).to(torch.bfloat16)
    ws, ss = get_window_size(grid, (grid[0], 7, 7), (grid[0] // 2, 3, 3))
    mask = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(cuda_device, torch.bfloat16)
    kw = dict(num_heads=H, bias=0.02 * torch.randn(H, N, N, generator=gen, device=cuda_device),
              mask=mask[:B_], scale=D ** -0.5)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    out = window_attn3d_train_fwd(qkv, **kw)
    dqkv, dbias = window_attn3d_train_bwd(qkv, dout, **kw)
    want = [window_attn3d_train_fwd_plain(q, k, v, **kw),
            *window_attn3d_train_bwd_plain(q, k, v, dout, **kw)]
    got = [out, *dqkv.split(C, dim=-1), dbias]
    amax = lambda t: t.float().abs().max().item()
    dp = amax(dout) * amax(v) * D  # |dP| at most
    terms = {"dq": dp * amax(k) * kw["scale"], "dk": dp * amax(q) * kw["scale"],
             "dbias": dp * B_}
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        assert bool(torch.isfinite(a).all()), name
        err = (a.float() - b.float()).abs().max().item()
        tol = 2.0 ** -6 * terms[name] if name in terms else k5_tolerance(b)
        assert err <= tol, (name, err, tol)


# (B_, H, N, mask grid side or None, cosine): SwinV2-B at window 16, 256^2, b8:
# stage 0 (16 masks) and stage 1 (4 masks) shifted and not, stage 2 (one
# window an image); the scaled form at N = 392
K6_CASES = [(128, 4, 256, 64, True), (128, 4, 256, None, True), (32, 8, 256, 32, True),
            (32, 8, 256, None, True), (8, 16, 256, None, True), (16, 3, 392, None, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,H,N,side,cosine", K6_CASES, ids=[
    "stage0_shifted", "stage0", "stage1_shifted", "stage1", "stage2", "scaled_392"])
def test_k6_kernel_matches_plain(cuda_device, B_, H, N, side, cosine, dtype):
    """K6 on q, k, v read out of one [B_, N, 3C] qkv tensor by strides, as
    SwinV2 passes them, with logit scales from 10 up to the clamp (100)."""
    gen = torch.Generator(cuda_device).manual_seed(7)
    C = 32 * H
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=cuda_device).to(dtype)
    q, k, v = qkv.view(B_, N, 3, H, 32).permute(2, 0, 3, 1, 4).unbind(0)
    mask = None
    if side is not None:
        mask = torch.from_numpy(shift_attn_mask(side, side, 16, 8)).to(cuda_device)
    if cosine:
        kw = dict(bias=16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=cuda_device)),
                  mask=mask, logit_scale=torch.exp(torch.linspace(
                      math.log(10.0), math.log(100.0), H, device=cuda_device)).reshape(H, 1, 1))
    else:
        kw = dict(bias=0.5 * torch.randn(H, N, N, generator=gen, device=cuda_device),
                  scale=32 ** -0.5, cosine=False)
    before = window_attention_multihead.launches
    got = window_attention_multihead(q, k, v, **kw)
    torch.cuda.synchronize()
    assert window_attention_multihead.launches == before + 1
    want = window_attention_heads_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= k4_tolerance(want), err
    # the result is a head-major view of a token-major [B_, N, C] tensor
    assert got.transpose(1, 2).is_contiguous()


# (window side, windows B_, heads): SwinV2's windows above K2's range that the
# kernels took only once K6 was widened: windows 9-11 (N = 81-121), window 24
# (N = 576, the 384^2 fine-tunes) and window 32 (N = 1024, four key tiles)
K6_RANGE_CASES = [(9, 8, 4), (10, 8, 4), (11, 8, 4), (24, 8, 2), (32, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["tokens", "heads"])
@pytest.mark.parametrize("ws,B_,H", K6_RANGE_CASES,
                         ids=[f"N{ws * ws}" for ws, _, _ in K6_RANGE_CASES])
def test_k6_range_matches_plain(cuda_device, ws, B_, H, layout, dtype):
    """K6 at N = 81, 100, 121, 576 and 1024, cosine with the shift masks of
    a 2x2-window grid and logit scales from 10 up to the clamp, in both of
    SwinV2's layouts: q, k, v read out of one [B_, N, 3C] qkv tensor by
    strides (token-major) and contiguous head-major tensors."""
    gen = torch.Generator(cuda_device).manual_seed(9)
    N, C = ws * ws, 32 * H
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=cuda_device).to(dtype)
    q, k, v = qkv.view(B_, N, 3, H, 32).permute(2, 0, 3, 1, 4).unbind(0)
    if layout == "heads":
        q, k, v = (t.contiguous() for t in (q, k, v))
    mask = torch.from_numpy(shift_attn_mask(2 * ws, 2 * ws, ws, ws // 2)).to(cuda_device)
    kw = dict(bias=16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=cuda_device)),
              mask=mask, logit_scale=torch.exp(torch.linspace(
                  math.log(10.0), math.log(100.0), H, device=cuda_device)).reshape(H, 1, 1))
    before = window_attention_multihead.launches
    got = window_attention_multihead(q, k, v, **kw)
    torch.cuda.synchronize()
    assert window_attention_multihead.launches == before + 1
    want = window_attention_heads_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= k4_tolerance(want), err


def _k6_inputs(dev, N, cosine, masked, layout, seed):
    """8 windows (2 images of a 2x2-window grid), 2 heads: q, k, v as
    head-major views of one token-major qkv tensor, or contiguous head-major
    tensors; logit scales 10 and 100 (cosine) or D^-0.5 (scaled)."""
    gen = torch.Generator(dev).manual_seed(seed)
    ws, B_, H = math.isqrt(N), 8, 2
    qkv = torch.randn(B_, N, 3 * 32 * H, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.view(B_, N, 3, H, 32).permute(2, 0, 3, 1, 4).unbind(0)
    if layout == "heads":
        q, k, v = (t.contiguous() for t in (q, k, v))
    mask = None
    if masked:
        mask = torch.from_numpy(shift_attn_mask(2 * ws, 2 * ws, ws, ws // 2)).to(dev)
    if cosine:
        kw = dict(bias=16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=dev)),
                  mask=mask, logit_scale=torch.tensor([10.0, 100.0], device=dev).reshape(H, 1, 1))
    else:
        kw = dict(bias=0.5 * torch.randn(H, N, N, generator=gen, device=dev), mask=mask,
                  scale=32 ** -0.5, cosine=False)
    return q, k, v, kw


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("layout", ["tokens", "heads"])
@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "scaled"])
@pytest.mark.parametrize("N", [81, 100, 121, 256, 576])
def test_k6_forms_and_layouts_match_plain(cuda_device, N, cosine, layout, masked):
    """K6's bf16 kernel at N = 81, 100, 121, 256 and 576, with cosine (logit
    scale up to 100) and scaled logits, on head-major views of one token-major
    qkv tensor and on head-major tensors, with and without the shift mask,
    against the plain version within two bf16 ulps of the largest |output|."""
    q, k, v, kw = _k6_inputs(cuda_device, N, cosine, masked, layout, seed=15)
    before = window_attention_multihead.launches
    got = window_attention_multihead(q, k, v, **kw)
    torch.cuda.synchronize()
    assert window_attention_multihead.launches == before + 1
    want = window_attention_heads_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= k4_tolerance(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("N", [256, 576])
def test_k6_is_deterministic(cuda_device, N):
    """Two bf16 launches on the same inputs give the same bits."""
    q, k, v, kw = _k6_inputs(cuda_device, N, True, True, "tokens", seed=16)
    a = window_attention_multihead(q, k, v, **kw)
    b = window_attention_multihead(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_raises_for_windows_it_does_not_take(cuda_device):
    """K2's windows (N <= 64) and head dims above 128 raise before any
    launch; nothing falls back to the plain version."""
    before = window_attention_multihead.launches
    q = torch.zeros(2, 1, 64, 32, device=cuda_device)
    with pytest.raises(ValueError, match="N >= 65"):
        window_attention_multihead(q, q, q, bias=torch.zeros(1, 64, 64),
                                   logit_scale=torch.ones(1, 1, 1))
    q = torch.zeros(2, 1, 100, 129, device=cuda_device)
    with pytest.raises(ValueError, match="head dims 1 to 128"):
        window_attention_multihead(q, q, q, bias=torch.zeros(1, 100, 100),
                                   logit_scale=torch.ones(1, 1, 1))
    assert window_attention_multihead.launches == before


# Head dims other than 32 (Video Swin's and SwinV2-B's), every kernel of
# window attention in the tolerances above: K3 and K5 at Video Swin's
# stage-0 windows (N = 392, shifted: 8 masks, 2 clips), K6 at SwinV2's
# window 16 (N = 256, shifted: 4 masks); K2's are in K2_CASES. bf16 at these
# head dims runs the mma.sync kernels (csrc/window_attn_mma.cuh), K5's
# forward and backward among them, at the plain versions' cast points. Head
# dims that are not a multiple of 8 (12, 20, 36) take its element-by-element
# loads; K3 and K5 run them with 3 heads, so that a qkv row (9 D elements)
# is not a multiple of 8 either (108 at D = 12).
HEAD_DIMS = (12, 16, 20, 36, 48, 64, 128)


def _head_dim_heads(D):
    return 2 if D % 8 == 0 else 3


def _head_dim_qkv(dev, B_, H, N, D, dtype, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    qkv = torch.randn(B_, N, 3 * H * D, generator=gen, device=dev).to(dtype)
    return gen, qkv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_k3_head_dims_match_plain(cuda_device, D, dtype):
    B_, H, N = 16, _head_dim_heads(D), 392
    gen, qkv = _head_dim_qkv(cuda_device, B_, H, N, D, dtype, seed=21)
    C = H * D
    mask = torch.from_numpy(compute_mask_3d(16, 14, 14, (8, 7, 7), (4, 3, 3))).to(cuda_device)
    kw = dict(num_heads=H, bias=0.5 * torch.randn(H, N, N, generator=gen, device=cuda_device),
              mask=mask, scale=D ** -0.5)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    before = window_attn3d_tokens.launches
    got = window_attn3d_tokens(q, k, v, **kw)
    torch.cuda.synchronize()
    assert window_attn3d_tokens.launches == before + 1
    want = window_attn3d_tokens_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= k3_tolerance(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_k5_head_dims_match_plain(cuda_device, D, dtype):
    B_, H, N = 16, _head_dim_heads(D), 392
    gen, qkv = _head_dim_qkv(cuda_device, B_, H, N, D, dtype, seed=22)
    C = H * D
    dout = torch.randn(B_, N, C, generator=gen, device=cuda_device).to(dtype)
    mask = torch.from_numpy(compute_mask_3d(16, 14, 14, (8, 7, 7), (4, 3, 3))).to(
        cuda_device, torch.bfloat16)
    kw = dict(num_heads=H, bias=0.5 * torch.randn(H, N, N, generator=gen, device=cuda_device),
              mask=mask, scale=D ** -0.5)
    before = window_attn3d_train_fwd.launches, window_attn3d_train_bwd.launches
    out = window_attn3d_train_fwd(qkv, **kw)
    dqkv, dbias = window_attn3d_train_bwd(qkv, dout, **kw)
    torch.cuda.synchronize()
    assert (window_attn3d_train_fwd.launches, window_attn3d_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    want = [window_attn3d_train_fwd_plain(q, k, v, **kw),
            *window_attn3d_train_bwd_plain(q, k, v, dout, **kw)]
    got = [out, *dqkv.split(C, dim=-1), dbias]
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        tol = k5_tolerance(b, dbias=name == "dbias" and dtype == torch.bfloat16)
        assert math.isfinite(err) and err <= tol, (name, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["tokens", "heads"])
@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "scaled"])
@pytest.mark.parametrize("ws", [16, 10], ids=["N256", "N100"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_k6_head_dims_match_plain(cuda_device, D, ws, cosine, layout, dtype):
    """K6 at windows of 16 and 10 (N = 256 and 100: a partial last 64-row
    tile), q, k, v as views of one qkv tensor or contiguous head-major."""
    B_, H, N = 8, 2, ws * ws
    gen, qkv = _head_dim_qkv(cuda_device, B_, H, N, D, dtype, seed=23)
    q, k, v = qkv.view(B_, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    if layout == "heads":
        q, k, v = (t.contiguous() for t in (q, k, v))
    mask = torch.from_numpy(shift_attn_mask(2 * ws, 2 * ws, ws, ws // 2)).to(cuda_device)
    bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=cuda_device))
    if cosine:
        kw = dict(bias=bias, mask=mask, logit_scale=torch.tensor(
            [10.0, 100.0], device=cuda_device).reshape(H, 1, 1))
    else:
        kw = dict(bias=bias, mask=mask, scale=D ** -0.5, cosine=False)
    before = window_attention_multihead.launches
    got = window_attention_multihead(q, k, v, **kw)
    torch.cuda.synchronize()
    assert window_attention_multihead.launches == before + 1
    want = window_attention_heads_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= k4_tolerance(want), err


# ------------------------------------------------------------- CUDA graphs

# small geometries of the five modalities (2 frames of 96^2 for IRv2, a 56^2
# mel image for SwinV2 at head dim 32, a 2-layer 64-wide wav2vec2, Video
# Swin at 16 x 56^2 with head dim 32), 1 s PCM buckets
GRAPH_BASE = {"data.num_frames": 2, "data.frame_size": 96, "data.audio_size": 56,
              "data.wave_seconds_buckets": (1.0,), "model.swin2d_embed_dim": 64,
              "model.swin2d_depths": (2, 2), "model.swin2d_heads": (2, 4),
              "model.wav_layers": 2, "model.wav_hidden": 64, "model.wav_heads": 4,
              "model.wav_intermediate": 128, "model.wav_conv_dim": 64}
GRAPH_VIDEO_SWIN = {"data.num_frames": 16, "data.frame_size": 56,
                    "model.swin3d_embed_dim": 64, "model.swin3d_depths": (2, 2),
                    "model.swin3d_heads": (2, 4), "model.num_hiddens": 16}
MODALITIES = ["fused", "video", "audio", "paudio", "video_swin"]


def _graph_cfg(modality, dtype):
    from deepfake_tpu_torch.config import Config

    cfg = Config()
    for k, v in dict(GRAPH_BASE, **(GRAPH_VIDEO_SWIN if modality == "video_swin" else {}),
                     **{"data.modality": modality}).items():
        cfg.set(k, v)
    cfg.set("parallel.compute_dtype", "float32" if dtype == torch.float32 else "bfloat16")
    return cfg


def _model_request(cfg, batch, dev, seed, scale=0.5):
    from deepfake_tpu_torch.models.registry import example_inputs

    gen = torch.Generator(dev).manual_seed(seed)
    (zeros,) = example_inputs(cfg, batch, dev)
    rnd = lambda z: scale * torch.randn(z.shape, generator=gen, device=dev)
    return tuple(rnd(z) for z in zeros) if isinstance(zeros, tuple) else rnd(zeros)


def _raw_request(cfg, batch, dev, seed):
    """The dataset's raw dict for the modality: uint8 frames, bucket-padded
    PCM with valid lengths drawn in the bucket's second half."""
    gen = torch.Generator(dev).manual_seed(seed)
    sr = cfg.data.wave_sample_rate
    T = int(cfg.data.wave_seconds_buckets[0] * sr)
    lengths = torch.randint(T // 2, T + 1, (batch,), generator=gen, device=dev)
    wave = 0.1 * torch.randn(batch, T, generator=gen, device=dev)
    wave = wave * (torch.arange(T, device=dev)[None] < lengths[:, None])
    t, side = cfg.data.num_frames, cfg.data.frame_size
    video = torch.randint(0, 256, (batch, t, side, side, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    m = cfg.data.modality
    feats = {}
    if m in ("fused", "video", "video_swin"):
        feats["video"] = video
    if m in ("fused", "audio"):
        feats.update(audio_wave=wave, audio_len=lengths)
    if m in ("fused", "paudio"):
        feats.update(paudio_wave=wave, paudio_len=lengths)
    return feats


def _predictor_pair(cfg, dev):
    from deepfake_tpu_torch.serving import Predictor

    eager = Predictor(cfg, device=dev, compiled=False)
    graph = Predictor(cfg, device=dev)
    for (n1, a), (n2, b) in zip(eager.model.state_dict().items(),
                                graph.model.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b), n1
    return eager, graph


def _outputs(pred, request, raw=False):
    """The logits (and video_swin's per-frame features) of one request."""
    out = pred.forward(request, return_logits=True, raw=raw)
    return out if isinstance(out, tuple) else (out,)


def _assert_graph_equals_eager(graph, eager, reqs, raw=False):
    """Scores, logits and features through one graph == the eager route's,
    to the bit (the same kernels in the same order), for each request in
    turn; the first two requests' logits differ, so a graph that replayed a
    stale input buffer would show."""
    import numpy as np

    call = (lambda p, r: p.predict_raw(r)) if raw else (lambda p, r: p.predict(r))
    logits = []
    for r in reqs:
        got, want = call(graph, r), call(eager, r)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
        outs = _outputs(graph, r, raw)
        for g, w in zip(outs, _outputs(eager, r, raw)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        logits.append(outs[0])
    assert not torch.equal(logits[0], logits[1])
    assert len(graph.graphs.graphs) == 1 and eager.graphs is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8], ids=["b1", "b8"])
@pytest.mark.parametrize("modality", MODALITIES)
def test_graph_matches_eager(cuda_device, modality, batch, dtype):
    """predict and forward through a CUDA graph == the eager route, to the
    bit, for two different requests through one graph and the first again;
    one graph for the one shape; forward's outputs are copies that the next
    replay leaves alone. The second request is drawn at four times the
    first's scale: the video model's logits move little with its input at
    these random weights, and two requests of one scale can round to one
    bf16 logit at b1."""
    eager, graph = _predictor_pair(_graph_cfg(modality, dtype), cuda_device)
    reqs = [_model_request(eager.cfg, batch, cuda_device, 31),
            _model_request(eager.cfg, batch, cuda_device, 32, scale=2.0)]
    assert graph.predict(reqs[0]).shape == (batch,)
    _assert_graph_equals_eager(graph, eager, [*reqs, reqs[0]])
    fwd = _outputs(graph, reqs[1])
    first = [t.clone() for t in fwd]
    graph.predict(reqs[0])
    for a, b in zip(fwd, first):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("modality", ["fused", "video", "audio", "paudio", "video_swin"])
def test_graph_predict_raw_matches_eager(cuda_device, modality, dtype):
    """predict_raw (front end and model in one graph) == the eager route, to
    the bit, for requests whose valid lengths differ within one PCM bucket:
    one graph."""
    eager, graph = _predictor_pair(_graph_cfg(modality, dtype), cuda_device)
    reqs = [_raw_request(eager.cfg, 2, cuda_device, seed) for seed in (41, 42, 43)]
    if "audio_len" in reqs[0] or "paudio_len" in reqs[0]:
        key = "audio_len" if "audio_len" in reqs[0] else "paudio_len"
        assert len({tuple(r[key].tolist()) for r in reqs}) == 3
    assert graph.predict_raw(reqs[0]).shape == (2,)
    _assert_graph_equals_eager(graph, eager, reqs, raw=True)


@pytest.mark.cuda
def test_graph_mel_image_keeps_full_f32_products(cuda_device):
    """TF32 is on for the process here, and the mel front end turns it off
    around its products (full_f32_matmul): the mel image from a captured
    graph equals the eager one, so the graph recorded the f32 math mode."""
    from deepfake_tpu_torch.compiled import GraphCache
    from deepfake_tpu_torch.data.pipeline import FeatureAssembler

    cfg = _graph_cfg("audio", torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fa = FeatureAssembler(cfg, device=cuda_device)
        feats = _raw_request(cfg, 2, cuda_device, 44)
        zeros = torch.zeros(1, device=cuda_device)  # labels: no host copy under capture
        fn = lambda f: fa(f, zeros)[0]
        with torch.inference_mode():
            want = fn(feats).clone()
            got = GraphCache(cuda_device).run(("raw", "audio", 0), fn, feats).clone()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_graph_new_shape_captures_a_second_graph(cuda_device):
    eager, graph = _predictor_pair(_graph_cfg("audio", torch.bfloat16), cuda_device)
    for batch in (2, 3, 2):
        graph.predict(_model_request(eager.cfg, batch, cuda_device, 51))
    assert len(graph.graphs.graphs) == 2
    graph.predict_raw(_raw_request(eager.cfg, 2, cuda_device, 52))
    assert len(graph.graphs.graphs) == 3 and graph.graphs.pool_bytes() > 0


def _handwritten_kernels(fn, tries: int = 5):
    """The hand-written kernels that one call of ``fn`` runs, by name
    (torch.profiler): every __global__ function of csrc/ sits in namespace
    hop, simt or wtile. The profiler can drop the first kernels it should
    record, so a warm-up call runs first in the window, then the call
    between two sentinel kernels (torch.cuda._sleep's ``spin_kernel``),
    and only the kernels between them count; a window that missed a
    sentinel is traced again."""
    import collections
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    name = re.compile(r"(?:^|[^A-Za-z0-9_])(?:hop|simt|wtile)::")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000)
            fn()
            torch.cuda._sleep(1_000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if len(marks) == 2:
            return collections.Counter(e.name for e in events[marks[0] + 1:marks[1]]
                                       if name.search(e.name))
    raise AssertionError(f"torch.profiler recorded the sentinel kernels of none of {tries} traces")


@pytest.mark.cuda
@pytest.mark.parametrize("modality", MODALITIES)
def test_graph_replay_launches_the_captured_kernels(cuda_device, modality):
    """One replay launches exactly the hand-written kernels of one eager
    forward (torch.profiler, by kernel name), and the capture counted the
    wrapper launches of one eager forward: the kernels run inside the graph."""
    from deepfake_tpu_torch.ops import launch_counts

    eager, graph = _predictor_pair(_graph_cfg(modality, torch.bfloat16), cuda_device)
    req = _model_request(eager.cfg, 8, cuda_device, 61)
    graph.predict(req)
    (g,) = graph.graphs.graphs.values()
    before = launch_counts()
    eager.predict(req)
    after = launch_counts()
    assert g.launches == {k: after[k] - before[k] for k in after if after[k] != before[k]}
    with torch.inference_mode():
        want = _handwritten_kernels(lambda: eager.predict(req))
        counted = launch_counts()
        got = _handwritten_kernels(g.graph.replay)
    assert got == want
    # wav2vec2 (paudio) has no hand-written kernel; every other model does
    assert (sum(got.values()) > 0 and sum(g.launches.values()) > 0) == (modality != "paudio")
    assert launch_counts() == counted  # a replay moves no wrapper's counter


@pytest.mark.cuda
def test_predict_raw_front_end_runs_in_f32_under_bf16(cuda_device):
    """A bf16 audio Predictor at window 16 (D = 32, so K6 serves its four
    blocks): the front end assembles the mel image in f32 on the card, equal
    to the CPU's on >= 99.9% of values and within one uint8 level elsewhere,
    and predict_raw is that image through predict."""
    import numpy as np

    from deepfake_tpu_torch.config import Config
    from deepfake_tpu_torch.data.pipeline import FeatureAssembler
    from deepfake_tpu_torch.serving import Predictor

    cfg = Config.preset("audio")
    for key, val in {"data.audio_size": 128, "model.swin2d_window": 16,
                     "model.swin2d_pretrained_windows": (0, 0), "model.swin2d_embed_dim": 64,
                     "model.swin2d_depths": (2, 2), "model.swin2d_heads": (2, 4),
                     "parallel.compute_dtype": "bfloat16"}.items():
        cfg.set(key, val)
    pred = Predictor(cfg, device=cuda_device, compiled=False)
    rng = np.random.default_rng(8)
    wave = (0.1 * rng.standard_normal((2, 64000))).astype(np.float32)
    lengths = np.asarray([41000, 64000])
    wave[0, 41000:] = 0
    feats = {"audio_wave": wave, "audio_len": lengths}
    zeros = np.zeros(1, np.float32)
    got, _ = pred._assemble(feats, zeros)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    want, _ = FeatureAssembler(cfg, device="cpu")(feats, zeros)
    d = (got.cpu() - want).abs()
    assert (d > 1e-5).float().mean().item() <= 1e-3 and d.max().item() <= 1 / 255 / 0.224 + 1e-5
    before = window_attention_multihead.launches
    scores = pred.predict_raw(feats)
    assert window_attention_multihead.launches == before + 4
    assert scores.shape == (2,) and np.isfinite(scores).all()
    np.testing.assert_array_equal(scores, pred.predict(got))


# ---------------------------------------------------------------- training as a CUDA graph

# Video Swin at a small geometry (stage 0: 8 x 14 x 14 tokens, (8,7,7)
# windows of N = 392, shifted in its second block), bf16 on the K5 route,
# DropPath at 0.5 in the last block and classifier dropout, batch 2 x accum
# 2, cosine over 3 steps
SMALL_TRAIN = {
    "data.modality": "video_swin", "data.num_frames": 16, "data.frame_size": 56,
    "model.swin3d_embed_dim": 32, "model.swin3d_depths": (2, 2), "model.swin3d_heads": (1, 2),
    "model.num_hiddens": 16, "model.swin3d_drop_path": 0.5, "model.classify_drop": 0.1,
    "optim.batch_size": 2, "optim.accum_step": 2, "optim.learning_rate": 0.1,
    "optim.epochs": 3, "parallel.compute_dtype": "bfloat16",
}


class _OneBatch:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def train_loader(self):
        return [(self.x, self.y)]

    def val_loader(self):
        return [(self.x, self.y)]


def _train_batches(dev, n, seed=61):
    gen = torch.Generator(dev).manual_seed(seed)
    return [(torch.randn(4, 16, 56, 56, 3, generator=gen, device=dev),
             (torch.rand(4, generator=gen, device=dev) > 0.5).float()) for _ in range(n)]


def _trainer(dev, compiled, batches, **over):
    from deepfake_tpu_torch.config import Config
    from deepfake_tpu_torch.train.trainer import Trainer

    cfg = Config()
    for k, v in dict(SMALL_TRAIN, **over).items():
        cfg.set(k, v)
    return Trainer(None, cfg, _OneBatch(*batches[0]), logger=lambda line: None, device=dev,
                   compiled=compiled)


def _weights(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


def _steps(trainer, batches):
    return [float(trainer.train_step(x, y)["loss"]) for x, y in batches]


def _gap(a, b):
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def _spread_tolerance(spread: float, scale: float) -> float:
    """What the graph route may differ from the eager route by: four times
    the spread of two eager runs from one state (K5's backward adds dS into
    dbias with atomics, in an order that changes from run to run), and no
    less than 1e-6 of the quantity's scale (two runs may agree by chance)."""
    return 4.0 * spread + 1e-6 * max(scale, 1.0)


@pytest.mark.cuda
def test_train_graph_matches_eager_within_spread(cuda_device):
    """Three steps of the graph route (the default on the card) against
    three eager steps from the same seed: losses and updated weights within
    the eager-vs-eager spread's tolerance; one graph, replayed three times,
    whose capture launched K5 both ways."""
    batches = _train_batches(cuda_device, 3)
    eager = [_trainer(cuda_device, False, batches) for _ in range(2)]
    graph = _trainer(cuda_device, True, batches)
    assert graph.graphs is not None and eager[0].graphs is None
    losses = [_steps(t, batches) for t in (*eager, graph)]
    weights = [_weights(t) for t in (*eager, graph)]
    loss_spread = max(abs(a - b) for a, b in zip(losses[0], losses[1]))
    w_spread = _gap(weights[0], weights[1])
    scale = max(abs(v) for v in losses[0])
    w_scale = max(w.abs().max().item() for w in weights[0])
    assert max(abs(a - b) for a, b in zip(losses[0], losses[2])) <= _spread_tolerance(
        loss_spread, scale), (losses, loss_spread)
    assert _gap(weights[0], weights[2]) <= _spread_tolerance(w_spread, w_scale), w_spread
    assert _gap(weights[0], _weights(_trainer(cuda_device, False, batches))) > 0  # they train
    (g,) = graph.graphs.graphs.values()
    assert g.replays == 3 and graph.step == 3
    assert g.launches["window_attn3d_train_fwd"] > 0 and g.launches["window_attn3d_train_bwd"] > 0


@pytest.mark.cuda
def test_train_graph_replays_draw_new_dropout_masks(cuda_device):
    """At lr 0 (the weights never move) two replays on one batch give
    different losses: each draws new DropPath and dropout masks, and the
    generator's state advances; the replays' losses are those of two eager
    steps from the same seed (the same mask sequence)."""
    batches = _train_batches(cuda_device, 1) * 2
    graph = _trainer(cuda_device, True, batches, **{"optim.learning_rate": 0.0})
    eager = [_trainer(cuda_device, False, batches, **{"optim.learning_rate": 0.0})
             for _ in range(2)]
    states = [graph.dropout.get_state()]
    got = []
    for x, y in batches:
        got.append(float(graph.train_step(x, y)["loss"]))
        states.append(graph.dropout.get_state())
    assert got[0] != got[1]
    assert not torch.equal(states[0], states[1]) and not torch.equal(states[1], states[2])
    want, again = (_steps(t, batches) for t in eager)
    spread = max(abs(a - b) for a, b in zip(want, again))
    assert max(abs(a - b) for a, b in zip(got, want)) <= _spread_tolerance(
        spread, max(abs(v) for v in want)), (got, want)


@pytest.mark.cuda
def test_train_graph_rates_follow_the_schedule(cuda_device):
    """With momentum and weight decay off, each replay moves every
    parameter by -lr(t) times its gradient (the graph's static .grad): the
    rate the update read on the device is make_schedule's for that step,
    through the cosine's three steps."""
    batches = _train_batches(cuda_device, 3)
    t = _trainer(cuda_device, True, batches, **{"optim.momentum": 0.0,
                                                "optim.weight_decay": 0.0})
    for step, (x, y) in enumerate(batches):
        before = _weights(t)
        t.train_step(x, y)
        lr = t.lr(step)
        assert float(t.optimizer.lr) == pytest.approx(lr, rel=1e-6)
        for p, b in zip(t.model.parameters(), before):
            want = b - lr * p.grad
            tol = 1e-6 * max(b.abs().max().item(), 1.0)
            assert (p.detach() - want).abs().max().item() <= tol
    assert [t.lr(s) for s in range(3)] == sorted([t.lr(s) for s in range(3)], reverse=True)


@pytest.mark.cuda
def test_train_graph_capture_moves_no_weight(cuda_device):
    """The capture (two eager warm-up steps and the captured one) leaves
    the weights, buffers, momentum, dropout generator and step count as
    they were."""
    batches = _train_batches(cuda_device, 1)
    t = _trainer(cuda_device, True, batches)
    # detached: a clone that autograd tracks would keep the parameters'
    # AccumulateGrad nodes alive on this stream, which the capture refuses
    state = [s.detach().clone() for s in t._state()]
    gen = t.dropout.get_state()
    t._step_graph(batches[0])
    assert len(t.graphs.graphs) == 1 and t.step == 0
    assert all(torch.equal(a, b) for a, b in zip(t._state(), state))
    assert all(not b.any() for b in t.optimizer.bufs)
    assert torch.equal(t.dropout.get_state(), gen)


@pytest.mark.cuda
def test_chained_train_steps_equal_single_replays(cuda_device):
    """chained_train_steps(3) on one batch against three train_step calls
    on it from the same seed: the last loss and the weights within the
    eager-vs-eager spread's tolerance, one graph replayed three times."""
    batches = _train_batches(cuda_device, 1) * 3
    single = _trainer(cuda_device, True, batches)
    chained = _trainer(cuda_device, True, batches)
    want = _steps(single, batches)[-1]
    got = chained.chained_train_steps(3)(*batches[0])
    assert got.dtype == torch.float32 and got.dim() == 0 and chained.step == 3
    eager = [_trainer(cuda_device, False, batches) for _ in range(2)]
    ew = [(_steps(t, batches), _weights(t)) for t in eager]
    spread = abs(ew[0][0][-1] - ew[1][0][-1])
    w_spread = _gap(ew[0][1], ew[1][1])
    assert abs(float(got) - want) <= _spread_tolerance(spread, abs(want))
    w_scale = max(w.abs().max().item() for w in ew[0][1])
    assert _gap(_weights(single), _weights(chained)) <= _spread_tolerance(w_spread, w_scale)
    (g,) = chained.graphs.graphs.values()
    assert g.replays == 3


@pytest.mark.cuda
def test_train_eval_runs_through_graphs(cuda_device):
    """Trainer.eval on the compiled route replays one graph per batch shape
    (a ragged last batch captures a second) and matches the eager route's
    loss and accuracy; its probabilities' AUC too."""
    batches = _train_batches(cuda_device, 2)
    graph = _trainer(cuda_device, True, batches)
    eager = _trainer(cuda_device, False, batches)
    loader = [batches[0], batches[1], (batches[1][0][:3], batches[1][1][:3])]
    got, want = graph.eval(loader), eager.eval(loader)
    assert len(graph.graphs.graphs) == 2
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["acc"] == want["acc"] and got["auc"] == pytest.approx(want["auc"])


# ------------------------------------------------- submission from video files

def _ingest_case(dev, tmp_path, n_clips=5):
    """A fused bf16 Predictor on the graph route at the small geometry, and
    a synthetic test set of ``n_clips`` mp4v clips (12 frames of 64^2,
    0.5 s PCM sidecars) for batches of 2. Skips where cv2 does not import
    (it writes and decodes the clips)."""
    pytest.importorskip("cv2", reason="needs OpenCV to write and decode the mp4 clips")
    from deepfake_tpu_torch.data.synthetic import make_synthetic_testset
    from deepfake_tpu_torch.serving import Predictor

    make_synthetic_testset(str(tmp_path), n_clips, frames=12, size=64, seconds=0.5, seed=5)
    cfg = _graph_cfg("fused", torch.bfloat16)
    cfg.data.data_root = str(tmp_path)
    cfg.optim.batch_size = 2
    cfg.data.num_workers = 2
    return cfg, Predictor(cfg, device=dev)


def _submit(cfg, pred, csv, logs=None):
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.train.submit import SubmitCtl

    dm = DeepFakeDataModule(cfg, prediction_csv=str(csv)).setup("test")
    return SubmitCtl(pred, cfg, dm, logger=(logs if logs is not None else []).append,
                     prediction_csv=str(csv))


@pytest.mark.cuda
def test_submit_graph_route_equals_predict_raw(cuda_device, tmp_path):
    """submit() over 5 clips in batches of 2 (the ragged last padded): each
    clip's score equals, to the bit, predict_raw of its batch from the host
    through the same Predictor; one graph serves every batch."""
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.train.submit import pad_rows

    cfg, pred = _ingest_case(cuda_device, tmp_path)
    result = _submit(cfg, pred, tmp_path / "prediction.csv").submit()
    assert list(result) == [f"clip_{i}.mp4" for i in range(5)]
    assert len(pred.graphs.graphs) == 1
    dm = DeepFakeDataModule(cfg, prediction_csv=str(tmp_path / "none.csv")).setup("test")
    for feats, _labels, names in dm.test_dataloader():
        want = pred.predict_raw(pad_rows(feats, 2))[:len(names)]
        assert [result[n] for n in names] == [float(p) for p in want]
    rows = [line.split(",") for line in open(tmp_path / "prediction.csv").read().splitlines()]
    assert [float(r[1]) for r in rows] == [float(v) for v in result.values()]


@pytest.mark.cuda
def test_graph_capture_while_the_producer_decodes(cuda_device, tmp_path, monkeypatch):
    """The first batch's graph is captured while the prefetcher's thread
    decodes the next batches (each decode slowed by 200 ms, so that the
    decodes span the warm-up and the capture): the capture succeeds, a decode ran during it, and the scores
    are those of a run without the slowdown."""
    import threading
    import time

    from deepfake_tpu_torch.compiled import GraphCache
    from deepfake_tpu_torch.data import dataset

    cfg, pred = _ingest_case(cuda_device, tmp_path, n_clips=10)
    decodes, captures = [], []
    real_decode, real_graph = dataset.extract_frames, GraphCache.graph

    def slow_decode(*a, **k):
        t0 = time.perf_counter()
        time.sleep(0.2)
        out = real_decode(*a, **k)
        decodes.append((t0, time.perf_counter(), threading.get_ident()))
        return out

    def timed_graph(self, key, *a, **k):
        new = key not in self.graphs
        t0 = time.perf_counter()
        g = real_graph(self, key, *a, **k)
        if new:
            captures.append((t0, time.perf_counter()))
        return g

    monkeypatch.setattr(dataset, "extract_frames", slow_decode)
    monkeypatch.setattr(GraphCache, "graph", timed_graph)
    got = _submit(cfg, pred, tmp_path / "slow.csv").submit()
    (c0, c1), = captures
    assert any(d0 < c1 and d1 > c0 for d0, d1, tid in decodes
               if tid != threading.get_ident()), (captures, decodes)
    monkeypatch.setattr(dataset, "extract_frames", real_decode)
    assert _submit(cfg, pred, tmp_path / "fast.csv").submit() == got


@pytest.mark.cuda
def test_submit_resume_on_the_card(cuda_device, tmp_path, monkeypatch):
    """A run stopped after its first batch, then resumed: prediction.csv
    holds each clip once, with the scores of an uninterrupted run to the
    bit (the same graph)."""
    cfg, pred = _ingest_case(cuda_device, tmp_path)
    whole = _submit(cfg, pred, tmp_path / "whole.csv").submit()
    real, calls = pred.predict_raw, []

    def stop_after_one(feats):
        if calls:
            raise KeyboardInterrupt
        calls.append(1)
        return real(feats)

    monkeypatch.setattr(pred, "predict_raw", stop_after_one)
    with pytest.raises(KeyboardInterrupt):
        _submit(cfg, pred, tmp_path / "prediction.csv").submit()
    monkeypatch.setattr(pred, "predict_raw", real)
    rest = _submit(cfg, pred, tmp_path / "prediction.csv").submit()
    assert list(rest) == [f"clip_{i}.mp4" for i in range(2, 5)]
    rows = [line.split(",") for line in open(tmp_path / "prediction.csv").read().splitlines()]
    assert [r[0] for r in rows] == list(whole)
    assert [float(r[1]) for r in rows] == [float(v) for v in whole.values()]
