"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU (a CUDA kernel
has no CPU mode). Imports nothing of JAX, so it runs on a machine with the
card and PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances for K1 and K2, on max |kernel - plain| / max(|plain|, 1): f32
with TF32 off, 1e-4 (summation order and rsqrt rounding; K2's logits reach
~116 and amplify them); bf16 2e-2 (one bf16 rounding of a stored value,
where the two sides may round apart by an ulp). For K3, on max |kernel -
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
    window_attn3d_train_fwd, window_attn3d_train_fwd_plain,
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,S", [("A", 9), ("B", 4), ("C", 5), ("c9", 5), ("A", 25)],
                         ids=["A_S9", "B_S4", "C_S5", "c9_S5", "A_S25"])
def test_k1_kernel_matches_plain(cuda_device, kind, S, dtype, tol):
    gen = torch.Generator(cuda_device).manual_seed(0)
    block = _block(kind, cuda_device, gen)
    blk = block.pack_weights(dtype)
    C = block.conv.out_channels
    x = (0.5 * torch.randn(6, S, S, C, generator=gen, device=cuda_device)).to(dtype)
    before = inception_block.launches
    got = inception_block(x, blk).float()
    torch.cuda.synchronize()
    assert inception_block.launches == before + 1
    want = inception_block_plain(x, blk).float()
    rel = _rel_err(got, want)
    assert math.isfinite(rel) and rel <= tol, rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,H,masked", [(8, 4, True), (32, 16, False), (1, 32, False)],
                         ids=["shifted_nW4", "stage2", "single_window"])
def test_k2_kernel_matches_plain(cuda_device, B_, H, masked, dtype, tol):
    gen = torch.Generator(cuda_device).manual_seed(1)
    N, D = 49, 32
    C = H * D
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=cuda_device).to(dtype)
    bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=cuda_device))
    mask = (torch.from_numpy(shift_attn_mask(14, 14, 7, 3)).to(cuda_device)
            if masked else None)
    ls = torch.exp(torch.clamp(math.log(10.0) + 0.3 * torch.randn(
        H, 1, 1, generator=gen, device=cuda_device), max=math.log(100.0)))
    kw = dict(bias=bias, mask=mask, logit_scale=ls)
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


@pytest.mark.cuda
def test_k3_raises_for_windows_it_does_not_take(cuda_device):
    q = torch.zeros(1, 640, 32, device=cuda_device)
    with pytest.raises(ValueError, match="N <= 512"):
        window_attn3d_tokens(q, q, q, num_heads=1, bias=torch.zeros(1, 640, 640), scale=0.2)


def k4_tolerance(want: torch.Tensor) -> float:
    """1e-5 of max(|plain|, 1) in f32; in bf16 two ulps of the largest |output|."""
    big = want.float().abs().max().item()
    if want.dtype == torch.float32:
        return 1e-5 * max(big, 1.0)
    return 2.0 * 2.0 ** (math.floor(math.log2(big)) - 7)


# (rows, K, N, role): Video Swin-S stage 0 and stage 3 widths, and the whole
# MLP tail (mlp_tail: one launch at C <= 384, two at 768) at the four stage
# widths; the row counts are not multiples of the 64-row tile
K4_CASES = [(4100, 96, 288, "ln_qkv"), (4100, 96, 96, "proj"), (4100, 96, 384, "sum_ln_fc1_gelu"),
            (4100, 384, 96, "fc2_residual_pair"), (1000, 768, 2304, "ln_qkv"),
            (1000, 3072, 768, "fc2_residual_pair"), (4100, 96, 96, "mlp_tail"),
            (2050, 192, 192, "mlp_tail"), (1000, 384, 384, "mlp_tail"),
            (1000, 768, 768, "mlp_tail")]


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
# 224 (grid (16, 56 / 2^i, 56 / 2^i)), shifted and not; b1 (B_ = nW: one
# window per mask index, so a group shares nothing); an odd batch (B_ = 3 nW);
# an unmasked prime B_ that no window group divides; a clamped 196-token
# window; N = 512 (launch 1 without its dbias slab)
K5_CASES = [(1024, 3, 392, (16, 56, 56)), (1024, 3, 392, None), (256, 6, 392, (16, 28, 28)),
            (256, 6, 392, None), (64, 12, 392, None), (64, 12, 392, (16, 14, 14)),
            (16, 24, 392, (16, 7, 7)), (16, 24, 392, None), (128, 3, 392, (16, 56, 56)),
            (24, 12, 392, (16, 14, 14)), (1021, 3, 392, None), (8, 2, 196, (4, 14, 14)),
            (3, 1, 512, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,H,N,grid", K5_CASES, ids=[
    "stage0_shifted", "stage0", "stage1_shifted", "stage1", "stage2", "stage2_shifted",
    "stage3_shifted", "stage3", "b1_stage0_shifted", "b3_stage2_shifted", "ungrouped_1021",
    "clamped_196", "n512"])
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


@pytest.mark.cuda
def test_k6_raises_for_windows_it_does_not_take(cuda_device):
    """K2's windows (N <= 64) and head dims other than 32 raise before any
    launch; nothing falls back to the plain version."""
    before = window_attention_multihead.launches
    q = torch.zeros(2, 1, 64, 32, device=cuda_device)
    with pytest.raises(ValueError, match="N >= 65"):
        window_attention_multihead(q, q, q, bias=torch.zeros(1, 64, 64),
                                   logit_scale=torch.ones(1, 1, 1))
    q = torch.zeros(2, 1, 100, 64, device=cuda_device)
    with pytest.raises(ValueError, match="D == 32"):
        window_attention_multihead(q, q, q, bias=torch.zeros(1, 100, 100),
                                   logit_scale=torch.ones(1, 1, 1))
    assert window_attention_multihead.launches == before


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
    pred = Predictor(cfg, device=cuda_device)
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
