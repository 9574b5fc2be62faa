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
dbias (f32) within 1e-2 of its largest |value|.
"""

import math

import pytest
import torch

from deepfake_tpu_torch.models import inception_resnet_v2 as irv2
from deepfake_tpu_torch.models.layers import BatchNorm, init_weights
from deepfake_tpu_torch.models.swin2d import shift_attn_mask
from deepfake_tpu_torch.ops.inception_block import inception_block, inception_block_plain
from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size
from deepfake_tpu_torch.ops.ln_linear_kernel import ln_linear, ln_linear_plain
from deepfake_tpu_torch.ops.window_attn3d_kernel import (
    window_attn3d_tokens, window_attn3d_tokens_plain,
)
from deepfake_tpu_torch.ops.window_attn3d_train import (
    window_attn3d_train, window_attn3d_train_bwd, window_attn3d_train_bwd_plain,
    window_attn3d_train_fwd, window_attn3d_train_fwd_plain,
)
from deepfake_tpu_torch.ops.window_attn_kernel import (
    window_attention_heads, window_attention_heads_plain, window_attention_tokens,
    window_attention_tokens_plain,
)

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,H,masked,N", [
    (256, 3, True, 392), (64, 12, False, 392), (16, 24, True, 392), (8, 2, True, 196),
    (3, 1, False, 512)], ids=["stage0_shifted", "stage2", "stage3_shifted", "clamped_196",
                              "n512"])
def test_k3_tokens_kernel_matches_plain(cuda_device, B_, H, masked, N, dtype):
    gen = torch.Generator(cuda_device).manual_seed(2)
    C = 32 * H
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=cuda_device).to(dtype)
    bias = 0.5 * torch.randn(H, N, N, generator=gen, device=cuda_device)
    mask = None
    if masked:
        grid = {392: (16, 14, 14), 196: (4, 14, 14)}[N]
        ws = (8, 7, 7) if N == 392 else (4, 7, 7)
        mask = torch.from_numpy(compute_mask_3d(*grid, ws, (4, 3, 3))).to(cuda_device)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    kw = dict(num_heads=H, bias=bias, mask=mask, scale=32 ** -0.5)
    before = window_attn3d_tokens.launches
    got = window_attn3d_tokens(q, k, v, **kw)
    torch.cuda.synchronize()
    assert window_attn3d_tokens.launches == before + 1
    want = window_attn3d_tokens_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= k3_tolerance(want), err


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


# (rows, K, N, role): Video Swin-S stage 0 and stage 3 widths; the row counts
# are not multiples of the 128-row tile
K4_CASES = [(4100, 96, 288, "ln_qkv"), (4100, 96, 96, "proj"), (4100, 96, 384, "sum_ln_fc1_gelu"),
            (4100, 384, 96, "fc2_residual_pair"), (1000, 768, 2304, "ln_qkv"),
            (1000, 3072, 768, "fc2_residual_pair")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,role", K4_CASES,
                         ids=[f"{r}_{m}x{k}x{n}" for m, k, n, r in K4_CASES])
def test_k4_kernel_matches_plain(cuda_device, M, K, N, role, dtype):
    gen = torch.Generator(cuda_device).manual_seed(4)
    rnd = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=gen, device=cuda_device)).to(dtype)
    x = rnd(M, K)
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
# 224 (grid (16, 56 / 2^i, 56 / 2^i)), a clamped 196-token window, N = 512
K5_CASES = [(1024, 3, 392, (16, 56, 56)), (1024, 3, 392, None), (256, 6, 392, (16, 28, 28)),
            (64, 12, 392, None), (64, 12, 392, (16, 14, 14)), (16, 24, 392, (16, 7, 7)),
            (8, 2, 196, (4, 14, 14)), (3, 1, 512, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,H,N,grid", K5_CASES, ids=[
    "stage0_shifted", "stage0", "stage1_shifted", "stage2", "stage2_shifted", "stage3_shifted",
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
