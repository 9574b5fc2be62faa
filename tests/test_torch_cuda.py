"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU (a CUDA kernel
has no CPU mode). Imports nothing of JAX, so it runs on a machine with the
card and PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances, on max |kernel - plain| / max(|plain|, 1): f32 with TF32 off,
1e-4 (summation order and rsqrt rounding; K2's logits reach ~116 and
amplify them); bf16 2e-2 (one bf16 rounding of a stored value, where the
two sides may round apart by an ulp).
"""

import math

import pytest
import torch

from deepfake_tpu_torch.models import inception_resnet_v2 as irv2
from deepfake_tpu_torch.models.layers import BatchNorm, init_weights
from deepfake_tpu_torch.models.swin2d import shift_attn_mask
from deepfake_tpu_torch.ops.inception_block import inception_block, inception_block_plain
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
