"""Blocks at the widths this slice opened, the port against the JAX package
on the CPU: Video Swin blocks at head dim 64 (K3's and K4's plain versions
against the JAX nhc and QKV-fused routes, Pallas in interpret mode), a Video
Swin-L stage-3 block at C = 1536 (K4's LayerNorm over rows wider than its
shared-memory panel on the card), and SwinV2 blocks at head dim 16 (K2's
and K6's plain versions against the JAX block with use_pallas=True). Inputs
and weights from numpy seeds; f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_swin3d import jax_routes
from tests.torch_port_helpers import random_variables

from deepfake_tpu_torch.io.jax_weights import load_jax_variables
from deepfake_tpu_torch.models.registry import precompute_bias_cache


def _swin3d_block(monkeypatch, routes, dim, heads, shape, shift, seed):
    """(port output, JAX output) of one SwinBlock3D on the same input and
    weights; the port on its kernel route (the kernels' plain versions)."""
    from deepfake_tpu.models.swin3d import SwinBlock3D as J
    from deepfake_tpu_torch.models.swin3d import SwinBlock3D as T

    jax_routes(monkeypatch, routes)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jblock = J(dim=dim, num_heads=heads, window_size=(8, 7, 7), shift_size=shift,
               use_pallas=True)
    variables = random_variables(jblock, jnp.asarray(x), seed=seed + 1, deterministic=True)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), deterministic=True))
    tblock = T(dim, shape[1:4], heads, (8, 7, 7), shift, kernels=True)
    load_jax_variables(tblock, variables)
    precompute_bias_cache(tblock)
    with torch.inference_mode():
        got = tblock(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("routes", ["nhc", "fused"])
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 3, 3)], ids=["unshifted", "shifted"])
def test_swin_block3d_head_dim_64_matches_jax(monkeypatch, routes, shift):
    """A Video Swin block at dim 128 with 2 heads (head dim 64), shifted and
    not: max abs error <= 2e-5 against the JAX block on its nhc route and
    on its QKV-fused + MLP-tail route."""
    got, want = _swin3d_block(monkeypatch, routes, 128, 2, (1, 8, 14, 14, 128), shift, seed=70)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_swin_block3d_c1536_matches_jax(monkeypatch):
    """Video Swin-L's stage-3 block (C = 1536, 48 heads of 32, one (8,7,7)
    window of a clip's 8 x 7 x 7 tokens): the port's kernel route against
    the JAX block on its default routes, max abs error <= 1e-4 of the
    largest |output| (f32 sums over 1536 and 6144 terms)."""
    got, want = _swin3d_block(monkeypatch, "fused", 1536, 48, (1, 8, 7, 7, 1536), (0, 0, 0),
                              seed=72)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("res,ws,shift", [(14, 7, 3), (32, 16, 8)], ids=["w7_k2", "w16_k6"])
def test_swin_v2_block_head_dim_16_matches_jax(monkeypatch, res, ws, shift):
    """A SwinV2 block at dim 32 with 2 heads (head dim 16), shifted: at
    window 7 (N = 49, K2's plain version) and window 16 (N = 256, K6's)
    against the JAX block with use_pallas=True (the Pallas window attention
    in interpret mode): max abs error <= 2e-5."""
    from deepfake_tpu.models.swin2d import SwinBlock as J
    from deepfake_tpu_torch.models.swin2d import SwinBlock as T

    monkeypatch.setenv("DEEPFAKE_TPU_PALLAS_INTERPRET", "1")
    x = np.random.default_rng(74).standard_normal((2, res * res, 32)).astype(np.float32)
    jblock = J(dim=32, input_resolution=(res, res), num_heads=2, window_size=ws,
               shift_size=shift, use_pallas=True)
    variables = random_variables(jblock, jnp.asarray(x), seed=75)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), deterministic=True))
    tblock = T(32, (res, res), 2, ws, shift, attn_kernel=True)
    load_jax_variables(tblock, variables)
    with torch.inference_mode():
        got = tblock(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


# Head dims that are not a multiple of 8: the kernels' plain versions (what
# the CPU runs, and what the card's kernels are held to) against the JAX
# kernels in interpret mode. K3 and K5 at Video Swin's (8,7,7) windows with
# 3 heads (a qkv row of 9 D elements: 108 at D = 12), K6 at SwinV2's window
# 16 with 4 shift masks.
ODD_HEAD_DIMS = (12, 20)


def _odd_qkv(B_, H, N, D, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return rng, mk, mk(B_, N, 3 * H * D)


@pytest.mark.parametrize("D", ODD_HEAD_DIMS)
def test_k3_plain_at_odd_head_dims_matches_pallas_nhc(D):
    """K3 (plain on the CPU) == pallas_window_attention_nhc at N = 392,
    3 heads of D, shifted (4 masks, B_ = 8), q, k, v column slices of one
    qkv tensor: max abs error <= 2e-5."""
    from deepfake_tpu.models.swin3d import compute_mask_3d
    from deepfake_tpu.ops.pallas_window_attn import pallas_window_attention_nhc
    from deepfake_tpu_torch.ops.window_attn3d_kernel import window_attn3d_tokens

    B_, H, N = 8, 3, 392
    C = H * D
    _, mk, qkv = _odd_qkv(B_, H, N, D, 80 + D)
    bias = 0.5 * mk(H, N, N)
    mask = compute_mask_3d(8, 14, 14, (8, 7, 7), (4, 3, 3))
    want = np.asarray(pallas_window_attention_nhc(
        jnp.asarray(qkv[..., :C]), jnp.asarray(qkv[..., C:2 * C]), jnp.asarray(qkv[..., 2 * C:]),
        num_heads=H, bias=jnp.asarray(bias), mask=jnp.asarray(mask), scale=D ** -0.5))
    t = torch.from_numpy(qkv)
    with torch.inference_mode():
        got = window_attn3d_tokens(t[..., :C], t[..., C:2 * C], t[..., 2 * C:], num_heads=H,
                                   bias=torch.from_numpy(bias), mask=torch.from_numpy(mask),
                                   scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("D", ODD_HEAD_DIMS)
def test_k5_plain_at_odd_head_dims_matches_pallas_nhc_train(D):
    """K5's autograd Function (plain forward and backward on the CPU) ==
    pallas_window_attention_nhc_train under jax.vjp at N = 392, 3 heads of
    D, shifted (4 masks, B_ = 4), f32: out, dq, dk, dv and dbias within
    atol 2e-4 / rtol 1e-4, as at D = 32."""
    import jax

    from deepfake_tpu.models.swin3d import compute_mask_3d
    from deepfake_tpu.ops.pallas_window_attn import pallas_window_attention_nhc_train
    from deepfake_tpu_torch.ops.window_attn3d_train import window_attn3d_train

    B_, H, N = 4, 3, 392
    C = H * D
    rng, mk, qkv = _odd_qkv(B_, H, N, D, 90 + D)
    bias = 0.5 * mk(H, N, N)
    g = mk(B_, N, C)
    mask = compute_mask_3d(8, 14, 14, (8, 7, 7), (4, 3, 3))

    def attn(q, k, v, b):
        return pallas_window_attention_nhc_train(q, k, v, num_heads=H, bias=b,
                                                 mask=jnp.asarray(mask), scale=D ** -0.5)

    out, vjp = jax.vjp(attn, *(jnp.asarray(qkv[..., i * C:(i + 1) * C]) for i in range(3)),
                       jnp.asarray(bias))
    want = [out, *vjp(jnp.asarray(g))]
    tqkv = torch.from_numpy(qkv).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    got_out = window_attn3d_train(tqkv, num_heads=H, bias=tbias, mask=torch.from_numpy(mask),
                                  scale=D ** -0.5)
    got_out.backward(torch.from_numpy(g))
    got = [got_out, *tqkv.grad.split(C, dim=-1), tbias.grad]
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "scaled"])
@pytest.mark.parametrize("D", ODD_HEAD_DIMS)
def test_k6_plain_at_odd_head_dims_matches_pallas(D, cosine):
    """K6 (plain on the CPU) == pallas_window_attention on its
    _run_multihead route at N = 256 (window 16 of a 32x32 grid shifted by
    8: 4 masks), B_ = 8, 4 heads of D, q, k, v head-major views of one qkv
    tensor: max abs error <= 1e-5."""
    from deepfake_tpu.models.swin2d import shift_attn_mask
    from deepfake_tpu.ops.pallas_window_attn import pallas_window_attention
    from deepfake_tpu_torch.ops.window_attn_multihead import window_attention_multihead

    B_, H, N = 8, 4, 256
    _, mk, qkv = _odd_qkv(B_, H, N, D, 100 + D)
    heads = qkv.reshape(B_, N, 3, H, D).transpose(2, 0, 3, 1, 4)
    bias = (16.0 / (1.0 + np.exp(-mk(H, N, N)))).astype(np.float32)
    mask = shift_attn_mask(32, 32, 16, 8)
    ls = np.exp(np.minimum(mk(H, 1, 1) * 0.5 + np.log(10.0), np.log(100.0))).astype(np.float32)
    jkw = dict(logit_scale=jnp.asarray(ls)) if cosine else dict(scale=D ** -0.5)
    want = np.asarray(pallas_window_attention(
        *(jnp.asarray(np.ascontiguousarray(a)) for a in heads), bias=jnp.asarray(bias),
        mask=jnp.asarray(mask), cosine=cosine, **jkw))
    tq, tk, tv = torch.from_numpy(qkv).view(B_, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    tkw = dict(logit_scale=torch.from_numpy(ls)) if cosine else dict(scale=D ** -0.5)
    with torch.inference_mode():
        got = window_attention_multihead(tq, tk, tv, bias=torch.from_numpy(bias),
                                         mask=torch.from_numpy(mask), cosine=cosine, **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
