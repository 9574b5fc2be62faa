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
