"""The port's models against the JAX package's, module by module, on the
CPU in f32: the same numpy inputs, the JAX weights carried across with
load_jax_variables, the JAX side on its default XLA path. The port runs
each kernel route (through the kernels' plain versions here) and its plain
route."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import random_variables, torch_on_one_thread  # noqa: F401 (autouse)

from deepfake_tpu_torch.io.jax_weights import load_jax_variables


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6))


@pytest.fixture(scope="module")
def irv2_case():
    """Inputs, random JAX weights and the JAX output (jitted XLA path) of
    the IRv2 trunk at 96x96 frames, shared by both port routes."""
    from deepfake_tpu.models.inception_resnet_v2 import InceptionResNetV2 as J

    x = np.random.default_rng(2).standard_normal((2, 96, 96, 3)).astype(np.float32) * 0.5
    jm = J(use_pallas=False)
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    return x, variables, np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))


@pytest.mark.parametrize("fused", [True, False], ids=["k1_route", "plain_route"])
def test_inception_resnet_v2_96px(irv2_case, fused):
    """IRv2 trunk at 96x96 frames: max error <= 1e-4 of the largest feature."""
    from deepfake_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2 as T

    x, variables, want = irv2_case
    tm = load_jax_variables(T(fused_blocks=fused), variables)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1536)
    assert _rel_err(got, want) <= 1e-4


def test_nextvlad():
    """NeXtVLAD with its BN-over-frames and L1-normalisation quirks: <= 1e-5."""
    from deepfake_tpu.models.nextvlad import NeXtVLAD as J
    from deepfake_tpu_torch.models.nextvlad import NeXtVLAD as T

    x = np.random.default_rng(4).standard_normal((2, 5, 32)).astype(np.float32)
    kw = dict(dim=32, num_clusters=8, lamb=2, groups=4, max_frames=5)
    jm = J(**kw)
    variables = random_variables(jm, jnp.asarray(x), seed=5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = load_jax_variables(T(**kw), variables)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) <= 1e-5


SWIN_KW = dict(img_size=56, num_classes=1, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
               window_size=7, pretrained_window_sizes=(16, 16))


@functools.lru_cache(maxsize=None)
def _swin_case(batch):
    """Inputs, random JAX weights and the JAX logits (jitted XLA path) of
    SwinV2 at 56x56, shared by both port routes."""
    from deepfake_tpu.models.swin2d import SwinTransformerV2 as J

    x = np.random.default_rng(6).standard_normal((batch, 56, 56, 3)).astype(np.float32)
    jm = J(**SWIN_KW)
    variables = random_variables(jm, jnp.asarray(x), True, seed=7)
    apply = jax.jit(functools.partial(jm.apply, deterministic=True, return_logits=True))
    return x, variables, np.asarray(apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("batch", [2, 1], ids=["b2_tokens", "b1_heads"])
@pytest.mark.parametrize("kernel", [True, False], ids=["k2_route", "plain_route"])
def test_swin_v2_56px(kernel, batch):
    """SwinV2 at 56x56, embed 16, depths (2, 2): logits within 1e-4. At
    batch 1 stage 1's single window takes K2's head-major route."""
    from deepfake_tpu_torch.models.swin2d import SwinTransformerV2 as T

    x, variables, want = _swin_case(batch)
    tm = load_jax_variables(T(attn_kernel=kernel, **SWIN_KW), variables)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), return_logits=True).numpy()
    np.testing.assert_allclose(got, np.atleast_1d(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_lengths", [False, True], ids=["wave", "wave_lengths"])
def test_audio2d_small_wav2vec2(with_lengths):
    """Audio2D over a 2-layer, 64-wide wav2vec2, with and without the
    (wave, lengths) batch-longest masking: scores within 1e-5."""
    from deepfake_tpu.models.audio2d import Audio2D as J
    from deepfake_tpu.models.wav2vec2 import Wav2Vec2Config as JC
    from deepfake_tpu_torch.models.audio2d import Audio2D as T
    from deepfake_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TC

    dims = dict(conv_dim=(64,) * 7, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128)
    rng = np.random.default_rng(8)
    wave = rng.standard_normal((2, 4000)).astype(np.float32)
    lengths = np.asarray([2600, 3500], np.int32)
    jm = J(num_classes=1, wav_config=JC(**dims))
    jin = (jnp.asarray(wave), jnp.asarray(lengths)) if with_lengths else jnp.asarray(wave)
    variables = random_variables(jm, jin, seed=9)
    want = np.asarray(jm.apply(variables, jin, deterministic=True, return_logits=True))
    tm = load_jax_variables(T(num_classes=1, wav_config=TC(**dims)), variables)
    tin = ((torch.from_numpy(wave), torch.from_numpy(lengths)) if with_lengths
           else torch.from_numpy(wave))
    with torch.inference_mode():
        got = tm(tin, return_logits=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
