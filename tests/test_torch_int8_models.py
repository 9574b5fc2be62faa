"""The int8 ``video`` and ``fused`` models in the port against the JAX
package, on the CPU in f32 at the tests' small
geometries (2 frames of 96^2; the fused model's SwinV2 at 56^2 and a
2-layer wav2vec2), through ``Predictor``: the same random numpy weights
(``load_jax_variables``), the same inputs. K1 on (the port's default: the
residual blocks in f32 through K1's plain version, against the JAX Pallas
blocks in interpret mode) and off (every conv int8, against JAX's XLA
path). torch runs on one thread.

Tolerance: logits within 0.02 max(1, |logit|) (the int8 trunks differ by
one-step rounding flips that carry through like quantisation noise, see
tests/test_torch_int8.py). int8_static against the JAX package's
calibration: tests/test_torch_int8_static.py."""

import functools

import numpy as np
import pytest
import torch

import jax

from tests.torch_port_helpers import SMALL_FUSED, both_configs, random_variables

from deepfake_tpu_torch.serving import Predictor

VIDEO = {"data.modality": "video", "data.num_frames": 2, "data.frame_size": 96,
         "parallel.compute_dtype": "float32"}
FUSED = dict(SMALL_FUSED, **{"data.wave_seconds_buckets": (0.5, 1.0)})
GEOMETRY = {"video": VIDEO, "fused": FUSED}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(modality, batch, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    video = (scale * rng.standard_normal((batch, 2, 96, 96, 3))).astype(np.float32)
    if modality == "video":
        return video
    return (video, rng.standard_normal((batch, 56, 56, 3)).astype(np.float32),
            (0.1 * rng.standard_normal((batch, 8000))).astype(np.float32))


def _configs(modality, quant, fused_blocks):
    jcfg, tcfg = both_configs(dict(GEOMETRY[modality], **{"model.irv2_quant": quant}))
    jcfg.model.irv2_pallas_blocks = fused_blocks
    tcfg.model.irv2_fused_blocks = fused_blocks
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _variables(modality):
    """Random JAX variables of the float model (the int8 models' tree is the
    same: the quantised branch declares the float one's parameters)."""
    from deepfake_tpu.models.registry import build_model, example_inputs

    jcfg, _ = _configs(modality, "none", False)
    return random_variables(build_model(jcfg), *example_inputs(jcfg, batch=1),
                            deterministic=True, seed=21)


def _jax_apply(jcfg):
    from deepfake_tpu.models.registry import build_model

    model = build_model(jcfg)
    return model, jax.jit(functools.partial(model.apply, deterministic=True, return_logits=True))


def _jax_input(x):
    import jax.numpy as jnp

    return tuple(jnp.asarray(v) for v in x) if isinstance(x, tuple) else jnp.asarray(x)


def _port_logits(pred, x):
    return pred.forward(x, return_logits=True).numpy()


def _calibrated(pred):
    from deepfake_tpu_torch.models.layers import Int8Owner

    return sum(len(m.calibrated) for m in pred.model.modules() if isinstance(m, Int8Owner))


# ---------------------------------------------------------------- (e) models

@pytest.mark.parametrize("fused_blocks", [True, False], ids=["k1_on", "k1_off"])
@pytest.mark.parametrize("modality", ["video", "fused"])
def test_int8_model_matches_jax(modality, fused_blocks):
    """The video and fused models at irv2_quant=int8 against the JAX models
    at int8 on the same weights and a batch of 2: logits within 0.02 max(1,
    |logit|); 24 int8 convs a frame batch with K1 on, 244 off."""
    from deepfake_tpu_torch.ops.int8_conv import recorded_convs

    jcfg, tcfg = _configs(modality, "int8", fused_blocks)
    v = _variables(modality)
    x = _inputs(modality, 2, seed=22)
    _, apply = _jax_apply(jcfg)
    want = np.asarray(apply(v, _jax_input(x)))
    pred = Predictor(tcfg, v, device="cpu")
    with recorded_convs() as calls:
        got = _port_logits(pred, x)
    assert len(calls) == (24 if fused_blocks else 244)
    np.testing.assert_allclose(got, want, rtol=0.02, atol=0.02)
