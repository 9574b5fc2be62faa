"""Compiled serving (deepfake_tpu_torch/compiled.py) on the CPU: the graph
key, and the Predictor's route choice. Graph capture and replay need the
card; tests/test_torch_cuda.py holds graphs against the eager route there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfake_tpu_torch.compiled import signature
from deepfake_tpu_torch.ops import kernel_wrappers, launch_counts

from tests.torch_port_helpers import SMALL_FUSED, both_configs, random_variables
from tests.torch_port_helpers import torch_on_one_thread  # noqa: F401 (an autouse fixture)


def _raw(batch=2, samples=16000, frames=(2, 96, 96), keys=("video", "audio_wave", "audio_len"),
         wave_dtype=np.float32):
    rng = np.random.default_rng(0)
    full = {"video": rng.integers(0, 256, (batch, *frames, 3), dtype=np.uint8),
            "audio_wave": rng.standard_normal((batch, samples)).astype(wave_dtype),
            "audio_len": np.full(batch, samples, np.int64),
            "paudio_wave": rng.standard_normal((batch, samples)).astype(wave_dtype),
            "paudio_len": np.full(batch, samples, np.int64)}
    return {k: full[k] for k in keys}


def test_same_request_shape_gives_one_key():
    """Values do not enter the key: two requests of one shape (other PCM,
    other valid lengths) share a graph; numpy and torch arrays alike."""
    a, b = _raw(), _raw()
    b["audio_wave"] = b["audio_wave"] * 0.5
    b["audio_len"] = np.asarray([9000, 16000])
    assert signature("raw", "fused", a) == signature("raw", "fused", b)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    assert signature("raw", "fused", t) == signature("raw", "fused", a)
    x = np.zeros((2, 56, 56, 3), np.float32)
    assert signature("predict", "audio", x) == signature("predict", "audio", x + 1)


@pytest.mark.parametrize("change", [
    "batch", "bucket", "frames", "dtype", "modality", "keys", "route", "nesting"])
def test_another_shape_gives_another_key(change):
    base = signature("raw", "fused", _raw())
    other = {
        "batch": lambda: signature("raw", "fused", _raw(batch=3)),
        "bucket": lambda: signature("raw", "fused", _raw(samples=32000)),
        "frames": lambda: signature("raw", "fused", _raw(frames=(4, 96, 96))),
        "dtype": lambda: signature("raw", "fused", _raw(wave_dtype=np.float64)),
        "modality": lambda: signature("raw", "audio", _raw()),
        "keys": lambda: signature("raw", "fused", _raw(
            keys=("video", "audio_wave", "audio_len", "paudio_wave", "paudio_len"))),
        "route": lambda: signature("predict", "fused", _raw()),
        "nesting": lambda: signature("raw", "fused", tuple(_raw().values())),
    }[change]()
    assert other != base


def test_fused_wave_lengths_pair_is_part_of_the_key():
    """The fused (frames, mel, (wave, lengths)) form keys apart from
    (frames, mel, wave), and the lengths' dtype counts."""
    v, m, w = (np.zeros(s, np.float32) for s in ((2, 2, 96, 96, 3), (2, 56, 56, 3), (2, 4000)))
    plain = signature("predict", "fused", (v, m, w))
    pair = signature("predict", "fused", (v, m, (w, np.zeros(2, np.int32))))
    pair64 = signature("predict", "fused", (v, m, (w, np.zeros(2, np.int64))))
    assert len({plain, pair, pair64}) == 3


def test_kernel_wrappers_are_counted():
    names = set(kernel_wrappers())
    assert {"inception_block", "window_attn3d_tokens", "window_attn3d_train_fwd",
            "window_attn3d_train_bwd", "window_attention_multihead", "ln_linear",
            "mlp_tail"} <= names
    assert set(launch_counts()) == names and all(
        isinstance(v, int) for v in launch_counts().values())


@pytest.fixture(scope="module")
def audio_case():
    """A small audio model (SwinV2 on a 56^2 mel image), randomised JAX
    weights and a b2 raw PCM request."""
    from deepfake_tpu.models.registry import build_model, example_inputs

    jcfg, tcfg = both_configs(dict(SMALL_FUSED, **{"data.modality": "audio"}))
    model = build_model(jcfg)
    variables = random_variables(model, *example_inputs(jcfg, batch=1), deterministic=True,
                                 seed=71)
    rng = np.random.default_rng(72)
    samples = int(jcfg.data.wave_seconds_buckets[0] * jcfg.data.wave_sample_rate)
    wave = (0.1 * rng.standard_normal((2, samples))).astype(np.float32)
    lengths = np.asarray([int(0.7 * samples), samples], np.int32)
    wave[0, lengths[0]:] = 0
    return jcfg, tcfg, variables, {"audio_wave": wave, "audio_len": lengths}


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
def test_cpu_predictor_is_eager_and_matches_jax(audio_case, compiled):
    """On the CPU a Predictor keeps no graph cache whatever ``compiled``
    says, captures nothing and moves no launch counter; its scores (raw and
    model-ready) equal the JAX Predictor's within 1e-4."""
    from deepfake_tpu.serving import Predictor as JaxPredictor
    from deepfake_tpu_torch.serving import Predictor

    jcfg, tcfg, variables, feats = audio_case
    pred = Predictor(tcfg, variables, device="cpu", compiled=compiled)
    assert pred.graphs is None
    before = launch_counts()
    got_raw = pred.predict_raw(feats)
    inputs, _ = pred._assemble(feats, np.zeros(1, np.float32))
    got = pred.predict(inputs.numpy())
    assert launch_counts() == before
    jax_pred = JaxPredictor(jcfg, variables)
    want_raw = np.asarray(jax_pred.predict_raw(feats))
    want = np.asarray(jax_pred.predict(jnp.asarray(inputs.numpy())))
    np.testing.assert_allclose(got_raw, want_raw, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    out = pred.forward(inputs.numpy())
    assert out.device.type == "cpu" and out.shape[0] == 2
    logits = pred.forward(feats, return_logits=True, raw=True)
    np.testing.assert_allclose(torch.sigmoid(logits).numpy(), got_raw, atol=1e-6, rtol=0)
