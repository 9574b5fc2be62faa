"""The port's ``audio`` slice against the JAX package on the CPU: the device
front end (resample, mel image, FeatureAssembler in evaluation), SwinV2 at a
window-16 geometry on the route that reaches the large-window attention
(K6's plain version here, the Pallas ``_run_multihead`` in interpret mode on
the JAX side), the routing of SwinV2's attention by window size, and
``Predictor.predict_raw`` from raw PCM. Inputs from numpy seeds; f32."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import SMALL_FUSED, both_configs, random_variables
from tests.torch_port_helpers import torch_on_one_thread  # noqa: F401 (an autouse fixture)

from deepfake_tpu_torch.io.jax_weights import load_jax_variables

# SwinV2 at window 16 on a 128^2 image: stage 0 (32^2 tokens) has 4 windows
# of 256 tokens, shifted in its second block; stage 1 (16^2) one window of 256
SMALL_AUDIO_W16 = {
    "data.modality": "audio",
    "data.audio_size": 128,
    "model.swin2d_window": 16,
    "model.swin2d_pretrained_windows": (0, 0),
    "model.swin2d_embed_dim": 16,
    "model.swin2d_depths": (2, 2),
    "model.swin2d_heads": (2, 4),
    "parallel.compute_dtype": "float32",
}
SWIN_W16 = dict(img_size=128, num_classes=1, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                window_size=16, pretrained_window_sizes=(0, 0))


def _pcm(batch: int, samples: int, seed: int):
    """Bucket-padded PCM [batch, samples] (a decaying tone plus noise, zeros
    past each valid length) and valid lengths drawn in [0.6, 1] x samples."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000, (batch, 1)) * t) * np.exp(-t)
            + 0.1 * rng.standard_normal((batch, samples))).astype(np.float32)
    lengths = rng.integers(int(0.6 * samples), samples + 1, batch).astype(np.int32)
    lengths[-1] = samples
    wave[np.arange(samples)[None] >= lengths[:, None]] = 0.0
    return wave, lengths


def _levels(got, want):
    """Share of uint8 pixels that differ, and the largest difference."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return float((d > 0).mean()), int(d.max())


def test_resample_matches_jax():
    """16 -> 22.05 kHz polyphase resampling (scipy's resample_poly filter):
    within 1e-6 of the largest |sample| of the JAX output."""
    from deepfake_tpu.ops.resample import resample as jresample
    from deepfake_tpu_torch.ops.resample import resample, resampled_length

    wave, lengths = _pcm(2, 24000, 50)
    want = np.asarray(jresample(jnp.asarray(wave), 16000, 22050))
    got = resample(torch.from_numpy(wave), 16000, 22050).numpy()
    assert got.shape == want.shape == (2, 33075)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    assert resampled_length(24000, 16000, 22050) == 33075
    x = torch.from_numpy(wave)
    assert resample(x, 16000, 16000) is x


@pytest.mark.parametrize("size", [56, 256])
def test_mel_image_masked_matches_jax(size):
    """The uint8 mel image from 16 kHz PCM with valid lengths shorter than
    the bucket, at 56 (the mel axis downsampled, antialiased) and 256
    (upsampled): equal on >= 99.9% of pixels, never more than one level
    apart; the normalised model input within one level (1 / 255 / std) and
    equal to f32 rounding elsewhere."""
    from deepfake_tpu.data.pipeline import mel_image_masked as jmel
    from deepfake_tpu_torch.data.pipeline import mel_image_masked

    wave, lengths = _pcm(3, 64000, 51)
    kw = dict(size=size, wave_sr=16000)
    want = np.asarray(jmel(jnp.asarray(wave), jnp.asarray(lengths), raw_uint8=True, **kw))
    got = mel_image_masked(torch.from_numpy(wave), torch.from_numpy(lengths), raw_uint8=True,
                           **kw).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (3, size, size)
    share, worst = _levels(got, want)
    assert share <= 1e-3 and worst <= 1, (share, worst)
    want = np.asarray(jmel(jnp.asarray(wave), jnp.asarray(lengths), **kw))
    got = mel_image_masked(torch.from_numpy(wave), torch.from_numpy(lengths), **kw).numpy()
    d = np.abs(got - want)
    assert got.shape == want.shape == (3, size, size, 3)
    assert (d > 1e-5).mean() <= 1e-3 and d.max() <= 1.0 / 255 / 0.224 + 1e-5


FEATS = {
    # name: (overrides, feature dict maker)
    "video": ({"data.modality": "video"}, lambda r: {
        "video": r.integers(0, 256, (2, 2, 16, 16, 3), dtype=np.uint8)}),
    "audio_image": ({"data.modality": "audio"}, lambda r: {
        "audio_image": r.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)}),
    "audio_wave": ({"data.modality": "audio", "data.audio_size": 56},
                   lambda r: dict(zip(("audio_wave", "audio_len"), _pcm(2, 24000, 52)))),
    **{f"paudio_{norm}": ({"data.modality": "paudio", "data.wave_norm": norm},
                          lambda r: dict(zip(("paudio_wave", "paudio_len"), _pcm(3, 4000, 53))))
       for norm in ("batch_longest", "hf", "masked")},
    "fused": ({"data.modality": "fused", "data.audio_size": 56}, lambda r: {
        "video": r.integers(0, 256, (2, 2, 16, 16, 3), dtype=np.uint8),
        **dict(zip(("audio_wave", "audio_len"), _pcm(2, 24000, 52))),
        **dict(zip(("paudio_wave", "paudio_len"), _pcm(2, 4000, 53)))}),
}


def _assembled_close(name, got, want):
    """One assembled input against the JAX one: the mel image within one
    uint8 level (1 / 255 / std) on at most 0.1% of elements, the rest
    within 1e-5 of the largest |value|."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    d = np.abs(got - want)
    if name == "audio_wave":
        assert (d > 1e-5).mean() <= 1e-3 and d.max() <= 1.0 / 255 / 0.224 + 1e-5
    else:
        assert d.max() <= 1e-5 * max(1.0, np.abs(want).max()), (name, d.max())


@pytest.mark.parametrize("name", list(FEATS))
def test_feature_assembler_matches_jax(name):
    """FeatureAssembler(cfg, train=False) against the JAX one for every
    modality's evaluation input: frames and mel JPEGs normalised, the mel
    image from PCM (one uint8 level on at most 0.1% of pixels), the paudio
    waveform under the three wave_norm modes (and its lengths for
    batch_longest): within 1e-5; and all three in the fused order."""
    from deepfake_tpu.data.pipeline import FeatureAssembler as J
    from deepfake_tpu_torch.data.pipeline import FeatureAssembler as T

    overrides, make = FEATS[name]
    jcfg, tcfg = both_configs(overrides)
    feats = make(np.random.default_rng(54))
    labels = np.asarray([0.0, 1.0], np.float32)
    want, wl = J(jcfg, train=False)(feats, labels)
    got, tl = T(tcfg, train=False, device="cpu")(feats, labels)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))
    if name != "fused":
        got, want = (got,), (want,)
    parts = [n for n in ("video", "audio_image", "audio_wave", "paudio_wave") if n in feats]
    assert len(got) == len(want) == len(parts)
    for part, g, w in zip(parts, got, want):
        if part == "paudio_wave" and isinstance(w, tuple):  # batch_longest: (wave, lengths)
            (g, glen), (w, wlen) = g, w
            np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
        _assembled_close(part, g, w)


def test_feature_assembler_is_evaluation_only():
    """The audio input's assembly is the evaluation one in training too: a
    train assembler (which augments frames and normalises batch_longest
    waves per micro-batch) gives the mel image of the evaluation assembler,
    bit for bit, and draws nothing for it."""
    from deepfake_tpu_torch.data.pipeline import FeatureAssembler

    _, tcfg = both_configs({"data.modality": "audio", "data.audio_size": 56})
    feats = dict(zip(("audio_wave", "audio_len"), _pcm(2, 24000, 52)))
    labels = np.asarray([0.0, 1.0], np.float32)
    train = FeatureAssembler(tcfg, train=True, device="cpu")
    state = train.gen.get_state()
    got, _ = train(feats, labels)
    want, _ = FeatureAssembler(tcfg, train=False, device="cpu")(feats, labels)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(train.gen.get_state(), state)


@functools.lru_cache(maxsize=None)
def _swin_w16_case(batch):
    """Inputs, random JAX weights and the JAX logits of SwinV2 at window 16
    with use_pallas=True, which reaches pallas_window_attention's
    _run_multihead (interpret mode) in every block; the head groups it ran."""
    from deepfake_tpu.models.swin2d import SwinTransformerV2 as J
    from deepfake_tpu.ops import pallas_window_attn as P

    x = np.random.default_rng(55).standard_normal((batch, 128, 128, 3)).astype(np.float32)
    jm = J(use_pallas=True, **SWIN_W16)
    variables = random_variables(jm, jnp.asarray(x), True, seed=56)
    shapes, run = [], P._run_multihead
    apply = jax.jit(functools.partial(jm.apply, deterministic=True, return_logits=True))
    try:
        P._run_multihead = lambda q, *a, **k: shapes.append(q.shape) or run(q, *a, **k)
        want = np.asarray(apply(variables, jnp.asarray(x)))
    finally:
        P._run_multihead = run
    return x, variables, want, shapes


@pytest.mark.parametrize("batch", [2, 1], ids=["b2", "b1"])
@pytest.mark.parametrize("kernel", [True, False], ids=["k6_route", "plain_route"])
def test_swin_v2_window16_matches_jax_multihead(kernel, batch):
    """SwinV2 at img 128, window 16, embed 16, depths (2, 2), heads (2, 4)
    (N = 256 in both stages, shifted and unshifted) against the JAX model
    with use_pallas=True, whose four blocks all run _run_multihead: logits
    within 1e-4, on the kernel route (K6's plain version here) and the plain
    route."""
    from deepfake_tpu_torch.models.swin2d import SwinTransformerV2 as T

    x, variables, want, shapes = _swin_w16_case(batch)
    assert shapes == [(4 * batch, 2, 256, 8)] * 2 + [(batch, 4, 256, 8)] * 2
    tm = load_jax_variables(T(attn_kernel=kernel, **SWIN_W16), variables)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), return_logits=True).numpy()
    np.testing.assert_allclose(got, np.atleast_1d(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("res,ws,batch,route", [
    (32, 16, 2, "multihead"), (16, 16, 2, "multihead"), (16, 16, 1, "multihead"),
    (14, 7, 2, "tokens"), (7, 7, 1, "heads"), (20, 10, 2, "multihead"),
    (48, 24, 1, "multihead")],
    ids=["N256_B8_shifted", "N256_B2", "N256_B1", "N49_B8", "N49_B1", "N100_B8_shifted",
         "N576_B4_shifted"])
def test_swin_block_routes_attention_by_window(monkeypatch, res, ws, batch, route):
    """With the kernels on, a SwinV2 block sends windows of N <= 64 tokens to
    K2 (token-major for B_ >= 2, head-major for B_ == 1, as swin2d.py:181-249
    routes the Pallas kernels) and every larger window to K6 whatever B_ is:
    window 10 (N = 100, which the Pallas routes send to _run) and window 24
    (N = 576, the 384^2 fine-tunes) included; exactly one attention call per
    block."""
    from deepfake_tpu_torch.models import swin2d

    calls = {"multihead": 0, "tokens": 0, "heads": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        attr = f"window_attention_{name}"
        monkeypatch.setattr(swin2d, attr, spy(name, getattr(swin2d, attr)))
    block = swin2d.SwinBlock(64, (res, res), 2, window_size=ws, shift_size=ws // 2,
                             attn_kernel=True)
    x = torch.from_numpy(np.random.default_rng(57).standard_normal(
        (batch, res * res, 64)).astype(np.float32))
    with torch.inference_mode():
        out = block(x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert calls == {n: int(n == route) for n in calls}, calls


def _jax_predictor(jcfg, variables):
    from deepfake_tpu.serving import Predictor

    return Predictor(jcfg, variables)


def _raw_case(overrides, feats, seed, kernels=True):
    """(JAX scores, port scores) of predict_raw on the same weights."""
    from deepfake_tpu.models.registry import build_model, example_inputs
    from deepfake_tpu_torch.serving import Predictor

    jcfg, tcfg = both_configs(overrides)
    jcfg.model.swin2d_pallas_attn = kernels
    tcfg.model.swin2d_attn_kernel = tcfg.model.irv2_fused_blocks = kernels
    model = build_model(jcfg)
    variables = random_variables(model, *example_inputs(jcfg, batch=1), deterministic=True,
                                 seed=seed)
    want = _jax_predictor(jcfg, variables).predict_raw(feats)
    got = Predictor(tcfg, variables, device="cpu").predict_raw(feats)
    return want, got


def test_predict_raw_audio_window16_matches_jax():
    """predict_raw for ``audio`` from bucket-padded 16 kHz PCM (4 s, valid
    2.5-4 s) at the window-16 geometry, the JAX side through
    _run_multihead: scores within 1e-3 (PARITY.md:5-6)."""
    wave, lengths = _pcm(2, 64000, 58)
    want, got = _raw_case(SMALL_AUDIO_W16, {"audio_wave": wave, "audio_len": lengths}, 59)
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_predict_raw_paudio_matches_jax():
    """predict_raw for ``paudio`` (the batch_longest waveform and its
    lengths) at the small geometry of tests/test_torch_serving.py: scores
    within 1e-3."""
    wave, lengths = _pcm(2, 16000, 61)
    want, got = _raw_case(dict(SMALL_FUSED, **{"data.modality": "paudio"}),
                          {"paudio_wave": wave, "paudio_len": lengths}, 62)
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_predict_raw_fused_is_assembly_then_predict():
    """``fused`` predict_raw (uint8 frames, PCM to the mel image and to the
    waveform) is the FeatureAssembler's output through ``predict``: the same
    scores. The assembler's fused output is held against the JAX one in
    test_feature_assembler_matches_jax[fused], and ``predict`` against the
    JAX fused model in tests/test_torch_serving.py (the JAX fused Predictor's
    compile is left out of this file to keep it short)."""
    from deepfake_tpu_torch.serving import Predictor

    _, tcfg = both_configs(SMALL_FUSED)
    pred = Predictor(tcfg, device="cpu")
    wave, lengths = _pcm(2, 16000, 61)
    feats = {"video": np.random.default_rng(60).integers(0, 256, (2, 2, 96, 96, 3), np.uint8),
             "audio_wave": wave, "audio_len": lengths, "paudio_wave": wave,
             "paudio_len": lengths}
    got = pred.predict_raw(feats)
    assert got.shape == (2,) and np.isfinite(got).all()
    inputs, _ = pred._assemble(feats, np.zeros(1, np.float32))
    np.testing.assert_array_equal(got, pred.predict(inputs))


def test_predict_raw_fused_matches_jax():
    """``fused`` predict_raw from uint8 frames and 16 kHz PCM (the mel image
    and the waveform) against the JAX fused Predictor's raw path, at the
    small fused geometry of tests/test_torch_serving.py with the same
    weights, both on their kernel routes (the JAX side's Pallas kernels in
    interpret mode): f32 scores within 1e-4."""
    wave, lengths = _pcm(2, 16000, 63)
    feats = {"video": np.random.default_rng(64).integers(0, 256, (2, 2, 96, 96, 3), np.uint8),
             "audio_wave": wave, "audio_len": lengths, "paudio_wave": wave,
             "paudio_len": lengths}
    want, got = _raw_case(SMALL_FUSED, feats, 65)
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_score_file_is_not_ported(tmp_path):
    """score_file is ported (its name is kept from when it raised): for
    ``audio`` it reads the clip's PCM sidecar, pads it to its bucket and
    scores it at batch 1, the score of predict_raw on those arrays (its
    parity with the JAX score_file: tests/test_torch_submit.py)."""
    from scipy.io import wavfile

    from deepfake_tpu_torch.serving import Predictor

    _, tcfg = both_configs(SMALL_AUDIO_W16)
    pred = Predictor(tcfg, device="cpu")
    wave, _ = _pcm(1, 40000, 66)
    wavfile.write(str(tmp_path / "clip.wav"), 16000, (wave[0] * 32767).astype(np.int16))
    (tmp_path / "clip.mp4").write_bytes(b"")
    got = pred.score_file(str(tmp_path / "clip.mp4"))
    pcm = np.zeros((1, 64000), np.float32)
    pcm[0, :40000] = (wave[0] * 32767).astype(np.int16) / np.float32(32768.0)
    want = pred.predict_raw({"audio_wave": pcm, "audio_len": np.array([40000], np.int32)})
    assert isinstance(got, float) and got == float(want[0])
