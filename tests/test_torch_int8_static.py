"""int8_static serving in the port against the JAX package, on the CPU in
f32: ``Predictor.calibrate`` against ``calibrate_act_scales``, a carried JAX
``quant_cache``, static against dynamic, and ``SubmitCtl.calibrate`` with
``load_checkpoint``; the video model at the tests' small geometry (2 frames
of 96^2) with K1 on (its 24 int8 convs), through ``Predictor``. torch runs
on one thread.

Tolerances: calibrated scales: the stem's first conv, which reads the
input, to the bit; every scale within rtol 5e-3, not 1e-5: a conv whose
input comes through an earlier int8 conv sees that conv's one-step rounding
flips (tests/test_torch_int8.py), and 10 of the 24 scales here differ from
JAX's by up to 3.25e-3 relative (the other 14 by less than 1e-5); logits
within 0.02 max(1, |logit|); static on its calibration batch and
uncalibrated static equal to dynamic to the bit (the same ops)."""

import numpy as np
import pytest
import torch

from tests.test_torch_int8_models import (
    _calibrated, _configs, _inputs, _jax_apply, _jax_input, _port_logits, _variables,
)

from deepfake_tpu_torch.serving import Predictor


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- (f) static mode

@pytest.fixture(scope="module")
def static_video():
    """The video model with K1 on at int8_static: the JAX package calibrated
    on two batches (calibrate_act_scales), its static and dynamic logits on
    a batch of four times the calibration scale (so the static scales
    saturate), and the batches."""
    from deepfake_tpu.models.registry import calibrate_act_scales

    jcfg, _ = _configs("video", "int8_static", True)
    v = _variables("video")
    calib = [_inputs("video", 2, seed=23), _inputs("video", 2, seed=24, scale=0.7)]
    served = _inputs("video", 2, seed=25, scale=2.0)
    model, apply = _jax_apply(jcfg)
    vc = calibrate_act_scales(model, v, [(_jax_input(b),) for b in calib])
    return {"variables": v, "calibrated": vc, "calib": calib, "served": served,
            "static": np.asarray(apply(vc, _jax_input(served)))}


def test_calibrated_scales_match_jax(static_video):
    """Predictor.calibrate on the JAX calibration's two batches records the
    running max of each of the 24 int8 convs' inputs as JAX's quant_cache:
    the stem's f0 to the bit, all within rtol 5e-3 (see the module's note),
    leaf by leaf by path."""
    _, tcfg = _configs("video", "int8_static", True)
    pred = Predictor(tcfg, static_video["variables"], device="cpu")
    assert _calibrated(pred) == 0
    assert pred.calibrate(static_video["calib"]) == 24
    want = {}

    def walk(tree, path=()):
        for k, val in tree.items():
            if hasattr(val, "items"):
                walk(val, path + (k,))
            else:
                want[".".join(path + (k,))] = float(np.asarray(val))

    walk(static_video["calibrated"]["quant_cache"])
    got = {f"{name}.{leaf}": getattr(m, leaf).item() for name, m in pred.model.named_modules()
           for leaf in getattr(m, "calibrated", ())}
    assert sorted(got) == sorted(want) and len(got) == 24
    assert got["inception.stem.f0.act_amax"] == want["inception.stem.f0.act_amax"]
    np.testing.assert_allclose([got[k] for k in sorted(got)], [want[k] for k in sorted(got)],
                               rtol=5e-3, atol=0)


def test_carried_quant_cache_serves_like_jax_static(static_video):
    """A Predictor built from the JAX variables with their quant_cache
    counts as calibrated and serves like JAX's static forward (logits
    within 0.02 max(1, |logit|)), and not like the dynamic one it would run
    uncalibrated."""
    _, tcfg = _configs("video", "int8_static", True)
    pred = Predictor(tcfg, static_video["calibrated"], device="cpu")
    assert _calibrated(pred) == 24
    got = _port_logits(pred, static_video["served"])
    np.testing.assert_allclose(got, static_video["static"], rtol=0.02, atol=0.02)
    dynamic = Predictor(tcfg, static_video["variables"], device="cpu")
    assert not np.array_equal(_port_logits(dynamic, static_video["served"]), got)


def test_static_equals_dynamic_where_the_scales_agree(static_video):
    """A Predictor starts uncalibrated, and uncalibrated int8_static equals
    int8 to the bit (the JAX fallback); calibrated on one batch, static on
    that batch equals dynamic to the bit (the same scales and kernels)."""
    _, dyn_cfg = _configs("video", "int8", True)
    _, tcfg = _configs("video", "int8_static", True)
    v, (batch, _), served = (static_video["variables"], static_video["calib"],
                             static_video["served"])
    dynamic = Predictor(dyn_cfg, v, device="cpu")
    pred = Predictor(tcfg, v, device="cpu")
    assert _calibrated(pred) == 0
    np.testing.assert_array_equal(_port_logits(pred, served), _port_logits(dynamic, served))
    assert pred.calibrate([batch]) == 24
    np.testing.assert_array_equal(_port_logits(pred, batch), _port_logits(dynamic, batch))


def test_submitctl_calibrate_then_load_checkpoint(static_video, tmp_path):
    """SubmitCtl.calibrate (input tuples or bare arrays, submit.py:112-121)
    calibrates the Predictor's model; load_checkpoint serves the
    checkpoint's weights uncalibrated (the stale-cache strip, submit.py:66-72),
    so int8_static runs dynamic again until the next calibrate."""
    from deepfake_tpu_torch.io.checkpoint import save_checkpoint
    from deepfake_tpu_torch.io.jax_weights import load_jax_variables
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.submit import SubmitCtl
    from deepfake_tpu_torch.train.trainer import Trainer

    class NoBatches:
        def train_loader(self):
            return []

    _, tcfg = _configs("video", "int8_static", True)
    v, calib, served = static_video["variables"], static_video["calib"], static_video["served"]
    ctl = SubmitCtl(Predictor(tcfg, device="cpu"), tcfg, data=None, logger=lambda s: None)
    assert _calibrated(ctl.predictor) == 0
    assert ctl.calibrate([calib[0], (calib[1],)]) == 24
    model = load_jax_variables(build_model(tcfg, "cpu", train=True), v)
    path = save_checkpoint(str(tmp_path / "ckpt"), Trainer(model, tcfg, NoBatches(),
                                                           logger=lambda s: None, device="cpu"))
    ctl.load_checkpoint(path)
    assert _calibrated(ctl.predictor) == 0
    _, dyn_cfg = _configs("video", "int8", True)
    want = _port_logits(Predictor(dyn_cfg, v, device="cpu"), served)
    np.testing.assert_array_equal(_port_logits(ctl.predictor, served), want)
    assert ctl.calibrate(calib) == 24
