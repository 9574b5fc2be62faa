"""``model.parity_inference_dropout`` in the port's Predictor
(deepfake_tpu_torch/models/registry.py::inference_dropout, serving.py), the
reference's ungated F.dropout at the three sites the JAX package gates on
the flag: the IRv2 pool (inception_resnet_v2.py:400), NeXtVLAD
(nextvlad.py:136) and the paudio head (audio2d.py:40). The two packages'
random streams differ, so nothing here compares masks with JAX:

* off (the default), a Predictor's scores are the eval forward's with
  every dropout taken out, to the bit, and it draws nothing;
* on, the same request twice gives the same scores (the Predictor resets
  its generator before each request), other scores than off, and each
  site zeroes a share of its elements within 3 sigma of its rate.
SMALL_FUSED and the paudio model at its widths, f32 on the CPU.
"""

import math

import numpy as np
import pytest
import torch
from torch import nn

from tests.torch_port_helpers import SMALL_FUSED

PAUDIO = {k: v for k, v in SMALL_FUSED.items() if k.startswith(("model.wav", "parallel."))}
PAUDIO["data.modality"] = "paudio"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(overrides, flag: bool):
    from deepfake_tpu_torch.config import Config

    cfg = Config()
    for k, v in overrides.items():
        cfg.set(k, v)
    cfg.model.parity_inference_dropout = flag
    return cfg


def _request(modality):
    rng = np.random.default_rng(80)
    wave = rng.standard_normal((2, 16000)).astype(np.float32)
    if modality == "paudio":
        return wave
    return (rng.standard_normal((2, 2, 96, 96, 3)).astype(np.float32),
            rng.standard_normal((2, 56, 56, 3)).astype(np.float32), wave)


SITES = {"fused": ("video_extractor.inception.drop", "video_extractor.vlad_drop",
                   "paudio_extractor.model_drop"),
         "paudio": ("model_drop", "classify_drop")}


@pytest.mark.parametrize("modality", ["fused", "paudio"])
def test_off_is_the_eval_forward(modality):
    """Flag off: no dropout acts at serving and the Predictor registers no
    generator; its scores equal the model's eval forward with every Dropout
    replaced by the identity, to the bit."""
    from deepfake_tpu_torch.models.layers import Dropout
    from deepfake_tpu_torch.serving import Predictor

    over = SMALL_FUSED if modality == "fused" else PAUDIO
    pred = Predictor(_cfg(over, False), device="cpu")
    assert pred.dropout is None
    assert not any(m.at_inference for m in pred.model.modules() if isinstance(m, Dropout))
    x = _request(modality)
    got = pred.predict(x)
    for name, mod in list(pred.model.named_modules()):
        for child, sub in list(mod.named_children()):
            if isinstance(sub, Dropout) and type(sub) is Dropout:
                setattr(mod, child, nn.Identity())
    with torch.inference_mode():
        want = pred._scores(pred._model(x))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("modality", ["fused", "paudio"])
def test_on_repeats_per_request_and_keeps_its_rates(modality):
    """Flag on: the same request twice gives the same scores (one mask per
    request shape), they differ from the flag-off scores of the same
    weights, and each site zeroes its rate of its elements (within 3 sigma,
    counted where its input is nonzero), x / (1 - rate) elsewhere."""
    from deepfake_tpu_torch.serving import Predictor

    over = SMALL_FUSED if modality == "fused" else PAUDIO
    x = _request(modality)
    off = Predictor(_cfg(over, False), device="cpu").predict(x)
    pred = Predictor(_cfg(over, True), device="cpu")
    sites = dict(pred.model.named_modules())
    seen = {}
    for name in SITES[modality]:
        mod = sites[name]
        assert mod.at_inference and not mod.training and mod.rate > 0

        def hook(m, args, out, name=name):
            (inp,) = args
            live = inp != 0
            seen.setdefault(name, []).append(
                (((out == 0) & live).sum().item(), live.sum().item()))
            torch.testing.assert_close(out[out != 0], inp[out != 0] / (1 - m.rate))

        mod.register_forward_hook(hook)
    first, second = pred.predict(x), pred.predict(x)
    assert np.array_equal(first, second)
    assert not np.array_equal(first, off)
    for name in SITES[modality]:
        a, b = seen[name]
        assert a == b, name  # the same mask on both requests
        zeros, live = a
        p = sites[name].rate
        sigma = math.sqrt(p * (1 - p) / live)
        assert abs(zeros / live - p) <= 3 * sigma, (name, zeros / live, p, sigma, live)


def test_a_missing_site_raises():
    """A site that is gone (renamed, or no longer a Dropout) raises where the
    flag is applied, rather than leaving that site off in silence."""
    from deepfake_tpu_torch.models.registry import build_model, inference_dropout

    model = build_model(_cfg(PAUDIO, False), "cpu")
    model.classify_drop = nn.Identity()
    with pytest.raises(AttributeError, match="Audio2D.classify_drop"):
        inference_dropout(model)
