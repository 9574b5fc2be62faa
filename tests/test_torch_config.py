"""The port's configuration against the JAX package's (deepfake_tpu/config.py):
every field of the JAX tree, applied through the port's ``get_config(["--set",
...])`` at its JAX default and at another value, either configures the port
(read back under the port's name; the JAX kernel switches are aliases of the
port's) or raises, naming why: TPU-only, or waiting for the native ingest
(ROADMAP A1) or the reference checkpoints (ROADMAP A3). Neither package's
model is built, except one small audio Predictor for ``infer_bias_cache``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from deepfake_tpu.config import Config as JaxConfig
from deepfake_tpu_torch import config as T

from tests.torch_port_helpers import SMALL_FUSED, torch_on_one_thread  # noqa: F401

REASONS = ("TPU-only", "ROADMAP A1", "ROADMAP A3")


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", v


FIELDS = list(_leaves(JaxConfig()))


def _other(v):
    """A value of the field's kind other than its default."""
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)):
        return v * 2 + 1
    if isinstance(v, str):
        return v + "_other"
    if isinstance(v, tuple):
        return v[::-1] if len(set(v)) > 1 else v + v
    return "other/path"  # None: an optional path or limit


def _read(cfg, path):
    obj = cfg
    for p in T.ALIASES.get(path, path).split("."):
        obj = getattr(obj, p)
    return obj


def _same(a, b):
    return list(a) == list(b) if isinstance(a, (tuple, list)) else a == b


@pytest.mark.parametrize("path,default", FIELDS, ids=[p for p, _ in FIELDS])
def test_every_jax_field_configures_the_port_or_says_why(path, default):
    """At the JAX default and at another value: the port takes the value
    (read back equal), or it is one of ``NOT_ON_THE_CARD``'s fields and
    raises with the reason (TPU-only, ROADMAP A1 or A3); a field the port
    reads is never refused, and a refused one is never stored."""
    for value in (default, _other(default)):
        argv = ["--set", f"{path}={json.dumps(value)}"]
        try:
            cfg = T.get_config(argv)
        except ValueError as e:
            assert path in T.NOT_ON_THE_CARD, f"{path}={value!r} raised: {e}"
            assert any(r in str(e) for r in REASONS), f"{path}: {e}"
            continue
        if path in T.NOT_ON_THE_CARD:
            assert value in T.NOT_ON_THE_CARD[path][0] or tuple(value) in T.NOT_ON_THE_CARD[path][0]
            continue
        assert _same(_read(cfg, path), value), f"{path}: {_read(cfg, path)!r} != {value!r}"


def test_refusals_and_aliases():
    """data.use_native_ingest=true raises for A1 (false, what the port does,
    is taken); the pretrained dirs for A3 through --set as through their
    flags; the JAX kernel names set the port's switches; parallel.axis_names
    and prng_impl take their defaults only."""
    with pytest.raises(ValueError, match="ROADMAP A1"):
        T.get_config(["--set", "data.use_native_ingest=true"])
    T.get_config(["--set", "data.use_native_ingest=false", "--set", "data.use_native_ingest=False"])
    for name in ("wav2vec2_dir", "video_pretrained_dir", "audio_pretrained_dir"):
        with pytest.raises(ValueError, match="ROADMAP A3"):
            T.get_config(["--set", f"model.{name}=w"])
    cfg = T.get_config(["--set", "model.irv2_pallas_blocks=false",
                        "--set", "model.swin2d_pallas_attn=False",
                        "--set", "model.swin3d_pallas_attn=0"])
    assert not (cfg.model.irv2_fused_blocks or cfg.model.swin2d_attn_kernel
                or cfg.model.swin3d_attn_kernel)
    T.get_config(["--set", 'parallel.axis_names=["data", "model"]', "--set",
                  "parallel.prng_impl=auto"])
    with pytest.raises(ValueError, match="TPU-only"):
        T.get_config(["--set", 'parallel.axis_names=["batch", "model"]'])
    with pytest.raises(ValueError, match="TPU-only"):
        T.get_config(["--set", "parallel.prng_impl=rbg"])


def test_infer_bias_cache_off_computes_the_bias_each_forward():
    """parallel.infer_bias_cache=false: the Predictor keeps no bias cache and
    scores as with it (the bias is a function of the weights)."""
    from deepfake_tpu_torch.serving import Predictor

    audio = {k: v for k, v in SMALL_FUSED.items() if not k.startswith(("model.wav", "data.num",
                                                                        "data.frame"))}
    x = np.random.default_rng(0).standard_normal((2, 56, 56, 3)).astype(np.float32)
    scores = []
    for cache in (True, False):
        cfg = T.get_config(["--set", "data.modality=audio", "--set",
                            f"parallel.infer_bias_cache={json.dumps(cache)}"])
        for k, v in audio.items():
            if k != "data.modality":
                cfg.set(k, v)
        pred = Predictor(cfg, device="cpu")
        caches = [m.bias_cache for m in pred.model.modules() if hasattr(m, "bias_cache")]
        assert caches and all((c is not None) == cache for c in caches)
        scores.append(pred.predict(x))
    np.testing.assert_allclose(scores[0], scores[1], rtol=1e-6, atol=1e-6)
