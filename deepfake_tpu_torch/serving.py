"""Serving: an inference handle around any modality (deepfake_tpu/serving.py:25-101).

    pred = Predictor(cfg)                       # seeded random weights, on the card
    pred = Predictor(cfg, variables)            # weights from the JAX package's tree
    probs = pred.predict((frames, mel, wave))   # model-ready numpy/torch inputs
    probs = pred.predict_raw({"audio_wave": pcm, "audio_len": lengths})  # raw inputs

Inputs keep the JAX contract: frames NTHWC float32, mel image NHWC, wave
[B, T] or a (wave, lengths) pair. ``video_swin`` takes NTHWC clips of the
configured length and size; its model returns (scores, per-frame
features), of which ``predict`` returns the scores. ``predict_raw`` takes
the dataset's raw dict (uint8 frames, bucket-padded 16 kHz PCM and valid
lengths) and assembles the model inputs on the Predictor's device
(data/pipeline.py::FeatureAssembler). ``score_file`` waits for video decode.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.data.pipeline import FeatureAssembler
from deepfake_tpu_torch.models.registry import (
    build_model, compute_dtype, pack_block_weights, precompute_bias_cache, resolve_device,
)


class Predictor:
    """Builds the model once on ``device`` (the card unless the caller passes
    ``device="cpu"``; raises when there is no card and none was named),
    loads ``variables`` or draws seeded random weights, computes the
    inference caches from the f32 weights, then casts the parameters to
    ``cfg.parallel.compute_dtype``."""

    def __init__(self, cfg: Config, variables: Optional[Dict[str, Any]] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # f32 means parity: full-precision products, no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = build_model(cfg, self.device)
        if variables is not None:
            from deepfake_tpu_torch.io.jax_weights import load_jax_variables

            load_jax_variables(model, variables)
        precompute_bias_cache(model)
        pack_block_weights(model, self.dtype)
        # parameters in the compute type, buffers (BatchNorm running
        # statistics, shift masks) kept in f32, as the JAX package keeps
        # batch_stats f32 (registry.py::cast_inference_params)
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(self.dtype)
        self.model = model
        self._assemble = FeatureAssembler(cfg, train=False, device=self.device)

    def _put(self, x):
        if isinstance(x, (tuple, list)):
            return type(x)(self._put(v) for v in x)
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if t.is_floating_point():
            t = t.to(self.device, self.dtype)
        return t.to(self.device)

    def _inputs(self, inputs):
        if self.cfg.data.modality == "fused":
            video, audio, wave = inputs
            if isinstance(wave, (tuple, list)):
                # lengths stay integers; the wave takes the compute dtype
                wave = (self._put(wave[0]), self._put(wave[1]))
            else:
                wave = self._put(wave)
            return (self._put(video), self._put(audio), wave)
        return self._put(inputs)

    @torch.inference_mode()
    def forward(self, inputs):
        """Model-ready inputs -> the model's output on the device: scores, or
        (scores, per-frame features) for video_swin."""
        return self.model(self._inputs(inputs))

    def predict(self, inputs) -> np.ndarray:
        """Model-ready inputs (a tuple for fused) -> sigmoid scores [B]."""
        out = self.forward(inputs)
        if isinstance(out, tuple):
            out = out[0]
        return np.atleast_1d(out.float().cpu().numpy())

    @torch.inference_mode()
    def predict_raw(self, feats: Dict[str, Any]) -> np.ndarray:
        """Raw batch dict (``video``, ``audio_image``, ``audio_wave`` /
        ``audio_len``, ``paudio_wave`` / ``paudio_len``) -> sigmoid scores [B].
        The features are assembled in f32 on the device; only the assembled
        inputs take the compute type (a bf16 waveform would move the mel
        image)."""
        inputs, _ = self._assemble(feats, np.zeros(1, np.float32))
        return self.predict(inputs)

    def score_file(self, path: str) -> float:
        """One video file end to end: needs the video decoder, not ported."""
        raise NotImplementedError("score_file needs video decode, which is not ported")
