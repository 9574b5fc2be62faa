"""Serving: an inference handle around any modality (deepfake_tpu/serving.py:25-101).

    pred = Predictor(cfg)                       # seeded random weights, on the card
    pred = Predictor(cfg, compiled=False)       # the eager route, on the card
    pred = Predictor(cfg, variables)            # weights from the JAX package's tree
    pred = Predictor.from_checkpoint(cfg, path) # weights from a training checkpoint
    pred = Predictor(cfg, mesh=mesh)            # one data rank of batch-sharded serving
    probs = pred.predict((frames, mel, wave))   # model-ready numpy/torch inputs
    probs = pred.predict_raw({"audio_wave": pcm, "audio_len": lengths})  # raw inputs
    pred.calibrate([inputs, ...])               # model.irv2_quant = int8_static: record scales

Inputs keep the JAX contract: frames NTHWC float32, mel image NHWC, wave
[B, T] or a (wave, lengths) pair. ``video_swin`` takes NTHWC clips of the
configured length and size; its model returns (scores, per-frame
features), of which ``predict`` returns the scores. ``predict_raw`` takes
the dataset's raw dict (uint8 frames, bucket-padded 16 kHz PCM and valid
lengths) and assembles the model inputs on the Predictor's device
(data/pipeline.py::FeatureAssembler). ``score_file`` decodes one video file
(``data/dataset.py``) and scores it at batch 1.

Routes. On the card a Predictor is compiled by default (``compiled=True``):
``predict``, ``predict_raw`` and ``forward`` run each request shape as one
CUDA graph (``compiled.py``, the counterpart of the JAX Predictor's
``jax.jit``); ``predict_raw`` captures the front end and the model in one
graph, as the JAX front end is one jitted program. A capture or replay that
fails raises. ``compiled=False`` runs every op eagerly from Python: the
reference route that the graphs are held against. On the CPU
(``device="cpu"``) a Predictor always runs eagerly (the kernel wrappers take
their plain versions for CPU tensors, and there is nothing to capture).

int8 serving (``model.irv2_quant``, ``models/layers.py::Int8Owner``): the
int8 weights are folded and quantised once from the f32 weights, beside
K1's packed weights. A Predictor starts uncalibrated, whatever built its
weights (the seeded init, ``variables`` without a ``quant_cache``, a
checkpoint): int8_static runs the dynamic computation until ``calibrate``
records the scales on representative batches (or ``variables`` carries the
JAX package's ``quant_cache``). ``calibrate`` drops the Predictor's graphs:
a static graph launches other kernels than a dynamic one. A dynamic graph
zeroes each scalar it reduces into on every replay (K8's first launch).

Under a mesh (``parallel/mesh.py``; deepfake_tpu/serving.py:31-40, 62-64)
serving is data-parallel: every rank holds the whole model, as the JAX
Predictor replicates its weights. ``predict``, ``predict_raw`` and
``forward`` take the global batch on every rank; a ragged one is padded to
a multiple of the data axis by repeating its last row, each data rank runs
its contiguous block of rows (through its own graph), and the outputs are
all-gathered over the data axis into input order, outside the graph, and
trimmed. Statistics that span the batch (the batch-longest wave, int8's
per-tensor max) are taken over the global batch. ``score_file`` runs at
batch 1 on the calling rank alone.

``model.parity_inference_dropout`` (off by default) keeps the reference's
ungated dropouts active (``registry.inference_dropout``: the IRv2 pool,
NeXtVLAD, the paudio head). Their masks come from the Predictor's own
generator (the seed's dropout stream), reset to one state before every
request, on the eager route and before every graph replay alike, so one
request shape draws the same masks on every call, as the JAX Predictor's
fixed key does (deepfake_tpu/serving.py:45). A mesh with a data axis above 1
raises for it: its ranks would each draw their rows' masks from that one
state, not one device's masks for those rows.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepfake_tpu_torch.compiled import GraphCache, signature
from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.data.pipeline import FeatureAssembler
from deepfake_tpu_torch.io.checkpoint import load_model_state, read_checkpoint
from deepfake_tpu_torch.models.layers import set_dropout_generator
from deepfake_tpu_torch.models.registry import (
    build_model, calibrate_act_scales, compute_dtype, pack_block_weights, pack_int8_weights,
    precompute_bias_cache, resolve_device,
)
from deepfake_tpu_torch.parallel import mesh as pm
from deepfake_tpu_torch.train.submit import pad_rows
from deepfake_tpu_torch.utils.seeding import make_generators


class Predictor:
    """Builds the model once on ``device`` (the card unless the caller passes
    ``device="cpu"``; raises when there is no card and none was named),
    loads ``variables`` (the JAX package's tree) or ``state`` (a training
    checkpoint's model state, the port's names) or draws seeded random
    weights, computes the inference caches from the f32 weights, then casts
    the parameters to ``cfg.parallel.compute_dtype``. ``compiled``: on the
    card, each request shape runs as one CUDA graph (see the module's
    note)."""

    def __init__(self, cfg: Config, variables: Optional[Dict[str, Any]] = None, device=None,
                 compiled: bool = True, state: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None):
        if cfg.model.parity_inference_dropout and mesh is not None and mesh.data > 1:
            # each rank would draw its rows' masks from the one reset state:
            # rank 0's masks, not those one device draws for those rows
            raise ValueError(f"model.parity_inference_dropout at a data axis of {mesh.data}: "
                             "its masks are one device's draw over the whole batch; serve it "
                             "on a mesh of data 1")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        self.graphs = GraphCache(self.device) if compiled and self.device.type == "cuda" else None
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # f32 means parity: full-precision products, no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = build_model(cfg, self.device)
        if variables is not None:
            from deepfake_tpu_torch.io.jax_weights import load_jax_variables

            load_jax_variables(model, variables)
        if state is not None:
            # before the caches below: K1's packed weights and the bias
            # tables are computed from the loaded weights
            load_model_state(model, state)
        if cfg.parallel.infer_bias_cache:
            precompute_bias_cache(model)
        pack_block_weights(model, self.dtype)
        pack_int8_weights(model)
        # parameters in the compute type, buffers (BatchNorm running
        # statistics, shift masks) kept in f32, as the JAX package keeps
        # batch_stats f32 (registry.py::cast_inference_params)
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(self.dtype)
        if mesh is not None:
            pm.attach(model, mesh)
        # model.parity_inference_dropout: the ungated dropouts draw from this
        # generator, reset to one state before every request (eager) or
        # every replay (a graph: registered, its state set by the prologue)
        self.dropout, self._dropout_state = None, None
        if cfg.model.parity_inference_dropout:
            self.dropout = make_generators(cfg.random_seed, self.device).dropout
            self._dropout_state = self.dropout.get_state()
            set_dropout_generator(model, self.dropout)
        self.model = model
        self._assemble = FeatureAssembler(cfg, train=False, device=self.device, mesh=mesh)
        # predict_raw's labels: none, as one zero on the device (a graph
        # cannot capture a copy from pageable host memory)
        self._no_labels = torch.zeros(1, device=self.device)

    @classmethod
    def from_checkpoint(cls, cfg: Config, path: str, device=None,
                        compiled: bool = True, mesh=None) -> "Predictor":
        """Serves the weights and BatchNorm statistics of a training
        checkpoint (``Trainer.save_ckpt``; deepfake_tpu/serving.py:67-78),
        loaded strictly into the serving model before its caches are
        computed."""
        return cls(cfg, device=device, compiled=compiled, state=read_checkpoint(path)["model"],
                   mesh=mesh)

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

    def _model(self, inputs):
        """(scores, logits), with the per-frame features for video_swin: the
        model's sigmoid applied here, so that a graph keeps the logits too."""
        out = self.model(self._inputs(inputs), return_logits=True)
        logits, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        return (torch.sigmoid(logits), logits, *rest)

    def _raw(self, feats):
        inputs, _ = self._assemble(feats, self._no_labels)
        return self._model(inputs)

    def _run(self, route: str, fn, inputs):
        """``fn(inputs)`` eagerly, or through the graph of the request's
        signature (its static outputs); under a mesh on this data rank's rows
        of the global batch, the outputs gathered and trimmed (see the
        module's note)."""
        if self.mesh is None or route == "file":
            return self._call(route, fn, inputs)
        inputs, n = self._rows(inputs)
        out = self._call(route, fn, inputs)
        return tuple(pm.gather_from(t, self.mesh.data_group, dim=0)[:n] for t in out)

    def _reset_dropout(self) -> None:
        if self.dropout is not None:
            self.dropout.set_state(self._dropout_state)

    def _call(self, route: str, fn, inputs):
        if self.graphs is None:
            self._reset_dropout()
            return fn(inputs)
        gens, reset = (), None
        if self.dropout is not None:  # the prologue holds no reference to self
            gens = (self.dropout,)
            reset = functools.partial(self.dropout.set_state, self._dropout_state)
        return self.graphs.run(signature(route, self.cfg.data.modality, inputs), fn, inputs,
                               gens, reset)

    def _rows(self, inputs):
        """This data rank's contiguous block of the global batch, padded to a
        multiple of the data axis; and the batch's rows before padding."""
        leaves = list(inputs.values()) if isinstance(inputs, dict) else [inputs]
        while isinstance(leaves[0], (tuple, list)):
            leaves = list(leaves[0])
        n = leaves[0].shape[0]
        W = self.mesh.data
        k = -(-n // W)
        lo, hi = self.mesh.d * k, (self.mesh.d + 1) * k

        def cut(x):
            if isinstance(x, (tuple, list)):
                return type(x)(cut(e) for e in x)
            return pad_rows({"x": x}, k * W)["x"][lo:hi]

        if isinstance(inputs, dict):
            return {key: cut(v) for key, v in inputs.items()}, n
        return cut(inputs), n

    def calibrate(self, batches) -> int:
        """int8_static: record every int8 conv's activation scale as the
        running max over ``batches`` (deepfake_tpu/train/submit.py:112-121),
        each a model-ready input (a bare array, a tuple of the model's
        arguments as JAX takes them, or ``predict``'s fused tuple), run
        eagerly (under a mesh, this data rank's rows, the max taken over the
        data axis, so every rank records the same scales); then drop the
        captured graphs. A no-op in other modes, as in JAX. Returns the
        number of scalars calibrated."""
        def run(batch):
            args = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
            inputs = args[0] if len(args) == 1 else args
            if self.mesh is not None:
                inputs, _ = self._rows(inputs)
            self.model(self._inputs(inputs))

        n = calibrate_act_scales(self.model, run, batches)
        if self.graphs is not None:
            self.graphs = None
            torch.cuda.empty_cache()
            self.graphs = GraphCache(self.device)
        return n

    @staticmethod
    def _scores(out) -> np.ndarray:
        return np.atleast_1d(out[0].float().cpu().numpy())

    @torch.inference_mode()
    def forward(self, inputs, return_logits: bool = False, raw: bool = False):
        """Model-ready inputs (``raw``: predict_raw's dict) -> the model's
        output on the device, through the request's graph where there is one:
        scores (``return_logits``: the logits before the sigmoid), or (scores,
        per-frame features) for video_swin. A graph's outputs are copied, as
        its next replay overwrites them."""
        out = self._run("raw", self._raw, inputs) if raw else self._run(
            "predict", self._model, inputs)
        out = out[1:] if return_logits else (out[0], *out[2:])
        if self.graphs is not None:
            out = tuple(t.clone() for t in out)
        return out if len(out) > 1 else out[0]

    @torch.inference_mode()
    def predict(self, inputs) -> np.ndarray:
        """Model-ready inputs (a tuple for fused) -> sigmoid scores [B]."""
        return self._scores(self._run("predict", self._model, inputs))

    @torch.inference_mode()
    def predict_raw(self, feats: Dict[str, Any]) -> np.ndarray:
        """Raw batch dict (``video``, ``audio_image``, ``audio_wave`` /
        ``audio_len``, ``paudio_wave`` / ``paudio_len``) -> sigmoid scores [B].
        The features are assembled in f32 on the device; only the assembled
        inputs take the compute type (a bf16 waveform would move the mel
        image). Compiled, the front end and the model are one graph."""
        return self._scores(self._run("raw", self._raw, feats))

    def score_file(self, path: str) -> float:
        """One video file end to end: decoded on the host as the test split
        decodes a clip (frames, and PCM from its sidecar or ffmpeg), then
        ``predict_raw`` at batch 1 (deepfake_tpu/serving.py:103-115)."""
        from deepfake_tpu_torch.data.dataset import DeepFakeDataset

        ds = DeepFakeDataset.__new__(DeepFakeDataset)
        ds.cfg, ds.split, ds.dataset_path, ds.labels, ds.names = self.cfg, "test", "", {}, [path]
        feats, _label, _name = ds[0]
        feats = {k: np.asarray(v)[None] for k, v in feats.items()}
        if self.mesh is None:
            return float(self.predict_raw(feats)[0])
        # this rank alone: the batch's statistics are its own
        with pm.batch_state(self.mesh, False), torch.inference_mode():
            return float(self._scores(self._run("file", self._raw, feats))[0])
