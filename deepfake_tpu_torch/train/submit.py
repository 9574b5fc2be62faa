"""Scoring a test set into a crash-resumable submission
(deepfake_tpu/train/submit.py, the reference's src/submit.py:23-120).

    ctl = SubmitCtl(Predictor(cfg), cfg, DeepFakeDataModule(cfg).setup("test"))
    result = ctl.submit()          # appends "name,score" lines to prediction.csv
    ctl.write_full(result)         # prediction_full.csv, with a header

``submit`` runs the test loader's batches through ``DevicePrefetcher`` into
``Predictor.predict_raw``: on the card, the front end and the model as one
CUDA graph per batch shape. Each batch's lines are appended to
prediction.csv and flushed, so a run that is stopped resumes where it was
(the dataset skips the names already there). A ragged last batch is padded
to the batch size by repeating its last row, and its scores trimmed: so it
replays the same graph as the full batches, and its real rows' scores are
those of an unpadded batch (the padding repeats a row, which leaves the
batch's longest valid wave length, the one statistic that batch_longest
normalisation and wav2vec2's frame mask share across rows, unchanged).

``score_long_video`` / ``score_frames`` / ``submit_chunked`` score long
videos (``video`` and ``video_swin``) by sliding windows of
``data.chunk_frames`` frames every ``data.chunk_stride``, in batches of
``batch_windows`` windows (the last padded by repeating its last window),
aggregated by ``mean``, ``max`` or ``top3``.

Under a mesh (the Predictor's) every rank runs ``submit`` on the same whole
batches: the Predictor scores each data rank's rows and gathers the scores
in input order, and rank 0 alone writes prediction.csv and
prediction_full.csv (the data module's rank 0 reads the names already
scored and broadcasts them). The long-video routes score their window
batches the same way.

Weights are the Predictor's. ``load_checkpoint(path)`` swaps in a
``Predictor.from_checkpoint`` of a training checkpoint on the same device
and route (this ctl drops the old one, whose graphs, pool and K1 packed
weights hold the old weights); the new one starts uncalibrated, as the JAX
ctl strips a stale ``quant_cache`` on a weight load (submit.py:66-72).
``calibrate(batches)`` records ``model.irv2_quant=int8_static``'s
activation scales on representative batches (``Predictor.calibrate``).
Importing the reference's ``.pth`` checkpoints waits for such files in the
repository.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.utils.logging import Logger


def pad_rows(feats: Dict[str, object], rows: int) -> Dict[str, object]:
    """Each feature padded to ``rows`` rows by repeating its last row."""
    def pad(x):
        n = x.shape[0]
        if n >= rows:
            return x
        if torch.is_tensor(x):
            return torch.cat([x, x[-1:].expand(rows - n, *x.shape[1:])])
        return np.concatenate([x, np.repeat(x[-1:], rows - n, axis=0)])
    return {k: pad(v) for k, v in feats.items()}


class SubmitCtl:
    """Scores the data module's test split with ``predictor`` (a
    ``serving.Predictor``), writing ``prediction_csv``."""

    def __init__(self, predictor, cfg: Config, data, logger: Optional[Logger] = None,
                 prediction_csv: str = "prediction.csv"):
        self.predictor = predictor
        self.cfg = cfg
        self.data = data
        self.logger = logger or Logger(cfg.log.log_dir)
        self.prediction_csv = prediction_csv

    def _rank0(self) -> bool:
        mesh = self.predictor.mesh
        return mesh is None or mesh.rank == 0

    def _writer(self):
        """prediction.csv opened to append, on rank 0 (None on the others)."""
        return open(self.prediction_csv, "a") if self._rank0() else None

    def load_checkpoint(self, path: str):
        """Serve ``path``'s weights (deepfake_tpu/train/submit.py:124-133): a
        new Predictor on the old one's device and route. This ctl drops the
        old one before building the new one: its graphs hold its own
        weights' addresses and K1's packed copy of them."""
        from deepfake_tpu_torch.serving import Predictor

        device, compiled = self.predictor.device, self.predictor.graphs is not None
        mesh = self.predictor.mesh
        self.predictor = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        self.predictor = Predictor.from_checkpoint(self.cfg, path, device=device,
                                                   compiled=compiled, mesh=mesh)
        self.logger(f"Load Finetuned Model From:{path}")

    def load_reference_pth(self, path: str):
        raise NotImplementedError(
            f"loading {path}: importing the reference's .pth checkpoints waits for reference "
            "files in the repository")

    def calibrate(self, batches) -> int:
        """Calibrate int8_static's activation scales on ``batches`` (input
        tuples or bare arrays, as the JAX ctl takes them; submit.py:112-121);
        a no-op unless the model has int8_static convs. Returns the number
        of scales recorded."""
        return self.predictor.calibrate(batches)

    def submit(self) -> Dict[str, float]:
        """Score the test split into prediction.csv; returns {name: score}
        of the names this run scored."""
        from deepfake_tpu_torch.data.pipeline import DevicePrefetcher

        cfg = self.cfg
        result: Dict[str, float] = {}
        loader = self.data.test_dataloader()
        total = len(loader)
        writer = self._writer()
        with writer or contextlib.nullcontext():
            for it, (feats, _labels, names) in enumerate(DevicePrefetcher(
                    loader, self.predictor.device, cfg.data.prefetch_depth)):
                probs = self.predictor.predict_raw(pad_rows(feats, cfg.optim.batch_size))
                for name, p in zip(names, probs[:len(names)]):
                    if writer is not None:
                        writer.write(f"{name},{p}\n")
                    result[name] = float(p)
                if writer is not None:
                    writer.flush()
                if it % cfg.log.log_step == 0:
                    self.logger("|step {:4d} |total {:4d}| Rate% {:.3f}".format(
                        it, total, it / max(total, 1) * 100))
        self.logger("Test Score Prediction Done")
        return result

    def score_long_video(self, path: str, agg: str = "mean", batch_windows: int = 8) -> float:
        """Every frame of ``path`` decoded, cut into windows and scored."""
        from deepfake_tpu_torch.data.video_decode import sequential_frames

        return self.score_frames(sequential_frames(path, self.cfg.data.frame_size), agg,
                                 batch_windows)

    def score_frames(self, frames: np.ndarray, agg: str = "mean",
                     batch_windows: int = 8) -> float:
        """A decoded [N, S, S, 3] uint8 stream -> one score: its windows
        through ``predict_raw`` in batches of ``batch_windows``."""
        from deepfake_tpu_torch.data.chunking import aggregate_window_scores, chunk_frames

        cfg = self.cfg
        if cfg.data.modality not in ("video", "video_swin"):
            raise ValueError(f"long videos are scored by their frames: {cfg.data.modality} "
                             "needs audio")
        windows = chunk_frames(frames, cfg.data.chunk_frames, cfg.data.chunk_stride)
        scores = []
        for s in range(0, windows.shape[0], batch_windows):
            batch = windows[s:s + batch_windows]
            probs = self.predictor.predict_raw(pad_rows({"video": batch}, batch_windows))
            scores.extend(probs[:batch.shape[0]].tolist())
        return aggregate_window_scores(scores, agg)

    def submit_chunked(self, agg: str = "mean", decode_ahead: int = 2) -> Dict[str, float]:
        """Long-video scoring of the test split into prediction.csv, while
        ``decode_ahead`` threads decode the next clips (host work only)."""
        from deepfake_tpu_torch.data.video_decode import sequential_frames

        result: Dict[str, float] = {}
        ds = self.data.testset
        names = list(ds.names)
        size = self.cfg.data.frame_size
        decode_ahead = max(1, decode_ahead)

        def decode(name):
            return sequential_frames(os.path.join(ds.dataset_path, name), size)

        writer = self._writer()
        with ThreadPoolExecutor(decode_ahead) as pool, writer or contextlib.nullcontext():
            futs = {i: pool.submit(decode, names[i]) for i in range(min(decode_ahead, len(names)))}
            for it, name in enumerate(names):
                frames = futs.pop(it).result()
                if it + decode_ahead < len(names):
                    futs[it + decode_ahead] = pool.submit(decode, names[it + decode_ahead])
                score = self.score_frames(frames, agg)
                if writer is not None:
                    writer.write(f"{name},{score}\n")
                    writer.flush()
                result[name] = score
                if it % self.cfg.log.log_step == 0:
                    self.logger(f"|clip {it:4d}| {name} -> {score:.5f}")
        self.logger("Test Score Prediction Done (chunked)")
        return result

    def write_full(self, result: Dict[str, float], path: str = "prediction_full.csv"):
        """prediction_full.csv: a header and one row per entry of ``result``
        (after a resume, only this run's rows, as in the JAX package); rank
        0's under a mesh."""
        if not self._rank0():
            return
        with open(path, "w") as f:
            f.write("video_name,y_pred\n")
            for k, v in result.items():
                f.write(f"{k},{v}\n")
        self.logger(f"wrote {path} ({len(result)} rows)")
