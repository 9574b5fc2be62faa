"""Dataset discovery, per-clip features and loaders
(deepfake_tpu/data/dataset.py).

Layout (the reference's data/data_process.py:22-31): ``<root>/phase1/trainset``
with ``<root>/train_label.txt``, ``<root>/phase1/valset`` with
``<root>/val_label.txt``, ``<root>/phase2/testset1seen`` with
``<root>/phase2/prediction.txt.csv`` (``video_name,...`` rows; its names and
their order are the test split). A test split skips the names already in
``prediction.csv`` (a run that was stopped resumes). Under a mesh the train
and val loaders decode this data rank's rows only (``_Loader``); the test
loader yields whole batches, which the Predictor shards.

A clip's features are host arrays: ``video`` uint8 [T, S, S, 3];
``audio_wave`` / ``paudio_wave`` float32 16 kHz PCM zero-padded to a bucket
with its valid length ``audio_len`` / ``paudio_len``; or, on the JPEG path
(``data.audio_from_images``), ``audio_image`` uint8 [S, S, 3] read from the
reference's ``<split>AudioImgs`` mel JPEGs. Everything after that (frame
normalisation, the mel image, the wave normalisation) runs on the device in
``data/pipeline.py::FeatureAssembler``. Loaders yield (features dict,
labels, names) batches of numpy arrays, decoded by a pool of threads (cv2
releases the GIL while it decodes). The JAX package's native ingest loader
(``_IngestLoader``) waits with the native ingest (ROADMAP A1).
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.data.audio_io import extract_wav, pad_to_bucket
from deepfake_tpu_torch.data.video_decode import extract_frames

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")
IMG_DIRS = {"train": "trainAudioImgs", "val": "ValAudioImgs", "test": "TestAudioImgs"}


def read_label_csv(path: str) -> Dict[str, float]:
    """``video_name,target`` rows -> {name: label}; NaN where a row has no
    target (the test split's name list)."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            name = row.get("video_name")
            if name is None:
                continue
            target = row.get("target")
            out[name] = float(target) if target not in (None, "") else float("nan")
    return out


def predicted_names(prediction_csv: str) -> List[str]:
    """The names already scored in a prediction.csv, with or without a
    ``video_name`` header."""
    if not os.path.exists(prediction_csv):
        return []
    names = []
    with open(prediction_csv) as f:
        for i, line in enumerate(f):
            parts = line.strip().split(",")
            if not parts or not parts[0]:
                continue
            if i == 0 and parts[0] == "video_name":
                continue
            names.append(parts[0])
    return names


class DeepFakeDataset:
    """The index of one split; ``ds[i]`` is (features dict, label, name).
    With ``data.audio_from_images`` (audio and fused), the missing mel JPEGs
    of the split are written first (all of them with
    ``data.force_generate``), on ``device``."""

    def __init__(self, cfg: Config, split: str = "train", prediction_csv: str = "./prediction.csv",
                 resume: bool = True, device=None, scored: Optional[Sequence[str]] = None):
        self.cfg = cfg
        self.split = split
        root = cfg.data.data_root
        if split == "train":
            self.dataset_path = os.path.join(root, "phase1", "trainset")
            label_path = os.path.join(root, "train_label.txt")
        elif split == "val":
            self.dataset_path = os.path.join(root, "phase1", "valset")
            label_path = os.path.join(root, "val_label.txt")
        else:
            self.dataset_path = os.path.join(root, "phase2", "testset1seen")
            label_path = os.path.join(root, "phase2", "prediction.txt.csv")
        self.labels = read_label_csv(label_path) if os.path.exists(label_path) else {}
        listing = sorted(n for n in os.listdir(self.dataset_path)
                         if n.lower().endswith(VIDEO_EXTS))
        if split == "test":
            names = list(self.labels) or listing
            if scored is None:
                scored = predicted_names(prediction_csv) if resume else []
            skip = set(scored)
            names = [n for n in names if n not in skip]
        else:
            names = listing
        self.names = names
        if cfg.data.audio_from_images and cfg.data.modality in ("audio", "fused"):
            from deepfake_tpu_torch.data.audio_images import ensure_audio_images

            ensure_audio_images(cfg, split, self.dataset_path, listing or names, device=device)

    def __len__(self) -> int:
        return len(self.names)

    def _load_audio_image(self, name: str) -> np.ndarray:
        """The reference's mel JPEG ``<split>AudioImgs/<name>.jpg`` as uint8
        RGB [S, S, 3] (resized to ``data.audio_size`` where it differs)."""
        import cv2

        img_path = os.path.join(self.cfg.data.data_root, IMG_DIRS[self.split],
                                os.path.splitext(name)[0] + ".jpg")
        img = cv2.imread(img_path)
        if img is None:
            raise FileNotFoundError(img_path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        s = self.cfg.data.audio_size
        if img.shape[:2] != (s, s):
            img = cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
        return img

    def assemble(self, name: str, frames: Optional[np.ndarray] = None,
                 wave: Optional[np.ndarray] = None):
        """(features, label, name) of one clip; ``name`` is a path relative to
        the split's directory (or absolute). ``frames`` / ``wave`` given are
        used as they are; None decodes them here."""
        cfg = self.cfg
        path = os.path.join(self.dataset_path, name)
        modality = cfg.data.modality
        feats: Dict[str, np.ndarray] = {}
        buckets = [int(s * cfg.data.wave_sample_rate) for s in cfg.data.wave_seconds_buckets]
        if modality in ("video", "video_swin", "fused"):
            if frames is None:
                frames = extract_frames(path, cfg.data.num_frames, cfg.data.frame_size,
                                        method=cfg.data.decode_method)
            feats["video"] = frames
        need_audio_img = modality in ("audio", "fused") and cfg.data.audio_from_images
        if need_audio_img:
            feats["audio_image"] = self._load_audio_image(name)
        if modality in ("paudio", "fused") or (modality == "audio" and not need_audio_img):
            if wave is None:
                wave = extract_wav(path, cfg.data.wave_sample_rate)
            padded = pad_to_bucket(wave, buckets)
            valid = np.int32(min(len(wave), len(padded)))
            if modality in ("audio", "fused") and not need_audio_img:
                feats["audio_wave"] = padded
                feats["audio_len"] = valid
            if modality in ("paudio", "fused"):
                feats["paudio_wave"] = padded
                feats["paudio_len"] = valid
        if name not in self.labels and self.split in ("train", "val"):
            raise KeyError(
                f"no label for {name!r} in {self.split} split — expected it in "
                f"{os.path.join(cfg.data.data_root, self.split + '_label.txt')} "
                "(label files live at the data root, not under phase1/)")
        return feats, np.float32(self.labels.get(name, np.nan)), name

    def __getitem__(self, index: int):
        return self.assemble(self.names[index])


def collate(samples: Sequence, wave_len: int = 0) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                                           List[str]]:
    """Stack a batch's features; waves pad to the batch's largest bucket, or
    to ``wave_len`` samples where that is longer."""
    feats, labels, names = zip(*samples)
    out: Dict[str, np.ndarray] = {}
    for k in feats[0]:
        vals = [f[k] for f in feats]
        if k.endswith("_wave"):
            m = max([wave_len] + [v.shape[0] for v in vals])
            vals = [np.pad(v, (0, m - v.shape[0])) if v.shape[0] < m else v for v in vals]
        out[k] = np.stack(vals)
    return out, np.asarray(labels, np.float32), list(names)


class _Loader:
    """Batches of ``batch_size`` clips in order (shuffled per epoch with
    ``shuffle``, from ``seed + epoch``), each clip decoded by one of
    ``num_workers`` threads; ``drop_last`` drops a ragged last batch.

    With a ``mesh`` (parallel/mesh.py) each batch is this data rank's rows of
    the global one, and only those are decoded: its slice of each of the
    ``accum`` micro-batches (every rank sees one order, from the seed), or
    the whole batch where the data axis does not divide a micro-batch. A
    batch of a loader without ``drop_last`` (val) is padded to a multiple of the data
    axis by repeating its last clip, the padding rows' labels NaN (the
    Trainer's eval drops them). Waves pad to the largest bucket
    (``wave_len``), so that every rank's arrays are as long as the longest
    wave of the global batch needs."""

    def __init__(self, dataset: DeepFakeDataset, batch_size: int, shuffle: bool,
                 num_workers: int, seed: int = 0, drop_last: bool = False, mesh=None,
                 accum: int = 1, wave_len: int = 0):
        self.ds = dataset
        self.batch = batch_size
        self.shuffle = shuffle
        self.workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.mesh, self.accum, self.wave_len = mesh, accum, wave_len
        self.epoch = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.batch if self.drop_last else (n + self.batch - 1) // self.batch

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
            self.epoch += 1
        with ThreadPoolExecutor(self.workers) as pool:
            for s in range(0, len(order), self.batch):
                idx = order[s:s + self.batch]
                if self.drop_last and len(idx) < self.batch:
                    break
                pad = 0
                if self.mesh is not None:
                    idx, pad = self._rows(idx)
                feats, labels, names = collate(list(pool.map(lambda i: self.ds[int(i)], idx)),
                                               self.wave_len)
                if pad:
                    labels[-pad:] = np.nan
                yield feats, labels, names

    def _rows(self, idx):
        """This data rank's clips of the global batch ``idx`` and how many of
        them (at the end) are padding."""
        from deepfake_tpu_torch.parallel.mesh import data_rows

        n = len(idx)
        if self.drop_last:  # training: whole micro-batches, never padded
            rows = data_rows(n, self.mesh, self.accum)
            return (idx, 0) if rows is None else (idx[rows], 0)
        padded = -(-n // self.mesh.data) * self.mesh.data
        idx = np.concatenate([idx, np.repeat(idx[-1:], padded - n)])
        rows = data_rows(padded, self.mesh, 1)
        return idx[rows], sum(r >= n for r in rows)


class DeepFakeDataModule:
    """The train, val and test loaders of a data root
    (deepfake_tpu/data/dataset.py::DeepFakeDataModule). A train batch is one
    optimizer step's rows (batch_size x accum_step, ragged last dropped);
    val and test batches are batch_size clips. ``device``: where the mel
    JPEGs are computed, on the JPEG path."""

    def __init__(self, cfg: Config, prediction_csv: str = "./prediction.csv", device=None,
                 mesh=None):
        self.cfg = cfg
        self.prediction_csv = prediction_csv
        self.device = device
        self.mesh = mesh
        self.trainset: Optional[DeepFakeDataset] = None
        self.valset: Optional[DeepFakeDataset] = None
        self.testset: Optional[DeepFakeDataset] = None

    def setup(self, stage: Optional[str] = None):
        if stage in (None, "fit"):
            self.trainset = DeepFakeDataset(self.cfg, "train", device=self.device)
            self.valset = DeepFakeDataset(self.cfg, "val", device=self.device)
        if stage in (None, "test"):
            scored = None
            if self.mesh is not None:
                # rank 0 reads what is scored and tells the others: no rank
                # reads prediction.csv while rank 0 writes it
                import torch.distributed as dist

                box = [predicted_names(self.prediction_csv) if self.mesh.rank == 0 else None]
                dist.broadcast_object_list(box, src=0)
                scored = box[0]
            self.testset = DeepFakeDataset(self.cfg, "test", self.prediction_csv,
                                           device=self.device, scored=scored)
        return self

    def _mesh_kw(self, accum: int = 1) -> Dict:
        """A loader's mesh arguments: this data rank's rows, waves padded to
        the largest bucket (none without a mesh)."""
        if self.mesh is None:
            return {}
        d = self.cfg.data
        return dict(mesh=self.mesh, accum=accum,
                    wave_len=int(max(d.wave_seconds_buckets) * d.wave_sample_rate))

    def train_dataloader(self):
        accum = max(1, self.cfg.optim.accum_step)
        return _Loader(self.trainset, self.cfg.optim.batch_size * accum, True,
                       self.cfg.data.num_workers, self.cfg.random_seed, drop_last=True,
                       **self._mesh_kw(accum))

    def val_dataloader(self):
        return _Loader(self.valset, self.cfg.optim.batch_size, False, self.cfg.data.num_workers,
                       **self._mesh_kw())

    def test_dataloader(self):
        return _Loader(self.testset, self.cfg.optim.batch_size, False, self.cfg.data.num_workers)
