"""The reference's mel JPEGs (``<root>/{trainAudioImgs,ValAudioImgs,
TestAudioImgs}/<clip>.jpg``, data/data_process.py:70-97), written from the
port's mel image (deepfake_tpu/data/audio_images.py): each clip's PCM padded
to its bucket, ``mel_image_masked(..., raw_uint8=True)`` run on a batch of
one bucket at a time on the caller's device, each [S, S] uint8 image written
by cv2.imwrite. The mel parameters, the image side (224) and the buckets are
the default config's, as in the JAX package (the dataset resizes the JPEGs
to ``data.audio_size`` as it reads them). Shared by the dataset's lazy pass
and ``deepfake_tpu_torch.audio_preprocess --format jpeg``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np

from deepfake_tpu_torch.data.dataset import IMG_DIRS


def write_mel_jpegs(data_root, split, dataset_path, names, sample_rate, logger,
                    batch: int = 8, force: bool = False, device=None) -> int:
    """Mel JPEGs of ``names`` (those missing, or all with ``force``), batched
    per waveform bucket; returns how many were written."""
    import cv2
    import torch

    from deepfake_tpu_torch.config import Config
    from deepfake_tpu_torch.data.audio_io import extract_wav, pad_to_bucket
    from deepfake_tpu_torch.data.pipeline import mel_image_masked
    from deepfake_tpu_torch.models.registry import resolve_device

    cfg = Config()
    dev = resolve_device(device)
    out_dir = os.path.join(data_root, IMG_DIRS[split])
    os.makedirs(out_dir, exist_ok=True)
    buckets = [int(s * sample_rate) for s in cfg.data.wave_seconds_buckets]
    pending = {b: [] for b in buckets}  # bucket -> [(name, padded, valid)]

    def flush(bucket):
        group = pending[bucket]
        if not group:
            return
        m = cfg.mel
        with torch.inference_mode():
            imgs = mel_image_masked(
                torch.from_numpy(np.stack([g[1] for g in group])).to(dev),
                torch.tensor([g[2] for g in group], device=dev), sr=m.sample_rate,
                n_fft=m.n_fft, hop=m.hop_length, n_mels=m.n_mels, size=cfg.data.audio_size,
                wave_sr=sample_rate, raw_uint8=True).cpu().numpy()
        for (name, _w, _l), img in zip(group, imgs):
            cv2.imwrite(os.path.join(out_dir, os.path.splitext(name)[0] + ".jpg"), img)
        group.clear()

    done = 0
    for index, name in enumerate(names):
        if os.path.exists(os.path.join(out_dir, os.path.splitext(name)[0] + ".jpg")) and not force:
            continue
        if index % 100 == 0:
            rate = int(index / max(len(names), 1) * 100)
            logger("[" + "*" * rate + "-" * (100 - rate) + f"] ({index}/{len(names)})")
        wave = extract_wav(os.path.join(dataset_path, name), sample_rate)
        padded = pad_to_bucket(wave, buckets)
        pending[len(padded)].append((name, padded, min(len(wave), len(padded))))
        done += 1
        if len(pending[len(padded)]) >= batch:
            flush(len(padded))
    for b in buckets:
        flush(b)
    logger(f"wrote {done} mel JPEGs to {out_dir}")
    return done


def ensure_audio_images(cfg, split: str, dataset_path: str, names: Sequence[str],
                        logger: Optional[Callable] = None, force: Optional[bool] = None,
                        device=None) -> int:
    """Write the split's missing mel JPEGs (all of them with
    ``data.force_generate``) before a first epoch; returns how many."""
    if force is None:
        force = cfg.data.force_generate
    out_dir = os.path.join(cfg.data.data_root, IMG_DIRS[split])
    if not force and all(os.path.exists(os.path.join(out_dir, os.path.splitext(n)[0] + ".jpg"))
                         for n in names):
        return 0
    return write_mel_jpegs(cfg.data.data_root, split, dataset_path, names,
                           cfg.data.wave_sample_rate, logger or (lambda s: None), force=force,
                           device=device)
