"""Synthetic data sets in the reference's layout (deepfake_tpu/data/synthetic.py):
mp4v clips of random frames written by cv2.VideoWriter, each with a 16 kHz
PCM ``.wav`` sidecar (cv2 writes no audio track). ``make_synthetic_testset``
writes ``<root>/phase2/testset1seen/`` and ``<root>/phase2/prediction.txt.csv``,
the name list the test split reads; ``make_synthetic_trainset`` writes
``<root>/phase1/{trainset,valset}/`` and the labels ``<root>/train_label.txt``
and ``<root>/val_label.txt`` (``video_name,target``, alternating 0 and 1).
Frames and PCM come from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


def _write_clips(directory: str, n_clips: int, frames: int, size: int, seconds: float,
                 rng: np.random.Generator) -> List[str]:
    import cv2
    from scipy.io import wavfile

    os.makedirs(directory, exist_ok=True)
    names = []
    for i in range(n_clips):
        name = f"clip_{i}.mp4"
        p = os.path.join(directory, name)
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 12, (size, size))
        for _ in range(frames):
            w.write(rng.integers(0, 255, (size, size, 3), np.uint8))
        w.release()
        wav = (rng.standard_normal(int(16000 * seconds)) * 0.1 * 32767).astype(np.int16)
        wavfile.write(p[:-4] + ".wav", 16000, wav)
        names.append(name)
    return names


def make_synthetic_trainset(root: str, n_train: int, n_val: int, frames: int = 48,
                            size: int = 256, seconds: float = 4.0, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    for split, n, labels in (("trainset", n_train, "train_label.txt"),
                             ("valset", n_val, "val_label.txt")):
        names = _write_clips(os.path.join(root, "phase1", split), n, frames, size, seconds, rng)
        with open(os.path.join(root, labels), "w") as f:
            f.write("video_name,target\n")
            for i, name in enumerate(names):
                f.write(f"{name},{i % 2}\n")


def make_synthetic_testset(root: str, n_clips: int, frames: int = 48, size: int = 256,
                           seconds: float = 4.0, seed: int = 0) -> List[str]:
    rng = np.random.default_rng(seed)
    names = _write_clips(os.path.join(root, "phase2", "testset1seen"), n_clips, frames, size,
                         seconds, rng)
    with open(os.path.join(root, "phase2", "prediction.txt.csv"), "w") as f:
        f.write("video_name,y_pred\n")
        for n in names:
            f.write(f"{n},0.5\n")
    return names
