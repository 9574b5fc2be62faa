"""A synthetic test set in the reference's layout
(deepfake_tpu/data/synthetic.py): ``n_clips`` mp4v clips of random frames
written by cv2.VideoWriter under ``<root>/phase2/testset1seen/``, a 16 kHz
PCM ``.wav`` sidecar for each (cv2 writes no audio track), and
``<root>/phase2/prediction.txt.csv``, the name list the test split reads.
Frames and PCM come from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


def make_synthetic_testset(root: str, n_clips: int, frames: int = 48, size: int = 256,
                           seconds: float = 4.0, seed: int = 0) -> List[str]:
    import cv2
    from scipy.io import wavfile

    os.makedirs(os.path.join(root, "phase2", "testset1seen"), exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_clips):
        name = f"clip_{i}.mp4"
        p = os.path.join(root, "phase2", "testset1seen", name)
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 12, (size, size))
        for _ in range(frames):
            w.write(rng.integers(0, 255, (size, size, 3), np.uint8))
        w.release()
        wav = (rng.standard_normal(int(16000 * seconds)) * 0.1 * 32767).astype(np.int16)
        wavfile.write(p[:-4] + ".wav", 16000, wav)
        names.append(name)
    with open(os.path.join(root, "phase2", "prediction.txt.csv"), "w") as f:
        f.write("video_name,y_pred\n")
        for n in names:
            f.write(f"{n},0.5\n")
    return names
