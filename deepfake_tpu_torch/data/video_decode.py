"""Video files to fixed-shape uint8 clips on the host, through OpenCV
(deepfake_tpu/data/video_decode.py:23-115, its cv2 paths).

``extract_frames`` keeps ``num_frames`` frames at indices i * (total //
num_frames), resized to ``target_size``^2 RGB: by one seek a frame
(``method="seek"``, the reference's sampling) or by one pass over the
stream that keeps the same frames (``"sequential"``, the sampling of the
JAX package's native ``df_decode_clip_seq``). A short clip repeats its last
decoded frame; a file that cannot be read gives zeros, as in the JAX
package. ``sequential_frames`` decodes every frame, to the end of the
stream, for the long-video chunker. cv2 is imported where it is used.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rgb(cv2, frame, size: int) -> np.ndarray:
    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    return cv2.resize(frame, (size, size), interpolation=cv2.INTER_LINEAR)


def extract_frames(video_path: str, num_frames: int = 32, target_size: int = 224,
                   method: str = "seek") -> np.ndarray:
    """[num_frames, target_size, target_size, 3] uint8 RGB."""
    import cv2

    if method not in ("seek", "sequential"):
        raise ValueError(f"decode method must be 'seek' or 'sequential', got {method!r}")
    cap = cv2.VideoCapture(video_path)
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        interval = max(total // num_frames, 1)
        out = np.zeros((num_frames, target_size, target_size, 3), np.uint8)
        got = 0
        if method == "seek":
            for i in range(num_frames):
                cap.set(cv2.CAP_PROP_POS_FRAMES, i * interval)
                ok, frame = cap.read()
                if not ok:
                    break
                out[i] = _rgb(cv2, frame, target_size)
                got += 1
        else:
            pos = 0
            while got < num_frames:
                # frames between the kept ones are decoded, not converted
                if not cap.grab():
                    break
                if pos == got * interval:
                    ok, frame = cap.retrieve()
                    if not ok:
                        break
                    out[got] = _rgb(cv2, frame, target_size)
                    got += 1
                pos += 1
        if 0 < got < num_frames:
            out[got:] = out[got - 1]
        return out
    finally:
        cap.release()


def sequential_frames(video_path: str, target_size: int = 224,
                      max_frames: Optional[int] = None) -> np.ndarray:
    """Every frame to the end of the stream (or the first ``max_frames``),
    [N, target_size, target_size, 3] uint8: the frame count in the
    container's metadata is not trusted."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok or (max_frames and len(frames) >= max_frames):
                break
            frames.append(_rgb(cv2, frame, target_size))
    finally:
        cap.release()
    if not frames:
        return np.zeros((0, target_size, target_size, 3), np.uint8)
    return np.stack(frames)
