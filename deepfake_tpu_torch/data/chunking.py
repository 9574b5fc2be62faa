"""Long videos as fixed-shape sliding windows, and dataset directory
re-sharding (deepfake_tpu/data/chunking.py).

``sliding_windows`` / ``chunk_frames`` cut a decoded frame stream into
[n_windows, chunk, S, S, 3] clips (the last window right-aligned, so every
frame is covered and every window has one shape); the windows' scores
aggregate to one score a video. ``reshard_directory`` moves the files of a
large directory into ``sub_dir{N}`` folders of ``files_per_shard``.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator, List, Sequence, Tuple

import numpy as np


def sliding_windows(total: int, chunk: int, stride: int) -> List[Tuple[int, int]]:
    """[(start, length)] covering ``total`` frames with windows of ``chunk``
    frames every ``stride``, the last one right-aligned."""
    if total <= 0:
        return []
    if total <= chunk:
        return [(0, total)]
    starts = list(range(0, total - chunk + 1, stride))
    if starts[-1] + chunk < total:
        starts.append(total - chunk)
    return [(s, chunk) for s in starts]


def chunk_frames(frames: np.ndarray, chunk: int, stride: int) -> np.ndarray:
    """[N, S, S, 3] -> [n_windows, chunk, S, S, 3]; a video shorter than
    ``chunk`` repeats its last frame."""
    wins = sliding_windows(frames.shape[0], chunk, stride)
    out = np.zeros((len(wins), chunk) + frames.shape[1:], frames.dtype)
    for i, (s, ln) in enumerate(wins):
        out[i, :ln] = frames[s:s + ln]
        if ln < chunk:
            out[i, ln:] = frames[s + ln - 1]
    return out


def aggregate_window_scores(scores: Sequence[float], method: str = "mean") -> float:
    """Window scores -> one score: ``mean``, ``max`` or ``top3`` (the mean
    of the three largest); NaN for no windows."""
    s = np.asarray(scores, np.float32)
    if s.size == 0:
        return float("nan")
    if method == "max":
        return float(s.max())
    if method == "top3":
        return float(np.sort(s)[-3:].mean())
    return float(s.mean())


def reshard_directory(parent_dir: str, files_per_shard: int = 10000, prefix: str = "sub_dir",
                      dry_run: bool = False) -> List[str]:
    """Move the files directly in ``parent_dir`` (sorted by name) into
    ``{prefix}{N}/`` folders of ``files_per_shard``; returns the folders
    (only named, with ``dry_run``)."""
    entries = sorted(f for f in os.listdir(parent_dir)
                     if os.path.isfile(os.path.join(parent_dir, f)))
    shards = []
    for i in range(0, len(entries), files_per_shard):
        shard = os.path.join(parent_dir, f"{prefix}{i // files_per_shard + 1}")
        shards.append(shard)
        if dry_run:
            continue
        os.makedirs(shard, exist_ok=True)
        for f in entries[i:i + files_per_shard]:
            shutil.move(os.path.join(parent_dir, f), os.path.join(shard, f))
    return shards


def iter_sharded_files(parent_dir: str) -> Iterator[str]:
    """Every file under ``parent_dir``, resharded or not."""
    for root, _dirs, files in os.walk(parent_dir):
        for f in sorted(files):
            yield os.path.join(root, f)
