"""Line logger and running mean (deepfake_tpu/utils/logging.py:17-57), what
``Trainer.train`` and ``Trainer.eval`` use."""

from __future__ import annotations

import sys
from datetime import datetime
from typing import Optional


class Logger:
    """Timestamped line logger writing to a file (truncated on open) or to
    stdout, flushed per line."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        if log_dir:
            self.f = open(log_dir, "a")
            self.f.truncate(0)
        else:
            self.f = sys.stdout

    def __call__(self, string) -> None:
        print(datetime.now(), string, file=self.f, flush=True)

    def close(self) -> None:
        if self.f is not sys.stdout:
            self.f.close()


class AverageMeter:
    """Running mean of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        if self.count > 0:
            self.avg = self.sum / self.count
