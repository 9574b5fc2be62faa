"""The training loop's logging (deepfake_tpu/utils/logging.py): the line
logger and running mean, the loss curves (``Drawer``), the duty cycle of the
loop's phases (``DutyCycle``) and their wall-clock marks (``StepTimer``)."""

from __future__ import annotations

import os
import sys
import time
from datetime import datetime
from typing import Callable, List, Optional


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


class Drawer:
    """Collects a scalar per logged step and draws the loss curve of an
    epoch as a PNG in ``out_dir`` (deepfake_tpu/utils/logging.py:60-89).
    matplotlib is imported at the first ``draw``. Where it does not import,
    ``draw`` logs once (through ``logger``) that curves are not drawn and
    returns None: a missing plotting package never ends a training run."""

    def __init__(self, modality: str, phase: str, out_dir: str = "./checkpoints",
                 logger: Optional[Callable[[str], None]] = None):
        self.modality = modality
        self.phase = phase
        self.out_dir = out_dir
        self.logger = logger
        self._warned = False
        self.reset()

    def reset(self):
        self.log_list: List[float] = []

    def update(self, val, n: int = 1):
        self.log_list.append(float(val))

    def draw(self, epoch: int) -> Optional[str]:
        if not self.log_list:
            return None
        try:
            import matplotlib
        except ImportError:
            if not self._warned:
                self._warned = True
                (self.logger or print)(f"[WARN] matplotlib does not import: the {self.phase} "
                                       "loss curves are not drawn")
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(self.out_dir, exist_ok=True)
        path = f"{self.out_dir}/Modality:{self.modality}_Phase:{self.phase}_Epoch{epoch}.png"
        fig = plt.figure()
        plt.plot(range(len(self.log_list)), self.log_list)
        fig.savefig(path)
        plt.close(fig)
        return path


class DutyCycle:
    """Where the training loop's wall-clock time goes (deepfake_tpu/utils/
    logging.py:92-125): each second is added to a phase (``input_wait``: the
    loader, ``step``: the step and the metric read at ``log_step``,
    ``ckpt``: checkpoint saves and curves), and every ``log_step`` steps a
    ``duty |`` line gives each phase's share of the running total. On the
    graph route a replay returns before the card finishes, so device time
    surfaces where the host waits for it: at the metric read and the save."""

    def __init__(self, logger: Optional[Callable[[str], None]] = None, log_step: int = 10):
        self.logger = logger
        self.log_step = log_step
        self.totals: dict = {}
        self._count = 0

    def add(self, phase: str, seconds: float):
        self.totals[phase] = self.totals.get(phase, 0.0) + seconds

    def step(self):
        self._count += 1
        if self.logger and self._count % self.log_step == 0:
            total = sum(self.totals.values()) or 1.0
            parts = " | ".join(
                f"{k} {100.0 * v / total:.1f}%" for k, v in sorted(self.totals.items()))
            self.logger(f"duty | {parts} (over {self._count} steps)")

    def share(self, phase: str) -> float:
        total = sum(self.totals.values())
        return self.totals.get(phase, 0.0) / total if total else 0.0


class StepTimer:
    """Host wall-clock marks around the loop's phases (deepfake_tpu/utils/
    logging.py:128-146): ``report`` logs an elapsed time every
    ``log_step``-th report, one count over every name."""

    def __init__(self, logger: Optional[Callable[[str], None]] = None, log_step: int = 10):
        self.logger = logger
        self.log_step = log_step
        self._marks = {}
        self._count = 0

    def mark(self, name: str):
        self._marks[name] = time.perf_counter()

    def elapsed(self, name: str) -> float:
        return time.perf_counter() - self._marks.get(name, time.perf_counter())

    def report(self, name: str):
        dt = self.elapsed(name)
        self._count += 1
        if self.logger and self._count % self.log_step == 0:
            self.logger(f"{name} : elapse {dt:.4f} secs")
        return dt
