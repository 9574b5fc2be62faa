"""A stall detector for the training loop (deepfake_tpu/utils/watchdog.py).

    wd = StepWatchdog(deadline_s=600, on_stall=logger)
    with wd.watch(f"train_step {t}"):
        trainer.train_step(x, y)
    wd.close()

A daemon thread polls every ``poll_s`` seconds and calls ``on_stall`` once
per section that runs longer than ``deadline_s``. It times the host's
section, as the JAX one does. On the card's graph route a replay returns
before the card has finished, so a step that stalls on the device shows
where the host next waits for it: the metric read at ``log_step`` or the
checkpoint save, not inside the replay's own section.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class StepWatchdog:
    """One section watched at a time (no nesting)."""

    def __init__(self, deadline_s: float = 300.0,
                 on_stall: Optional[Callable[[str], None]] = None, poll_s: float = 5.0):
        self.deadline_s = deadline_s
        self.on_stall = on_stall or (lambda msg: print(msg, flush=True))
        self.poll_s = poll_s
        self._lock = threading.Lock()
        self._section: Optional[str] = None
        self._start = 0.0
        self._fired = False
        self._stop = threading.Event()
        self.stall_count = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                if self._section is None or self._fired:
                    continue
                elapsed = time.monotonic() - self._start
                if elapsed <= self.deadline_s:
                    continue
                self._fired = True
                self.stall_count += 1
                section = self._section
            self.on_stall(
                f"[watchdog] section '{section}' exceeded {self.deadline_s:.0f}s "
                f"deadline ({elapsed:.0f}s elapsed) — device or input pipeline may be stuck")

    class _Section:
        def __init__(self, wd: "StepWatchdog", name: str):
            self.wd, self.name = wd, name

        def __enter__(self):
            with self.wd._lock:
                self.wd._section = self.name
                self.wd._start = time.monotonic()
                self.wd._fired = False
            return self

        def __exit__(self, *exc):
            with self.wd._lock:
                self.wd._section = None
            return False

    def watch(self, name: str) -> "StepWatchdog._Section":
        return StepWatchdog._Section(self, name)

    def close(self):
        """Stops the thread and waits for it (at most one poll)."""
        self._stop.set()
        self._thread.join(self.poll_s + 1.0)
