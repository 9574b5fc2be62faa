"""Tracing, memory accounting and operation counts on the card
(deepfake_tpu/utils/profiling.py:32-155).

* ``trace(log_dir)`` / ``StepAnnotation``: a torch.profiler trace (host ops
  and CUDA kernels) written as a Chrome trace into ``log_dir``, and a named
  range per training step in it.
* ``hbm_stats`` / ``live_buffer_census`` / ``HbmTracker``: the caching
  allocator's counters, and the live CUDA tensors grouped by dtype and shape
  by a walk of the garbage collector's objects (the reference's
  gpu_mem_track.py), diffed into a track file every ``every`` steps.
* ``model_size``: parameters and persistent buffers (the JAX variables).
* ``activation_memory_estimate``: the bytes of every op's outputs, x2.
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``.
* ``Monitor``: a rate-limited device-memory line.
"""

from __future__ import annotations

import contextlib
import gc
import os
from datetime import datetime
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the enclosed region (host ops, and CUDA kernels where there
    is a card) and writes ``<log_dir>/trace_<time>.json``, a Chrome trace;
    yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}_{os.getpid()}.json"))


def StepAnnotation(name: str, step: int):
    """A named range ``"<name> <step>"`` in the trace (jax.profiler's
    StepTraceAnnotation)."""
    return torch.profiler.record_function(f"{name} {step}")


def hbm_stats(device=None) -> Dict[str, int]:
    """``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved`` and
    ``bytes_limit`` (the card's memory) of a CUDA device; {} on the CPU."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else
        torch.device("cpu"))
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_limit": total}


def live_buffer_census(device_type: str = "cuda") -> Dict[str, Any]:
    """The live tensors on ``device_type`` devices that the garbage collector
    can see, grouped by dtype and shape: {"total_bytes", "groups": {"dtype[
    shape]": {"count", "bytes"}}}; a view counts as a tensor of its own. A
    CUDA graph's pool is not a tensor: see ``hbm_stats``."""
    groups: Dict[str, Dict[str, int]] = {}
    total = 0
    for obj in gc.get_objects():
        # type(), not isinstance: isinstance reads __class__, which lazy and
        # deprecated module attributes answer with a warning
        if not issubclass(type(obj), torch.Tensor) or obj.device.type != device_type:
            continue
        key = f"{str(obj.dtype).replace('torch.', '')}{list(obj.shape)}"
        size = obj.numel() * obj.element_size()
        g = groups.setdefault(key, {"count": 0, "bytes": 0})
        g["count"] += 1
        g["bytes"] += size
        total += size
    return {"total_bytes": total, "groups": groups}


class HbmTracker:
    """Every ``every`` steps, the census of live tensors diffed against the
    last one and appended to ``<path>/<time>-hbm_track.txt`` ('+' new
    groups, '~' changed counts, '-' groups gone), the JAX tracker's lines."""

    def __init__(self, path: str = "./hbm_track/", every: int = 500, device_type: str = "cuda"):
        ts = datetime.now().strftime("%d-%b-%y-%H:%M:%S")
        self.path = path  # made at the first census
        self.file = os.path.join(path, f"{ts}-hbm_track.txt")
        self.every = every
        self.device_type = device_type
        self._count = 0
        self._last: Dict[str, Dict[str, int]] = {}

    def step(self):
        self._count += 1

    def track(self):
        if self._count % self.every:
            return
        census = live_buffer_census(self.device_type)
        cur = census["groups"]
        lines = [f"\nAt step {self._count} Total HBM bytes: {census['total_bytes']}"]
        for k, v in cur.items():
            prev = self._last.get(k)
            if prev is None:
                lines.append(f"+ {v['count']} x {k} ({v['bytes']} B)")
            elif prev["count"] != v["count"]:
                lines.append(f"~ {prev['count']} -> {v['count']} x {k}")
        for k, v in self._last.items():
            if k not in cur:
                lines.append(f"- {v['count']} x {k} ({v['bytes']} B)")
        self._last = cur
        os.makedirs(self.path, exist_ok=True)
        with open(self.file, "a") as f:
            f.write("\n".join(lines) + "\n")


def model_size(module: nn.Module) -> Dict[str, float]:
    """{'params': elements, 'mb': MiB} over the parameters and persistent
    buffers (``state_dict``: the JAX params and batch_stats)."""
    tensors = list(module.state_dict().values())
    return {"params": sum(t.numel() for t in tensors),
            "mb": sum(t.numel() * t.element_size() for t in tensors) / 1024 / 1024}


class _OutputBytes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if torch.is_tensor(t):
                self.total += t.numel() * t.element_size()
        return out


def activation_memory_estimate(fn: Callable, *args, **kwargs) -> int:
    """Bytes of every op's outputs while ``fn(*args, **kwargs)`` runs, x2 for
    the backward's residuals, as the JAX estimator counts its jaxpr."""
    with torch.no_grad(), _OutputBytes() as mode:
        fn(*args, **kwargs)
    return 2 * mode.total


def flops(fn: Callable, *args, **kwargs) -> int:
    """Floating-point operations of ``fn(*args, **kwargs)`` as
    ``FlopCounterMode`` counts them (2 M N K a matmul). The hand-written
    kernels launch through ``ctypes``, below PyTorch's dispatcher, so the
    counter sees none of their work: count a model on its plain route (the
    kernel switches off), or on the CPU, where the wrappers run their plain
    versions."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


class Monitor:
    """Every ``log_step`` calls, prints the device memory in use."""

    def __init__(self, log_step: int = 10, printer=print, device=None):
        self.log_step = log_step
        self.printer = printer
        self.device = device
        self._count = 0

    def __call__(self, *a):
        if (self._count + 1) % self.log_step == 0:
            stats = hbm_stats(self.device)
            used = stats.get("bytes_in_use", 0)
            limit = stats.get("bytes_limit", 0)
            pct = 100.0 * used / limit if limit else float("nan")
            self.printer(f"HBM: {used / 2 ** 20:.1f} MiB in use ({pct:.1f}%)")

    def step(self):
        self._count += 1
