"""What the development tools of this folder share: the card's name and
power limit, patched copies of kernel sources, nvcc builds apart from the
package's, and device time by torch.profiler. The tools run by path, so
their folder is on sys.path and ``import common`` finds this file, which
puts the checkout's root there too, for the package.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
BUILD = os.path.join(ROOT, "deepfake_tpu_torch", "_build")  # ignored by git


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def patch(text: str, patches, what: str) -> str:
    """``text`` with each (old, new) replacement applied in order, at old's
    first occurrence, or at every one where a third element "all" follows;
    an old text that does not occur stops the tool."""
    for old, new, *how in patches:
        if old not in text:
            raise SystemExit(f"{what}: missing {old[:70]!r}")
        text = text.replace(old, new) if how == ["all"] else text.replace(old, new, 1)
    return text


def nvcc(jobs, out_dir: str, show=("Used", "spill", "warning", "C75")):
    """Builds each (name, source, extra nvcc arguments) of ``jobs`` with the
    package's flags, csrc/ on the include path after the source's own
    folder, one nvcc process a source, all started together. Prints the
    ptxas lines that hold one of ``show``; returns {name: CDLL}, each with
    its ptxas output in ``.ptxas``. Built without GNU unique symbols: the
    host code's function-local statics (a launcher's cached occupancy and
    shared-memory attribute) are otherwise bound process-wide, and a second
    version loaded beside the first would read the first's."""
    from deepfake_tpu_torch.kernels.build import CSRC, FLAGS, nvcc_path

    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, (name, src, extra) in enumerate(jobs):
        lib = os.path.join(out_dir, f"lib{i}-{re.sub(r'[^A-Za-z0-9_.-]', '_', name)[-60:]}.so")
        cmd = [nvcc_path(), *FLAGS, "-Xcompiler", "-fno-gnu-unique", f"-I{CSRC}", *extra, "-o",
               lib, src]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if any(s in line for s in show):
                print(f"  ptxas {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(lib)
        libs[name].ptxas = log
    return libs


def device_ms(fn, iters: int = 10, part=None) -> float:
    """The summed device time of the kernels ``fn`` launches (those whose
    name holds ``part``, where given), per call (torch.profiler), after one
    warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and (part is None or part in e.name)
               ) / 1e3 / iters
