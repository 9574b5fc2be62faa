"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``deepfake_tpu_torch/_build/lib<name>-<hash>.so``; the hash covers the
source, the headers beside it (``csrc/*.cuh``) and the flags, so an edited
source or header never loads a stale library.
No PyTorch header is included, so a build takes seconds. ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

A build failure raises: no caller carries on without its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("inception_block", "window_attn", "window_attn3d", "ln_linear", "window_attn3d_train",
           "window_attn_multihead", "int8_conv")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the loaded libraries, by source name (the only module-level state)
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    # the source and every header beside it (csrc/*.cuh), which it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all nvcc processes at
    once. Returns ``{name: ptxas report}`` for the sources built now."""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_target(name))
        _LIBS[name] = lib
    return lib


def check(status: int, error_string, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point;
    ``error_string`` is the library's exported ``cudaGetErrorString``."""
    if status != 0:
        raise RuntimeError(
            f"{what}: CUDA error {status} at launch: {error_string(status).decode()}")
