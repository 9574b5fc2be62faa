"""Compiled execution: each request shape runs as one CUDA graph, the port's
counterpart of the JAX Predictor's ``jax.jit`` (deepfake_tpu/serving.py:54-56)
and of its front end's one jitted program (deepfake_tpu/data/pipeline.py:97);
the Trainer's steps and evaluation batches run through the same cache
(train/trainer.py, the JAX Trainer's jitted step and eval step).

    cache = GraphCache(device)
    out = cache.run(key, fn, inputs)   # fn(static inputs) -> tensor(s) on the device

A graph is kept per request signature (``signature``): the route
(``predict`` or ``raw``), the modality, and the structure, shapes and dtypes
of the inputs, so a raw request's batch, frame shape, PCM bucket length and
the keys present each select their own graph. The first request of a
signature builds its graph: static input buffers on the device (the
request's own dtypes), ``fn`` run twice on them eagerly on a side stream,
so that everything built lazily exists before the capture (the front end's
cached tables, K1's K-major weights, the kernels' once-per-device shared
memory attribute, the window planners' caches, cuDNN's and cuBLAS's
choices), then one capture with ``torch.cuda.graph`` into the memory pool
that every graph of the cache shares. The math mode of each matrix product
(TF32 or not, ``ops/mel.py::full_f32_matmul``) is the one in force when it
is captured. A request copies its arrays into the static buffers (host
arrays through pinned staging buffers, non-blocking), replays the graph and
returns its static outputs, which the next replay overwrites.

The hand-written kernels' TMA tensor maps hold the global addresses of the
tensors they were encoded for, at capture, as kernel parameters. So the
static buffers are written in place and never replaced: a graph reads the
addresses it was captured with. The kernel wrappers' ``.launches`` counters
move when a graph is captured (and in its warm-up), not when it is
replayed: ``Graph.launches`` keeps the per-wrapper count of one capture,
the kernels that each replay launches, and ``Graph.replays`` counts the
replays.

A CUDA generator that ``fn`` draws from is registered with its graph
(``generators``): each replay then reads the generator's offset and
advances it by what the capture drew, so the replays draw what eager runs
from the same state would draw. ``generators`` may be a function, called
after the warm-up (a checkpointed step's recompute generators exist only
once a warm-up has run it); ``prologue``, where given, runs on the host
before every replay (it sets generators' offsets, which a capture can
neither read nor set).

Python's cycle collector does not run during a capture: an object it frees
there may own another graph or its pool's memory, and releasing those is an
operation a capture forbids (the capture then fails at its end, with no
error of its own). Objects that hold a graph should not sit in reference
cycles (a replay's ``prologue`` bound to its owner makes one), so that they
go when their last reference does.

A failed capture or replay raises: nothing here falls back to eager
execution. On the CPU there is nothing to capture; ``serving.Predictor``
and ``train.Trainer`` run eagerly there.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deepfake_tpu_torch.ops import launch_counts

WARMUP = 2  # eager runs before a capture


def _leaf_sig(x) -> Tuple:
    if torch.is_tensor(x):
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    a = np.asarray(x)
    return (a.shape, str(a.dtype))


def signature(route: str, modality: str, inputs) -> Tuple:
    """The key of a request's graph: route, modality and, for every array of
    the (nested tuple, list or dict) inputs, its place, shape and dtype."""
    def sig(x):
        if isinstance(x, dict):
            return ("dict",) + tuple((k, sig(x[k])) for k in sorted(x))
        if isinstance(x, (tuple, list)):
            return ("seq",) + tuple(sig(v) for v in x)
        return _leaf_sig(x)
    return (route, modality, sig(inputs))


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def map_leaves(fn, x):
    """``fn`` on every leaf of a nested tuple, list or dict, the structure kept."""
    if isinstance(x, dict):
        return {k: map_leaves(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(map_leaves(fn, v) for v in x)
    return fn(x)


def _leaves(x):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


class Graph:
    """One captured request shape: static inputs, the graph, its static
    outputs, the per-wrapper kernel launches of one replay and the number of
    replays."""

    def __init__(self, fn: Callable, example, device: torch.device, pool,
                 generators=(), prologue: Optional[Callable[[], None]] = None):
        self.static_in = map_leaves(lambda x: torch.empty(
            tuple(_as_tensor(x).shape), dtype=_as_tensor(x).dtype, device=device), example)
        self.staging: Dict[int, torch.Tensor] = {}  # pinned, for inputs from the host
        self.copied = torch.cuda.Event()  # the last request's copies out of the staging
        self.copy_in(example)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP):
                fn(self.static_in)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        self.prologue = prologue
        for gen in generators() if callable(generators) else generators:
            # each replay draws from, and advances, its state
            self.graph.register_generator_state(gen)
        # the capture empties the allocator's cache first; so does this, so
        # that the reserved bytes grow by the capture's own segments only
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before, reserved = launch_counts(), torch.cuda.memory_reserved(device)
        collecting = gc.isenabled()
        gc.disable()  # no cycle collection inside the capture (module docstring)
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.static_out = fn(self.static_in)
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        # the device memory the capture reserved: this graph's share of the pool
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.replays = 0

    def copy_in(self, inputs) -> None:
        """Writes a request's arrays into the static buffers, in place."""
        self.copied.synchronize()  # a staging buffer is rewritten only once it was read
        for i, (dst, src) in enumerate(zip(_leaves(self.static_in), _leaves(inputs))):
            if torch.is_tensor(src) and src.device.type != "cpu":
                dst.copy_(src, non_blocking=True)
            else:
                stage = self.staging.get(i)
                if stage is None:
                    stage = self.staging[i] = torch.empty(
                        tuple(dst.shape), dtype=dst.dtype, pin_memory=True)
                stage.copy_(_as_tensor(src))
                dst.copy_(stage, non_blocking=True)
        self.copied.record()

    def replay(self, inputs=None):
        """Replays the graph on ``inputs`` or, when None, on what the static
        buffers hold; returns the static outputs."""
        if inputs is not None:
            self.copy_in(inputs)
        if self.prologue is not None:
            self.prologue()
        self.graph.replay()
        self.replays += 1
        return self.static_out


class GraphCache:
    """A Predictor's graphs, one per request signature, in one memory pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Tuple, Graph] = {}

    def graph(self, key: Tuple, fn: Callable, inputs, generators=(),
              prologue: Optional[Callable[[], None]] = None) -> Graph:
        """The graph of ``key``, captured from ``fn`` on ``inputs`` if it is
        new; ``generators``: the CUDA generators ``fn`` draws from (or a
        function giving them after the warm-up); ``prologue``: run before
        each replay."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = Graph(fn, inputs, self.device, self.pool, generators,
                                         prologue)
        return g

    def run(self, key: Tuple, fn: Callable, inputs, generators=(),
            prologue: Optional[Callable[[], None]] = None):
        """``fn`` on ``inputs`` through the graph of ``key``, captured at the
        first request of that key; returns the graph's static outputs (the
        capture's own run computed nothing: the request replays)."""
        return self.graph(key, fn, inputs, generators, prologue).replay(inputs)

    def pool_bytes(self) -> int:
        """Device memory reserved while the graphs were captured (the
        allocator's ``reserved_bytes``, ``torch.cuda.memory_stats``): the
        shared pool's size."""
        return sum(g.pool_bytes for g in self.graphs.values())
