"""What a CUDA graph capture lets a program do with a CUDA generator's
state: the question behind the recompute of checkpointed blocks in a
captured training step (models/layers.py::RecomputeStreams).

A checkpointed block's recompute must draw the masks that its forward drew,
and leave the generator where the step without remat leaves it. Eagerly a
copy of the state does it. This probe tries each candidate inside a capture
and reports what happens, as one JSON object on its last line:

* ``get_state``, ``get_offset``, ``set_state``, ``clone_state`` inside the
  capture: whether each raises;
* ``graphsafe_roundtrip``: ``graphsafe_get_state`` before a draw and
  ``graphsafe_set_state`` after it, then the draw again, all in the capture;
  whether the replay draws the same values twice;
* ``registered_clone``: a clone of the state made before the capture and
  registered with the graph (``register_generator_state``), swapped in with
  ``graphsafe_set_state`` for the second draw, after an earlier draw (the
  blocks before it); whether the second draw repeats the first, at the first
  replay and at the second;
* ``eager_clone``: the same swap on the eager route.

    python -m deepfake_tpu_torch.tools.rng_capture_probe      # on the card
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rng_capture_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    n = 1 << 16
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}

    def in_capture(name, fn):
        gen = torch.Generator(dev).manual_seed(1)
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(gen)
        torch.cuda.synchronize()
        try:
            with torch.cuda.graph(g):
                torch.rand(n, device=dev, generator=gen)
                fn(gen)
            out[name] = "ran"
        except Exception as e:  # noqa: BLE001 - the refusal is the finding
            out[name] = f"raises {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        torch.cuda.synchronize()

    probe = torch.Generator(dev).manual_seed(2)
    state = probe.get_state()
    in_capture("get_state", lambda gen: gen.get_state())
    in_capture("get_offset", lambda gen: gen.get_offset())
    in_capture("set_state", lambda gen: gen.set_state(state))
    in_capture("clone_state", lambda gen: gen.clone_state())

    # graph-safe round trip inside the capture
    gen = torch.Generator(dev).manual_seed(3)
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        saved = gen.graphsafe_get_state()
        a = torch.rand(n, device=dev, generator=gen)
        gen.graphsafe_set_state(saved)
        b = torch.rand(n, device=dev, generator=gen)
    g.replay()
    torch.cuda.synchronize()
    out["graphsafe_roundtrip"] = {"second_draw_repeats_first": bool(torch.equal(a, b))}

    # a clone registered before the capture, swapped in for the recompute
    gen = torch.Generator(dev).manual_seed(4)
    twin = gen.clone_state()
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    g.register_generator_state(twin)
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        torch.rand(n, device=dev, generator=gen)  # the blocks before this one
        live = gen.graphsafe_get_state()
        a = torch.rand(n, device=dev, generator=gen)  # this block's forward
        gen.graphsafe_set_state(twin)
        b = torch.rand(n, device=dev, generator=gen)  # its recompute
        gen.graphsafe_set_state(live)
    repeats = []
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        repeats.append(bool(torch.equal(a, b)))
    out["registered_clone"] = {"second_draw_repeats_first_at_replays": repeats}

    # the same swap eagerly
    gen = torch.Generator(dev).manual_seed(5)
    torch.rand(n, device=dev, generator=gen)
    twin = gen.clone_state()
    a = torch.rand(n, device=dev, generator=gen)
    live = gen.graphsafe_get_state()
    gen.graphsafe_set_state(twin)
    b = torch.rand(n, device=dev, generator=gen)
    gen.graphsafe_set_state(live)
    c = torch.rand(n, device=dev, generator=gen)
    ref = torch.Generator(dev).manual_seed(5)
    want = [torch.rand(n, device=dev, generator=ref) for _ in range(3)][2]
    out["eager_clone"] = {"second_draw_repeats_first": bool(torch.equal(a, b)),
                          "generator_moves_as_without_recompute": bool(torch.equal(c, want))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
