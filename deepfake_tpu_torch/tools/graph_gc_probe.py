"""What releasing a dead object inside a CUDA graph capture does to that
capture: the question behind the cycle-collector guard in
compiled.py::Graph.

PyTorch's ``torch.cuda.graph`` no longer runs ``gc.collect()`` before a
capture (``torch.compiler.config.force_cudagraph_gc`` is False by default),
so a dead reference cycle can be collected by the automatic collector in the
middle of a capture. Each case below leaves one such cycle behind, then
captures a graph whose function collects explicitly during the capture (the
point where the automatic collector could fire), and prints whether the
capture held:

* ``dead_tensor``: the cycle owns a device tensor only;
* ``dead_graph``: the cycle owns a ``GraphCache`` with one captured graph;
* ``dead_predictor``: the cycle is a compiled fused ``Predictor`` (small
  widths) whose request graph was captured;
* ``noguard_test``: ``tests/test_torch_cuda.py::
  test_graph_capture_runs_no_cycle_collection`` with the guard switched off
  (``compiled.gc.disable`` a no-op); the test must fail.

Run each case in a process of its own, from the repository's root, on the
card:

    python deepfake_tpu_torch/tools/graph_gc_probe.py dead_tensor
    python deepfake_tpu_torch/tools/graph_gc_probe.py dead_graph   # ... and so on
"""

import gc
import os
import sys
import traceback
import types

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))

import torch  # noqa: E402

import deepfake_tpu_torch.compiled as C  # noqa: E402

dev = torch.device("cuda")
x = torch.randn(1 << 16, device=dev)


class Owner:
    pass


def case(name, make_dead):
    gc.collect()
    gc.disable()
    make_dead()

    def fn(t):
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return t + 1

    try:
        out = C.GraphCache(dev).run((name,), fn, x)
        torch.cuda.synchronize()
        print(name, "capture ok", bool(torch.equal(out, x + 1)), flush=True)
    except Exception as e:
        print(name, "capture FAILED:", repr(e)[:300], flush=True)
        try:
            torch.cuda.synchronize()
        except Exception as e2:
            print("  sync after:", repr(e2)[:200])
    gc.enable()


def dead_graph():
    o = Owner()
    o.me, o.cache = o, C.GraphCache(dev)
    o.cache.run(("d",), lambda t: t * 2, x)


def dead_predictor():
    from test_torch_cuda import _graph_cfg, _model_request

    from deepfake_tpu_torch.serving import Predictor

    cfg = _graph_cfg("fused", torch.bfloat16)
    p = Predictor(cfg, device=dev)
    p.me = p
    p.predict(_model_request(cfg, 2, dev, 53))


def dead_tensor():
    o = Owner()
    o.me, o.t = o, torch.randn(1 << 20, device=dev)


def noguard_test():
    import test_torch_cuda as T

    C.gc = types.SimpleNamespace(isenabled=gc.isenabled, disable=lambda: None, enable=gc.enable)
    try:
        T.test_graph_capture_runs_no_cycle_collection(dev)
        print("noguard_test: PASSED (the test does not see the missing guard)")
    except BaseException as e:
        print("noguard_test: failed as it should:", repr(e)[:400])


CASES = {"dead_tensor": dead_tensor, "dead_graph": dead_graph, "dead_predictor": dead_predictor}

for n in sys.argv[1:]:
    try:
        if n == "noguard_test":
            noguard_test()
        else:
            case(n, CASES[n])
    except Exception:
        traceback.print_exc()
        break
