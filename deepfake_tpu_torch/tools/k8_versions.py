#!/usr/bin/env python3
"""K8, the activation max and the int8 quantiser of the IRv2 trunk
(csrc/int8_conv.cu: k8_amax, k8_quantize), in versions side by side on the
card: each version is a source file, built into the ignored
deepfake_tpu_torch/_build/k8bench/ and called through the package's own
wrappers (ops/int8_conv.py::act_amax, act_quantize).

    python3 deepfake_tpu_torch/tools/k8_versions.py \\
        _checkout/parent/deepfake_tpu_torch/csrc/int8_conv.cu \\
        deepfake_tpu_torch/csrc/int8_conv.cu [--frames 256] [--iters 10] [--out PATH]

A version may come from an older checkout (its csrc/ unpacked with git
archive; the headers beside the source are its own): one whose K8 entry
points take no SM count (the first design) is called through ``_NoSms``.

The calls: one eager int8 forward of the IRv2 trunk (K1 on, bf16, seeded
random weights) on ``frames`` frames of 224 (256: one fused b8 request)
records the input of every act_amax and act_quantize call, on the shared
route (one max and one quantisation a distinct activation, the max of a K7
output from K7's epilogue) and on the per-conv route
(``per_conv_quantization``: one of each a conv, the first design's
composition). At every distinct input shape, on seeded random bf16 values
(``--data relu``, the default: max(0, N(0, 1/4)), half of them zeros, as the
ReLU outputs most of these calls read; ``signed``: N(0, 1/4)), each
version's max and quantisation are held against the plain versions to
the bit, then timed with CUDA events over ``iters`` calls in turns (every
version, then again in reverse order; the min is kept), with their device
time (torch.profiler) beside them, ``torch.linalg.vector_norm(x, inf)`` and
the bound (the input read once and the output written once, over 3.35
TB/s). Prints the card's name and power limit, one line per shape and the
totals per request of each version on each route; --out writes them as
JSON. A development tool for the kernels' redesign, off every serving path;
PERF.md's K8 table was timed by it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def bound_ms(numel: int, op: str) -> float:
    """The least time of one call on the card: the bf16 input read once, the
    int8 output written once (quantize), the scalar."""
    nbytes = 2 * numel + 4 + (numel if op == "quantize" else 0)
    return nbytes / HBM_BYTES_PER_S * 1e3


def recorded_calls(frames: int, dev):
    """{route: {"amax": {shape: count}, "quantize": {shape: count}}} of one
    int8 IRv2 forward (K1 on, bf16) on ``frames`` frames of 224, for the
    shared and the per-conv route."""
    import torch

    from deepfake_tpu_torch.models import inception_resnet_v2 as irv2
    from deepfake_tpu_torch.models.layers import init_weights
    from deepfake_tpu_torch.models.registry import pack_int8_weights, pack_block_weights
    from deepfake_tpu_torch.ops import int8_conv as Q

    gen = torch.Generator(dev).manual_seed(81)
    model = init_weights(irv2.InceptionResNetV2(True, quant="int8").to(dev), gen)
    pack_int8_weights(model)
    model = model.to(torch.bfloat16)
    pack_block_weights(model, torch.bfloat16)
    x = torch.randn(frames, 224, 224, 3, generator=gen, device=dev).to(torch.bfloat16)
    check = Q._check_act
    routes = {}
    for route in ("shared", "per_conv"):
        seen = {"amax": {}, "quantize": {}}

        def spy(name, t):  # act_amax and act_quantize check their input first
            key = tuple(t.shape)
            seen[name[4:]][key] = seen[name[4:]].get(key, 0) + 1
            return check(name, t)

        Q._check_act = spy
        try:
            with torch.inference_mode():
                if route == "shared":
                    model(x)
                else:
                    with Q.per_conv_quantization():
                        model(x)
        finally:
            Q._check_act = check
        routes[route] = seen
    del model, x
    torch.cuda.empty_cache()
    return routes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="K8 sources (csrc/int8_conv.cu of a checkout)")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--data", choices=("relu", "signed"), default="relu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from deepfake_tpu_torch.ops import int8_conv as Q

    if not torch.cuda.is_available():
        raise SystemExit("k8_versions: needs an NVIDIA GPU")
    print(common.card(), flush=True)
    libs = common.nvcc([(v, v, []) for v in args.versions],
                       os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k8bench"))
    typed = {v: Q.bind(libs[v]) if _takes_sms(v) else _NoSms(libs[v]) for v in args.versions}
    lib_of = Q._lib
    dev = torch.device("cuda")
    routes = recorded_calls(args.frames, dev)

    def use(v):
        Q._lib = lambda: typed[v]

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    gen = torch.Generator(dev).manual_seed(82)
    shapes = sorted({s for r in routes.values() for op in r.values() for s in op},
                    key=lambda s: -math.prod(s))
    rows = []
    for shape in shapes:
        x = (0.5 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
        if args.data == "relu":
            x = torch.relu(x)
        want = Q.act_amax_plain(x)
        low = 0.25 * want  # a static scale that saturates
        for v in args.versions:
            use(v)
            a = Q.act_amax(x)
            torch.cuda.synchronize()
            if not torch.equal(a, want):
                raise SystemExit(f"{v}: amax at {shape}: {a.item()} against {want.item()}")
            for scale in (a, low):
                if not torch.equal(Q.act_quantize(x, scale), Q.act_quantize_plain(x, scale)):
                    raise SystemExit(f"{v}: quantize at {shape} differs from the plain version")
        row = dict(shape=list(shape), mbytes=2 * x.numel() / 1e6, ms={}, device_ms={},
                   bound_ms={op: bound_ms(x.numel(), op) for op in ("amax", "quantize")},
                   vector_norm_ms=timed(lambda: torch.linalg.vector_norm(x, ord=math.inf)),
                   vector_norm_device_ms=common.device_ms(
                       lambda: torch.linalg.vector_norm(x, ord=math.inf), iters=args.iters),
                   calls={r: {op: routes[r][op].get(shape, 0) for op in ("amax", "quantize")}
                          for r in routes})
        calls = {"amax": lambda: Q.act_amax(x), "quantize": lambda: Q.act_quantize(x, want)}
        for op, fn in calls.items():
            for v in args.versions + args.versions[::-1]:
                use(v)
                t = timed(fn)
                key = f"{op}:{v}"
                row["ms"][key] = min(row["ms"].get(key, t), t)
                if key not in row["device_ms"]:
                    row["device_ms"][key] = common.device_ms(fn, iters=args.iters)
        rows.append(row)
        print(f"{list(shape)} ({row['mbytes']:.1f} MB) calls {json.dumps(row['calls'])}: "
              + " ".join(f"[{k}]={t:.4f}" for k, t in row["ms"].items()) + " device: "
              + " ".join(f"[{k}]={t:.4f}" for k, t in row["device_ms"].items())
              + f" vector_norm {row['vector_norm_ms']:.4f} (device "
              f"{row['vector_norm_device_ms']:.4f}) bound amax {row['bound_ms']['amax']:.4f} "
              f"quantize {row['bound_ms']['quantize']:.4f}", flush=True)
        del x, want, low
    Q._lib = lib_of

    # per request: each version's times on each route's calls (the amax and
    # quantisation counts of that route at each shape); int8_static is the
    # per-conv route's quantisations alone
    totals = {}
    for route in routes:
        for v in args.versions:
            t = dict.fromkeys(("amax_ms", "amax_device_ms", "quantize_ms", "quantize_device_ms",
                               "amax_bound_ms", "quantize_bound_ms", "vector_norm_ms"), 0.0)
            for r in rows:
                for op in ("amax", "quantize"):
                    n = r["calls"][route][op]
                    t[f"{op}_ms"] += n * r["ms"][f"{op}:{v}"]
                    t[f"{op}_device_ms"] += n * r["device_ms"][f"{op}:{v}"]
                    t[f"{op}_bound_ms"] += n * r["bound_ms"][op]
                t["vector_norm_ms"] += r["calls"][route]["amax"] * r["vector_norm_ms"]
            t["calls"] = {op: sum(r["calls"][route][op] for r in rows)
                          for op in ("amax", "quantize")}
            totals[f"{route}:{v}"] = t
            print(f"per request, {route} route, {v}: calls {json.dumps(t['calls'])} "
                  + " ".join(f"{k}={val:.4f}" for k, val in t.items() if k != "calls")
                  + f"; K8 in all {t['amax_ms'] + t['quantize_ms']:.4f} ms (device "
                  f"{t['amax_device_ms'] + t['quantize_device_ms']:.4f}, bound "
                  f"{t['amax_bound_ms'] + t['quantize_bound_ms']:.4f})", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=common.card(), versions=args.versions, frames=args.frames,
                           data=args.data, rows=rows, totals=totals), f, indent=1)
    return 0


def _takes_sms(source: str) -> bool:
    """Whether the source's k8_amax takes the SM count (the first design's
    does not)."""
    text = open(source).read()
    start = text.index('extern "C" int k8_amax(')
    return "int sms" in text[start:text.index("{", start)]


class _NoSms:
    """A build of the first design, whose k8_amax and k8_quantize take no SM
    count, called through the package's wrappers: the count is dropped."""

    def __init__(self, lib):
        import ctypes

        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.k8_amax.argtypes = [i, p, i64, p, p]
        lib.k8_amax.restype = i
        lib.k8_quantize.argtypes = [i, p, i64, p, p, p]
        lib.k8_quantize.restype = i
        lib.k7_error_string.argtypes = [i]
        lib.k7_error_string.restype = ctypes.c_char_p
        self.lib = lib
        self.k7_error_string = lib.k7_error_string

    def k8_amax(self, *args):
        return self.lib.k8_amax(*args[:-2], args[-1])

    def k8_quantize(self, *args):
        return self.lib.k8_quantize(*args[:-2], args[-1])


if __name__ == "__main__":
    sys.exit(main())
