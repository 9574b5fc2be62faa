#!/usr/bin/env python3
"""K7, the int8 IRv2 conv (csrc/int8_conv.cu), in versions side by side on
the card: each version is a source file, built into the ignored
deepfake_tpu_torch/_build/k7bench/ and called through the package's own
wrapper (ops/int8_conv.py::int8_conv).

    python3 deepfake_tpu_torch/tools/k7_versions.py _checkout/int8_conv.cu \\
        deepfake_tpu_torch/csrc/int8_conv.cu[@amax] [--lists k1_on,k1_off] [--out PATH]

A version named SOURCE@amax is SOURCE called with ``out_amax`` (the output's
max reduced in the epilogue, as the shared route asks of every conv whose
output an int8 conv alone reads).

A version may come from an older checkout (its csrc/ unpacked with git
archive; the headers beside the source are its own): one whose
k7_int8_conv takes no plan (the first design) or no output max (before the
epilogue reduced it) is called through ``_Older``, which drops those
arguments.

At every conv shape of a fused b8 request (256 frames of 224: the 24 convs
outside K1's blocks, and with K1 off the 244 of the trunk; ``irv2_convs``),
on seeded random int8 activations and weights, each version's bf16 and f32
outputs are held against ``int8_conv_plain`` to the bit; then its bf16 call
is timed with CUDA events over 10 calls, in turns (every version, then again
in reverse order; the min is kept), with its device time (torch.profiler)
beside it, cuDNN's bf16 conv of the same shape (channels_last) and the
bound (the int8 input and weights read once, the bf16 output written once,
over 3.35 TB/s; 2 M N K operations over 1,979 TOP/s; the larger). Prints the
card's name and power limit, one line per shape and the totals per request
(each shape times its count); --out writes them as JSON. A development tool
for the kernel's redesign, off every serving path; PERF.md's K7 tables were
timed by it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor cores, NVIDIA data sheet


def _out(side: int, k: int, stride: int, pad: int) -> int:
    return (side + 2 * pad - k) // stride + 1


def irv2_convs(frames: int = 256, side: int = 224):
    """The int8 convs of the IRv2 trunk (models/inception_resnet_v2.py) on
    ``frames`` frames of ``side``: [(name, x [F, H, W, Cin], w [Cout, KH,
    KW, Cin], stride, pad (top, bottom, left, right), relu, in_block)], in
    the order the forward runs them; a residual block's convs once, the
    block's repeats given by ``block_counts``. ``in_block``: the conv runs in
    K1 when the blocks are fused (then only the 24 others run int8)."""
    convs = []

    def conv(name, s, cin, cout, k, stride=1, pad=(0, 0), relu=True, block=False):
        kh, kw = k
        convs.append((name, (frames, s, s, cin), (cout, kh, kw, cin), stride,
                      (pad[0], pad[0], pad[1], pad[1]), relu, block))
        return _out(s, kh, stride, pad[0])

    s = conv("stem.f0", side, 3, 32, (3, 3), 2)
    s = conv("stem.f1", s, 32, 32, (3, 3))
    s = conv("stem.f2", s, 32, 64, (3, 3), 1, (1, 1))
    s = _out(s, 3, 2, 0)
    s = conv("stem.f4", s, 64, 80, (1, 1))
    s = conv("stem.f5", s, 80, 192, (3, 3))
    s = _out(s, 3, 2, 0)
    conv("stem.b0", s, 192, 96, (1, 1))
    conv("stem.b1_0", s, 192, 48, (1, 1))
    conv("stem.b1_1", s, 48, 64, (5, 5), 1, (2, 2))
    conv("stem.b2_0", s, 192, 64, (1, 1))
    conv("stem.b2_1", s, 64, 96, (3, 3), 1, (1, 1))
    conv("stem.b2_2", s, 96, 96, (3, 3), 1, (1, 1))
    conv("stem.b3_1", s, 192, 64, (1, 1))
    for name, cin, cout, k, pad in (("b0", 320, 32, (1, 1), (0, 0)),
                                    ("b1_0", 320, 32, (1, 1), (0, 0)),
                                    ("b1_1", 32, 32, (3, 3), (1, 1)),
                                    ("b2_0", 320, 32, (1, 1), (0, 0)),
                                    ("b2_1", 32, 48, (3, 3), (1, 1)),
                                    ("b2_2", 48, 64, (3, 3), (1, 1))):
        conv(f"a.{name}", s, cin, cout, k, 1, pad, block=True)
    conv("a.conv", s, 128, 320, (1, 1), relu=False, block=True)
    conv("red_a.b0", s, 320, 384, (3, 3), 2)
    conv("red_a.b1_0", s, 320, 256, (1, 1))
    conv("red_a.b1_1", s, 256, 256, (3, 3), 1, (1, 1))
    s = conv("red_a.b1_2", s, 256, 384, (3, 3), 2)
    for name, cin, cout, k, pad in (("b0", 1088, 192, (1, 1), (0, 0)),
                                    ("b1_0", 1088, 128, (1, 1), (0, 0)),
                                    ("b1_1", 128, 160, (1, 7), (0, 3)),
                                    ("b1_2", 160, 192, (7, 1), (3, 0))):
        conv(f"b.{name}", s, cin, cout, k, 1, pad, block=True)
    conv("b.conv", s, 384, 1088, (1, 1), relu=False, block=True)
    conv("red_b.b0_0", s, 1088, 256, (1, 1))
    conv("red_b.b0_1", s, 256, 384, (3, 3), 2)
    conv("red_b.b1_0", s, 1088, 256, (1, 1))
    conv("red_b.b1_1", s, 256, 288, (3, 3), 2)
    conv("red_b.b2_0", s, 1088, 256, (1, 1))
    conv("red_b.b2_1", s, 256, 288, (3, 3), 1, (1, 1))
    s = conv("red_b.b2_2", s, 288, 320, (3, 3), 2)
    for name, cin, cout, k, pad in (("b0", 2080, 192, (1, 1), (0, 0)),
                                    ("b1_0", 2080, 192, (1, 1), (0, 0)),
                                    ("b1_1", 192, 224, (1, 3), (0, 1)),
                                    ("b1_2", 224, 256, (3, 1), (1, 0))):
        conv(f"c.{name}", s, cin, cout, k, 1, pad, block=True)
    conv("c.conv", s, 448, 2080, (1, 1), relu=False, block=True)
    conv("conv", s, 2080, 1536, (1, 1))
    return convs


def block_counts(name: str) -> int:
    """How many times a request runs the conv ``name``: 10 blocks A, 20 B,
    10 C (c_0..c_9), once for every conv outside them."""
    return {"a": 10, "b": 20, "c": 10}.get(name.split(".")[0], 1)


def request_lists(frames: int = 256, side: int = 224):
    """{"k1_on": [(conv, count)], "k1_off": [...]}: the int8 convs of one
    request with K1 on (24) and off (244), each distinct shape once with
    its count."""
    out = {"k1_on": [], "k1_off": []}
    for c in irv2_convs(frames, side):
        n = block_counts(c[0])
        if not c[6]:
            out["k1_on"].append((c, n))
        out["k1_off"].append((c, n))
    return out


def cost(x_shape, w_shape, stride, pad):
    """(operations, bytes) of one K7 launch with bf16 out (chip_smoke.py's
    int8_conv_cost): 2 M N K; the int8 input and weights read once, the
    bf16 output written once, the scales, shift and amax."""
    from deepfake_tpu_torch.ops.int8_conv import out_size

    Fn, H, W, cin = x_shape
    cout, kh, kw, _ = w_shape
    Ho, Wo = out_size(H, W, kh, kw, stride, pad)
    M = Fn * Ho * Wo
    xb = Fn * H * W * cin
    return 2.0 * M * cout * kh * kw * cin, xb + cout * kh * kw * cin + 8 * cout + 4 + 2 * M * cout


def bound_ms(x_shape, w_shape, stride, pad):
    ops, nbytes = cost(x_shape, w_shape, stride, pad)
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="K7 sources (csrc/int8_conv.cu of a checkout)")
    ap.add_argument("--lists", default="k1_on,k1_off",
                    help="which requests' convs: k1_on (24), k1_off (244), or both")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.ops import int8_conv as Q

    if not torch.cuda.is_available():
        raise SystemExit("k7_versions: needs an NVIDIA GPU")
    print(common.card(), flush=True)
    libs = common.nvcc([(v, v.split("@")[0], []) for v in args.versions],
                       os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k7bench"))
    typed = {v: _adapted(libs[v], v.split("@")[0]) for v in args.versions}
    lib_of = Q._lib

    def use(v):
        Q._lib = lambda: typed[v]

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

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

    lists = request_lists(args.frames)
    keys = [*args.versions, "cudnn_bf16", "bound"]
    totals, rows, done = {}, [], {}
    for which in args.lists.split(","):
        total = dict.fromkeys(keys + [f"device:{v}" for v in args.versions], 0.0)
        for (name, xs, wsh, stride, pad, relu, _), count in lists[which]:
            key = (xs, wsh, stride, pad, relu)
            if key not in done:
                xq = torch.randint(-127, 128, xs, generator=gen, device=dev, dtype=torch.int8)
                wq = torch.randint(-127, 128, wsh, generator=gen, device=dev, dtype=torch.int8)
                cout = wsh[0]
                w = Q.Int8Weights(wq, 1e-3 * (1 + torch.rand(cout, generator=gen, device=dev)),
                                  torch.randn(cout, generator=gen, device=dev), stride, pad)
                amax = torch.full((1,), 3.0, device=dev)
                caller = lambda v: lambda dt=torch.bfloat16: Q.int8_conv(
                    xq, w, amax, relu, dt, out_amax=v.endswith("@amax"))
                for dt in (torch.bfloat16, torch.float32):
                    want, want_max = Q.int8_conv_plain(xq, w, amax, relu, dt, out_amax=True)
                    for v in args.versions:
                        use(v)
                        try:
                            got = caller(v)(dt)
                            torch.cuda.synchronize()
                        except RuntimeError as e:
                            raise SystemExit(f"{v}: {name} {dt}: {e}")
                        got, got_max = got if isinstance(got, tuple) else (got, want_max)
                        if not (torch.equal(got, want) and torch.equal(got_max, want_max)):
                            raise SystemExit(
                                f"{v}: {name} {dt} differs from the plain version by "
                                f"{(got.float() - want.float()).abs().max().item():.3e}, "
                                f"max {got_max.item()} against {want_max.item()}")
                        del got
                    del want
                ms, dev_ms = {}, {}
                for v in args.versions + args.versions[::-1]:
                    use(v)
                    t = timed(caller(v))
                    ms[v] = min(ms.get(v, t), t)
                    if v not in dev_ms:
                        dev_ms[v] = common.device_ms(caller(v), iters=args.iters)
                xb = torch.randn(xs[0], xs[3], xs[1], xs[2], generator=gen, device=dev).to(
                    torch.bfloat16).contiguous(memory_format=torch.channels_last)
                wb = torch.randn(cout, xs[3], wsh[1], wsh[2], generator=gen, device=dev).to(
                    torch.bfloat16).contiguous(memory_format=torch.channels_last)
                ms["cudnn_bf16"] = timed(lambda: F.conv2d(xb, wb, stride=stride,
                                                          padding=(pad[0], pad[2])))
                ms["bound"], by = bound_ms(xs, wsh, stride, pad)
                p = Q.plan(xs, wsh, stride, pad)
                done[key] = dict(ms=ms, device_ms=dev_ms, bound_by=by, plan=p.__dict__)
                del xq, wq, w, xb, wb
                torch.cuda.empty_cache()
            r = done[key]
            print(f"{which} {name} x{count} in {list(xs)} w {list(wsh)} s{stride} pad {pad} "
                  f"plan {r['plan']}: "
                  + " ".join(f"[{k}]={t:.4f}" for k, t in r["ms"].items())
                  + f" ({r['bound_by']}) device: "
                  + " ".join(f"[{k}]={t:.4f}" for k, t in r["device_ms"].items()), flush=True)
            rows.append(dict(list=which, name=name, count=count, x=list(xs), w=list(wsh),
                             stride=stride, pad=list(pad), **r))
            for k, t in r["ms"].items():
                total[k] += count * t
            for k, t in r["device_ms"].items():
                total[f"device:{k}"] += count * t
        totals[which] = total
        print(f"per request, {which} ({sum(c for _, c in lists[which])} convs): "
              + " ".join(f"[{k}]={t:.4f}" for k, t in total.items()), flush=True)
    Q._lib = lib_of
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=common.card(), versions=args.versions, rows=rows,
                           totals=totals), f, indent=1)
    return 0


def _takes(source: str, arg: str) -> bool:
    """Whether the source's k7_int8_conv takes the argument ``arg``."""
    text = open(source).read()
    start = text.index('extern "C" int k7_int8_conv(')
    return arg in text[start:text.index("{", start)]


def _adapted(lib, source: str):
    """The library bound for the package's wrapper: as it is where its
    k7_int8_conv takes a plan and an output max, else through ``_Older``."""
    from deepfake_tpu_torch.ops.int8_conv import bind

    plan, out_amax = _takes(source, "int kc"), _takes(source, "out_amax")
    return bind(lib) if plan and out_amax else _Older(lib, plan, out_amax)


class _Older:
    """A build of an earlier design, called through the package's wrapper:
    the plan's arguments (kc, wide, bn, bf, bh, bw, bfb, bhb, sms; the first
    design takes none) and the output max (before the epilogue reduced it;
    the wrapper then asks for none) are dropped."""

    PLAN = slice(20, 29)  # the plan's place in k7_int8_conv's arguments
    OUT_AMAX = -2         # the output max's, before the stream

    def __init__(self, lib, plan: bool, out_amax: bool):
        from deepfake_tpu_torch.ops.int8_conv import bind

        self.lib = bind(lib)
        self.plan, self.out_amax = plan, out_amax
        lib.k7_int8_conv.argtypes = self._drop(list(lib.k7_int8_conv.argtypes))
        self.k7_error_string = lib.k7_error_string

    def _drop(self, args):
        if not self.out_amax:
            del args[self.OUT_AMAX]
        if not self.plan:
            del args[self.PLAN]
        return args

    def k7_int8_conv(self, *args):
        return self.lib.k7_int8_conv(*self._drop(list(args)))


if __name__ == "__main__":
    sys.exit(main())
