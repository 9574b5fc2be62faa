#!/usr/bin/env python3
"""K1's bf16 route in versions, side by side on the card.

    python3 deepfake_tpu_torch/tools/k1_versions.py tree [NAME=PATH ...] [--out PATH]

Each version is a source of csrc/inception_block.cu with the tree's C
interface (``k1_conv_bf16``); ``tree`` is the tree's own. A version named
NAME@W (``tree@64``, ``v2=PATH@128``) plans column tiles no wider than W
(the ``widest`` of ops/inception_block.py::n_tile). Each is built with
the package's nvcc flags (csrc/ on the include path) into the ignored
deepfake_tpu_torch/_build/k1_versions/, held against the plain block
(``inception_block_plain``, max |kernel - plain| / max(|plain|, 1) <= 2e-2,
the tolerance of chip_smoke.py phase 2) and timed in turns (every version,
then again in reverse order) at IRv2 blocks A (25 x 25), B (12 x 12) and C
(5 x 5) of b8 x 32 frames in bf16: each block call by CUDA events over 10
calls, and each of its conv launches by its device time (torch.profiler
over 10 calls; the i-th kernel of a call is the block's i-th conv).
Prints the card's name and power limit, one line per version and block and
the sums per fused b8 request (10 A, 20 B, 10 C); --out writes them as JSON.
A development tool, off every serving path; PERF.md's table of K1's
versions was timed by it.

--diag adds diagnostic builds of the tree's source, each with one part
switched off by a patch of its text (they compute garbage and say only
where the time goes; written to the build directory): no_mma (no wgmma
product; the accumulators are never written), no_stores (the epilogue computes its
values but stores none), no_epilogue (no epilogue at all).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT

BLOCKS = {"A": (25, 10), "B": (12, 20), "C": (5, 10)}  # side, blocks a fused b8 request

# (name, [(old text, new text), ...]): --diag's patches of the tree's source
DIAGS = [
    ("no_mma", [("        WgmmaSS<BN>::mma(acc, desc_sw128(as + kk * 32), "
                 "desc_sw128(ws + kk * 32),\n                         c > 0 || kk > 0);",
                 "        asm volatile(\"\" ::\"l\"(desc_sw128(as + kk * 32)), "
                 "\"l\"(desc_sw128(ws + kk * 32)));")]),
    ("no_stores", [("      *reinterpret_cast<uint4*>(dst) = v;",
                    "      if (v.x == 0x7fc17fc1u) *reinterpret_cast<uint4*>(dst) = v;")]),
    ("no_epilogue", [("    for (int j = 0; j < BN / 8; ++j) {", "    for (int j = 0; j < 0; ++j) {"),
                     ("    for (int idx = t128; idx < 64 * (BN / 8); idx += 128) {",
                      "    for (int idx = t128; idx < 0; idx += 128) {")]),
]


def diag_sources(source, out_dir):
    """--diag: the patched copies of ``source``, as diagnostic versions."""
    text = open(source).read()
    out = {}
    for name, patches in DIAGS:
        t = text
        for old, new in patches:
            if old not in t:
                raise SystemExit(f"--diag {name}: the source has no {old[:60]!r}")
            t = t.replace(old, new, 1)
        path = os.path.join(out_dir, f"diag_{name}.cu")
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(t)
        out[name] = path
    return out


def build(versions, out_dir):
    from deepfake_tpu_torch.ops.inception_block import bind

    libs = common.nvcc(list((name, src, []) for name, src in versions.items()), out_dir, show=())
    for name, lib in libs.items():
        log = lib.ptxas
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in log.splitlines() if "registers" in line and "Used" in line})
        spills = sum("spill stores" in line and not line.strip().startswith("0 bytes")
                     and " 0 bytes spill stores" not in line for line in log.splitlines())
        warns = sorted({line.split("(C75")[1][:2] for line in log.splitlines() if "(C75" in line})
        print(f"{name}: built; registers per thread over its kernels: {', '.join(regs)}; "
              f"kernels that spill: {spills}; ptxas performance notes: "
              f"{', '.join('C75' + w for w in warns) or 'none'}", flush=True)
        libs[name] = bind(lib)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="'tree' or NAME=PATH of a source")
    ap.add_argument("--out", default=None, help="write the times as JSON here")
    ap.add_argument("--frames", type=int, default=8 * 32)
    ap.add_argument("--diag", action="store_true", help="add the diagnostic builds")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepfake_tpu_torch.kernels.build import CSRC
    from deepfake_tpu_torch.models import inception_resnet_v2 as irv2
    from deepfake_tpu_torch.models.layers import BatchNorm, init_weights
    from deepfake_tpu_torch.ops import inception_block as k1

    if not torch.cuda.is_available():
        raise SystemExit("k1_versions: needs an NVIDIA GPU")
    card = common.card()
    print(card, flush=True)
    versions, widest = {}, {}
    for v in args.versions:
        v, _, w = v.partition("@")
        name, _, path = v.partition("=")
        name += f"@{w}" if w else ""
        versions[name] = path or os.path.join(CSRC, "inception_block.cu")
        widest[name] = int(w) if w else max(k1.N_TILES)
    if args.diag:
        out_dir = os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k1_versions")
        for name, path in diag_sources(os.path.join(CSRC, "inception_block.cu"), out_dir).items():
            versions[name], widest[name] = path, max(k1.N_TILES)
    libs = build(versions, os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k1_versions"))
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    dt = torch.bfloat16
    real_lib, real_n_tile = k1._lib, k1.n_tile

    def with_lib(name, fn):
        k1._lib = lambda: libs[name]
        k1.n_tile = lambda n: real_n_tile(n, widest[name])
        try:
            return fn()
        finally:
            k1._lib, k1.n_tile = real_lib, real_n_tile

    res = {"card": card, "blocks": {}, "per_request": {}}
    order = list(versions) + list(versions)[::-1]
    for bname, (side, count) in BLOCKS.items():
        block = {"A": lambda: irv2.BlockA(0.17, True), "B": lambda: irv2.BlockB(0.10, True),
                 "C": lambda: irv2.BlockC(0.20, True, True)}[bname]()
        init_weights(block.to(dev), gen)
        with torch.no_grad():
            for m in block.modules():
                if isinstance(m, BatchNorm):
                    n = m.weight.numel()
                    m.running_mean.copy_(0.1 * torch.randn(n, generator=gen, device=dev))
                    m.running_var.copy_(0.5 + torch.rand(n, generator=gen, device=dev))
            block.conv.bias.copy_(0.1 * torch.randn(block.conv.bias.numel(), generator=gen,
                                                    device=dev))
        blk = block.eval().pack_weights(dt)
        C = block.conv.out_channels
        x = (0.5 * torch.randn(args.frames, side, side, C, generator=gen, device=dev)).to(dt)
        want = k1.inception_block_plain(x, blk).float()
        n_convs = 2 + sum(len(ch) for ch in blk.chains)
        rows = {name: {"ms": [], "conv_device_ms": []} for name in versions}
        for name in versions:
            got = with_lib(name, lambda: k1.inception_block(x, blk)).float()
            torch.cuda.synchronize()
            rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
            rows[name]["max_rel_err"] = rel
            if not rel <= 2e-2 and not name.startswith("no_"):
                raise SystemExit(f"{name}: block {bname} max rel err {rel:.3e} > 2e-2")
        for name in order:
            run = lambda: with_lib(name, lambda: k1.inception_block(x, blk))
            run()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(10):
                run()
            end.record()
            torch.cuda.synchronize()
            rows[name]["ms"].append(start.elapsed_time(end) / 10)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
            kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                          key=lambda e: e.time_range.start)
            if len(kern) != 10 * n_convs:
                raise SystemExit(f"{name}: {len(kern)} kernels in 10 calls, expected "
                                 f"{10 * n_convs}")
            rows[name]["conv_device_ms"].append(
                [sum(kern[c + n_convs * i].time_range.elapsed_us() for i in range(10)) / 1e4
                 for c in range(n_convs)])
        for name, r in rows.items():
            convs = [min(t[c] for t in r["conv_device_ms"]) for c in range(n_convs)]
            r["best_ms"], r["best_conv_device_ms"] = min(r["ms"]), convs
            print(f"block {bname} [{args.frames}x{side}x{side}x{C}] {name}: ms "
                  + "/".join(f"{t:.4f}" for t in r["ms"]) + f", device {sum(convs):.4f} (convs "
                  + " ".join(f"{t:.4f}" for t in convs) + f"), rel err {r['max_rel_err']:.2e}",
                  flush=True)
        res["blocks"][bname] = rows
        del x, want
        torch.cuda.empty_cache()
    for name in versions:
        ms = sum(BLOCKS[b][1] * res["blocks"][b][name]["best_ms"] for b in BLOCKS)
        dms = sum(BLOCKS[b][1] * sum(res["blocks"][b][name]["best_conv_device_ms"])
                  for b in BLOCKS)
        res["per_request"][name] = {"ms": ms, "device_ms": dms}
        print(f"per fused b8 request, {name}: ms {ms:.3f}, device ms {dms:.3f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
