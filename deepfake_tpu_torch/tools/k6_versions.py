#!/usr/bin/env python3
"""K6's bf16 route (csrc/window_attn_multihead.cu, on the chunk of
csrc/window_attn_tile.cuh) in versions side by side on the card: each
version is a source file, with optional -D switches, built into the ignored
deepfake_tpu_torch/_build/k6bench/ and called through the package's own
wrapper (ops/window_attn_multihead.py). A header beside the source file
takes the place of csrc/'s of that name (so a version of the shared chunk is
a directory holding both files).

    python3 deepfake_tpu_torch/tools/k6_versions.py \\
        deepfake_tpu_torch/csrc/window_attn_multihead.cu \\
        "_checkout/v2/window_attn_multihead.cu:-DFOO" [--out PATH]

At the three window-16 stage shapes of SwinV2-B at 256^2 in an audio b8
request (shifted and not), and off the main path at windows 10 and 24
(shifted, b8 of a 2x2-window grid) and in the scaled form at N = 392, every
version's output is held against the plain version (two bf16 ulps of the
largest |output|) and its launch timed by device time (torch.profiler over
10 launches), in turns (every version, then again in reverse order; the min
is kept), beside SDPA with bias + mask as attn_mask on q^ s and k^
normalised outside the timed call. q, k and v are head-major views of one
token-major qkv tensor, as SwinV2 calls K6. A leading ~ marks a diagnostic
build, timed but not held to the plain version. Prints the card's name and
power limit, the ptxas report, one line per shape and the totals per
request (the 22 blocks' launches); --out writes them as JSON. A development
tool for the kernel's redesign, off every serving path; PERF.md's table of
K6 versions was timed by it.

--diag adds diagnostic builds of the first version, each with one part
switched off by a patch of its text or of the shared header's (they compute
garbage and say only where the time goes; written to the build directory):
no_fill (no bias + mask tile is built), no_norm (no key norms), no_mma (no
chunk: no S or P V product, no softmax), no_exp (an affine stand-in for
ex2 in the chunk), no_store (the outputs are not stored). "--diag
no_fill,no_mma" takes some of them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT

D = 32
# (resolution, heads, C, depth) of SwinV2-B's window-16 stages at 256^2
STAGES = [(64, 4, 128, 2), (32, 8, 256, 2), (16, 16, 512, 18)]


# (name, [(file, old text, new text), ...]): the diagnostic patches of
# --diag, each applied to the first occurrence in the version's source
# ("cu") or in csrc/window_attn_tile.cuh ("cuh")
DIAGS = [
    ("no_fill", [("cu", "  if (!p.sliced) fill(", "  if (false) fill(")]),
    ("no_norm", [("cu", "for (int key = t >> 2; key < p.kt; key += 32) {",
                  "for (int key = t >> 2; key < 0; key += 32) {")]),
    ("no_mma", [("cu", "for (int kc = 0; kc < nkt; kc += KCH) {",
                 "for (int kc = 0; kc < 0; kc += KCH) {")]),
    ("no_exp", [("cuh", "      const float e0 = ex2(s[4 * j] - base_a), e1 = ex2(s[4 * j + 1] - base_a);\n"
                 "      const float e2 = ex2(s[4 * j + 2] - base_b), e3 = ex2(s[4 * j + 3] - base_b);",
                 "      const float e0 = s[4 * j] - base_a, e1 = s[4 * j + 1] - base_a;\n"
                 "      const float e2 = s[4 * j + 2] - base_b, e3 = s[4 * j + 3] - base_b;")]),
    ("no_store", [("cu", "      if (row_a < N)\n        *reinterpret_cast",
                   "      if (row_a < 0)\n        *reinterpret_cast"),
                  ("cu", "      if (row_b < N)\n        *reinterpret_cast",
                   "      if (row_b < 0)\n        *reinterpret_cast")]),
]


def diag_sources(first: str, names, out_dir: str):
    """The --diag builds of source ``first``: one directory each under
    out_dir holding the patched source and header; returns their specs."""
    from deepfake_tpu_torch.kernels.build import CSRC
    header = "window_attn_tile.cuh"
    specs = []
    for name, patches in DIAGS:
        if names and name not in names:
            continue
        text = {"cu": open(first).read(), "cuh": open(os.path.join(CSRC, header)).read()}
        for where, old, new in patches:
            if old not in text[where]:
                raise SystemExit(f"--diag {name}: {where} lacks {old[:60]!r}")
            text[where] = text[where].replace(old, new, 1)
        d = os.path.join(out_dir, "diag_" + name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, os.path.basename(first)), "w") as f:
            f.write(text["cu"])
        with open(os.path.join(d, header), "w") as f:
            f.write(text["cuh"])
        specs.append("~" + os.path.join(d, os.path.basename(first)))
    return specs


def build(versions, out_dir):
    """{spec: CDLL}: a spec is source[:-D switches], with a leading ~ for a
    diagnostic build; a header beside the source comes before csrc/'s."""
    return common.nvcc([(spec, spec.lstrip("~").partition(":")[0],
                         spec.lstrip("~").partition(":")[2].split()) for spec in versions], out_dir)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+",
                    help="source[:-D switches]; a leading ~ marks a diagnostic build, timed "
                         "but not held to the plain version")
    ap.add_argument("--diag", nargs="?", const="", default=None,
                    help="add the diagnostic builds of the first version (all, or those named)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from deepfake_tpu_torch.models.swin2d import shift_attn_mask
    from deepfake_tpu_torch.ops import window_attn_multihead as k6
    from deepfake_tpu_torch.ops.window_attn import l2_normalize

    if not torch.cuda.is_available():
        raise SystemExit("k6_versions: needs an NVIDIA GPU")
    print(common.card(), flush=True)
    out_dir = os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k6bench")
    if args.diag is not None:
        args.versions += diag_sources(args.versions[0].lstrip("~").partition(":")[0],
                                      [n for n in args.diag.split(",") if n], out_dir)
    libs = build(args.versions, out_dir)
    lib_of = k6._lib
    real = lib_of()

    def use(spec):
        lib = libs[spec]
        if not getattr(lib, "_typed", False):
            for fn in ("k6_window_attn", "k6_consumers", "k6_error_string"):
                getattr(lib, fn).argtypes = getattr(real, fn).argtypes
                getattr(lib, fn).restype = getattr(real, fn).restype
            lib._typed = True
        k6._lib = lambda: lib
        k6.consumers.cache_clear()

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cases = []  # name, B_, H, C, window, mask grid side or None, cosine, launches a request
    for res, H, C, depth in STAGES:
        B_ = 8 * (res // 16) ** 2
        if res > 16:
            cases.append((f"res {res}", B_, H, C, 16, None, True, (depth + 1) // 2))
            cases.append((f"res {res} shifted", B_, H, C, 16, res, True, depth // 2))
        else:
            cases.append((f"res {res}", B_, H, C, 16, None, True, depth))
    for ws in (10, 24):
        cases.append((f"window {ws} shifted", 32, 4, 128, ws, 2 * ws, True, 0))
    cases.append(("scaled N=392", 64, 12, 384, 0, None, False, 0))
    totals = dict.fromkeys([*args.versions, "sdpa"], 0.0)
    rows = []
    for name, B_, H, C, ws, side, cosine, count in cases:
        N = ws * ws if ws else 392
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv.view(B_, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
        mask = None
        if side is not None:
            mask = torch.from_numpy(shift_attn_mask(side, side, ws, ws // 2)).to(dev)
        if cosine:
            bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=dev))
            ls = torch.exp(torch.linspace(math.log(10.0), math.log(100.0), H, device=dev))
            kw = dict(bias=bias, mask=mask, logit_scale=ls.reshape(H, 1, 1))
        else:
            bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
            kw = dict(bias=bias, mask=None, scale=D ** -0.5, cosine=False)
        want = k6.window_attention_heads_plain(q, k, v, **kw).float()
        tol = 2.0 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
        label = f"{name} [{B_},{H},{N},{D}]"
        times = {}
        for spec in args.versions + args.versions[::-1]:
            use(spec)
            got = k6.window_attention_multihead(q, k, v, **kw)
            err = (got.float() - want).abs().max().item()
            if not spec.startswith("~") and not (math.isfinite(err) and err <= tol):
                raise SystemExit(f"{spec}: {label} err {err:.3e} > {tol:.3e}")
            t = common.device_ms(lambda: k6.window_attention_multihead(q, k, v, **kw))
            times[spec] = min(times.get(spec, t), t)
        k6._lib = lib_of
        k6.consumers.cache_clear()
        hq, hk, hv = (t.contiguous() for t in (q, k, v))
        if cosine:
            hq = (l2_normalize(hq.float()) * kw["logit_scale"]).to(torch.bfloat16)
            hk = l2_normalize(hk.float()).to(torch.bfloat16)
        am = bias[None].to(torch.bfloat16)
        if mask is not None:
            nW = mask.shape[0]
            am = (am.view(1, 1, H, N, N) + mask.to(torch.bfloat16).view(1, nW, 1, N, N)).expand(
                B_ // nW, nW, H, N, N).reshape(B_, H, N, N)
        times["sdpa"] = common.device_ms(lambda: F.scaled_dot_product_attention(
            hq, hk, hv, attn_mask=am, scale=1.0 if cosine else D ** -0.5))
        del hq, hk, hv, am
        print(label, f"x{count}", " ".join(f"[{s}]={t:.4f}" for s, t in times.items()),
              flush=True)
        rows.append(dict(case=label, launches_per_request=count, device_ms=times))
        for s, t in times.items():
            totals[s] += count * t
        del qkv, q, k, v, bias
        torch.cuda.empty_cache()
    print("per audio b8 request:", " ".join(f"[{s}]={t:.4f}" for s, t in totals.items()),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, totals=totals), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
