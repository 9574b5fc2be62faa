#!/usr/bin/env python3
"""K5's bf16 forward (csrc/window_attn3d_train.cu, the body in
csrc/window_attn_tile.cuh) in versions side by side on the card: each
version is a source file, with optional -D switches, built into the ignored
deepfake_tpu_torch/_build/k5fbench/ and called through the package's own
wrapper (ops/window_attn3d_train.py). A header beside the source file takes
the place of csrc/'s of that name (so a version of the shared body is a
directory holding both files).

    python3 deepfake_tpu_torch/tools/k5f_versions.py \\
        deepfake_tpu_torch/csrc/window_attn3d_train.cu \\
        "_checkout/v2/window_attn3d_train.cu:-DFOO" [--out PATH]

At each Video Swin-S stage shape of a b8 training micro-batch (32 frames of
224, window (8,7,7), N = 392), shifted and not, every version's output is
held against the plain version (two bf16 ulps of the largest |output|) and
its forward launch timed by device time (torch.profiler over 10 launches),
in turns (every version, then again in reverse order; the min is kept),
beside SDPA's forward with bias + mask as attn_mask. A leading ~ marks a
diagnostic build, timed but not held to the plain version. Prints the
card's name and power limit, the ptxas report, one line per shape and the
totals per micro-batch (the 24 blocks' launches); --out writes them as
JSON. A development tool for the kernel's redesign, off every training
path; PERF.md's table of K5 forward versions was timed by it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT

N, D = 392, 32
STAGES = [((16, 56, 56), 3, 96, 2), ((16, 28, 28), 6, 192, 2),
          ((16, 14, 14), 12, 384, 18), ((16, 7, 7), 24, 768, 2)]


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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size
    from deepfake_tpu_torch.ops import window_attn3d_train as k5

    if not torch.cuda.is_available():
        raise SystemExit("k5f_versions: needs an NVIDIA GPU")
    print(common.card(), flush=True)
    libs = build(args.versions, os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k5fbench"))
    lib_of = k5._lib
    real = lib_of()

    def use(spec):
        lib = libs[spec]
        if not getattr(lib, "_typed", False):
            for fn in ("k5_fwd", "k5_bwd", "k5_stats_stride", "k5_error_string"):
                getattr(lib, fn).argtypes = getattr(real, fn).argtypes
                getattr(lib, fn).restype = getattr(real, fn).restype
            lib._typed = True
        k5._lib = lambda: lib

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    totals = dict.fromkeys([*args.versions, "sdpa"], 0.0)
    rows = []
    for grid, H, C, depth in STAGES:
        ws, ss = get_window_size(grid, (8, 7, 7), (4, 3, 3))
        nW = math.prod(n // w for n, w in zip(grid, ws))
        B_ = 8 * nW
        mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        for mask, count in ((None, (depth + 1) // 2), (mask3, depth // 2)):
            kw = dict(num_heads=H, bias=bias, mask=mask, scale=D ** -0.5)
            want = k5.window_attn3d_train_fwd_plain(q, k, v, **kw).float()
            tol = 2.0 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
            name = f"stage {grid} B_={B_} H={H}" + (" shifted" if mask is not None else "")
            times = {}
            for spec in args.versions + args.versions[::-1]:
                use(spec)
                got = k5.window_attn3d_train_fwd(qkv, **kw)
                err = (got.float() - want).abs().max().item()
                if not spec.startswith("~") and not (math.isfinite(err) and err <= tol):
                    raise SystemExit(f"{spec}: {name} err {err:.3e} > {tol:.3e}")
                t = common.device_ms(lambda: k5.window_attn3d_train_fwd(qkv, **kw))
                times[spec] = min(times.get(spec, t), t)
            k5._lib = lib_of
            hq, hk, hv = (t.reshape(B_, N, H, D).transpose(1, 2).contiguous() for t in (q, k, v))
            am = bias[None].to(torch.bfloat16)
            if mask is not None:
                am = (am.view(1, 1, H, N, N) + mask.view(1, nW, 1, N, N)).expand(
                    8, nW, H, N, N).reshape(B_, H, N, N)
            times["sdpa"] = common.device_ms(lambda: F.scaled_dot_product_attention(
                hq, hk, hv, attn_mask=am, scale=D ** -0.5))
            del hq, hk, hv, am
            print(name, f"x{count}", " ".join(f"[{s}]={t:.4f}" for s, t in times.items()),
                  flush=True)
            rows.append(dict(case=name, launches_per_microbatch=count, device_ms=times))
            for s, t in times.items():
                totals[s] += count * t
        del qkv, bias, q, k, v
        torch.cuda.empty_cache()
    print("per b8 micro-batch:", " ".join(f"[{s}]={t:.4f}" for s, t in totals.items()), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, totals=totals), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
