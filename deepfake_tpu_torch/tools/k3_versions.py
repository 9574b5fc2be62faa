#!/usr/bin/env python3
"""K3 (csrc/window_attn3d.cu) in versions side by side on the card: each
version is a source file, with optional -D switches, built into the ignored
deepfake_tpu_torch/_build/k3bench/ and called through the package's own
wrapper (ops/window_attn3d_kernel.py).

    python3 deepfake_tpu_torch/tools/k3_versions.py deepfake_tpu_torch/csrc/window_attn3d.cu \\
        _checkout/k3_other.cu "deepfake_tpu_torch/csrc/window_attn3d.cu:-DFOO -DBAR"

At each Video Swin-S stage shape of a b8 and a b1 request (32 frames of
224, window (8,7,7), N = 392), shifted and not, every version is held
against the plain version (two bf16 ulps of the largest output) and timed
with CUDA events over 10 launches, in turns (every version, then again in
reverse order; the min is kept); SDPA with bias + mask as attn_mask is
timed beside them. Prints the card's name and power limit, one line per
launch and the totals per request (the 24 blocks' launches); --out writes
them as JSON. A development tool for the kernel's redesigns, off every
serving and training path; PERF.md's table of K3 versions was timed by it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT
sys.path.insert(0, os.path.join(ROOT, "deepfake_tpu_torch", "csrc"))

N = 392
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
                    help="source[:-D switches]; a leading ~ marks a diagnostic build, "
                         "timed but not held to the plain version")
    ap.add_argument("--batches", default="8,1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size
    from deepfake_tpu_torch.ops import window_attn3d_kernel as k3

    if not torch.cuda.is_available():
        raise SystemExit("k3_versions: needs an NVIDIA GPU")
    print(common.card(), flush=True)
    libs = build(args.versions, os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k3bench"))
    lib_of = k3._lib

    def use(spec):
        k3._lib = lambda lib=libs[spec]: _typed(lib, lib_of)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def timed(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    totals = {b: {v: 0.0 for v in [*args.versions, "sdpa"]} for b in map(int, args.batches.split(","))}
    rows = []
    for b_req in totals:
        for grid, H, C, depth in STAGES:
            ws, ss = get_window_size(grid, (8, 7, 7), (4, 3, 3))
            nW = math.prod(n // w for n, w in zip(grid, ws))
            B_ = b_req * nW
            mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
            qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
            bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            for mask, count in ((None, (depth + 1) // 2), (mask3, depth // 2)):
                kw = dict(num_heads=H, bias=bias, mask=mask, scale=(C // H) ** -0.5)
                want = k3.window_attn3d_tokens_plain(q, k, v, **kw).float()
                tol = 2.0 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
                times = {}
                for spec in args.versions + args.versions[::-1]:
                    use(spec)
                    got = k3.window_attn3d_tokens(q, k, v, **kw)
                    err = (got.float() - want).abs().max().item()
                    if not spec.startswith("~") and not (math.isfinite(err) and err <= tol):
                        raise SystemExit(f"{spec}: b{b_req} {grid} err {err:.3e} > {tol:.3e}")
                    t = timed(lambda: k3.window_attn3d_tokens(q, k, v, **kw))
                    times[spec] = min(times.get(spec, t), t)
                hq, hk, hv = (t.reshape(B_, N, H, C // H).transpose(1, 2).contiguous()
                              for t in (q, k, v))
                am = bias[None].to(torch.bfloat16)
                if mask is not None:
                    am = (am.view(1, 1, H, N, N) + mask.view(1, nW, 1, N, N)).expand(
                        b_req, nW, H, N, N).reshape(B_, H, N, N)
                times["sdpa"] = timed(lambda: F.scaled_dot_product_attention(
                    hq, hk, hv, attn_mask=am, scale=kw["scale"]))
                del hq, hk, hv, am
                name = f"b{b_req} stage {grid} B_={B_} H={H}" + (" shifted" if mask is not None else "")
                print(name, " ".join(f"[{s}]={t:.4f}" for s, t in times.items()), flush=True)
                rows.append(dict(case=name, blocks_per_request=count, ms=times))
                for s, t in times.items():
                    totals[b_req][s] += count * t
            del qkv, bias, q, k, v
            torch.cuda.empty_cache()
    for b_req, tot in totals.items():
        print(f"per b{b_req} request:", " ".join(f"[{s}]={t:.4f}" for s, t in tot.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, totals=totals), f, indent=1)
    return 0


def _typed(lib, lib_of):
    """lib with the argument types the package's _lib() sets."""
    if not getattr(lib, "_typed", False):
        real = lib_of()
        for fn in ("k3_window_attn", "k3_windows_per_block", "k3_error_string"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        lib._typed = True
    return lib


if __name__ == "__main__":
    sys.exit(main())
