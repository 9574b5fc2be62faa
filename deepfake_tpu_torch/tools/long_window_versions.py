#!/usr/bin/env python3
"""K3 and K5 (forward and backward) at windows of more than 512 tokens, in
source versions side by side on the card.

    python3 deepfake_tpu_torch/tools/long_window_versions.py \\
        VERSION [VERSION ...] [--out PATH]

A VERSION is NAME=DIR, a directory that holds a version of csrc/
(window_attn3d.cu, window_attn3d_train.cu and the headers they include; DIR
"tree" is the checkout's csrc/), or the name of a patch of csrc/ below
(PATCHES): "slice" (the forward's per-chunk slices filled by the threads
also where N % 8 == 0, the first streamed design), and the diagnostic builds
"diag_no_atomic" (the streamed backward adds no dS into its slot) and "diag_no_fill"
(the backward builds no bias + mask tile), which compute garbage and are
timed, not checked. Each is built into the ignored
deepfake_tpu_torch/_build/longwin/ and called through the package's own
wrappers. At each stage of a Video Swin-B b8 request or
training micro-batch at its (16,7,7) window (N = 784; heads 4/8/16/32, C =
128-1024), shifted and not, every version's K3 output and K5 out, dq, dk,
dv and dbias are held against the plain versions (two bf16 ulps of the
largest |value|; dbias 1e-2), then each launch's device time
(torch.profiler, 10 calls) is taken in turns (every version, then again in
reverse order; the min is kept), SDPA's forward beside them. Prints the
card's name and power limit, one line per shape and the totals a request
(K3) or micro-batch (K5, the 24 blocks' calls). A development tool, off
every serving and training path.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT

# (name, file, [(old text, new text), ...]): each old text occurs once
PATCHES = {
    "slice": [("window_attn_tile.cuh", "    p.tma = n % 8 == 0;", "    p.tma = 0;")],
    "diag_no_atomic": [("window_attn3d_train.cu", "          if (key < n) atomicAdd(",
                        "          if (key < -1) atomicAdd(")],
    "diag_no_fill": [
        ("window_attn3d_train.cu",
         "    fill_rows(tile, bias, mask, q0, k0, N, p.bpitch, threadIdx.x, CT);\n", ""),
        ("window_attn3d_train.cu",
         "    fill_cols(tile, bias, mask, k0, qo, N, p.bpitch, threadIdx.x, CT);\n", "")],
}
STAGES = [((16, 56, 56), 4, 128, 2), ((16, 28, 28), 8, 256, 2), ((16, 14, 14), 16, 512, 18),
          ((16, 7, 7), 32, 1024, 2)]
WINDOW, N = (16, 7, 7), 784


def patched(name: str, out_dir: str) -> str:
    """A copy of csrc/ with the patch ``name`` applied; returns its path."""
    from deepfake_tpu_torch.kernels import build as kb

    dst = os.path.join(out_dir, "src-" + name)
    shutil.copytree(kb.CSRC, dst)
    for fname, old, new in PATCHES[name]:
        path = os.path.join(dst, fname)
        with open(path) as f:
            text = common.patch(f.read(), [(old, new)], f"patch {name} of {fname}")
        with open(path, "w") as f:
            f.write(text)
    return dst


def build(name: str, src: str, out_dir: str):
    """{source name: CDLL} of one version."""
    libs = common.nvcc([(f"{lib}-{name}", os.path.join(src, lib + ".cu"), [])
                        for lib in ("window_attn3d", "window_attn3d_train")], out_dir, show=())
    return {key.rsplit("-" + name, 1)[0]: lib for key, lib in libs.items()}


def use(libs):
    """Route the wrappers to one version's libraries."""
    from deepfake_tpu_torch.kernels import build as kb
    from deepfake_tpu_torch.ops import window_attn3d_kernel as k3, window_attn3d_train as k5

    for lib in libs.values():
        lib._typed = False
    kb._LIBS.update(libs)
    k3._lib()
    k5._lib()


def tol(want, dbias=False):
    big = want.float().abs().max().item()
    return 1e-2 * big if dbias else 2.0 * 2.0 ** (math.floor(math.log2(big)) - 7)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("versions", nargs="+", help="NAME=DIR (DIR 'tree': csrc/) or a patch name")
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size
    from deepfake_tpu_torch.ops import window_attn3d_kernel as k3, window_attn3d_train as k5

    smi = common.card()
    print(smi, flush=True)
    out_dir = os.path.join(ROOT, "deepfake_tpu_torch", "_build", "longwin")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    versions = {}
    for spec in args.versions:
        if "=" in spec:
            name, src = spec.split("=", 1)
            src = os.path.join(ROOT, "deepfake_tpu_torch", "csrc") if src == "tree" else src
        else:
            name, src = spec, patched(spec, out_dir)
        versions[name] = build(name, src, out_dir)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    totals = {v: {"k3": 0.0, "k5_fwd": 0.0, "k5_bwd": 0.0, "bwd_launch1": 0.0,
                  "bwd_launch2": 0.0} for v in versions}
    totals["sdpa"] = {"k3": 0.0, "k5_fwd": 0.0, "k5_bwd": 0.0}
    rows = []
    for grid, H, C, depth in STAGES:
        ws, ss = get_window_size(grid, WINDOW, tuple(w // 2 for w in WINDOW))
        nW = math.prod(n // w for n, w in zip(grid, ws))
        B_ = 8 * nW
        mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
        for mask, count in ((None, (depth + 1) // 2), (mask3, depth // 2)):
            if count == 0:
                continue
            qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
            dout = torch.randn(B_, N, C, generator=gen, device=dev).to(torch.bfloat16)
            bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            kw = dict(num_heads=H, bias=bias, mask=mask, scale=(C // H) ** -0.5)
            want3 = k3.window_attn3d_tokens_plain(q, k, v, **kw)
            want5 = [k5.window_attn3d_train_fwd_plain(q, k, v, **kw),
                     *k5.window_attn3d_train_bwd_plain(q, k, v, dout, **kw)]
            calls = {"k3": lambda: k3.window_attn3d_tokens(q, k, v, **kw),
                     "k5_fwd": lambda: k5.window_attn3d_train_fwd(qkv, **kw),
                     "k5_bwd": lambda: k5.window_attn3d_train_bwd(qkv, dout, **kw)}
            for name, libs in versions.items():
                if name.startswith("diag"):
                    continue  # a diagnostic build computes garbage
                use(libs)
                got3 = calls["k3"]()
                out = calls["k5_fwd"]()
                dqkv, dbias = calls["k5_bwd"]()
                torch.cuda.synchronize()
                checks = [("k3", got3, want3, False)] + [
                    (n_, a, b, n_ == "dbias") for n_, a, b in zip(
                        ("out", "dq", "dk", "dv", "dbias"), (out, *dqkv.split(C, -1), dbias),
                        want5)]
                for n_, a, b, db in checks:
                    err = (a.float() - b.float()).abs().max().item()
                    if not (math.isfinite(err) and err <= tol(b, db)):
                        raise SystemExit(f"{name}: {n_} at {grid} H={H}: err {err:.3e}")
            times = {name: {} for name in versions}
            for order in (list(versions), list(reversed(versions))):
                for name in order:
                    use(versions[name])
                    for key, fn in calls.items():
                        try:
                            t = common.device_ms(fn)
                        except RuntimeError as e:
                            raise SystemExit(f"{name}: {key} at {grid} H={H}: {e}")
                        times[name][key] = min(times[name].get(key, t), t)
                    for key, part in (("bwd_launch1", "hop::dq_"), ("bwd_launch2", "hop::dkdv_")):
                        t = common.device_ms(calls["k5_bwd"], part=part)
                        times[name][key] = min(times[name].get(key, t), t)
            hq, hk, hv = (t.reshape(B_, N, H, C // H).transpose(1, 2).contiguous()
                          .requires_grad_() for t in (q, k, v))
            am = bias[None].to(torch.bfloat16).expand(B_, H, N, N)
            if mask is not None:
                am = (bias.to(torch.bfloat16).view(1, 1, H, N, N)
                      + mask.view(1, nW, 1, N, N)).expand(B_ // nW, nW, H, N, N)
            am = am.reshape(B_, H, N, N).contiguous().requires_grad_()
            sdpa = lambda: F.scaled_dot_product_attention(hq, hk, hv, attn_mask=am,
                                                          scale=kw["scale"])
            o = sdpa()
            do_h = dout.reshape(B_, N, H, C // H).transpose(1, 2).contiguous()
            s_f = common.device_ms(sdpa)
            s_b = common.device_ms(lambda: torch.autograd.grad(o, (hq, hk, hv, am), do_h,
                                                        retain_graph=True))
            times["sdpa"] = {"k3": s_f, "k5_fwd": s_f, "k5_bwd": s_b}
            label = f"{grid} B_={B_} H={H}" + (" shifted" if mask is not None else "")
            print(f"{label:34s} x{count:2d} " + "  ".join(
                f"{name}: k3 {t['k3']:.3f} fwd {t['k5_fwd']:.3f} bwd {t['k5_bwd']:.3f}"
                + (f" ({t['bwd_launch1']:.3f} + {t['bwd_launch2']:.3f})" if name != "sdpa" else "")
                for name, t in times.items()), flush=True)
            rows.append(dict(shape=label, count=count, ms=times))
            for name, t in times.items():
                for key, val in t.items():
                    totals[name][key] += count * val
            del qkv, dout, bias, hq, hk, hv, am, o, do_h, want3, want5
            torch.cuda.empty_cache()
    for name, t in totals.items():
        split = (f" (launch 1 {t['bwd_launch1']:.3f}, launch 2 {t['bwd_launch2']:.3f})"
                 if name != "sdpa" else "")
        print(f"per b8 request / micro-batch, device ms: {name}: K3 {t['k3']:.3f}, K5 forward "
              f"{t['k5_fwd']:.3f}, K5 backward {t['k5_bwd']:.3f}{split}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, rows=rows, totals=totals), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
