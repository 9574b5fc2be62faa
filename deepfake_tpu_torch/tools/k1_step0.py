#!/usr/bin/env python3
"""Where does K1's time go? A diagnostic of the first K1 design (one
mma.sync shifted-GEMM launch per conv, cp.async tap gather, per-element
epilogue; the port's csrc/inception_block.cu up to commit 622cde6) on the
card.

    git show 622cde6:deepfake_tpu_torch/csrc/inception_block.cu > _checkout/k1_first.cu
    python3 deepfake_tpu_torch/tools/k1_step0.py --source _checkout/k1_first.cu [--out PATH]

Builds the source in variants (compile-time switches patched in here; the
arithmetic of each is otherwise the source's) into the ignored
deepfake_tpu_torch/_build/k1_step0/ and times every conv launch of IRv2
blocks A (25 x 25), B (12 x 12) and C (5 x 5) at b8 x 32 frames in bf16, each
launch on its own, by its device time (torch.profiler over 10 launches):
  base         as it is
  no_store     the epilogue computes every value but stores none
               (computes nothing usable)
  no_residual  the out conv adds 0 for the residual x (no x reads)
  no_pred      a tap's source row is r + oy W + ox clamped into the
               buffer, with no frame-edge test (wrong at the edges)
  bare         all three
beside the library's time for the same product: cuBLAS torch.matmul on
[R, K] x [K, n] for a 1x1 conv (the product alone, no epilogue), cuDNN
F.conv2d (channels_last, bf16, zero padding) for a tap conv. Then the IRv2
branch (stem to the final 1x1 conv, 256 frames of 224^2, bf16) by its
device time on the K1 route and on the plain route (cuDNN convs and
PyTorch glue for every block): a yardstick made of many library calls, not
one call for the same function. Prints the card's name and power limit and
one line per launch; --out writes the times as JSON. A development tool,
off every serving path; PERF.md's Step 0 table of K1 was timed by it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT

VARIANTS = {"base": [], "no_store": ["NO_STORE"], "no_residual": ["NO_RESIDUAL"],
            "no_pred": ["NO_PRED"], "bare": ["NO_STORE", "NO_RESIDUAL", "NO_PRED"]}

# (old text, new text) pairs applied to the source, once each
PATCHES = [
    ("""    v = to_f(static_cast<const T*>(g.x)[(int64_t)rr * g.ldx + nn]) + res;""",
     """#ifdef NO_RESIDUAL
    v = res;
#else
    v = to_f(static_cast<const T*>(g.x)[(int64_t)rr * g.ldx + nn]) + res;
#endif"""),
    ("""  if (nn < g.nsplit) {
    static_cast<T*>(g.out0)""",
     """#ifdef NO_STORE
  if (v != 3.0e38f) return;  // keeps the value live; no real output equals it
#endif
  if (nn < g.nsplit) {
    static_cast<T*>(g.out0)"""),
    ("""      const bool v = a_ok[i] && si >= 0 && si < g.h && sj >= 0 && sj < g.wd && kk < g.k;
      const __nv_bfloat16* src =
          v ? A + (int64_t)(row0 + a_r[i] + oy * g.wd + ox) * g.lda + kk : A;""",
     """#ifdef NO_PRED
      (void)si; (void)sj;
      const bool v = a_ok[i] && kk < g.k;
      const int sr = min(max(row0 + a_r[i] + oy * g.wd + ox, 0), g.rows - 1);
      const __nv_bfloat16* src = v ? A + (int64_t)sr * g.lda + kk : A;
#else
      const bool v = a_ok[i] && si >= 0 && si < g.h && sj >= 0 && sj < g.wd && kk < g.k;
      const __nv_bfloat16* src =
          v ? A + (int64_t)(row0 + a_r[i] + oy * g.wd + ox) * g.lda + kk : A;
#endif"""),
]


def build(source: str, out_dir: str):
    text = common.patch(open(source).read(), PATCHES,
                        "the source is not K1's mma.sync design (commit 622cde6)")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "k1_step0.cu")
    with open(src, "w") as f:
        f.write(text)
    libs = common.nvcc([(name, src, [f"-D{d}" for d in defs]) for name, defs in VARIANTS.items()],
                       out_dir)
    for dll in libs.values():
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        dll.k1_shifted_gemm.argtypes = [
            i, p, i64, i, p, i, i, i, i, i, i, i, p, p, p, i64, f, i, p, i64, i, p, i64, p]
        dll.k1_shifted_gemm.restype = i
    return libs



def conv_launches(blk, x):
    """The first design's launch sequence for one block (the wrapper's, as of
    commit 622cde6): a list of (label, kwargs of k1_shifted_gemm past the
    dtype, library call for the same product)."""
    import torch
    import torch.nn.functional as F

    Fn, H, W, C = x.shape
    R = Fn * H * W
    dev, dt = x.device, x.dtype
    xr = x.view(R, C)
    n_in, n_cat = blk.w_in.shape[1], blk.w_out.shape[0]
    cat = torch.zeros(R, n_cat, dtype=dt, device=dev)
    heads = torch.zeros(R, n_in - blk.n_direct, dtype=dt, device=dev)
    ptr = lambda t, col=0: t.data_ptr() + col * t.element_size()

    def conv(a, col, k, w, kh, kw, n, out0, out0_col=0, nsplit=None, out1=None, affine=None,
             bias=None, res=None):
        return dict(a=ptr(a, col), lda=a.shape[1], k=k, w=w.data_ptr(), kh=kh, kw=kw, rows=R,
                    h=H, wd=W, n=n, mode=0 if affine is not None else 1,
                    scale=affine[0].data_ptr() if affine is not None else None,
                    bias=affine[1].data_ptr() if affine is not None else bias.data_ptr(),
                    x=res.data_ptr() if res is not None else None,
                    ldx=res.shape[1] if res is not None else 0, res_scale=blk.res_scale,
                    relu=int(blk.relu), out0=ptr(out0, out0_col), ld0=out0.shape[1],
                    nsplit=n if nsplit is None else nsplit,
                    out1=out1.data_ptr() if out1 is not None else None,
                    ld1=out1.shape[1] if out1 is not None else 0)

    out = []
    w_in = blk.w_in
    out.append((f"in 1x1 K={C} n={n_in}",
                conv(xr, 0, C, w_in, 1, 1, n_in, cat, nsplit=blk.n_direct, out1=heads,
                     affine=blk.a_in),
                lambda: torch.matmul(xr, w_in)))
    col_in, col_out = 0, blk.n_direct
    for chain in blk.chains:
        src, src_col = heads, col_in
        col_in += chain[0].w.shape[1]
        for i, c in enumerate(chain):
            taps, cin, cout = c.w.shape
            if i == len(chain) - 1:
                dst, dst_col = cat, col_out
            else:
                dst, dst_col = torch.zeros(R, cout, dtype=dt, device=dev), 0
            inp = torch.randn(Fn, cin, H, W, device=dev).to(dt).contiguous(
                memory_format=torch.channels_last)
            wt = c.w.reshape(c.kh, c.kw, cin, cout).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            out.append((f"{c.kh}x{c.kw} K={cin} n={cout}",
                        conv(src, src_col, cin, c.w, c.kh, c.kw, cout, dst, dst_col,
                             affine=c.affine),
                        lambda inp=inp, wt=wt, p=(c.kh // 2, c.kw // 2):
                            F.conv2d(inp, wt, padding=p)))
            src, src_col = dst, dst_col
        col_out += chain[-1].w.shape[2]
    res_out = torch.zeros_like(xr)
    w_out = blk.w_out
    out.append((f"out 1x1 K={n_cat} n={C}",
                conv(cat, 0, n_cat, w_out, 1, 1, C, res_out, bias=blk.b_out, res=xr),
                lambda: torch.matmul(cat, w_out)))
    return out, (cat, heads, res_out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True,
                    help="csrc/inception_block.cu as of commit 622cde6")
    ap.add_argument("--out", default=None, help="write the times as JSON here")
    ap.add_argument("--frames", type=int, default=8 * 32)
    args = ap.parse_args()

    import torch

    from deepfake_tpu_torch.models import inception_resnet_v2 as irv2
    from deepfake_tpu_torch.models.layers import BatchNorm, init_weights
    from deepfake_tpu_torch.models.registry import pack_block_weights

    if not torch.cuda.is_available():
        raise SystemExit("k1_step0: needs an NVIDIA GPU")
    card = common.card()
    print(card, flush=True)
    libs = build(args.source, os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k1_step0"))
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    dt = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream

    def randomize(model):
        init_weights(model.to(dev), gen)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    n = m.weight.numel()
                    m.running_mean.copy_(0.1 * torch.randn(n, generator=gen, device=dev))
                    m.running_var.copy_(0.5 + torch.rand(n, generator=gen, device=dev))
        return model.eval()

    res = {"card": card, "launches": [], "branch": {}}
    for name, block, side in (("A", irv2.BlockA(0.17, True), 25),
                              ("B", irv2.BlockB(0.10, True), 12),
                              ("C", irv2.BlockC(0.20, True, True), 5)):
        blk = randomize(block).pack_weights(dt)
        C = block.conv.out_channels
        x = (0.5 * torch.randn(args.frames, side, side, C, generator=gen, device=dev)).to(dt)
        convs, keep = conv_launches(blk, x)
        for label, kw, lib_call in convs:
            def call(v, kw=kw):
                status = libs[v].k1_shifted_gemm(1, *kw.values(), stream)
                if status:
                    raise SystemExit(f"{v}: launch failed: CUDA error {status}")
            row = {"block": name, "conv": label}
            for v in VARIANTS:
                row[v] = common.device_ms(lambda v=v: call(v))
            row["library"] = common.device_ms(lib_call)
            res["launches"].append(row)
            print(f"block {name} [{args.frames}x{side}x{side}x{C}] {label:22s} "
                  + " ".join(f"{k}={row[k]:.4f}" for k in list(VARIANTS) + ["library"]),
                  flush=True)
        del x, convs, keep
        torch.cuda.empty_cache()

    # the IRv2 branch on both routes, the same weights
    model = randomize(irv2.InceptionResNetV2(fused_blocks=True)).to(dt)
    pack_block_weights(model, dt)
    frames = (torch.rand(args.frames, 224, 224, 3, generator=gen, device=dev) - 0.5).to(dt)
    with torch.inference_mode():
        res["branch"]["k1_route_device_ms"] = common.device_ms(lambda: model(frames), iters=3)
        for b in model.blocks():
            b.fused = False
        res["branch"]["plain_route_device_ms"] = common.device_ms(lambda: model(frames), iters=3)
    print(f"IRv2 branch, {args.frames} frames of 224^2, device ms: K1 route "
          f"{res['branch']['k1_route_device_ms']:.3f}, plain (cuDNN) route "
          f"{res['branch']['plain_route_device_ms']:.3f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
