#!/usr/bin/env python3
"""Where does K6 spend its time on an audio request? A diagnostic of the
mma.sync design of K6's bf16 route (tc::attn_bf16: one block per (window,
128-row slab, head), the f32 bias and f32 mask read from device memory a
step ahead in the inner loop, K held twice as bf16 hi and lo; the port's
csrc/window_attn_multihead.cu up to commit c0f8c3f) on the card.

    git show c0f8c3f:deepfake_tpu_torch/csrc/window_attn_multihead.cu > _checkout/k6_first.cu
    python3 deepfake_tpu_torch/tools/k6_step0.py --source _checkout/k6_first.cu [--out PATH]

Builds the source in variants (compile-time switches patched in here; the
arithmetic of each is otherwise the source's; all but base compute wrong
numbers) into the ignored deepfake_tpu_torch/_build/k6_step0/:
  base      as it is
  no_bias   the bias loads of the inner loop gone (the bias read as 0)
  no_mask   the mask pointer null at compile time (no mask loads, no code)
  no_bm     both
  no_exp    an affine stand-in for __expf (the exponentials' cost gone)
  no_store  the output stores skipped at run time (a condition that never
            holds, so the arithmetic before them stays)
  no_lo     the two lo products of the cosine split (hi.lo, lo.hi) left out
and times each launch at the three window-16 stage shapes of SwinV2-B at
256^2 in an audio b8 request (shifted and not), and at window 24 (N = 576,
off the main path), by device time per launch (torch.profiler over 10
launches), in turns (every variant, then again in reverse order; the min is
kept), beside SDPA with bias + mask as attn_mask: on q^ s and k^ normalised
outside the timed call (sdpa), and with that normalisation inside it
(sdpa_norm), as K6 does it. q, k and v are head-major views of one
token-major qkv tensor and the output a head-major view of a token-major
tensor, as SwinV2 calls K6. Prints the card's name and power limit, one line
per shape and the sums per request (the 22 blocks' launches); --out writes
them as JSON. A development tool, off every serving path; PERF.md's Step 0
table of K6 was timed by it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT

D = 32
# (resolution, heads, C, depth) of SwinV2-B's window-16 stages at 256^2
STAGES = [(64, 4, 128, 2), (32, 8, 256, 2), (16, 16, 512, 18)]
VARIANTS = {"base": [], "no_bias": ["NO_BIAS"], "no_mask": ["NO_MASK"],
            "no_bm": ["NO_BIAS", "NO_MASK"], "no_exp": ["NO_EXP"], "no_store": ["NO_STORE"],
            "no_lo": ["NO_LO"]}

# (old text, new text) pairs applied to the source, in order; "__expf(" is
# replaced everywhere (only the tensor-core kernel calls it)
PATCHES = [
    ("__expf(", "EXPF(", "all"),
    ("namespace {\n", """namespace {
#if defined(NO_EXP)
#define EXPF(x) ((x) * 0.01f + 1.f)
#else
#define EXPF __expf
#endif
"""),
    ("""    const float4 b = *reinterpret_cast<const float4*>(brow + k4);
    a[0] = b.x; a[1] = b.y; a[2] = b.z; a[3] = b.w;""",
     """#ifdef NO_BIAS
    a[0] = a[1] = a[2] = a[3] = 0.f;
#else
    const float4 b = *reinterpret_cast<const float4*>(brow + k4);
    a[0] = b.x; a[1] = b.y; a[2] = b.z; a[3] = b.w;
#endif"""),
    ("    a[i] = ok ? brow[k4 + i] + (mrow ? mrow[k4 + i] : 0.f) : -INFINITY;",
     """#ifdef NO_BIAS
    a[i] = ok ? (mrow ? mrow[k4 + i] : 0.f) : -INFINITY;
#else
    a[i] = ok ? brow[k4 + i] + (mrow ? mrow[k4 + i] : 0.f) : -INFINITY;
#endif"""),
    ("""  const float* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  const bool vec = N % 4 == 0;""",
     """#ifdef NO_MASK
  const float* mask = nullptr;
#else
  const float* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
#endif
  const bool vec = N % 4 == 0;"""),
    ("""            mma_bf16(s[nt8], ql[st], bh);
            mma_bf16(s[nt8], qa[st], bl);""",
     """#ifndef NO_LO
            mma_bf16(s[nt8], ql[st], bh);
            mma_bf16(s[nt8], qa[st], bl);
#endif"""),
    ("""  const float sa = quad_sum(sum_a), sb = quad_sum(sum_b);
  bf16* O""",
     """  const float sa = quad_sum(sum_a), sb = quad_sum(sum_b);
#ifdef NO_STORE
  if (sa > 0.f || sb > 0.f) return;
#endif
  bf16* O"""),
]


def build(source: str, out_dir: str):
    text = common.patch(open(source).read(), PATCHES,
                        "the source is not K6's mma.sync design (commit c0f8c3f)")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "k6_step0.cu")
    with open(src, "w") as f:
        f.write(text)
    libs = common.nvcc([(name, src, [f"-D{d}" for d in defs]) for name, defs in VARIANTS.items()],
                       out_dir)
    for dll in libs.values():
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        dll.k6_window_attn.argtypes = [i, i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, i,
                                       p, i, i, i, i, p]
        dll.k6_window_attn.restype = i
    return libs



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True,
                    help="csrc/window_attn_multihead.cu as of commit c0f8c3f")
    ap.add_argument("--out", default=None, help="write the times as JSON here")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from deepfake_tpu_torch.models.swin2d import shift_attn_mask
    from deepfake_tpu_torch.ops.window_attn import l2_normalize

    if not torch.cuda.is_available():
        raise SystemExit("k6_step0: needs an NVIDIA GPU")
    print(common.card(), flush=True)
    libs = build(args.source, os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k6_step0"))
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cases = []  # name, B_, H, C, window, shifted, launches per request
    for res, H, C, depth in STAGES:
        if res > 16:
            cases.append((f"res {res}", 8 * (res // 16) ** 2, H, C, 16, False, (depth + 1) // 2))
            cases.append((f"res {res} shifted", 8 * (res // 16) ** 2, H, C, 16, True, depth // 2))
        else:
            cases.append((f"res {res}", 8, H, C, 16, False, depth))
    cases.append(("window 24 shifted", 32, 4, 128, 24, True, 0))
    names = [*VARIANTS, "sdpa", "sdpa_norm"]
    totals = dict.fromkeys(names, 0.0)
    rows = []
    for name, B_, H, C, ws, shifted, count in cases:
        N = ws * ws
        mask = None
        if shifted:
            side = ws * int(math.isqrt(B_ // 8))
            mask = torch.from_numpy(shift_attn_mask(side, side, ws, ws // 2)).to(dev)
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv.view(B_, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
        bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=dev))
        ls = torch.exp(torch.linspace(math.log(10.0), math.log(100.0), H, device=dev))
        out = torch.empty(B_, N, H, D, device=dev, dtype=torch.bfloat16).transpose(1, 2)

        def call(lib):
            status = lib.k6_window_attn(
                1, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], out.data_ptr(),
                *out.stride()[:3], bias.data_ptr(), None if mask is None else mask.data_ptr(),
                1 if mask is None else mask.shape[0], ls.data_ptr(), B_, H, N, D,
                torch.cuda.current_stream().cuda_stream)
            if status:
                raise SystemExit(f"launch failed: CUDA error {status}")
        times = {}
        for var in list(VARIANTS) + list(VARIANTS)[::-1]:
            t = common.device_ms(lambda: call(libs[var]))
            times[var] = min(times.get(var, t), t)
        am = bias[None].to(torch.bfloat16)
        if mask is not None:
            nW = mask.shape[0]
            am = (am.view(1, 1, H, N, N) + mask.to(torch.bfloat16).view(1, nW, 1, N, N)).expand(
                B_ // nW, nW, H, N, N).reshape(B_, H, N, N)
        hv = v.contiguous()
        norm = lambda: ((l2_normalize(q.float()) * ls.view(H, 1, 1)).to(torch.bfloat16),
                        l2_normalize(k.float()).to(torch.bfloat16))
        hq, hk = norm()
        times["sdpa"] = common.device_ms(lambda: F.scaled_dot_product_attention(
            hq, hk, hv, attn_mask=am, scale=1.0))
        times["sdpa_norm"] = common.device_ms(lambda: F.scaled_dot_product_attention(
            *norm(), hv, attn_mask=am, scale=1.0))
        del hq, hk, hv, am
        label = f"{name} [{B_},{H},{N},{D}]"
        print(label, f"x{count}", " ".join(f"{k_}={v_:.4f}" for k_, v_ in times.items()),
              flush=True)
        rows.append(dict(case=label, launches_per_request=count, device_ms=times))
        for k_, v_ in times.items():
            totals[k_] += count * v_
        del qkv, q, k, v, bias, out
        torch.cuda.empty_cache()
    print("per audio b8 request:", " ".join(f"{k_}={v_:.4f}" for k_, v_ in totals.items()),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, totals=totals), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
