#!/usr/bin/env python3
"""Where does K5's forward spend its time? A diagnostic of the mma.sync
design of K5's bf16 forward (tc::fwd_bf16: one block per (window, head),
the f32 bias and bf16 mask read from device memory a step ahead in the inner
loop; the port's csrc/window_attn3d_train.cu up to commit c0f8c3f) on the
card.

    git show c0f8c3f:deepfake_tpu_torch/csrc/window_attn3d_train.cu > _checkout/k5_first.cu
    python3 deepfake_tpu_torch/tools/k5f_step0.py --source _checkout/k5_first.cu [--out PATH]

Builds the source in variants (compile-time switches patched in here; the
arithmetic of each is otherwise the source's; all but base compute wrong
numbers) into the ignored deepfake_tpu_torch/_build/k5f_step0/:
  base      as it is
  no_bias   the bias loads of the inner loop gone (the bias read as 0)
  no_mask   the mask pointer null at compile time (no mask loads, no code)
  no_bm     both
  no_exp    an affine stand-in for __expf (the exponentials' cost gone)
  no_store  the output stores skipped at run time (a condition that never
            holds, so the arithmetic before them stays)
and times the forward's launch at the four Video Swin-S stage shapes of a
b8 training micro-batch (32 frames of 224, window (8,7,7), N = 392),
shifted and not, by device time per launch (torch.profiler over 10
launches), in turns (every variant, then again in reverse order; the min is
kept), beside SDPA's forward with bias + mask as attn_mask. Prints the
card's name and power limit, one line per shape and the sums per
micro-batch (the 24 blocks' launches); --out writes them as JSON. A
development tool, off every training path; PERF.md's Step 0 table of K5's
forward was timed by it.
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

N, D = 392, 32
STAGES = [((16, 56, 56), 3, 96, 2), ((16, 28, 28), 6, 192, 2),
          ((16, 14, 14), 12, 384, 18), ((16, 7, 7), 24, 768, 2)]
VARIANTS = {"base": [], "no_bias": ["NO_BIAS"], "no_mask": ["NO_MASK"],
            "no_bm": ["NO_BIAS", "NO_MASK"], "no_exp": ["NO_EXP"], "no_store": ["NO_STORE"]}

# (old text, new text) pairs applied to the source, in order; "__expf(" is
# replaced everywhere (only the tensor-core forward calls it)
PATCHES = [
    ("__expf(", "EXPF(", "all"),
    ("namespace {\n", """namespace {
#if defined(NO_EXP)
#define EXPF(x) ((x) * 0.01f + 1.f)
#else
#define EXPF __expf
#endif
"""),
    ("""    const float4 v = *reinterpret_cast<const float4*>(brow + k4);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;""",
     """#ifdef NO_BIAS
    b[0] = b[1] = b[2] = b[3] = 0.f;
#else
    const float4 v = *reinterpret_cast<const float4*>(brow + k4);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
#endif"""),
    ("    b[i] = ok ? brow[k4 + i] : -INFINITY;",
     """#ifdef NO_BIAS
    b[i] = ok ? 0.f : -INFINITY;
#else
    b[i] = ok ? brow[k4 + i] : -INFINITY;
#endif"""),
    ("""  const bf16* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  const bool vec = N % 4 == 0;""",
     """#ifdef NO_MASK
  const bf16* mask = nullptr;
#else
  const bf16* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
#endif
  const bool vec = N % 4 == 0;"""),
    ("""    const float ra = 1.f / quad_sum(sum_a), rb = 1.f / quad_sum(sum_b);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {""",
     """    const float ra = 1.f / quad_sum(sum_a), rb = 1.f / quad_sum(sum_b);
#ifdef NO_STORE
    if (ra < 0.f && rb < 0.f)
#endif
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {"""),
]


def build(source: str, out_dir: str):
    text = common.patch(open(source).read(), PATCHES,
                        "the source is not K5's mma.sync forward (commit c0f8c3f)")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "k5f_step0.cu")
    with open(src, "w") as f:
        f.write(text)
    libs = common.nvcc([(name, src, [f"-D{d}" for d in defs]) for name, defs in VARIANTS.items()],
                       out_dir)
    for dll in libs.values():
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        dll.k5_fwd.argtypes = [i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, i,
                               ctypes.c_float, i, i, i, i, p]
        dll.k5_fwd.restype = i
    return libs



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True,
                    help="csrc/window_attn3d_train.cu as of commit c0f8c3f")
    ap.add_argument("--out", default=None, help="write the times as JSON here")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size

    if not torch.cuda.is_available():
        raise SystemExit("k5f_step0: needs an NVIDIA GPU")
    print(common.card(), flush=True)
    libs = build(args.source, os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k5f_step0"))
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    names = [*VARIANTS, "sdpa"]
    totals = dict.fromkeys(names, 0.0)
    rows = []
    for grid, H, C, depth in STAGES:
        ws, ss = get_window_size(grid, (8, 7, 7), (4, 3, 3))
        nW = math.prod(n // w for n, w in zip(grid, ws))
        B_ = 8 * nW
        mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
        out = torch.empty(B_, N, C, device=dev, dtype=torch.bfloat16)
        for mask, count in ((None, (depth + 1) // 2), (mask3, depth // 2)):
            def call(lib):
                status = lib.k5_fwd(
                    1, qkv.data_ptr(), qkv.data_ptr() + 2 * C, qkv.data_ptr() + 4 * C,
                    N * 3 * C, D, 3 * C, out.data_ptr(), N * C, D, C, bias.data_ptr(),
                    None if mask is None else mask.data_ptr(), nW, D ** -0.5, B_, H, N, D,
                    torch.cuda.current_stream().cuda_stream)
                if status:
                    raise SystemExit(f"launch failed: CUDA error {status}")
            times = {}
            for name in list(VARIANTS) + list(VARIANTS)[::-1]:
                t = common.device_ms(lambda: call(libs[name]))
                times[name] = min(times.get(name, t), t)
            hq, hk, hv = (t.reshape(B_, N, H, D).transpose(1, 2).contiguous()
                          for t in qkv.split(C, dim=-1))
            am = bias[None].to(torch.bfloat16)
            if mask is not None:
                am = (am.view(1, 1, H, N, N) + mask.view(1, nW, 1, N, N)).expand(
                    8, nW, H, N, N).reshape(B_, H, N, N)
            times["sdpa"] = common.device_ms(lambda: F.scaled_dot_product_attention(
                hq, hk, hv, attn_mask=am, scale=D ** -0.5))
            del hq, hk, hv, am
            name = f"stage {grid} B_={B_} H={H}" + (" shifted" if mask is not None else "")
            print(name, f"x{count}", " ".join(f"{k}={v:.4f}" for k, v in times.items()), flush=True)
            rows.append(dict(case=name, launches_per_microbatch=count, device_ms=times))
            for k, v in times.items():
                totals[k] += count * v
        del qkv, bias, out
        torch.cuda.empty_cache()
    print("per b8 micro-batch:", " ".join(f"{k}={v:.4f}" for k, v in totals.items()), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, totals=totals), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
