#!/usr/bin/env python3
"""Does K3's time follow its bias and mask bytes? A diagnostic of the first
K3 design (one block per (window, head), mma.sync; the port's
csrc/window_attn3d.cu up to commit 685f5dd) on the card.

    git show 685f5dd:deepfake_tpu_torch/csrc/window_attn3d.cu > _checkout/k3_first.cu
    python3 deepfake_tpu_torch/tools/k3_step0.py --source _checkout/k3_first.cu [--out PATH]

Builds the source in variants (compile-time switches patched in here; the
arithmetic of each is otherwise the source's) into the ignored
deepfake_tpu_torch/_build/step0/, and times each at Video Swin-S stages 0
and 2 of a b8 request, shifted and not, in turns (every variant, then again
in reverse order), with CUDA events over 20 launches:
  base      as it is
  bias_l1   every row's bias read from one 64-row slice of head 0, which
            stays in L1 (the bias's L2 traffic gone, its loads kept)
  no_mask   the mask pointer null at compile time (no mask loads, no code)
  ex2       ex2.approx of x log2(e) for expf
  no_exp    an affine stand-in for expf (the exponentials' cost gone)
and the combinations named by their parts. Prints the card's name and power
limit and one line per launch; --out writes the times as JSON. A
development tool, off every serving and training path; PERF.md's Step 0
table of K3 was timed by it.
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

VARIANTS = {"base": [], "bias_l1": ["BIAS_L1"], "no_mask": ["NO_MASK"],
            "bias_l1_no_mask": ["BIAS_L1", "NO_MASK"], "ex2": ["EX2"],
            "ex2_bias_l1_no_mask": ["EX2", "BIAS_L1", "NO_MASK"], "no_exp": ["NO_EXP"],
            "no_exp_bias_l1_no_mask": ["NO_EXP", "BIAS_L1", "NO_MASK"]}

# (old text, new text) pairs applied to the source
PATCHES = [
    ("""    const float* brow_a = bias + (int64_t)(ok_a ? row_a : 0) * N;
    const float* brow_b = bias + (int64_t)(ok_b ? row_b : 0) * N;""",
     """#ifdef BIAS_L1
    const float* brow_a = g.bias + (int64_t)(row_a & 63) * N;
    const float* brow_b = g.bias + (int64_t)(row_b & 63) * N;
#else
    const float* brow_a = bias + (int64_t)(ok_a ? row_a : 0) * N;
    const float* brow_b = bias + (int64_t)(ok_b ? row_b : 0) * N;
#endif"""),
    ("""  const __nv_bfloat16* mask =
      g.mask ? static_cast<const __nv_bfloat16*>(g.mask) + (int64_t)(w % g.n_masks) * N * N
             : nullptr;
  const bool vec""",
     """#ifdef NO_MASK
  const __nv_bfloat16* mask = nullptr;
#else
  const __nv_bfloat16* mask =
      g.mask ? static_cast<const __nv_bfloat16*>(g.mask) + (int64_t)(w % g.n_masks) * N * N
             : nullptr;
#endif
  const bool vec"""),
    ("e[i] = expf(fminf((s[nt][i] + ba[c]) + ma[c] - 24.f, 60.f));",
     "e[i] = EXPF(fminf((s[nt][i] + ba[c]) + ma[c] - 24.f, 60.f));"),
    ("e[2 + i] = expf(fminf((s[nt][2 + i] + bb[c]) + mb[c] - 24.f, 60.f));",
     "e[2 + i] = EXPF(fminf((s[nt][2 + i] + bb[c]) + mb[c] - 24.f, 60.f));"),
    ("namespace {\n", """namespace {
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
#if defined(EX2)
#define EXPF ex2f
#elif defined(NO_EXP)
#define EXPF(x) ((x) * 0.01f + 1.f)
#else
#define EXPF expf
#endif
"""),
]


def build(source: str, out_dir: str):
    text = common.patch(open(source).read(), PATCHES,
                        "the source is not the first K3 design (commit 685f5dd)")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "k3_step0.cu")
    with open(src, "w") as f:
        f.write(text)
    libs = common.nvcc([(name, src, [f"-D{d}" for d in defs]) for name, defs in VARIANTS.items()],
                       out_dir)
    for dll in libs.values():
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        dll.k3_window_attn.argtypes = [i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, i,
                                       ctypes.c_float, i, i, i, i, p]
        dll.k3_window_attn.restype = i
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True, help="csrc/window_attn3d.cu as of commit 685f5dd")
    ap.add_argument("--out", default=None, help="write the times as JSON here")
    args = ap.parse_args()

    import torch
    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size

    if not torch.cuda.is_available():
        raise SystemExit("k3_step0: needs an NVIDIA GPU")
    print(common.card(), flush=True)
    libs = build(args.source, os.path.join(ROOT, "deepfake_tpu_torch", "_build", "step0"))
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    N, D = 392, 32
    res = {}
    for stage, (grid, H, C) in {0: ((16, 56, 56), 3, 96), 2: ((16, 14, 14), 12, 384)}.items():
        ws, ss = get_window_size(grid, (8, 7, 7), (4, 3, 3))
        nW = math.prod(n // w for n, w in zip(grid, ws))
        B_ = 8 * nW
        mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
        out = torch.empty(B_, N, C, device=dev, dtype=torch.bfloat16)
        for mask in (None, mask3):
            def call(lib):
                status = lib.k3_window_attn(
                    1, qkv.data_ptr(), qkv.data_ptr() + 2 * C, qkv.data_ptr() + 4 * C,
                    N * 3 * C, D, 3 * C, out.data_ptr(), N * C, D, C, bias.data_ptr(),
                    None if mask is None else mask.data_ptr(), nW, D ** -0.5, B_, H, N, D,
                    torch.cuda.current_stream().cuda_stream)
                if status:
                    raise SystemExit(f"launch failed: CUDA error {status}")
            times = {name: [] for name in VARIANTS}
            for name in list(VARIANTS) + list(VARIANTS)[::-1]:
                call(libs[name])
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    call(libs[name])
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 20)
            key = f"stage {stage} B_={B_} H={H}" + (" shifted" if mask is not None else "")
            res[key] = times
            print(key, " ".join(f"{k}={min(v):.4f}/{max(v):.4f}" for k, v in times.items()),
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
