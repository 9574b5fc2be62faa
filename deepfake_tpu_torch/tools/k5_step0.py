#!/usr/bin/env python3
"""Where does K5's backward spend its time? A diagnostic of the mma.sync
design of K5's bf16 backward (two launches: dq and dbias, then dk and dv;
the port's csrc/window_attn3d_train.cu up to commit 0a7e6c9) on the card.

    git show 0a7e6c9:deepfake_tpu_torch/csrc/window_attn3d_train.cu > _checkout/k5_first.cu
    python3 deepfake_tpu_torch/tools/k5_step0.py --source _checkout/k5_first.cu [--out PATH]

Builds the source in variants (compile-time switches patched in here; the
arithmetic of each is otherwise the source's) into the ignored
deepfake_tpu_torch/_build/k5_step0/, and times each launch of the backward
on its own at Video Swin-S stages 0 and 2 of a b8 micro-batch, shifted and
not, in turns (every variant, then again in reverse order), with CUDA events
over 10 launches:
  base       as it is
  one_sweep  launch 1's first sweep forms neither S nor dP: the row
             statistics are read from a buffer that base wrote
  kv_once    launch 1 loads K and V for the first window of each block only
             (computes garbage)
  no_mask    the mask pointers null at compile time in both launches
  bias_l1    launch 2 reads every key's transposed bias row from one 16-row
             slice, which stays in L1
  no_exp     an affine stand-in for __expf (computes garbage)
Prints the card's name and power limit and one line per launch; --out
writes the times as JSON. A development tool, off every serving and
training path; PERF.md's Step 0 table of K5's backward was timed by it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

VARIANTS = {"base": [], "one_sweep": ["ONE_SWEEP"], "kv_once": ["KV_ONCE"],
            "no_mask": ["NO_MASK"], "bias_l1": ["BIAS_L1"], "no_exp": ["NO_EXP"]}

# (old text, new text) pairs applied to the source, in order
PATCHES = [
    ("__expf(", "EXPF("),
    ("namespace {\n", """namespace {
#if defined(NO_EXP)
#define EXPF(x) ((x) * 0.01f + 1.f)
#else
#define EXPF __expf
#endif
int step0_only = 3;  // bit 0: launch 1, bit 1: launch 2
"""),
    ("__global__ void __launch_bounds__(DQ_THREADS) bwd_dq_bf16(BwdArgs g) {\n",
     """__global__ void __launch_bounds__(DQ_THREADS) bwd_dq_bf16(BwdArgs g) {
#ifdef NO_MASK
  g.mask = nullptr;
  g.mask_t = nullptr;
#endif
"""),
    ("__global__ void __launch_bounds__(THREADS, 2) bwd_dkdv_bf16(BwdArgs g) {\n",
     """__global__ void __launch_bounds__(THREADS, 2) bwd_dkdv_bf16(BwdArgs g) {
#ifdef NO_MASK
  g.mask = nullptr;
  g.mask_t = nullptr;
#endif
"""),
    ("""    load_rows(ks, static_cast<const bf16*>(g.k) + base, g.s_n, N, NK, tid, DQ_THREADS);
    load_rows(vs, static_cast<const bf16*>(g.v) + base, g.s_n, N, NK, tid, DQ_THREADS);""",
     """#ifdef KV_ONCE
    if (w == w0)
#endif
    {
    load_rows(ks, static_cast<const bf16*>(g.k) + base, g.s_n, N, NK, tid, DQ_THREADS);
    load_rows(vs, static_cast<const bf16*>(g.v) + base, g.s_n, N, NK, tid, DQ_THREADS);
    }"""),
    ("      for (int st = kg; st < steps; st += DQ_KEYS) {\n        const int j0 = st * 16;\n"
     "        float sc[2][4], dp[2][4], x[2][4];",
     "#ifndef ONE_SWEEP\n"
     "      for (int st = kg; st < steps; st += DQ_KEYS) {\n        const int j0 = st * 16;\n"
     "        float sc[2][4], dp[2][4], x[2][4];"),
    ("""            l_b += eb; c_b += eb * dp[nt][2 + i];
          }
      }
""", """            l_b += eb; c_b += eb * dp[nt][2 + i];
          }
      }
#endif
"""),
    ("""      // the key groups' statistics of rows a and b combined
""", """#ifdef ONE_SWEEP
      const float* st0 = g.stats + ((int64_t)w * g.heads + h) * 3 * g.ns;
      const float mx_a = st0[ok_a ? row_a : 0], mx_b = st0[ok_b ? row_b : 0];
      const float il_a = st0[g.ns + (ok_a ? row_a : 0)], il_b = st0[g.ns + (ok_b ? row_b : 0)];
      const float di_a = st0[2 * g.ns + (ok_a ? row_a : 0)];
      const float di_b = st0[2 * g.ns + (ok_b ? row_b : 0)];
#else
      // the key groups' statistics of rows a and b combined
"""),
    ("""        if (ok_b) { st[row_b] = mx_b; st[g.ns + row_b] = il_b; st[2 * g.ns + row_b] = di_b; }
      }
""", """        if (ok_b) { st[row_b] = mx_b; st[g.ns + row_b] = il_b; st[2 * g.ns + row_b] = di_b; }
      }
#endif
"""),
    ("""    const uint16_t* brow_a = bias_t + (int64_t)(ok_a ? key_a : 0) * N;
    const uint16_t* brow_b = bias_t + (int64_t)(ok_b ? key_b : 0) * N;""",
     """#ifdef BIAS_L1
    const uint16_t* brow_a = bias_t + (int64_t)(key_a & 15) * N;
    const uint16_t* brow_b = bias_t + (int64_t)(key_b & 15) * N;
#else
    const uint16_t* brow_a = bias_t + (int64_t)(ok_a ? key_a : 0) * N;
    const uint16_t* brow_b = bias_t + (int64_t)(ok_b ? key_b : 0) * N;
#endif"""),
    ("""    cudaError_t err = launch(tc::bwd_dq_bf16, dim3((n + tc::SLAB - 1) / tc::SLAB, heads, groups),
                             tc::DQ_THREADS, tc::dq_smem(n), s, g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(
        launch(tc::bwd_dkdv_bf16, dim3(windows, heads), tc::THREADS, tc::dkdv_smem(n), s, g));""",
     """    cudaError_t err = cudaSuccess;
    if (step0_only & 1)
      err = launch(tc::bwd_dq_bf16, dim3((n + tc::SLAB - 1) / tc::SLAB, heads, groups),
                   tc::DQ_THREADS, tc::dq_smem(n), s, g);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (step0_only & 2)
      err = launch(tc::bwd_dkdv_bf16, dim3(windows, heads), tc::THREADS, tc::dkdv_smem(n), s, g);
    return static_cast<int>(err);"""),
    ("""extern "C" const char* k5_error_string""",
     """extern "C" void k5_step0_only(int m) { step0_only = m; }

extern "C" const char* k5_error_string"""),
]


def build(source: str, out_dir: str):
    text = open(source).read()
    for old, new in PATCHES:
        if old not in text:
            raise SystemExit("the source is not K5's mma.sync backward (commit 0a7e6c9): "
                             f"missing {old[:70]!r}")
        text = text.replace(old, new) if old == "__expf(" else text.replace(old, new, 1)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "k5_step0.cu")
    with open(src, "w") as f:
        f.write(text)
    from deepfake_tpu_torch.kernels.build import FLAGS, nvcc_path
    procs = {}
    for name, defs in VARIANTS.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [nvcc_path(), *FLAGS, *(f"-D{d}" for d in defs), "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(lib)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        dll.k5_bwd.argtypes = [
            i, p, p, p, i64, i64, i64, p, i64, i64, i64, p, p, p, i64, i64, i64, p, p, p, p, i,
            p, p, ctypes.c_float, i, i, i, i, i, p]
        dll.k5_bwd.restype = i
        dll.k5_step0_only.argtypes = [i]
        libs[name] = dll
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True,
                    help="csrc/window_attn3d_train.cu as of commit 0a7e6c9")
    ap.add_argument("--out", default=None, help="write the times as JSON here")
    args = ap.parse_args()

    import torch
    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size

    if not torch.cuda.is_available():
        raise SystemExit("k5_step0: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(args.source, os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k5_step0"))
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    N, D = 392, 32
    ns = (N + 15) // 16 * 16
    res = {}
    for stage, (grid, H, C) in {0: ((16, 56, 56), 3, 96), 2: ((16, 14, 14), 12, 384)}.items():
        ws, ss = get_window_size(grid, (8, 7, 7), (4, 3, 3))
        nW = math.prod(n // w for n, w in zip(grid, ws))
        B_ = 8 * nW
        mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        dout = torch.randn(B_, N, C, generator=gen, device=dev).to(torch.bfloat16)
        bias = (0.5 * torch.randn(H, N, N, generator=gen, device=dev)).to(torch.bfloat16)
        bias_t = bias.transpose(1, 2).contiguous()
        dqkv = torch.empty_like(qkv)
        dbias = torch.zeros(H, N, N, device=dev)
        # the first design's group: about 1024 blocks, at most 16 windows
        group = max(1, min(16, B_ * H * -(-N // 32) // 1024))
        for mask in (None, mask3):
            mask_t = None if mask is None else mask.transpose(1, 2).contiguous()
            stats = {name: torch.zeros(B_ * H * 3 * ns, device=dev) for name in VARIANTS}
            ptr = lambda t: None if t is None else t.data_ptr()

            def call(name):
                status = libs[name].k5_bwd(
                    1, qkv.data_ptr(), qkv.data_ptr() + 2 * C, qkv.data_ptr() + 4 * C,
                    N * 3 * C, D, 3 * C, dout.data_ptr(), N * C, D, C, dqkv.data_ptr(),
                    dqkv.data_ptr() + 2 * C, dqkv.data_ptr() + 4 * C, N * 3 * C, D, 3 * C,
                    bias.data_ptr(), bias_t.data_ptr(), ptr(mask), ptr(mask_t), nW,
                    stats[name].data_ptr(), dbias.data_ptr(), D ** -0.5, B_, H, N, D, group,
                    torch.cuda.current_stream().cuda_stream)
                if status:
                    raise SystemExit(f"{name}: launch failed: CUDA error {status}")

            for name in VARIANTS:  # every variant's statistics, one_sweep's from base
                libs[name].k5_step0_only(3)
                call(name)
            torch.cuda.synchronize()
            stats["one_sweep"].copy_(stats["base"])
            times = {f"{name} launch {i}": [] for name in VARIANTS for i in (1, 2)}
            for name in list(VARIANTS) + list(VARIANTS)[::-1]:
                for i in (1, 2):
                    libs[name].k5_step0_only(i)
                    call(name)
                    torch.cuda.synchronize()
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    for _ in range(10):
                        call(name)
                    end.record()
                    torch.cuda.synchronize()
                    times[f"{name} launch {i}"].append(start.elapsed_time(end) / 10)
            key = f"stage {stage} B_={B_} H={H}" + (" shifted" if mask is not None else "")
            res[key] = times
            for i in (1, 2):
                print(key, f"launch {i}:", " ".join(
                    f"{n}={min(times[f'{n} launch {i}']):.4f}/{max(times[f'{n} launch {i}']):.4f}"
                    for n in VARIANTS), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
