#!/usr/bin/env python3
"""K5's bf16 backward (csrc/window_attn3d_train.cu) in versions side by side
on the card: each version is a source file, with optional -D switches,
built into the ignored deepfake_tpu_torch/_build/k5bench/ and called
through the package's own wrapper (ops/window_attn3d_train.py).

    python3 deepfake_tpu_torch/tools/k5_versions.py _checkout/k5_other.cu \\
        deepfake_tpu_torch/csrc/window_attn3d_train.cu [--diag [names]] [--out PATH]

At each Video Swin-S stage shape of a b8 training micro-batch (32 frames of
224, window (8,7,7), N = 392), shifted and not, every version's dq, dk, dv
(two bf16 ulps of the largest |value|) and dbias (1e-2 of its largest
|value|) are held against the plain version, and its backward is timed
with CUDA events over 10 calls, in turns (every version, then again in
reverse order; the min is kept), with each launch's device time
(torch.profiler) beside it; SDPA's backward with bias + mask as a
grad-requiring attn_mask is timed beside them. Prints the card's name and
power limit, one line per shape and the totals per micro-batch (the 24
blocks' calls); --out writes them as JSON. A development tool for the
kernel's redesign, off every training path; PERF.md's table of K5 backward
versions was timed by it.

--diag adds diagnostic builds of the first version, each with one part
switched off by a patch of its text (they compute garbage and say only
where the time goes; written to the build directory): no_exp (an affine
stand-in for ex2), loads_once (each block loads K and V in launch 1, q and
dO in launch 2, for its first window only), no_slab (launch 1 adds nothing
into its dbias slab), no_fill (no bias tile is built), no_tile_reads (every
tile read returns 0), no_mma_out (no dq, dV or dK product), no_mma_s (no S
or dP product). "--diag no_exp,no_fill" takes some of them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

N = 392
# (name, [(old text, new text), ...]): the diagnostic patches of --diag; each
# old text must occur in the source. The first occurrence is patched, or,
# where the pair has a third element "hop", every occurrence after the
# definition of ex2_diag (the Hopper backward's code).
DIAGS = [
    ("no_exp", [("namespace hop {\n\nusing namespace hopper;\n",
                 "namespace hop {\n\nusing namespace hopper;\n"
                 "__device__ __forceinline__ float ex2_diag(float x) "
                 "{ return x * 0.01f + 1.f; }\n"),
                ("ex2(", "ex2_diag(", "hop")]),
    ("loads_once", [("mbar_expect_tx(full + sl, tx);",
                     "mbar_expect_tx(full + sl, it ? 2 * TILE_BYTES : tx);"),
                    ("for (int b = 0; b < p.nbox; ++b) {",
                     "for (int b = 0; !it && b < p.nbox; ++b) {"),
                    ("mbar_expect_tx(full + sl, "
                     "2 * TILE_BYTES + 2 * p.nbox * p.kbox * ROW_BYTES + sbytes);",
                     "mbar_expect_tx(full + sl, it ? 2 * TILE_BYTES + sbytes\n"
                     "    : 2 * TILE_BYTES + 2 * p.nbox * p.kbox * ROW_BYTES + sbytes);"),
                    ("for (int b = 0; b < p.nbox; ++b) {",
                     "for (int b = 0; !it && b < p.nbox; ++b) {")]),
    ("no_slab", [("      if (SLAB) {\n        float4* x",
                  "      if (SLAB && !SLAB) {\n        float4* x"),
                 ("} else if (h ? ok_b : ok_a) {", "} else if (!SLAB && (h ? ok_b : ok_a)) {")]),
    ("no_fill", [("  fill_rows(tile,", "  if (0) fill_rows(tile,"),
                 ("  fill_cols(tile,", "  if (0) fill_cols(tile,")]),
    ("no_tile_reads", [("  return make_float4(lo.x, lo.y, hi.x, hi.y);",
                        "  return make_float4(0.f, 0.f, 0.f, 0.f);")]),
    # the products that read P or dS (dq, dV, dK) left out; their A operands
    # are kept alive, so everything before them still runs
    ("no_mma_out", [(f"    WgmmaRS<32, 1>::mma({acc}, {a}[st], ",
                     f"    keep_mma({acc}, {a}[st], ")
                    for acc, a in (("dq", "da"), ("dv", "pa"), ("dk", "da"))] +
                   [("template <int W>\n__device__ __forceinline__ void s_dp(",
                     "__device__ __forceinline__ void keep_mma(float (&)[16], "
                     "const uint32_t (&a)[4],\n"
                     "                                         uint64_t, int) {\n"
                     "  asm volatile(\"\" ::\"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), "
                     "\"r\"(a[3]));\n}\n"
                     "template <int W>\n__device__ __forceinline__ void s_dp(")]),
    # S and dP left out: their accumulators are zeros the compiler cannot see
    ("no_mma_s", [("  WgmmaRS<W, 0>::mma(s, a[0], desc_sw64(xs + kc * ROW_BYTES, 16), 0);\n"
                   "  WgmmaRS<W, 0>::mma(s, a[1], desc_sw64(xs + kc * ROW_BYTES + 32, 16), 1);\n"
                   "  WgmmaRS<W, 0>::mma(dp, b[0], desc_sw64(ys + kc * ROW_BYTES, 16), 0);\n"
                   "  WgmmaRS<W, 0>::mma(dp, b[1], desc_sw64(ys + kc * ROW_BYTES + 32, 16), 1);\n",
                   "#pragma unroll\n  for (int i = 0; i < W / 2; ++i) {\n"
                   "    asm volatile(\"mov.b32 %0, 0;\" : \"=f\"(s[i]));\n"
                   "    asm volatile(\"mov.b32 %0, 0;\" : \"=f\"(dp[i]));\n  }\n")]),
]

def diag_sources(source, out_dir, names):
    """--diag: the patched copies of ``source``, as diagnostic versions."""
    text = open(source).read()
    specs = []
    for name, patches in DIAGS:
        if names != "all" and name not in names.split(","):
            continue
        t = text
        for old, new, *how in patches:
            if old not in t:
                raise SystemExit(f"--diag {name}: {old[:60]!r} not in {source}")
            if how == ["hop"]:
                at = t.index("ex2_diag(float x)") + len("ex2_diag(float x)")
                t = t[:at] + t[at:].replace(old, new)
            else:
                t = t.replace(old, new, 1)
        path = os.path.join(out_dir, f"diag_{name}.cu")
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(t)
        specs.append("~" + path)
    return specs


STAGES = [((16, 56, 56), 3, 96, 2), ((16, 28, 28), 6, 192, 2),
          ((16, 14, 14), 12, 384, 18), ((16, 7, 7), 24, 768, 2)]


def build(versions, out_dir):
    from deepfake_tpu_torch.kernels.build import CSRC, FLAGS, nvcc_path
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for spec in versions:
        path, _, defs = spec.lstrip("~").partition(":")
        tag = hashlib.sha256((open(path).read() + spec).encode()).hexdigest()[:12]
        lib = os.path.join(out_dir, f"libk5-{tag}.so")
        cmd = [nvcc_path(), *FLAGS, f"-I{CSRC}", *defs.split(), "-o", lib, path]
        procs.append((spec, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for spec, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {spec}:\n{log}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "warning" in line.lower():
                print(f"  ptxas {spec}: {line.strip()}")
        libs[spec] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+",
                    help="source[:-D switches]; a leading ~ marks a diagnostic build, "
                         "timed but not held to the plain version")
    ap.add_argument("--out", default=None)
    ap.add_argument("--diag", nargs="?", const="all", default=None,
                    help="add diagnostic builds of the first version (see above): all, or "
                         "a comma-separated list of their names")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size
    from deepfake_tpu_torch.ops import window_attn3d_train as k5

    if not torch.cuda.is_available():
        raise SystemExit("k5_versions: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(ROOT, "deepfake_tpu_torch", "_build", "k5bench")
    if args.diag:
        args.versions += diag_sources(args.versions[0].lstrip("~").partition(":")[0], out_dir,
                                      args.diag)
    libs = build(args.versions, out_dir)
    lib_of = k5._lib

    def use(spec):
        k5._lib = lambda lib=libs[spec]: _typed(lib, lib_of)

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

    def launches(fn, iters=5):
        """device ms per call of launch 1 and launch 2 (torch.profiler)"""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = [0.0, 0.0]
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for i, key in enumerate(("dq_bf16", "dkdv_bf16")):
                    if key in e.name:
                        out[i] += e.time_range.elapsed_us() / 1e3 / iters
        return out

    keys = [*args.versions, "sdpa"]
    total = {s: 0.0 for s in keys}
    total_l = {s: [0.0, 0.0] for s in args.versions}
    rows = []
    for grid, H, C, depth in STAGES:
        ws, ss = get_window_size(grid, (8, 7, 7), (4, 3, 3))
        nW = math.prod(n // w for n, w in zip(grid, ws))
        B_ = 8 * nW
        mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        dout = torch.randn(B_, N, C, generator=gen, device=dev).to(torch.bfloat16)
        bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        for mask, count in ((None, (depth + 1) // 2), (mask3, depth // 2)):
            kw = dict(num_heads=H, bias=bias, mask=mask, scale=(C // H) ** -0.5)
            want = k5.window_attn3d_train_bwd_plain(q, k, v, dout, **kw)
            times, split = {}, {}
            for spec in args.versions + args.versions[::-1]:
                use(spec)
                dqkv, dbias = k5.window_attn3d_train_bwd(qkv, dout, **kw)
                for name, a, b in zip(("dq", "dk", "dv", "dbias"), (*dqkv.split(C, dim=-1), dbias),
                                      want):
                    big = b.float().abs().max().item()
                    tol = 1e-2 * big if name == "dbias" else 2.0 * 2.0 ** (
                        math.floor(math.log2(big)) - 7)
                    err = (a.float() - b.float()).abs().max().item()
                    if not spec.startswith("~") and not (math.isfinite(err) and err <= tol):
                        raise SystemExit(f"{spec}: {grid} {name} err {err:.3e} > {tol:.3e}")
                del dqkv, dbias
                t = timed(lambda: k5.window_attn3d_train_bwd(qkv, dout, **kw))
                times[spec] = min(times.get(spec, t), t)
                if spec not in split:
                    split[spec] = launches(lambda: k5.window_attn3d_train_bwd(qkv, dout, **kw))
            del want
            hq, hk, hv = (t.reshape(B_, N, H, C // H).transpose(1, 2).contiguous()
                          .requires_grad_() for t in (q, k, v))
            am = bias[None].to(torch.bfloat16)
            if mask is not None:
                am = (am.view(1, 1, H, N, N) + mask.view(1, nW, 1, N, N)).expand(
                    8, nW, H, N, N).reshape(B_, H, N, N)
            am = am.contiguous().requires_grad_()
            o = F.scaled_dot_product_attention(hq, hk, hv, attn_mask=am, scale=kw["scale"])
            do_h = dout.reshape(B_, N, H, C // H).transpose(1, 2).contiguous()
            times["sdpa"] = timed(lambda: torch.autograd.grad(o, (hq, hk, hv, am), do_h,
                                                              retain_graph=True))
            del hq, hk, hv, am, o, do_h
            name = f"stage {grid} B_={B_} H={H}" + (" shifted" if mask is not None else "")
            print(name, " ".join(f"[{s}]={t:.4f}" for s, t in times.items()), "device launch 1/2:",
                  " ".join(f"[{s}]={a:.4f}/{b:.4f}" for s, (a, b) in split.items()), flush=True)
            rows.append(dict(case=name, blocks_per_microbatch=count, ms=times, launches_ms=split))
            for s, t in times.items():
                total[s] += count * t
            for s, (a, b) in split.items():
                total_l[s][0] += count * a
                total_l[s][1] += count * b
        del qkv, dout, bias, q, k, v
        torch.cuda.empty_cache()
    print("per b8 micro-batch:", " ".join(f"[{s}]={t:.4f}" for s, t in total.items()),
          "device launch 1/2:", " ".join(f"[{s}]={a:.4f}/{b:.4f}" for s, (a, b) in total_l.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, totals=total, launches=total_l), f, indent=1)
    return 0


def _typed(lib, lib_of):
    """lib with the argument types the package's _lib() sets."""
    if not getattr(lib, "_typed", False):
        real = lib_of()
        for fn in ("k5_fwd", "k5_bwd", "k5_stats_stride", "k5_error_string"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        lib._typed = True
    return lib


if __name__ == "__main__":
    sys.exit(main())
