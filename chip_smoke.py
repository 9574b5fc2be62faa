#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepfake_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--report PATH]

Phases, in order; any failure exits non-zero and prints no result:
  1. the card's name and power limit; build every CUDA kernel from csrc/
     (one nvcc per source, all at once).
  2. each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it (fused: b8 x 32 frames at 224, SwinV2-B at
     224; video_swin: the four Video Swin-S stages at b8 x 32 frames of 224,
     K3's attention (at b1 too, with the L2 bytes its design reads and the
     exponentials' floor) and K4's launches of a block in serving (LN1 + qkv,
     proj, and the MLP tail: one launch at C <= 384, fc1 and fc2 at 768),
     K5's forward and backward in training, with device times by
     torch.profiler (the backward's two launches apart) beside SDPA's
     forward and backward; audio: K6 (device times beside SDPA's) at the three
     window-16 stages of SwinV2-B at 256^2, b8, shifted and not, logit
     scales up to 100, one scaled N = 392 case, and windows 10 and 24 (N =
     100 and 576, off the main path)), f32 with TF32 off and bf16; kernel,
     plain, library and bound times per shape and per b8 request or
     micro-batch; then K3 and K5 (forward and backward) again at the four
     stages of Video Swin-B at its (16,7,7) window (N = 784, streamed);
     then K2, K3, K5 (forward and backward) and K6 at head dims 12, 16, 20,
     36, 48, 64 and 128 (one shape of each path with the head dim changed;
     the kernel line's "head_dims"), and K4 (LN1 + qkv, proj and the MLP tail) at
     Video Swin-L's stage 3, C = 1536 (its "swin_l_stage3").
  3. fused serving at full width (IRv2 + NeXtVLAD, SwinV2-B, wav2vec2-base,
     fusion head; random weights from --seed) in bf16: three b8 requests
     and one b1 request, with the launch counters showing that the
     requests went through every kernel; then the same requests on the
     plain routes (kernels off, same weights) for the end-to-end
     comparison, and each branch's device time on both; then one b8
     request from raw inputs (uint8 frames, 16 kHz PCM) through predict_raw.
     Phases 3, 4, 8 and 10 serve each request on the eager route
     (compiled=False) and as CUDA graphs (the default on the card): per
     route latency, clips/s and the device's idle share, the graphs' pool
     bytes, graph scores and logits against the eager route's (equal to the
     bit; two requests' logits differ), each graph's captured launches
     against the eager route's, and one replay's hand-written kernels
     against one eager call's (torch.profiler, by name; each traced call
     sits between two sentinel kernels after a warm-up call, and is
     traced again where the profiler did not record both). A kernel's
     "launches" count the eager requests of its path's run; its
     "graph_launches" the timed replays of the same requests.
  4. the same for video_swin serving (Video Swin-S 3D, 32 frames of 224):
     three b8 and one b1 request through K3 and K4 (24 K3 launches each;
     K4: 3 a block at C <= 384 and 4 at 768, 74 in all), then on the plain
     route; then the same for Video Swin-L
     (swin_large_patch244_window877: embed 192, heads 6/12/24/48; K4's
     LayerNorm at C = 1536 in stage 3; the kernel line's
     "launches_swin_l").
  5. the kernel routes against the plain routes in f32 (TF32 off), the same
     weights: fused b2 (scores and branch features) and video_swin b2
     (scores and per-frame features). In f32 every kernel runs its SIMT
     parity kernel, not the tensor-core kernel that serves bf16; phase 2
     holds the tensor-core kernels.
  6. video_swin training at full width (the preset: micro-batch 8 x accum
     4, 32 clips of 32 x 224^2 a step, bf16 compute, f32 masters), fed by
     the train-side FeatureAssembler (augmentation on the card) from seeded
     random uint8 clips: three optimizer steps on the eager K5 route (96 K5
     forward and 96 backward launches a step; the kernel line's launches)
     and Trainer.eval of one batch (K3 and K4 on the trained f32 masters);
     the same three steps by a second eager Trainer (the spread of sums
     whose order may change from run to run); the same three on the graph route (the default: the
     first step captures the step graph), whose losses and weights must
     fall within SPREAD_MULTIPLE of that spread, then two more and its
     eval through a graph; then two steps on the plain route from the same
     weights. Per route: step ms and p50, clips/s, the assembly's ms apart,
     peak memory, one step under torch.profiler (idle share); the graph's
     pool bytes and its K5 launches (captured x replays, the kernel line's
     "graph_launches"). K5 itself is held against its plain versions in
     phase 2 (the four stage shapes of a b8 micro-batch).
  7. f32 parity of training: one b1 micro-batch, every gradient of the K5
     route against the plain route.
  8. audio serving from raw PCM (SwinV2-B at its published window-16, 256^2
     geometry; 4 s buckets of 16 kHz PCM, valid 2.5-4 s): three b8 and one
     b1 request through predict_raw (resample, mel image, then 22 K6 and 2
     K2 launches each), then on the plain route; latency, clips/s, idle
     share, top kernels, the front end's device time apart.
  9. f32 parity of audio: b2 scores, kernel route against plain route.
 10. Video Swin-B at its Something-Something v2 window (16,7,7) on 32
     frames of 224 (embed 128, heads 4/8/16/32, depths 2/2/18/2; N = 784
     in every stage): serving as phase 4 (three b8 and one b1 request, K3
     and K4 at C = 128-1024), two training steps of 8 x 4 on the eager K5
     route (step ms, clips/s, peak memory), f32 b1 parity of scores (graph
     against eager too) and of one micro-batch's gradients. Phases 5 and 9
     hold the f32 graphs against the eager route as well (to the bit).
 11. from video files, on the graph route (phase_ingest): a synthetic test
     set of 60 mp4v clips (48 frames of 256^2, 4 s PCM sidecars) scored by
     SubmitCtl in fused b8 batches through K1 and K2 (clips/s from files,
     the loader alone by seek and by sequential sampling, device ms a
     batch, the card's idle share; every score equal to the bit to
     predict_raw of its batch), the inference CLI in a subprocess stopped
     by SIGTERM after its first batch and resumed (each clip once), both
     serving phase 14's checkpoint (Predictor.from_checkpoint, --Resume), a
     96-frame video through Video Swin-S by sliding windows (K3, K4) and one
     file through SwinV2-B at window 16 (K6, K2); the kernel line's
     "launches_ingest" and "graph_launches_ingest".
 12. fused training at full width (the preset: micro-batch 8 x accum 4 of
     32 frames at 224^2, the 224^2 mel image and 4 s of PCM, bf16 compute,
     f32 masters; BatchNorm batch statistics in IRv2, NeXtVLAD and the
     head; SwinV2-B through K5 at N = 49: 96 forward and 96 backward
     launches a step, the kernel line's N=49 rows), fed by the train-side
     FeatureAssembler from raw clips: three steps on the eager K5 route, the
     same as one CUDA graph a step and two more replays (the timing rows,
     default configuration), then both again in the deterministic
     configuration (cuDNN's deterministic algorithms,
     torch.use_deterministic_algorithms; K5's dbias is summed in a fixed
     order), where the graph equals the eager route to the bit in losses
     and weights, then the plain route (K5 off) as the A/B; step ms,
     clips/s, peak memory, idle share, graph pool. Phase 2 holds K5 at
     SwinV2-B's four stage shapes of a b8 micro-batch (cosine inputs:
     q^ times per-head scales, scale 1), each backward launched twice: dbias
     repeats to the bit (the K5 rows' "dbias_repeats").
 15. the mesh on the card (phase_mesh, right after phase 12): a one-process
     NCCL group (world_size 1, rank 0) and its (1 data, 1 model) mesh;
     three fused graph steps at 8 x 4 with the group, in the deterministic
     configuration, equal to phase 12's deterministic graph steps without
     a group to the bit (losses and weights: an all-reduce of one rank is
     exact, and BatchNorm's statistics come from one routine with or
     without a group); a fused b8 Predictor request with the group equal
     to one without to the bit; the step ms beside phase 12's graph step,
     the collectives a step's graph holds and the bytes one step
     all-reduces (the "mesh:" line).
 16. int8 serving of the IRv2 trunk (phase_int8, right after phase 3, on its
     weights and requests): model.irv2_quant = int8, then int8_static after
     SubmitCtl.calibrate on one b8 batch, each on the eager route (24 K7
     launches a request; K8: one max and one quantisation a distinct
     activation at int8, 7 + 19, the max of a K7 output from K7's
     epilogue; 24 quantisations at int8_static) and as CUDA graphs (graph
     = eager to the bit), the logits of both routes equal to the per-conv
     route's (one K8 max and quantisation a conv) to the bit, the amax
     every conv is handed equal to act_amax_plain of its input (12 from K7's
     epilogue with K1 on, 102 off), latency, clips/s and idle share beside
     phase 3's bf16 route, K7's and K8's device ms a request (profiler),
     the logits' correlation with the bf16 route (>= 0.99), static on its
     calibration batch equal to dynamic to the bit; one b8 request with
     irv2_fused_blocks off (244 K7); K7 against its plain version to the
     bit at every conv shape of both (bf16 and f32 out, its output's max
     where the path asks for it), K8 at every input shape (bf16 and f32,
     with a saturating static scale), each shape's kernel, plain, cuDNN
     bf16 conv, torch._int_mm (1x1) and bound ms beside K7's route for it
     (ops/int8_conv.py::plan), K8 a request on the calls the path made; and,
     inside phase 11, the inference CLI over its files at
     --set model.irv2_quant=int8 (the kernel line's K7 and K8 rows).
 17. the remaining model options (right after phase 15): (a) activation
     checkpointing (parallel.remat) of the fused model at 8 x 4 on the
     graph route at remat_policy "", "dots" and "dots,dots,off,off", in the
     deterministic configuration: three steps equal to phase 12's
     deterministic graph steps to the bit in losses and weights, K5 at N =
     49 launching its forward once more per recomputed block (192 a step,
     112 at "dots,dots,off,off", 96 backward), step ms, peak GB and graph
     pool beside phase 12's; Video Swin-S at 8 x 4 at "" on phase 6's
     clips (K5's forward 192 a step; losses within phase 6's spread rule);
     (b) Video Swin-S at --video_pool Attention: b8 requests eager and as
     a graph (equal to the bit; K3 and K4 launching as at mean pooling),
     then three training steps eager, eager again and as a graph (phase 6's
     spread rule); (c) iResNet (bottleneck 2/2/2/2) and Res34 on one b8 x
     32-frame batch (256 images of 224^2), bf16 against f32, ms, and one
     train-mode forward and backward; (d) fused b8 under
     model.parity_inference_dropout: two equal requests give equal scores,
     the graph equals the eager route to the bit. The kernel line's K5 rows
     gain "launches_remat" (a step, by policy) and the K3, K4 and K5 rows
     "launches_attention_pool".
 13. the training CLI on mp4 files: item 5 of phase 14.
 14. checkpoints of fused training at 8 x 4 on the graph route
     (phase_checkpoints): Trainer.train over five steps with model_save 5,
     the profiler trace (naming K5's kernels), the HbmTracker file and the
     `duty |` line's ckpt share; a fresh Trainer resumed from the save
     after step 4 (every tensor equal to the file's) and the checkpoint
     loaded into a captured step graph (data_ptrs kept), step 5 against the
     uninterrupted one (losses to the bit, weights within 4x two eager
     steps' spread); Predictor.from_checkpoint serving fused b8 (graph =
     eager to the bit); the training CLI on 40 mp4v clips (32 train, 8 val)
     stopped by SIGTERM after its first checkpoint and resumed from it (its
     Train Loss and val AUC lines); phase 11 then serves the checkpoint
     (in-process and through the inference CLI with --Resume); the kernel
     line's "launches_checkpoints" (K5 over the captures and the loop, K1
     and K2 over the serving). Runs before phase 11.
A "phases (s)" line gives each phase's seconds. The last four lines are
{"ingest": {...}}, the card's name and power limit, {"kernels": [...]} and
{"ok": true, "device": ...};
--report writes every measurement and check as JSON to PATH. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 SIMT; bf16 dense tensor cores
K1_SRC = "deepfake_tpu_torch/csrc/inception_block.cu"
K2_SRC = "deepfake_tpu_torch/csrc/window_attn.cu"
K1_REPLACES = ("deepfake_tpu/ops/pallas_inception.py:229 fused_inception_block_a; "
               "deepfake_tpu/ops/pallas_inception.py:149 fused_inception_block")
K2_TOK_REPLACES = "deepfake_tpu/ops/pallas_window_attn.py:847 pallas_window_attention_nhc_packed"
K2_HEAD_REPLACES = "deepfake_tpu/ops/pallas_window_attn.py:1127 pallas_window_attention"
K3_SRC = "deepfake_tpu_torch/csrc/window_attn3d.cu"
K3_TOK_REPLACES = ("deepfake_tpu/ops/pallas_window_attn.py:709 pallas_window_attention_nhc; "
                   "the attention of deepfake_tpu/ops/pallas_window_attn.py:548 "
                   "pallas_window_attention_nhc_qkv")
K4_SRC = "deepfake_tpu_torch/csrc/ln_linear.cu"
K4_QKV_REPLACES = ("deepfake_tpu/ops/pallas_window_attn.py:548 pallas_window_attention_nhc_qkv "
                   "(LayerNorm, qkv and proj; with K3)")
K4_MLP_REPLACES = "deepfake_tpu/ops/pallas_mlp.py:101 fused_mlp_tail"
K5_SRC = "deepfake_tpu_torch/csrc/window_attn3d_train.cu"
K5_FWD_REPLACES = ("deepfake_tpu/ops/pallas_window_attn.py:1074 "
                   "pallas_window_attention_nhc_train (forward: _run_nhc :320)")
K5_BWD_REPLACES = ("deepfake_tpu/ops/pallas_window_attn.py:1074 "
                   "pallas_window_attention_nhc_train (backward: _run_nhc_bwd :966)")
K6_SRC = "deepfake_tpu_torch/csrc/window_attn_multihead.cu"
K6_REPLACES = ("deepfake_tpu/ops/pallas_window_attn.py:179 _run_multihead "
               "(pallas_window_attention :1127, N >= 128); for 64 < N < 128 its _run :51 "
               "and _run_packed :126 and pallas_window_attention_nhc_packed :847")


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# torch.cuda._sleep's kernel, launched before and after each traced call
SENTINEL = "spin_kernel"
TRACES = collections.Counter()  # traced calls, and tries traced again


def traced(fn, warm=None, tries: int = 5) -> list:
    """The device kernels of one call of ``fn`` under torch.profiler, as
    (name, ms) pairs in order, between two sentinel kernels. On an H100 the
    profiler dropped the first kernels it should have recorded in some
    windows (in eager calls and graph replays alike; late in a long run,
    in every window, however long the host waited before launching
    them). So one call of ``warm`` (default:
    ``fn``) runs first in the window, then the sentinels and the call; a
    window that did not record both sentinels is traced again, and one that
    never does fails. Only the card's activity is recorded: host ops are
    not read here, and turning an eager training step's tens of thousands
    of them into events costs the host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    TRACES["calls"] += 1
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (warm or fn)()
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000)
            fn()
            torch.cuda._sleep(1_000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if SENTINEL in e.name]
        if len(marks) == 2:
            return [(e.name, e.time_range.elapsed_us() / 1e3)
                    for e in events[marks[0] + 1:marks[1]]]
        TRACES["traced again"] += 1
        seen.append(f"{len(events)} kernels, sentinels at {marks}, first "
                    f"{[e.name[:60] for e in events[:2]]}, last {[e.name[:60] for e in events[-2:]]}")
    fail(f"torch.profiler recorded the sentinel kernels of none of {tries} traces: "
         + "; ".join(seen))


def device_kernel_ms(fn, iters: int = 10) -> dict:
    """The device's own time per call of ``fn`` by kernel name (the summed
    durations of each kernel it launches, torch.profiler), after one warm-up
    call."""
    def calls():
        for _ in range(iters):
            fn()

    by_name = {}
    for name, ms in traced(calls, warm=fn):
        by_name[name] = by_name.get(name, 0.0) + ms / iters
    return by_name


def device_time_ms(fn, iters: int = 10) -> float:
    """The device's own time per call of ``fn`` (every kernel it launches):
    unlike cuda_time_ms it leaves out the gaps while the host issues the
    calls, which set the event time of launches shorter than their host
    work."""
    return sum(device_kernel_ms(fn, iters).values())


def errors(got, want):
    """(max abs error, max of |got - want| / max(|want|, 1)) in f32."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d / want.float().abs().clamp(min=1.0)).max().item()


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------- phase 2: K1

def randomize_bn(model, gen):
    """Random BN affines and running stats, random final-conv biases, so
    that folding and every epilogue term matter."""
    import torch

    from deepfake_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                dev = m.weight.device
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=gen, device=dev))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen, device=dev))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen, device=dev))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen, device=dev))
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(0.1 * torch.randn(m.bias.numel(), generator=gen, device=m.bias.device))


def k1_flops_bytes(blk, rows: int, C: int, elt: int):
    macs = blk.w_in.numel() + blk.w_out.numel() + sum(c.w.numel() for ch in blk.chains for c in ch)
    weights = elt * macs + 4 * (blk.a_in.numel() + blk.b_out.numel()
                                + sum(c.affine.numel() for ch in blk.chains for c in ch))
    return 2.0 * rows * macs, 2.0 * rows * C * elt + weights


def k1_yardstick(blk, x):
    """One block's convs as library calls on inputs of their shapes: cuBLAS
    torch.matmul [R, K] x [K, n] for each 1 x 1 conv (the product alone),
    cuDNN F.conv2d (channels_last, zero padding) for each tap conv. A
    yardstick made of several calls, not one call for the same function."""
    import torch
    import torch.nn.functional as F

    Fn, H, W, C = x.shape
    R, dev, dt = Fn * H * W, x.device, x.dtype
    n_cat = blk.w_out.shape[0]
    calls = [(x.view(R, C), blk.w_in)]
    taps = []
    for chain in blk.chains:
        for conv in chain:
            _, cin, cout = conv.w.shape
            inp = torch.randn(Fn, cin, H, W, device=dev).to(dt).contiguous(
                memory_format=torch.channels_last)
            wt = conv.w.reshape(conv.kh, conv.kw, cin, cout).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            taps.append((inp, wt, (conv.kh // 2, conv.kw // 2)))
    cat = torch.randn(R, n_cat, device=dev).to(dt)
    calls.append((cat, blk.w_out))

    def run():
        for a, w in calls:
            torch.matmul(a, w)
        for inp, wt, pad in taps:
            F.conv2d(inp, wt, padding=pad)
    return run


def phase_k1(dev, gen, frames: int, report):
    import torch

    from deepfake_tpu_torch.models import inception_resnet_v2 as irv2
    from deepfake_tpu_torch.models.layers import init_weights
    from deepfake_tpu_torch.ops.inception_block import inception_block, inception_block_plain

    cases = [  # name, module, spatial side, blocks per request
        ("A", irv2.BlockA(0.17, True), 25, 10),
        ("B", irv2.BlockB(0.10, True), 12, 20),
        ("C", irv2.BlockC(0.20, True, True), 5, 9),
        ("c_9", irv2.BlockC(1.0, False, True), 5, 1),
    ]
    per_request = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "yardstick_device_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for name, block, side, count in cases:
        block = init_weights(block.to(dev), gen)
        randomize_bn(block, gen)
        C = block.conv.out_channels
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            dname = str(dtype).split(".")[1]
            blk = block.pack_weights(dtype)
            x = (0.5 * torch.randn(frames, side, side, C, generator=gen, device=dev)).to(dtype)
            got = inception_block(x, blk)
            torch.cuda.synchronize()
            err, rel = errors(got, inception_block_plain(x, blk))
            errs[dname] = max(errs[dname], err)
            if not (math.isfinite(rel) and rel <= tol):
                fail(f"K1 block {name} {dname}: max rel err {rel:.3e} > {tol}")
            ms = cuda_time_ms(lambda: inception_block(x, blk))
            plain = cuda_time_ms(lambda: inception_block_plain(x, blk), iters=2)
            flops, nbytes = k1_flops_bytes(blk, x.shape[0] * side * side, C, x.element_size())
            b, by = bound_ms(flops, nbytes, dname)
            row = dict(kernel="inception_block", case=f"{name} [{frames}x{side}x{side}x{C}]",
                       dtype=dname, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                       gflop=flops / 1e9, mbytes=nbytes / 1e6, max_rel_err=rel,
                       max_abs_err=err)
            if dtype == torch.bfloat16:
                # the device's own time, and the convs as library calls (a
                # yardstick of several calls: no one call is this function)
                dms = device_time_ms(lambda: inception_block(x, blk))
                yard = device_time_ms(k1_yardstick(blk, x))
                row.update(device_ms=dms, yardstick_device_ms=yard)
                for k, v in (("ms", ms), ("device_ms", dms), ("plain_ms", plain),
                             ("bound_ms", b), ("yardstick_device_ms", yard), ("flops", flops),
                             ("bytes", nbytes)):
                    per_request[k] += count * v
            report["k1"].append(row)
            log(f"K1 {name:4s} {dname:8s} kernel_ms={ms:.3f} "
                + (f"device_ms={row['device_ms']:.3f} conv-by-conv cuBLAS/cuDNN device_ms="
                   f"{row['yardstick_device_ms']:.3f} (several calls) " if "device_ms" in row else "")
                + f"plain_ms={plain:.3f} bound_ms={b:.4f} ({by}) GFLOP={flops / 1e9:.1f} "
                f"rel_err={rel:.2e} (tol {tol})")
            del x, got
        del block
    torch.cuda.empty_cache()
    inception_block.launches = 0
    _, by = bound_ms(per_request["flops"], per_request["bytes"], "bfloat16")
    log(f"K1 per b8 request: kernel_ms={per_request['ms']:.3f} device_ms="
        f"{per_request['device_ms']:.3f} bound_ms={per_request['bound_ms']:.4f}; conv-by-conv "
        f"cuBLAS/cuDNN device_ms={per_request['yardstick_device_ms']:.3f} (a yardstick of "
        "several calls, not a library call for the same function)")
    return dict(name="inception_block (K1)", route="cuda", source=K1_SRC, replaces=K1_REPLACES,
                launches=None, max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
                ms=per_request["ms"], device_ms=per_request["device_ms"],
                plain_ms=per_request["plain_ms"], bound_ms=per_request["bound_ms"], bound_by=by,
                library_ms=None,
                per="one fused b8 request: 10 A + 20 B + 10 C blocks, bf16")


# ---------------------------------------------------------------- phase 2: K2

SWIN_B_STAGES = [  # (resolution, heads, C, depth) of SwinV2-B at 224
    (56, 4, 128, 2), (28, 8, 256, 2), (14, 16, 512, 18), (7, 32, 1024, 2)]


def attn_case(dev, gen, B_, H, C, mask_np, dtype):
    import torch

    N = 49
    qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(dtype)
    bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=dev))
    ls = torch.exp(torch.clamp(math.log(10.0) + 0.3 * torch.randn(H, 1, 1, generator=gen,
                                                                   device=dev), max=math.log(100)))
    mask = None if mask_np is None else torch.from_numpy(mask_np).to(dev)
    return qkv, bias, mask, ls


def k2_flops_bytes(B_, H, C, n_masks, elt):
    N, D = 49, C // H
    flops = 4.0 * B_ * H * N * N * D
    nbytes = 4.0 * B_ * N * C * elt + 4.0 * H * N * N + 4.0 * n_masks * N * N
    return flops, nbytes


def phase_k2(dev, gen, batch: int, report):
    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.models.swin2d import shift_attn_mask
    from deepfake_tpu_torch.ops import window_attn_kernel as k2
    from deepfake_tpu_torch.ops.window_attn import l2_normalize

    tok = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "library_device_ms": 0.0, "library_norm_device_ms": 0.0, "flops": 0.0,
           "bytes": 0.0, "err": 0.0, "err32": 0.0}
    head = dict(tok)
    cases = []
    for res, H, C, depth in SWIN_B_STAGES:
        ws_ = min(res, 7)
        nW = (res // ws_) ** 2
        shifted = res > 7  # blocks alternate unshifted / shifted; stage 3 never shifts
        n_plain, n_masked = ((depth + 1) // 2, depth // 2) if shifted else (depth, 0)
        mask_np = shift_attn_mask(res, res, 7, 3) if shifted else None
        cases.append((f"stage res {res}", batch * nW, H, C, None, n_plain, tok))
        if shifted:
            cases.append((f"stage res {res} shifted", batch * nW, H, C, mask_np, n_masked, tok))
    # batch 1 at stage 3: one 7x7 window, head-major (B_ == 1)
    cases.append(("stage res 7, B_=1", 1, 32, 1024, None, 2, head))
    for name, B_, H, C, mask_np, count, acc in cases:
        D, N = C // H, 49
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            dname = str(dtype).split(".")[1]
            qkv, bias, mask, ls = attn_case(dev, gen, B_, H, C, mask_np, dtype)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            hq, hk, hv = (t.reshape(B_, N, H, D).transpose(1, 2).contiguous() for t in (q, k, v))
            kw = dict(bias=bias, mask=mask, logit_scale=ls)
            for layout, run, plain in (
                    ("tokens", lambda: k2.window_attention_tokens(q, k, v, num_heads=H, **kw),
                     lambda: k2.window_attention_tokens_plain(q, k, v, num_heads=H, **kw)),
                    ("heads", lambda: k2.window_attention_heads(hq, hk, hv, **kw),
                     lambda: k2.window_attention_heads_plain(hq, hk, hv, **kw))):
                if layout == "tokens" and B_ == 1:
                    continue  # SwinV2 takes the head-major route at B_ == 1
                got = run()
                torch.cuda.synchronize()
                err, rel = errors(got, plain())
                if not (math.isfinite(rel) and rel <= tol):
                    fail(f"K2 {layout} {name} {dname}: max rel err {rel:.3e} > {tol}")
                timed = (layout == "tokens") == (acc is tok)
                row = dict(kernel=f"window_attn_{layout}", case=f"{name} B_={B_} H={H} C={C}",
                           dtype=dname, max_abs_err=err, max_rel_err=rel)
                if timed:
                    ms = cuda_time_ms(run, iters=10)
                    pms = cuda_time_ms(plain, iters=5)
                    am = bias[None].to(dtype)
                    if mask is not None:
                        nW = mask.shape[0]
                        am = (am.view(1, 1, H, N, N) + mask.to(dtype).view(1, nW, 1, N, N)).expand(
                            B_ // nW, nW, H, N, N).reshape(B_, H, N, N)
                    qn = (l2_normalize(hq.float()) * ls).to(dtype)
                    kn = l2_normalize(hk.float()).to(dtype)
                    sdpa = lambda: F.scaled_dot_product_attention(
                        qn, kn, hv, attn_mask=am, scale=1.0)
                    lib = cuda_time_ms(sdpa, iters=10)
                    # device times (events over launches this short time the
                    # host too); SDPA also with the normalisation of q and k
                    # that K2 does inside
                    dms, lib_dms = device_time_ms(run), device_time_ms(sdpa)
                    lib_norm_dms = device_time_ms(lambda: F.scaled_dot_product_attention(
                        (l2_normalize(hq.float()) * ls).to(dtype),
                        l2_normalize(hk.float()).to(dtype), hv, attn_mask=am, scale=1.0))
                    flops, nbytes = k2_flops_bytes(B_, H, C, 0 if mask is None else mask.shape[0],
                                                   qkv.element_size())
                    b, by = bound_ms(flops, nbytes, dname)
                    row.update(ms=ms, device_ms=dms, plain_ms=pms, library_ms=lib,
                               library_device_ms=lib_dms, library_norm_device_ms=lib_norm_dms,
                               bound_ms=b, bound_by=by)
                    log(f"K2 {layout:6s} {name:24s} B_={B_:4d} H={H:2d} {dname:8s} "
                        f"kernel_ms={ms:.4f} device_ms={dms:.4f} plain_ms={pms:.4f} "
                        f"library_ms={lib:.4f} (device {lib_dms:.4f}, with q, k normalised "
                        f"{lib_norm_dms:.4f}) bound_ms={b:.4f} ({by}) rel_err={rel:.2e} "
                        f"(tol {tol})")
                    if dtype == torch.bfloat16:
                        for key, val in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                                         ("library_ms", lib), ("library_device_ms", lib_dms),
                                         ("library_norm_device_ms", lib_norm_dms),
                                         ("bound_ms", b), ("flops", flops), ("bytes", nbytes)):
                            acc[key] += count * val
                acc["err" if dtype == torch.bfloat16 else "err32"] = max(
                    acc["err" if dtype == torch.bfloat16 else "err32"], err)
                report["k2"].append(row)
    k2.window_attention_tokens.launches = 0
    k2.window_attention_heads.launches = 0
    out = []
    for name, acc, rep, per in (
            ("window_attn_tokens (K2, token-major)", tok, K2_TOK_REPLACES,
             "one fused b8 request: 24 SwinV2-B blocks, bf16"),
            ("window_attn_heads (K2, head-major)", head, K2_HEAD_REPLACES,
             "one fused b1 request: the 2 stage-3 blocks at B_=1, bf16")):
        _, by = bound_ms(acc["flops"], acc["bytes"], "bfloat16")
        log(f"K2 {name} per request: kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} (device {acc['library_device_ms']:.4f}, with q, "
            f"k normalised {acc['library_norm_device_ms']:.4f}) bound_ms={acc['bound_ms']:.4f}")
        out.append(dict(name=name, route="cuda", source=K2_SRC, replaces=rep, launches=None,
                        max_abs_err=acc["err"], max_abs_err_f32=acc["err32"], ms=acc["ms"],
                        device_ms=acc["device_ms"], plain_ms=acc["plain_ms"],
                        bound_ms=acc["bound_ms"], bound_by=by, library_ms=acc["library_ms"],
                        library_device_ms=acc["library_device_ms"],
                        library_norm_device_ms=acc["library_norm_device_ms"], per=per))
    return out


# ---------------------------------------------------------------- phase 2: K3

# (token grid, heads, C, depth) of each Video Swin-S stage at 32 frames of
# 224: patch (2,4,4), window (8,7,7), 392 tokens per window
SWIN3D_STAGES = [((16, 56, 56), 3, 96, 2), ((16, 28, 28), 6, 192, 2),
                 ((16, 14, 14), 12, 384, 18), ((16, 7, 7), 24, 768, 2)]
N3 = 392
# the same of Video Swin-B at Something-Something v2's window (16,7,7) on 32
# frames (Liu et al. 2022, configs/recognition/swin/
# swin_base_patch244_window1677_sthv2.py: embed 128, heads 4/8/16/32, depths
# 2/2/18/2): the 16 temporal tokens fill the window, so its temporal shift
# clamps to 0; 784 tokens per window in every stage, stage 3 one unshifted
# window a clip
SWIN3D_B16_STAGES = [((16, 56, 56), 4, 128, 2), ((16, 28, 28), 8, 256, 2),
                     ((16, 14, 14), 16, 512, 18), ((16, 7, 7), 32, 1024, 2)]
WINDOW_B16 = (16, 7, 7)
N3_B16 = 784


def k3_check(got, want, what: str):
    """Max abs error of K3 against its plain version, held to 1e-5 in f32
    and to two bf16 ulps of the largest |output| in bf16."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    if want.dtype == torch.float32:
        tol = 1e-5
    else:
        tol = 2.0 * 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)
    if not (math.isfinite(err) and err <= tol):
        fail(f"K3 {what}: max abs err {err:.3e} > {tol:.3e}")
    return err, tol


def k3_flops_bytes(B_, H, C, n_masks, elt, mask_elt, n=N3):
    """q, k, v read and out written once, the f32 bias and the mask read once."""
    flops = 4.0 * B_ * H * n * n * (C // H)
    nbytes = 4.0 * B_ * n * C * elt + 4.0 * H * n * n + mask_elt * n_masks * n * n
    return flops, nbytes


# special-function (ex2) throughput of the H100 SXM: ~3.9 T/s (FlashAttention-3,
# Shah et al. 2024, section 3); an assumed rate, not measured here, so the floor
# it gives stays out of the kernels line
EXP_PER_S = 3.9e12


def k3_l2_bytes(B_, H, n_masks, windows_per_block, n=N3):
    """What the bf16 design reads from L2 (and writes) in one launch: each
    block's bias (+ mask) tile, N rows of [N] f32 (+ bf16) over a group's
    query tiles; each (window, head, query tile) its K and V; each (window,
    head) its q and its out, 64 bytes a token. Against it, the first design
    (one block per (window, head)) read each head's bias and its window's
    mask once per (window, head). A model of the design, not a reading: no
    counter measures L2 here, so it stays out of the kernels line."""
    masked = n_masks > 0
    groups = (n_masks if masked else 1) * math.ceil(B_ // max(n_masks, 1) / windows_per_block)
    if n > 512:  # streamed: each window reads its own tile slices
        groups = B_
    q_tiles = math.ceil(n / 64)
    tiles = H * groups * n * n * (4 + 2 * masked)
    tokens = B_ * H * n * 64 * (2 * q_tiles + 2)
    first = B_ * H * (n * n * (4 + 2 * masked) + 4 * n * 64)
    return tiles + tokens, first


def sdpa_mask(bias, mask, B_, dtype):
    """bias [H, N, N] plus the window's mask, as one [B_, H, N, N] attn_mask."""
    H, N, _ = bias.shape
    am = bias[None].to(dtype)
    if mask is None:
        return am
    nW = mask.shape[0]
    am = am.view(1, 1, H, N, N) + mask.to(dtype).view(1, nW, 1, N, N)
    return am.expand(B_ // nW, nW, H, N, N).reshape(B_, H, N, N)


def phase_k3(dev, gen, batch: int, report, stages=SWIN3D_STAGES, window=(8, 7, 7), n=N3,
             b1: bool = True, label: str = "Video Swin-S"):
    """K3 at the four stage shapes (``stages``, ``window``: Video Swin-S's
    by default), shifted and not, of a b8 and (``b1``) a b1 request; the
    kernel line's numbers are per b8 request, with b1's beside them."""
    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size
    from deepfake_tpu_torch.ops import window_attn3d_kernel as k3

    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms",
            "flops", "bytes", "l2_bytes", "l2_bytes_first", "exp_floor_ms")
    per_batch = {b: dict.fromkeys(keys, 0.0) for b in ((batch, 1) if b1 else (batch,))}
    errs = {"float32": 0.0, "bfloat16": 0.0}
    shift = tuple(w // 2 for w in window)
    for b_req, acc in per_batch.items():
        for grid, H, C, depth in stages:
            ws, ss = get_window_size(grid, window, shift)
            nW = math.prod(n // w for n, w in zip(grid, ws))
            B_ = b_req * nW
            # the model's shift mask buffer: bf16, [nW, N, N]
            mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
            for mask, count in ((None, (depth + 1) // 2), (mask3, depth // 2)):
                name = (f"b{b_req} N={n} stage {grid} B_={B_} H={H} C={C}"
                        + (" shifted" if mask is not None else ""))
                scale = (C // H) ** -0.5
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).split(".")[1]
                    qkv = torch.randn(B_, n, 3 * C, generator=gen, device=dev).to(dtype)
                    # large enough that a wrong bias or mask index moves the
                    # output well past the tolerance
                    bias = 0.5 * torch.randn(H, n, n, generator=gen, device=dev)
                    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
                    kw = dict(num_heads=H, bias=bias, mask=mask, scale=scale)
                    run = lambda: k3.window_attn3d_tokens(q, k, v, **kw)
                    plain = lambda: k3.window_attn3d_tokens_plain(q, k, v, **kw)
                    got = run()
                    torch.cuda.synchronize()
                    err, tol = k3_check(got, plain(), f"tokens {name} {dname}")
                    errs[dname] = max(errs[dname], err)
                    row = dict(kernel="window_attn3d_tokens", case=name, dtype=dname,
                               max_abs_err=err, tol=tol, blocks_per_request=count)
                    if dtype == torch.bfloat16:
                        # events time back-to-back calls, which at b1 also
                        # counts the host's ~30-40 us a call; the profiler's
                        # device time does not
                        ms = cuda_time_ms(run, iters=10)
                        dms = device_time_ms(run)
                        pms = cuda_time_ms(plain, iters=3)
                        hq, hk, hv = (t.reshape(B_, n, H, C // H).transpose(1, 2).contiguous()
                                      for t in (q, k, v))
                        am = sdpa_mask(bias, mask, B_, dtype)
                        sdpa = lambda: F.scaled_dot_product_attention(
                            hq, hk, hv, attn_mask=am, scale=scale)
                        lib = cuda_time_ms(sdpa, iters=10)
                        lib_dms = device_time_ms(sdpa)
                        del hq, hk, hv, am, sdpa
                        n_masks = 0 if mask is None else mask.shape[0]
                        flops, nbytes = k3_flops_bytes(B_, H, C, n_masks, 2, 2, n)
                        b, by = bound_ms(flops, nbytes, dname)
                        g = k3.windows_per_block(B_, H, n, max(n_masks, 1), mask is not None)
                        l2, l2_first = k3_l2_bytes(B_, H, n_masks, g, n)
                        floor = B_ * H * n * n / EXP_PER_S * 1e3
                        row.update(ms=ms, device_ms=dms, plain_ms=pms, library_ms=lib,
                                   library_device_ms=lib_dms, bound_ms=b, bound_by=by,
                                   gflop=flops / 1e9, mbytes=nbytes / 1e6, windows_per_block=g,
                                   # not measured: the design's count and an
                                   # assumed exp rate, beside the measured ms
                                   l2_mbytes_model=l2 / 1e6,
                                   l2_mbytes_model_first=l2_first / 1e6,
                                   exp_floor_ms_assumed_rate=floor)
                        log(f"K3 tokens {name:51s} {dname} kernel_ms={ms:.4f} device_ms={dms:.4f} "
                            f"plain_ms={pms:.4f} library_ms={lib:.4f} (device {lib_dms:.4f}) "
                            f"bound_ms={b:.4f} ({by}) err={err:.2e} (tol {tol:.2e}); "
                            f"not measured: exp_floor_ms at an assumed 3.9 T/s={floor:.4f} "
                            f"G={g} modelled l2_MB={l2 / 1e6:.1f} (first design "
                            f"{l2_first / 1e6:.1f})")
                        for key, val in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                                         ("library_ms", lib), ("library_device_ms", lib_dms),
                                         ("bound_ms", b), ("flops", flops), ("bytes", nbytes),
                                         ("l2_bytes", l2), ("l2_bytes_first", l2_first),
                                         ("exp_floor_ms", floor)):
                            acc[key] += count * val
                    else:
                        row["ms"] = cuda_time_ms(run, iters=3)
                        log(f"K3 tokens {name:51s} {dname} kernel_ms={row['ms']:.4f} "
                            f"err={err:.2e} (tol {tol:.0e})")
                    report["k3"].append(row)
                    del qkv, bias, q, k, v, got
                torch.cuda.empty_cache()

    k3.window_attn3d_tokens.launches = 0
    acc = per_batch[batch]
    _, by = bound_ms(acc["flops"], acc["bytes"], "bfloat16")
    for b_req, a in per_batch.items():
        log(f"K3 N={n} per b{b_req} request: kernel_ms={a['ms']:.4f} "
            f"device_ms={a['device_ms']:.4f} "
            f"library_ms={a['library_ms']:.4f} (device {a['library_device_ms']:.4f}) "
            f"plain_ms={a['plain_ms']:.4f} bound_ms={a['bound_ms']:.4f}; not measured: "
            f"exp_floor_ms at an assumed 3.9 T/s={a['exp_floor_ms']:.4f} modelled l2_GB="
            f"{a['l2_bytes'] / 1e9:.3f} (first design {a['l2_bytes_first'] / 1e9:.3f})")
    row = dict(name="window_attn3d_tokens (K3)" + (f" N={n}" if n != N3 else ""), route="cuda",
               source=K3_SRC, replaces=K3_TOK_REPLACES, launches=None,
               max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"], ms=acc["ms"],
               plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"], bound_by=by,
               library_ms=acc["library_ms"], device_ms=acc["device_ms"],
               library_device_ms=acc["library_device_ms"],
               per=f"one video_swin b{batch} request" + (" (b1 in the _b1 keys)" if b1 else "")
                   + f": 24 {label} blocks at window {window}, bf16")
    if b1:
        acc1 = per_batch[1]
        row.update(ms_b1=acc1["ms"], device_ms_b1=acc1["device_ms"],
                   plain_ms_b1=acc1["plain_ms"], library_ms_b1=acc1["library_ms"],
                   library_device_ms_b1=acc1["library_device_ms"], bound_ms_b1=acc1["bound_ms"])
    return row


# ---------------------------------------------------------------- phase 2: K4

# K4's linear layers of the attention half of a Swin3D block at channel width
# C: (role, K / C, N / C, options); the MLP half is mlp_tail's
K4_ROLES = [("LN1 + qkv", 1, 3, dict(ln=True)), ("proj", 1, 1, {})]


def k4_check(got, want, what: str):
    """Max abs error of K4 against its plain version, held to 1e-5 of
    max(|plain|, 1) in f32 and to two bf16 ulps of the largest |output| in
    bf16."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    big = want.float().abs().max().item()
    if want.dtype == torch.float32:
        tol = 1e-5 * max(big, 1.0)
    else:
        tol = 2.0 * 2.0 ** (math.floor(math.log2(big)) - 7)
    if not (math.isfinite(err) and err <= tol):
        fail(f"K4 {what}: max abs err {err:.3e} > {tol:.3e}")
    return err, tol


def k4_launches(cfg):
    """(ln_linear, mlp_tail) launches of one bf16 video_swin request: LN1 +
    qkv and proj in every block; the MLP tail as one mlp_tail launch at the
    widths it takes, else as two ln_linear launches (fc1, fc2)."""
    from deepfake_tpu_torch.ops.ln_linear_kernel import MLP_TAIL_WIDTHS

    m = cfg.model
    fused = sum(d for i, d in enumerate(m.swin3d_depths)
                if m.swin3d_embed_dim * 2 ** i in MLP_TAIL_WIDTHS)
    blocks = sum(m.swin3d_depths)
    return 2 * blocks + 2 * (blocks - fused), fused


def phase_k4(dev, gen, batch: int, report, stages=SWIN3D_STAGES):
    """K4 at the four stage shapes of a video_swin b8 request: LN1 + qkv and
    proj (ln_linear), and the MLP tail (mlp_tail: one launch at C <= 384,
    fc1 and fc2 launches at 768), f32 and bf16. Bounds count each function's
    own inputs and output (the MLP tail's hidden tensor stays on chip);
    library_ms is F.linear on the same products."""
    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.ops.ln_linear_kernel import (
        ln_linear, ln_linear_plain, mlp_tail, mlp_tail_plain,
    )

    acc = {part: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
                  "bytes": 0.0} for part in ("attn", "mlp")}
    errs = {(part, d): 0.0 for part in ("attn", "mlp") for d in ("float32", "bfloat16")}
    for grid, H, C, depth in stages:
        M = batch * math.prod(grid)
        for role, kf, nf, opt in K4_ROLES + [("MLP tail", 1, 1, dict(mlp=True))]:
            K, N = kf * C, nf * C
            part = "mlp" if opt.get("mlp") else "attn"
            name = f"C={C} {role} [{M}x{K}] -> {N}"
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]

                def rnd(*shape, sc=1.0):
                    return (sc * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

                x = rnd(M, K)
                if part == "mlp":
                    h = rnd(M, C)
                    args = ((1 + rnd(C, sc=0.2), rnd(C, sc=0.5), 1e-6), rnd(4 * C, C, sc=C ** -0.5),
                            rnd(4 * C, sc=0.5), rnd(C, 4 * C, sc=(4 * C) ** -0.5), rnd(C, sc=0.5))
                    run = lambda: mlp_tail(x, h, *args)
                    plain = lambda: mlp_tail_plain(x, h, *args)
                    w1, b1, w2, b2 = args[1:]
                    lib_fn = lambda: F.linear(F.linear(x, w1, b1), w2, b2)
                    flops = 2.0 * M * C * 4 * C * 2
                    nbytes = 2.0 * (3 * M * C + 8 * C * C + 4 * C + 3 * C)
                else:
                    w, b = rnd(N, K, sc=K ** -0.5), rnd(N, sc=0.5)
                    kw = {}
                    if opt.get("ln"):
                        kw["ln"] = (1 + rnd(K, sc=0.2), rnd(K, sc=0.5), 1e-6)
                    run = lambda: ln_linear(x, w, b, **kw)
                    plain = lambda: ln_linear_plain(x, w, b, **kw)
                    lib_fn = lambda: F.linear(x, w, b)
                    flops = 2.0 * M * K * N
                    nbytes = 2.0 * (M * K + N * K + N + (2 * K if opt.get("ln") else 0) + M * N)
                before = ln_linear.launches, mlp_tail.launches
                got = run()
                torch.cuda.synchronize()
                ran = (ln_linear.launches - before[0], mlp_tail.launches - before[1])
                err, tol = k4_check(got, plain(), f"{name} {dname}")
                errs[part, dname] = max(errs[part, dname], err)
                row = dict(kernel="mlp_tail" if part == "mlp" else "ln_linear", case=name,
                           dtype=dname, max_abs_err=err, tol=tol, blocks_per_request=depth,
                           launches_ln_linear_mlp_tail=list(ran))
                if dtype == torch.bfloat16:
                    ms = cuda_time_ms(run, iters=10)
                    pms = cuda_time_ms(plain, iters=3)
                    lib = cuda_time_ms(lib_fn, iters=10)
                    bnd, by = bound_ms(flops, nbytes, dname)
                    row.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=bnd, bound_by=by,
                               gflop=flops / 1e9, mbytes=nbytes / 1e6)
                    log(f"K4 {name:46s} {dname} kernel_ms={ms:.4f} plain_ms={pms:.4f} "
                        f"F.linear_ms={lib:.4f} bound_ms={bnd:.4f} ({by}) err={err:.2e} "
                        f"(tol {tol:.2e}) launches (ln_linear, mlp_tail)={ran}")
                    for key, val in (("ms", ms), ("plain_ms", pms), ("library_ms", lib),
                                     ("bound_ms", bnd), ("flops", flops), ("bytes", nbytes)):
                        acc[part][key] += depth * val
                else:
                    row["ms"] = cuda_time_ms(run, iters=3)
                    log(f"K4 {name:46s} {dname} kernel_ms={row['ms']:.4f} err={err:.2e} "
                        f"(tol {tol:.2e}) launches (ln_linear, mlp_tail)={ran}")
                report["k4"].append(row)
                del x, got
            torch.cuda.empty_cache()
    ln_linear.launches = mlp_tail.launches = 0
    rows = []
    for part, name, rep, per in (
            ("attn", "ln_linear (K4: LN1 + qkv, proj)", K4_QKV_REPLACES,
             "one video_swin b8 request: LN1 + qkv and proj in each of 24 Video Swin-S blocks, "
             "bf16; its launches also count stage 3's fc1 and fc2 (the MLP tail at C = 768); "
             "library_ms is F.linear, the product and bias alone"),
            ("mlp", "mlp_tail (K4: the MLP tail in one launch)", K4_MLP_REPLACES,
             "one video_swin b8 request: the MLP tail of 24 Video Swin-S blocks (one mlp_tail "
             "launch each at C <= 384, fc1 and fc2 ln_linear launches at 768), bf16; the bound "
             "counts the function's own inputs and output, the hidden tensor on chip; "
             "library_ms is F.linear on fc1 and fc2")):
        a = acc[part]
        _, by = bound_ms(a["flops"], a["bytes"], "bfloat16")
        rows.append(dict(name=name, route="cuda", source=K4_SRC, replaces=rep, launches=None,
                         max_abs_err=errs[part, "bfloat16"],
                         max_abs_err_f32=errs[part, "float32"], ms=a["ms"],
                         plain_ms=a["plain_ms"], bound_ms=a["bound_ms"], bound_by=by,
                         library_ms=a["library_ms"], per=per))
    return rows


# ---------------------------------------------------------------- phase 2: K5

def k5_check(got, want, what: str, dbias: bool = False):
    """Max abs error of K5 against its plain version: f32 1e-5 of
    max(|plain|, 1); bf16 two bf16 ulps of the largest |output| for out, dq,
    dk, dv, and 1e-2 of the largest |value| for the f32 dbias."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    big = want.float().abs().max().item()
    if dbias:
        tol = 1e-2 * big
    elif want.dtype == torch.float32:
        tol = 1e-5 * max(big, 1.0)
    else:
        tol = 2.0 * 2.0 ** (math.floor(math.log2(big)) - 7)
    if not (math.isfinite(err) and err <= tol):
        fail(f"K5 {what}: max abs err {err:.3e} > {tol:.3e}")
    return err, tol


def k5_flops_bytes(B_, H, C, n_masks, n=N3):
    """bf16; forward: q, k, v in, out written, the f32 bias and the bf16 mask
    read, 4 B_ H N^2 D operations. Backward: q, k, v, dO in, dq, dk, dv
    out, the bias (bf16, its cast point) and mask read, the f32 dbias
    written, 10 B_ H N^2 D operations (S, dP, dV, dQ, dK)."""
    tok = B_ * n * C * 2.0
    nn_ = n * n
    fwd = (4.0 * B_ * H * nn_ * (C // H), 4 * tok + 4.0 * H * nn_ + 2.0 * n_masks * nn_)
    bwd = (10.0 * B_ * H * nn_ * (C // H),
           7 * tok + 2.0 * H * nn_ + 2.0 * n_masks * nn_ + 4.0 * H * nn_)
    return fwd, bwd


def k5_cases_3d(dev, batch: int, stages=SWIN3D_STAGES, window=(8, 7, 7), n=N3):
    """(name, B_, H, C, mask, blocks) of a b``batch`` Video Swin training
    micro-batch's K5 calls: each stage's unshifted and shifted blocks."""
    import torch

    from deepfake_tpu_torch.models.swin3d import compute_mask_3d, get_window_size

    cases = []
    for grid, H, C, depth in stages:
        ws, ss = get_window_size(grid, window, tuple(w // 2 for w in window))
        nW = math.prod(n // w for n, w in zip(grid, ws))
        B_ = batch * nW
        mask3 = torch.from_numpy(compute_mask_3d(*grid, ws, ss)).to(dev, torch.bfloat16)
        for mask, count in ((None, (depth + 1) // 2), (mask3, depth // 2)):
            cases.append((f"N={n} stage {grid} B_={B_} H={H} C={C}"
                          + (" shifted" if mask is not None else ""), B_, H, C, mask, count))
    return cases


def k5_cases_swinv2(dev, batch: int, window: int = 7):
    """The same for SwinV2-B's 24 blocks at 224^2 (window 7, N = 49): stage 3
    (7^2 tokens) is one unshifted window a clip."""
    import torch

    from deepfake_tpu_torch.models.swin2d import shift_attn_mask

    cases = []
    for res, H, C, depth in SWIN_B_STAGES:
        B_ = batch * (res // window) ** 2
        shifted = res > window
        mask = (torch.from_numpy(shift_attn_mask(res, res, window, window // 2)).to(
            dev, torch.bfloat16) if shifted else None)
        for m, count in ((None, (depth + 1) // 2 if shifted else depth),
                         (mask, depth // 2 if shifted else 0)):
            if count:
                cases.append((f"N={window * window} stage {res}^2 B_={B_} H={H} C={C}"
                              + (" shifted" if m is not None else ""), B_, H, C, m, count))
    return cases


def k5_inputs(gen, dev, B_, n, H, C, dtype, cosine: bool):
    """qkv, dout and the bias of one K5 case. ``cosine``: what SwinV2's
    training route hands K5 (swin2d.py:195-222): q^ times per-head scales
    exp(ln 10 +- 0.3 N(0,1)) clamped at 100, k^ unit rows per head, the
    16 sigmoid bias, scale 1; else Video Swin's N(0,1) q, k, v at D^-0.5."""
    import torch

    D = C // H
    if not cosine:
        qkv = torch.randn(B_, n, 3 * C, generator=gen, device=dev).to(dtype)
        bias = 0.5 * torch.randn(H, n, n, generator=gen, device=dev)
        scale = D ** -0.5
    else:
        unit = lambda t: torch.nn.functional.normalize(t.view(B_, n, H, D), dim=-1)
        ls = torch.exp(torch.clamp(math.log(10.0) + 0.3 * torch.randn(
            H, 1, generator=gen, device=dev), max=math.log(100.0)))
        q = unit(torch.randn(B_, n, C, generator=gen, device=dev)) * ls
        k = unit(torch.randn(B_, n, C, generator=gen, device=dev))
        v = torch.randn(B_, n, C, generator=gen, device=dev)
        qkv = torch.cat([q.reshape(B_, n, C), k.reshape(B_, n, C), v], -1).to(dtype)
        bias = 16 * torch.sigmoid(torch.randn(H, n, n, generator=gen, device=dev))
        scale = 1.0
    dout = torch.randn(B_, n, C, generator=gen, device=dev).to(dtype)
    return qkv, dout, bias, scale


def phase_k5(dev, gen, batch: int, report, stages=SWIN3D_STAGES, window=(8, 7, 7), n=N3,
             label: str = "Video Swin-S", cases=None, cosine: bool = False,
             path: str = "video_swin"):
    """K5's forward and backward at the four stage shapes of a b8 training
    micro-batch (Video Swin-S's by default), shifted and not; ``cases``
    (k5_cases_swinv2) replaces the stages, ``cosine`` the inputs."""
    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.ops import window_attn3d_train as k5

    acc = {d: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "library_device_ms": 0.0, "flops": 0.0, "bytes": 0.0} for d in ("fwd", "bwd")}
    acc["bwd"].update(device_ms_launch1=0.0, device_ms_launch2=0.0, device_ms_sum_parts=0.0,
                      workspace_bytes=0)
    errs = {(d, t): 0.0 for d in ("fwd", "bwd") for t in ("float32", "bfloat16")}
    if cases is None:
        cases = k5_cases_3d(dev, batch, stages, window, n)
    for name, B_, H, C, mask, count in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            qkv, dout, bias, scale = k5_inputs(gen, dev, B_, n, H, C, dtype, cosine)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            kw = dict(num_heads=H, bias=bias, mask=mask, scale=scale)
            run_f = lambda: k5.window_attn3d_train_fwd(qkv, **kw)
            run_b = lambda: k5.window_attn3d_train_bwd(qkv, dout, **kw)
            plain_f = lambda: k5.window_attn3d_train_fwd_plain(q, k, v, **kw)
            plain_b = lambda: k5.window_attn3d_train_bwd_plain(q, k, v, dout, **kw)
            out = run_f()
            dqkv, dbias = run_b()
            if dtype == torch.bfloat16:  # dbias is summed in a fixed order: the same bits
                again = run_b()
                if not (torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)):
                    fail(f"K5 bwd {name}: two launches on the same inputs differ")
                del again
            torch.cuda.synchronize()
            e_f, _ = k5_check(out, plain_f(), f"fwd {name} {dname}")
            want = plain_b()
            e_b = max(k5_check(a, b, f"bwd {n} {name} {dname}",
                               dbias=n == "dbias" and dtype == torch.bfloat16)[0]
                      for n, a, b in zip(("dq", "dk", "dv", "dbias"),
                                         (*dqkv.split(C, dim=-1), dbias), want))
            del out, dqkv, dbias, want
            errs["fwd", dname] = max(errs["fwd", dname], e_f)
            errs["bwd", dname] = max(errs["bwd", dname], e_b)
            row = dict(kernel="window_attn3d_train", case=name, dtype=dname,
                       max_abs_err_fwd=e_f, max_abs_err_bwd=e_b, blocks_per_microbatch=count)
            if dtype == torch.bfloat16:
                ms_f, ms_b = cuda_time_ms(run_f, iters=10), cuda_time_ms(run_b, iters=10)
                dms_f = device_time_ms(run_f)
                # the backward's device time by launch: launch 1 (dq,
                # dbias) and launch 2 (dk, dv), streamed above 512
                # tokens; the rest is the wrapper's copies and zero fills
                by_name = device_kernel_ms(run_b)
                dms_b = sum(by_name.values())
                l1 = sum(v for k, v in by_name.items() if "dq_bf16" in k or "dq_stream" in k)
                l2 = sum(v for k, v in by_name.items()
                         if "dkdv_bf16" in k or "dkdv_stream" in k)
                l3 = sum(v for k, v in by_name.items() if "sum_parts" in k)
                if not (l1 > 0 and l2 > 0 and l3 > 0):
                    fail(f"K5 bwd {name}: the profile shows no launch 1, 2 or sum_parts: "
                         f"{by_name}")
                # the dS partial sums: a slot for each block of a (head, query tile)
                n_masks = 0 if mask is None else mask.shape[0]
                parts = k5._lib().k5_bwd_parts(1, B_, H, n, C // H, max(n_masks, 1),
                                               mask is not None, k5._group(
                                                   qkv, H, n, max(n_masks, 1), mask is not None))
                ws = parts * H * n * n * 4
                pms_f, pms_b = cuda_time_ms(plain_f, iters=3), cuda_time_ms(plain_b, iters=3)
                # SDPA forward, and its backward alone, with bias + mask as one
                # grad-requiring [B_, H, N, N] attn_mask
                hq, hk, hv = (t.reshape(B_, n, H, C // H).transpose(1, 2).contiguous()
                              .requires_grad_() for t in (q, k, v))
                am = sdpa_mask(bias, mask, B_, dtype).contiguous().requires_grad_()
                sdpa = lambda: F.scaled_dot_product_attention(hq, hk, hv, attn_mask=am,
                                                              scale=kw["scale"])
                lib_f = cuda_time_ms(sdpa, iters=10)
                lib_dms_f = device_time_ms(sdpa)
                o = sdpa()
                do_h = dout.reshape(B_, n, H, C // H).transpose(1, 2).contiguous()
                sdpa_b = lambda: torch.autograd.grad(o, (hq, hk, hv, am), do_h,
                                                     retain_graph=True)
                lib_b = cuda_time_ms(sdpa_b, iters=10)
                lib_dms_b = device_time_ms(sdpa_b)
                del hq, hk, hv, am, o, do_h, sdpa_b
                for d, ms, dms, pms, lib, lib_dms, (flops, nbytes) in (
                        ("fwd", ms_f, dms_f, pms_f, lib_f, lib_dms_f,
                         k5_flops_bytes(B_, H, C, n_masks, n)[0]),
                        ("bwd", ms_b, dms_b, pms_b, lib_b, lib_dms_b,
                         k5_flops_bytes(B_, H, C, n_masks, n)[1])):
                    b, by = bound_ms(flops, nbytes, dname)
                    row[d] = dict(ms=ms, device_ms=dms, plain_ms=pms, library_ms=lib,
                                  library_device_ms=lib_dms, bound_ms=b, bound_by=by,
                                  gflop=flops / 1e9, mbytes=nbytes / 1e6)
                    split = (f" (launch 1 {l1:.4f}, launch 2 {l2:.4f})" if d == "bwd"
                             else "")
                    log(f"K5 {d} {name:48s} {dname} kernel_ms={ms:.4f} device_ms={dms:.4f}"
                        f"{split} plain_ms={pms:.3f} sdpa_ms={lib:.4f} (device "
                        f"{lib_dms:.4f}) bound_ms={b:.4f} ({by})")
                    for key, val in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                                     ("library_ms", lib), ("library_device_ms", lib_dms),
                                     ("bound_ms", b), ("flops", flops), ("bytes", nbytes)):
                        acc[d][key] += count * val
                row["bwd"].update(device_ms_launch1=l1, device_ms_launch2=l2,
                                  device_ms_sum_parts=l3, workspace_bytes=ws, dbias_repeats=True)
                acc["bwd"]["device_ms_launch1"] += count * l1
                acc["bwd"]["device_ms_launch2"] += count * l2
                acc["bwd"]["device_ms_sum_parts"] += count * l3
                acc["bwd"]["workspace_bytes"] = max(acc["bwd"]["workspace_bytes"], ws)
                log(f"K5 {name:52s} {dname} err fwd={e_f:.2e} bwd={e_b:.2e}")
            else:
                row["ms_fwd"] = cuda_time_ms(run_f, iters=3)
                row["ms_bwd"] = cuda_time_ms(run_b, iters=3)
                log(f"K5 {name:52s} {dname} fwd_ms={row['ms_fwd']:.4f} "
                    f"bwd_ms={row['ms_bwd']:.4f} err fwd={e_f:.2e} bwd={e_b:.2e}")
            report["k5"].append(row)
            del qkv, dout, bias, q, k, v
        torch.cuda.empty_cache()
    k5.window_attn3d_train_fwd.launches = 0
    k5.window_attn3d_train_bwd.launches = 0
    rows = []
    for d, rep, what in (("fwd", K5_FWD_REPLACES, "forward"), ("bwd", K5_BWD_REPLACES, "backward")):
        a = acc[d]
        _, by = bound_ms(a["flops"], a["bytes"], "bfloat16")
        row = dict(
            name=f"window_attn3d_train_{d} (K5)" + (f" N={n}" if n != N3 else ""), route="cuda",
            source=K5_SRC, replaces=rep,
            launches=None, max_abs_err=errs[d, "bfloat16"], max_abs_err_f32=errs[d, "float32"],
            ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"], bound_by=by,
            library_ms=a["library_ms"], device_ms=a["device_ms"],
            library_device_ms=a["library_device_ms"],
            per=f"one {path} b8 training micro-batch: the {what} of 24 {label} blocks at "
                f"window {window}, bf16; library_ms is SDPA's " + what + " with bias + mask as a "
                "grad-requiring attn_mask")
        if d == "bwd":
            row.update(device_ms_launch1=a["device_ms_launch1"],
                       device_ms_launch2=a["device_ms_launch2"],
                       device_ms_sum_parts=a["device_ms_sum_parts"],
                       workspace_bytes_largest=a["workspace_bytes"], dbias_repeats=True)
        log(f"K5 N={n} {what} per b8 micro-batch: kernel_ms={a['ms']:.4f} "
            f"device_ms={a['device_ms']:.4f}"
            + (f" (launch 1 {a['device_ms_launch1']:.4f}, launch 2 {a['device_ms_launch2']:.4f}, "
               f"sum_parts {a['device_ms_sum_parts']:.4f}; largest dS workspace "
               f"{a['workspace_bytes'] / 2 ** 20:.1f} MiB; dbias repeats to the bit)"
               if d == "bwd" else "")
            + f" plain_ms={a['plain_ms']:.4f} sdpa_ms={a['library_ms']:.4f} (device "
            f"{a['library_device_ms']:.4f}) bound_ms={a['bound_ms']:.4f}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------- phase 2: head dims

# every kernel of window attention takes head dims 1-128; 12, 20 and 36
# (not multiples of 8) take the mma.sync kernels' element-by-element loads
HEAD_DIMS = (12, 16, 20, 36, 48, 64, 128)
# Video Swin-L (Liu et al. 2022, configs/recognition/swin/
# swin_large_patch244_window877_kinetics400_22k.py: embed 192, heads
# 6/12/24/48, depths 2/2/18/2, window (8,7,7)) at 32 frames of 224: stage 3
# at C = 1536, where rows no longer fit K4's LayerNorm panel
SWIN3D_L_STAGE3 = [((16, 7, 7), 48, 1536, 2)]
SWIN_L = "swin_large_patch244_window877"  # the port's preset of that config


def phase_head_dims(dev, gen, batch: int, report):
    """K2, K3, K5 (forward and backward) and K6 at head dims 12, 16, 20,
    36, 48, 64 and 128, f32 and bf16, each at one shape of its path with the head dim
    changed: K3 and K5 at Video Swin-S's stage-0 windows of a b8 clip batch
    (1024 shifted windows of N = 392, 3 heads), K2 at SwinV2-B's stage 0 at
    224 (512 shifted windows of N = 49, 4 heads, cosine), K6 at SwinV2-B's
    stage 0 at window 16, 256^2 (128 shifted windows of N = 256, 4 heads,
    cosine). Each against its plain version in the tolerance of D = 32;
    bf16 timed beside its plain version, SDPA on the same bias + mask and
    its bound. Returns {kernel: [rows]}, which main attaches to the
    kernels line's entries as "head_dims"."""
    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.models.swin2d import shift_attn_mask
    from deepfake_tpu_torch.models.swin3d import compute_mask_3d
    from deepfake_tpu_torch.ops import window_attn3d_kernel as k3
    from deepfake_tpu_torch.ops import window_attn3d_train as k5
    from deepfake_tpu_torch.ops import window_attn_kernel as k2
    from deepfake_tpu_torch.ops import window_attn_multihead as k6
    from deepfake_tpu_torch.ops.window_attn import l2_normalize

    out = {"k2": [], "k3": [], "k5_fwd": [], "k5_bwd": [], "k6": []}
    mask3 = torch.from_numpy(compute_mask_3d(16, 56, 56, (8, 7, 7), (4, 3, 3))).to(dev)
    B3, H3, n3 = batch * mask3.shape[0], 3, N3
    mask2 = torch.from_numpy(shift_attn_mask(56, 56, 7, 3)).to(dev)
    B2, H2 = batch * mask2.shape[0], 4
    mask6 = torch.from_numpy(shift_attn_mask(64, 64, 16, 8)).to(dev)
    B6, H6, n6 = batch * mask6.shape[0], 4, N6

    def record(key, what, D, ms, pms, lib, flops, nbytes, err, err32):
        b, by = bound_ms(flops, nbytes, "bfloat16")
        row = dict(head_dim=D, case=what, ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b,
                   bound_by=by, max_abs_err=err, max_abs_err_f32=err32)
        out[key].append(row)
        report.setdefault("head_dims", []).append(dict(row, kernel=key))
        log(f"head dim {D:3d} {key:6s} {what}: kernel_ms={ms:.4f} plain_ms={pms:.4f} "
            f"sdpa_ms={lib:.4f} bound_ms={b:.4f} ({by}) err={err:.2e} (f32 {err32:.2e})")

    for D in HEAD_DIMS:
        errs = collections.defaultdict(float)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            timed = dtype == torch.bfloat16
            # K3 and K5 at Video Swin's stage-0 windows
            C = H3 * D
            qkv = torch.randn(B3, n3, 3 * C, generator=gen, device=dev).to(dtype)
            dout = torch.randn(B3, n3, C, generator=gen, device=dev).to(dtype)
            bias = 0.5 * torch.randn(H3, n3, n3, generator=gen, device=dev)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            kw3 = dict(num_heads=H3, bias=bias, mask=mask3.to(torch.bfloat16), scale=D ** -0.5)
            run3 = lambda: k3.window_attn3d_tokens(q, k, v, **kw3)
            plain3 = lambda: k3.window_attn3d_tokens_plain(q, k, v, **kw3)
            errs["k3", dname] = k3_check(run3(), plain3(), f"D={D} {dname}")[0]
            run_f = lambda: k5.window_attn3d_train_fwd(qkv, **kw3)
            run_b = lambda: k5.window_attn3d_train_bwd(qkv, dout, **kw3)
            plain_f = lambda: k5.window_attn3d_train_fwd_plain(q, k, v, **kw3)
            plain_b = lambda: k5.window_attn3d_train_bwd_plain(q, k, v, dout, **kw3)
            errs["k5_fwd", dname] = k5_check(run_f(), plain_f(), f"fwd D={D} {dname}")[0]
            dqkv, dbias = run_b()
            errs["k5_bwd", dname] = max(
                k5_check(a, w, f"bwd {name} D={D} {dname}", dbias=name == "dbias" and timed)[0]
                for name, a, w in zip(("dq", "dk", "dv", "dbias"),
                                      (*dqkv.split(C, dim=-1), dbias), plain_b()))
            del dqkv, dbias
            if timed:
                hq, hk, hv = (t.reshape(B3, n3, H3, D).transpose(1, 2).contiguous()
                              .requires_grad_() for t in (q, k, v))
                am = sdpa_mask(bias, kw3["mask"], B3, dtype).contiguous().requires_grad_()
                sdpa = lambda: F.scaled_dot_product_attention(hq, hk, hv, attn_mask=am,
                                                              scale=D ** -0.5)
                o = sdpa()
                do_h = dout.reshape(B3, n3, H3, D).transpose(1, 2).contiguous()
                sdpa_b = lambda: torch.autograd.grad(o, (hq, hk, hv, am), do_h, retain_graph=True)
                lib_f, lib_b = cuda_time_ms(sdpa, iters=5), cuda_time_ms(sdpa_b, iters=5)
                fb3 = k3_flops_bytes(B3, H3, C, mask3.shape[0], 2, 2, n3)
                fwd5, bwd5 = k5_flops_bytes(B3, H3, C, mask3.shape[0], n3)
                what = f"stage 0 [{B3}, {n3}, {H3}x{D}] shifted"
                record("k3", what, D, cuda_time_ms(run3), cuda_time_ms(plain3, iters=2), lib_f,
                       *fb3, errs["k3", dname], errs["k3", "float32"])
                record("k5_fwd", what, D, cuda_time_ms(run_f), cuda_time_ms(plain_f, iters=2),
                       lib_f, *fwd5, errs["k5_fwd", dname], errs["k5_fwd", "float32"])
                record("k5_bwd", what, D, cuda_time_ms(run_b), cuda_time_ms(plain_b, iters=2),
                       lib_b, *bwd5, errs["k5_bwd", dname], errs["k5_bwd", "float32"])
                del hq, hk, hv, am, o, do_h
            del qkv, dout, bias, q, k, v
            torch.cuda.empty_cache()
            # K2 (token-major, N = 49) and K6 (head-major views, N = 256), cosine
            for key, B_, H, n, mask in (("k2", B2, H2, 49, mask2), ("k6", B6, H6, n6, mask6)):
                C = H * D
                qkv = torch.randn(B_, n, 3 * C, generator=gen, device=dev).to(dtype)
                bias = 16 * torch.sigmoid(torch.randn(H, n, n, generator=gen, device=dev))
                ls = torch.exp(torch.linspace(math.log(10.0), math.log(100.0), H,
                                              device=dev)).reshape(H, 1, 1)
                kw = dict(bias=bias, mask=mask, logit_scale=ls)
                hq, hk, hv = qkv.view(B_, n, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
                if key == "k2":
                    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
                    run = lambda: k2.window_attention_tokens(q, k, v, num_heads=H, **kw)
                    plain = lambda: k2.window_attention_tokens_plain(q, k, v, num_heads=H, **kw)
                    got, want = run(), plain()
                    err, rel = errors(got, want)
                    if not (math.isfinite(rel) and rel <= (2e-2 if timed else 1e-4)):
                        fail(f"K2 D={D} {dname}: max rel err {rel:.3e}")
                else:
                    run = lambda: k6.window_attention_multihead(hq, hk, hv, **kw)
                    plain = lambda: k2.window_attention_heads_plain(hq, hk, hv, **kw)
                    err = k6_check(run(), plain(), f"D={D} {dname}")[0]
                errs[key, dname] = err
                if timed:
                    am = sdpa_mask(bias, mask, B_, dtype)
                    qn = (l2_normalize(hq.float()) * ls).to(dtype)
                    kn = l2_normalize(hk.float()).to(dtype)
                    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                        qn, kn, hv, attn_mask=am, scale=1.0), iters=5)
                    fb = (k2_flops_bytes(B_, H, C, mask.shape[0], 2) if key == "k2"
                          else k6_flops_bytes(B_, H, C, n, mask.shape[0], 2))
                    record(key, f"stage 0 [{B_}, {n}, {H}x{D}] shifted, cosine", D,
                           cuda_time_ms(run), cuda_time_ms(plain, iters=2), lib, *fb,
                           errs[key, dname], errs[key, "float32"])
                    del am, qn, kn
                del qkv, bias, hq, hk, hv
                torch.cuda.empty_cache()
    for fn in (k3.window_attn3d_tokens, k5.window_attn3d_train_fwd, k5.window_attn3d_train_bwd,
               k2.window_attention_tokens, k6.window_attention_multihead):
        fn.launches = 0
    return out


# ---------------------------------------------------------------- phase 2: K6

# (resolution, heads, C, depth) of SwinV2-B's stages at window 16, 256^2:
# windows of 16 x 16 = 256 tokens in stages 0-2 (stage 2's 16^2 grid is one
# unshifted window); stage 3 (8^2, window 8) is K2's
SWIN_B_W16_STAGES = [(64, 4, 128, 2), (32, 8, 256, 2), (16, 16, 512, 18)]
N6 = 256


def k6_check(got, want, what: str):
    """Max abs error of K6 against its plain version: f32 1e-5 of
    max(|plain|, 1) (summation order, amplified by logit scales up to 100);
    bf16 two bf16 ulps of the largest |output| (the weights are rounded to
    bf16 for P V, and the output once)."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    big = want.float().abs().max().item()
    if want.dtype == torch.float32:
        tol = 1e-5 * max(big, 1.0)
    else:
        tol = 2.0 * 2.0 ** (math.floor(math.log2(big)) - 7)
    if not (math.isfinite(err) and err <= tol):
        fail(f"K6 {what}: max abs err {err:.3e} > {tol:.3e}")
    return err, tol


def k6_flops_bytes(B_, H, C, N, n_masks, elt):
    """q, k, v read and out written once, the f32 bias and the f32 masks
    read once; 4 B_ H N^2 D operations (Q K^T and P V)."""
    flops = 4.0 * B_ * H * N * N * (C // H)
    nbytes = 4.0 * B_ * N * C * elt + 4.0 * H * N * N + 4.0 * n_masks * N * N
    return flops, nbytes


def phase_k6(dev, gen, batch: int, report):
    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.models.swin2d import shift_attn_mask
    from deepfake_tpu_torch.ops import window_attn_multihead as k6
    from deepfake_tpu_torch.ops.window_attn import l2_normalize

    acc = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "library_device_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = []  # name, B_, H, C, N, mask, cosine, blocks per request
    for res, H, C, depth in SWIN_B_W16_STAGES:
        B_ = batch * (res // 16) ** 2
        if res > 16:
            mask = torch.from_numpy(shift_attn_mask(res, res, 16, 8)).to(dev)
            cases.append((f"stage res {res}", B_, H, C, N6, None, True, (depth + 1) // 2))
            cases.append((f"stage res {res} shifted", B_, H, C, N6, mask, True, depth // 2))
        else:
            cases.append((f"stage res {res}", B_, H, C, N6, None, True, depth))
    # the scaled form at N = 392 (a Video Swin-S stage-2 b8 shape), as the
    # JAX tests drive this route; on no model path
    cases.append(("scaled N=392", 64, 12, 384, 392, None, False, 0))
    # SwinV2-B stage 0 at windows 10 (N = 100) and 24 (N = 576, the 384^2
    # fine-tunes), b8 of a 2x2-window grid, shifted; on no path of this run
    for ws in (10, 24):
        mask = torch.from_numpy(shift_attn_mask(2 * ws, 2 * ws, ws, ws // 2)).to(dev)
        cases.append((f"window {ws} shifted", 4 * batch, 4, 128, ws * ws, mask, True, 0))
    for name, B_, H, C, N, mask, cosine, count in cases:
        D = C // H
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(dtype)
            q, k, v = qkv.view(B_, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
            if cosine:
                bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=dev))
                # logit scales drawn up to the clamp: 10 .. 100, the last head at 100
                ls = torch.exp(torch.linspace(math.log(10.0), math.log(100.0), H, device=dev)
                               ).reshape(H, 1, 1)
                kw = dict(bias=bias, mask=mask, logit_scale=ls)
            else:
                bias = 0.5 * torch.randn(H, N, N, generator=gen, device=dev)
                kw = dict(bias=bias, mask=None, scale=D ** -0.5, cosine=False)
            run = lambda: k6.window_attention_multihead(q, k, v, **kw)
            plain = lambda: k6.window_attention_heads_plain(q, k, v, **kw)
            got = run()
            torch.cuda.synchronize()
            err, tol = k6_check(got, plain(), f"{name} B_={B_} H={H} {dname}")
            errs[dname] = max(errs[dname], err)
            row = dict(kernel="window_attention_multihead", case=f"{name} [{B_},{H},{N},{D}]",
                       dtype=dname, max_abs_err=err, tol=tol, blocks_per_request=count)
            ms = cuda_time_ms(run, iters=10)
            dms = device_time_ms(run) if dtype == torch.bfloat16 else None
            pms = cuda_time_ms(plain, iters=3)
            hq, hk, hv = (t.contiguous() for t in (q, k, v))
            if cosine:
                hq = (l2_normalize(hq.float()) * kw["logit_scale"]).to(dtype)
                hk = l2_normalize(hk.float()).to(dtype)
            am = sdpa_mask(bias, mask, B_, dtype)
            sdpa = lambda: F.scaled_dot_product_attention(
                hq, hk, hv, attn_mask=am, scale=1.0 if cosine else D ** -0.5)
            lib = cuda_time_ms(sdpa, iters=10)
            lib_dms = device_time_ms(sdpa) if dtype == torch.bfloat16 else None
            del hq, hk, hv, am, sdpa
            flops, nbytes = k6_flops_bytes(B_, H, C, N, 0 if mask is None else mask.shape[0],
                                           qkv.element_size())
            b, by = bound_ms(flops, nbytes, dname)
            row.update(ms=ms, device_ms=dms, plain_ms=pms, library_ms=lib,
                       library_device_ms=lib_dms, bound_ms=b, bound_by=by, gflop=flops / 1e9,
                       mbytes=nbytes / 1e6)
            log(f"K6 {name:22s} [{B_},{H},{N},{D}] {dname:8s} kernel_ms={ms:.4f} "
                + ("" if dms is None else f"device_ms={dms:.4f} ")
                + f"plain_ms={pms:.4f} sdpa_ms={lib:.4f} "
                + ("" if lib_dms is None else f"(device {lib_dms:.4f}) ")
                + f"bound_ms={b:.4f} ({by}) err={err:.2e} (tol {tol:.2e})")
            if dtype == torch.bfloat16:
                for key, val in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                                 ("library_ms", lib), ("library_device_ms", lib_dms),
                                 ("bound_ms", b), ("flops", flops), ("bytes", nbytes)):
                    acc[key] += count * val
            report["k6"].append(row)
            del qkv, q, k, v, bias, got
        torch.cuda.empty_cache()
    k6.window_attention_multihead.launches = 0
    _, by = bound_ms(acc["flops"], acc["bytes"], "bfloat16")
    log(f"K6 per audio b{batch} request: kernel_ms={acc['ms']:.4f} "
        f"device_ms={acc['device_ms']:.4f} plain_ms={acc['plain_ms']:.4f} "
        f"sdpa_ms={acc['library_ms']:.4f} (device {acc['library_device_ms']:.4f}) "
        f"bound_ms={acc['bound_ms']:.4f}")
    return dict(name="window_attention_multihead (K6)", route="cuda", source=K6_SRC,
                replaces=K6_REPLACES, launches=None, max_abs_err=errs["bfloat16"],
                max_abs_err_f32=errs["float32"], ms=acc["ms"], plain_ms=acc["plain_ms"],
                bound_ms=acc["bound_ms"], bound_by=by, library_ms=acc["library_ms"],
                device_ms=acc["device_ms"], library_device_ms=acc["library_device_ms"],
                per="one audio b8 request (SwinV2-B window 16, 256^2): the 22 blocks of stages "
                    "0-2, bf16; library_ms is SDPA with bias + mask as attn_mask on "
                    "pre-normalised q and k; device_ms (library_device_ms) is the kernel's "
                    "(SDPA's) own device time (torch.profiler), ms the CUDA-event time of "
                    "back-to-back calls")


# ---------------------------------------------------------------- phases 3 and 4

def fused_inputs(cfg, batch, dev, gen):
    """Random (frames, mel image, wave) of the fused model's input shapes."""
    import torch

    from deepfake_tpu_torch.models.registry import example_inputs

    (zeros,) = example_inputs(cfg, batch, dev)
    return tuple(s * torch.randn(z.shape, generator=gen, device=dev)
                 for z, s in zip(zeros, (0.5, 1.0, 1.0)))


def wrappers():
    """Every kernel wrapper, by the name its launches are reported under."""
    from deepfake_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


def counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def branch_times(pred, inputs):
    """Device time of each part of one fused forward (CUDA events), after
    the counted requests: where a request's time goes."""
    import torch

    m = pred.model
    with torch.inference_mode():
        video, audio, wave = pred._inputs(inputs)
        feats = m.branch_features((video, audio, wave))
        parts = {"video: IRv2 + NeXtVLAD": lambda: m.video_extractor(video),
                 "audio: SwinV2-B": lambda: m.audio_extractor(audio),
                 "paudio: wav2vec2-base": lambda: m.paudio_extractor(wave),
                 "fusion head": lambda: m.head(*feats)}
        return {name: cuda_time_ms(fn, iters=3) for name, fn in parts.items()}


def batch_of(inputs) -> int:
    if isinstance(inputs, dict):
        return next(iter(inputs.values())).shape[0]
    return (inputs[0] if isinstance(inputs, tuple) else inputs).shape[0]


def serve(pred, requests):
    """Answer each request (model-ready inputs through ``predict``, a raw
    feature dict through ``predict_raw``); returns (latencies in s,
    scores), each score checked finite and in [0, 1]."""
    lat, out = [], []
    for inputs in requests:
        t = time.perf_counter()
        # ends in a device->host copy
        scores = pred.predict_raw(inputs) if isinstance(inputs, dict) else pred.predict(inputs)
        lat.append(time.perf_counter() - t)
        B = batch_of(inputs)
        if scores.shape != (B,) or not np.isfinite(scores).all() or not (
                (scores >= 0) & (scores <= 1)).all():
            fail(f"serving: bad scores for a b{B} request: {scores}")
        out.append(scores)
    return lat, out


def profile_call(fn, wall_ms: float):
    """One call of ``fn`` under torch.profiler: the device's busy time (the
    sum of its kernels' durations; one stream, so they do not overlap), its
    idle share of ``wall_ms`` (the call's unprofiled time), and the kernels
    that take the most device time."""
    by_name = {}
    for name, ms in traced(fn):
        by_name[name] = by_name.get(name, 0.0) + ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_idle_share=1.0 - busy / wall_ms,
                kernel_names=len(by_name), top_kernels_ms=[[n[:90], t] for n, t in top])


# the hand-written kernels' names as the profiler reports them: every
# __global__ function of csrc/ sits in namespace hop, simt, wtile or i8
KERNEL_NAME = re.compile(r"(?:^|[^A-Za-z0-9_])(?:hop|simt|wtile|i8)::")


def handwritten_kernels(fn) -> collections.Counter:
    """The hand-written kernels that one call of ``fn`` runs on the card, by
    name (torch.profiler)."""
    return collections.Counter(name for name, _ in traced(fn) if KERNEL_NAME.search(name))


def graph_equals_eager(pred, eager, r, what: str):
    """The logits (and video_swin's per-frame features) of request ``r``
    through ``pred``'s graph against the eager route's: the same kernels in
    the same order, so equal to the bit. Returns the graph's logits."""
    raw = isinstance(r, dict)
    got, want = (p.forward(r, return_logits=True, raw=raw) for p in (pred, eager))
    got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
    for a, b in zip(got, want):
        if not torch_equal(a, b):
            fail(f"{what} b{batch_of(r)}: graph and eager outputs differ by "
                 f"{(a.float() - b.float()).abs().max().item():.3e}")
    return got[0]


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def graph_route(pred, eager, requests, scores_eager, per_req_eager, what: str):
    """The graph route of a serving phase (``pred``, compiled; ``eager``,
    the same weights on the eager route): the first request of each shape
    captures its graph (two eager warm-up runs, then the capture, each
    counted by the wrappers), then every request replays, timed; the
    launches of that timed run are each graph's captured launches times its
    replays. Each graph's captured launches must be the eager route's
    launches for that request, one replay must launch exactly the
    hand-written kernels of one eager call (torch.profiler, by kernel name),
    every score must equal the eager route's, and so must the logits of the
    first and last requests, while two requests' logits differ (a stale
    input buffer would give the first request's logits again)."""
    import torch

    from deepfake_tpu_torch.compiled import signature
    from deepfake_tpu_torch.ops import launch_counts

    first = {}
    for r in (requests[0], requests[-1]):
        t = time.perf_counter()
        serve(pred, [r])
        first[f"b{batch_of(r)}"] = time.perf_counter() - t
    replays = {k: g.replays for k, g in pred.graphs.graphs.items()}
    lat, scores = serve(pred, requests)
    launches = collections.Counter()
    for k, g in pred.graphs.graphs.items():
        for name, n in g.launches.items():
            launches[name] += n * (g.replays - replays[k])
    d_score = max(float(np.abs(a - b).max()) for a, b in zip(scores, scores_eager))
    graphs = {}
    for i in (0, len(requests) - 1):
        r = requests[i]
        route = "raw" if isinstance(r, dict) else "predict"
        g = pred.graphs.graphs[signature(route, pred.cfg.data.modality, r)]
        want = {k: v for k, v in per_req_eager[i].items() if v}
        if g.launches != want:
            fail(f"{what} b{batch_of(r)}: the graph's capture counted {g.launches}, the eager "
                 f"route launches {want}")
        call = (lambda r=r: eager.predict_raw(r)) if route == "raw" else (
            lambda r=r: eager.predict(r))
        with torch.inference_mode():
            k_eager = handwritten_kernels(call)
            counted = launch_counts()
            k_graph = handwritten_kernels(g.graph.replay)
        if k_graph != k_eager or not k_graph or launch_counts() != counted:
            fail(f"{what} b{batch_of(r)}: one replay launched {dict(k_graph)}, one eager call "
                 f"{dict(k_eager)}")
        graphs[f"b{batch_of(r)}"] = dict(launches=g.launches, pool_bytes=g.pool_bytes,
                                         kernels_per_replay=sum(k_graph.values()),
                                         kernel_names=len(k_graph))
    logits = [graph_equals_eager(pred, eager, r, what) for r in requests[:2]]
    graph_equals_eager(pred, eager, requests[-1], what)
    if torch_equal(*logits):
        fail(f"{what}: two different requests gave the same logits through one graph")
    p50 = statistics.median(lat[:-1])
    res = dict(latency_s=lat, p50_b8_s=p50, clips_per_s_b8=8 * (len(lat) - 1) / sum(lat[:-1]),
               b1_latency_s=lat[-1], first_call_s=first, graphs=graphs, launches=dict(launches),
               pool_bytes=pred.graphs.pool_bytes(), max_abs_score_diff_vs_eager=d_score)
    res["profile"] = {
        "graph route b8": profile_call(lambda: serve(pred, [requests[0]]), p50 * 1e3),
        "graph route b1": profile_call(lambda: serve(pred, [requests[-1]]), lat[-1] * 1e3)}
    log(f"{what}: graph route b8 p50 {p50 * 1e3:.2f} ms, {res['clips_per_s_b8']:.2f} clips/s; "
        f"b1 {lat[-1] * 1e3:.2f} ms; first calls (capture) "
        + ", ".join(f"{k} {v * 1e3:.0f} ms" for k, v in first.items())
        + f"; pool {res['pool_bytes'] / 2**20:.0f} MiB; max |score - eager| {d_score:.2e}; "
        f"hand-written kernels a replay " + json.dumps({k: v["kernels_per_replay"]
                                                      for k, v in graphs.items()})
        + "; launches of the timed replays " + json.dumps(res["launches"]))
    for name, prof in res["profile"].items():
        log(f"{what}: profile {name}: device busy {prof['device_busy_ms']:.2f} ms of "
            f"{prof['wall_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}")
    if d_score != 0:
        fail(f"{what}: graph and eager scores differ by {d_score:.3e}")
    return res


def branch_rel_err(pa, pb, inputs):
    """max |a - b| / max |b| of each branch feature (video, audio, paudio)
    of two predictors on the same request."""
    import torch

    with torch.inference_mode():
        fa = pa.model.branch_features(pa._inputs(inputs))
        fb = pb.model.branch_features(pb._inputs(inputs))
    return [((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-6)).item()
            for a, b in zip(fa, fb)]


def pcm_batch(cfg, batch, dev, gen):
    """Seeded bucket-padded 16 kHz PCM on the card: the first bucket (4 s),
    valid lengths drawn in [2.5 s, 4 s], zeros past each."""
    import torch

    sr = cfg.data.wave_sample_rate
    T = int(cfg.data.wave_seconds_buckets[0] * sr)
    lengths = torch.randint(int(2.5 * sr), T + 1, (batch,), generator=gen, device=dev)
    wave = 0.1 * torch.randn(batch, T, generator=gen, device=dev)
    return wave * (torch.arange(T, device=dev)[None] < lengths[:, None]), lengths


def fused_raw(cfg, batch, dev, gen):
    """A raw fused request: uint8 frames of the model's clip shape and one
    PCM clip each for the mel image and the waveform."""
    import torch

    t, s = cfg.data.num_frames, cfg.data.frame_size
    wave, lengths = pcm_batch(cfg, batch, dev, gen)
    return {"video": torch.randint(0, 256, (batch, t, s, s, 3), generator=gen, device=dev,
                                   dtype=torch.uint8),
            "audio_wave": wave, "audio_len": lengths, "paudio_wave": wave, "paudio_len": lengths}


def irv2_features(pred, request):
    """The IRv2 trunk's per-frame features [frames, 1536] of a fused
    request, in f32."""
    import torch

    with torch.inference_mode():
        video = pred._inputs(request)[0]
        frames = video.reshape((-1,) + tuple(video.shape[2:]))
        return pred.model.video_extractor.inception(frames).float()


def phase_serving(cfg, cfg_plain, dev, gen, report):
    """Fused serving on the kernel routes (the main path), then the same
    requests on the plain routes (cuDNN convs, plain attention) with the
    same weights, for the end-to-end comparison."""
    import torch

    from deepfake_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    pred = Predictor(cfg, device=dev, compiled=False)
    torch.cuda.synchronize()
    log(f"serving: Predictor(fused, {cfg.parallel.compute_dtype}) built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in pred.model.parameters()) / 1e6:.1f} M params")
    plain = Predictor(cfg_plain, device=dev, compiled=False)
    graph = Predictor(cfg, device=dev)  # the default on the card: CUDA graphs
    requests = [fused_inputs(cfg, 8, dev, gen) for _ in range(3)] + [fused_inputs(cfg, 1, dev, gen)]
    for p in (pred, plain):  # warm-up at both batch sizes: cuDNN plans, allocator
        serve(p, [requests[0], requests[-1]])
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    lat, per_req, scores = [], [], []
    for inputs in requests:
        before = counts()
        (t,), (sc,) = serve(pred, [inputs])
        after = counts()
        lat.append(t)
        scores.append(sc)
        per_req.append({k: after[k] - before[k] for k in after})
    launches = counts()  # ... and ends here
    for i, d in enumerate(per_req):
        b8 = i < 3
        if d["inception_block"] != 40:
            fail(f"request {i}: K1 ran {d['inception_block']} block calls, expected 40")
        if b8 and (d["window_attn_tokens"] == 0 or d["window_attn_heads"] != 0):
            fail(f"b8 request {i}: K2 launches {d}")
        if not b8 and d["window_attn_heads"] == 0:
            fail(f"b1 request: no head-major K2 launch: {d}")
        if d["window_attention_multihead"]:
            fail(f"request {i}: K6 ran at window 7: {d}")
    lat_plain, scores_plain = serve(plain, requests)
    if counts() != launches:
        fail("the plain routes launched a kernel")
    res_graph = graph_route(graph, pred, requests, scores, per_req, "serving")
    # one b8 request from raw inputs (uint8 frames, 16 kHz PCM) through
    # predict_raw: FeatureAssembler feeds the same kernels; then through the
    # graph of the front end and the model
    raw = fused_raw(cfg, 8, dev, gen)
    before = counts()
    (t_first, t_raw), (sc_raw, _) = serve(pred, [raw, raw])  # the first builds the tables
    after = counts()
    d_raw = {k: (after[k] - before[k]) // 2 for k in after}
    if d_raw["inception_block"] != 40 or d_raw["window_attn_tokens"] == 0:
        fail(f"fused predict_raw b8: launches {d_raw}")
    (t_raw_capture, t_raw_graph), (sc_raw_graph, _) = serve(graph, [raw, raw])
    d_raw_graph = float(np.abs(sc_raw_graph - sc_raw).max())
    graph_equals_eager(graph, pred, raw, "serving predict_raw")
    fe_ms = cuda_time_ms(lambda: pred._assemble(raw, np.zeros(1, np.float32)), iters=3)
    d_score = max(float(np.abs(a - b).max()) for a, b in zip(scores, scores_plain))
    d_feat = branch_rel_err(pred, plain, requests[0])
    res = dict(per_request_launches=per_req, latency_s=lat, p50_b8_s=statistics.median(lat[:3]),
               clips_per_s_b8=8 * 3 / sum(lat[:3]), b1_latency_s=lat[3],
               plain_latency_s=lat_plain, plain_p50_b8_s=statistics.median(lat_plain[:3]),
               plain_clips_per_s_b8=8 * 3 / sum(lat_plain[:3]),
               max_abs_score_diff_vs_plain_bf16=d_score, branch_rel_err_vs_plain_bf16=d_feat,
               branch_ms_b8=branch_times(pred, requests[0]),
               plain_branch_ms_b8=branch_times(plain, requests[0]),
               predict_raw_b8=dict(latency_s=t_raw, first_call_s=t_first, launches=d_raw,
                                   frontend_ms=fe_ms, graph_latency_s=t_raw_graph,
                                   graph_capture_call_s=t_raw_capture,
                                   graph_max_abs_score_diff_vs_eager=d_raw_graph),
               graph_route=res_graph)
    res["profile"] = {
        "kernel routes b8": profile_call(lambda: pred.predict(requests[0]),
                                         res["p50_b8_s"] * 1e3),
        "kernel routes b1": profile_call(lambda: pred.predict(requests[3]), lat[3] * 1e3),
        "plain routes b8": profile_call(lambda: plain.predict(requests[0]),
                                        res["plain_p50_b8_s"] * 1e3)}
    report["serving"] = res
    log(f"serving: launches per request {per_req}")
    log(f"serving: kernel routes b8 p50 {res['p50_b8_s'] * 1e3:.1f} ms, "
        f"{res['clips_per_s_b8']:.2f} clips/s; b1 {lat[3] * 1e3:.1f} ms ({report['card']})")
    log(f"serving: plain routes  b8 p50 {res['plain_p50_b8_s'] * 1e3:.1f} ms, "
        f"{res['plain_clips_per_s_b8']:.2f} clips/s; b1 {lat_plain[3] * 1e3:.1f} ms; "
        f"vs kernel routes: max |score diff| {d_score:.2e}, branch feature rel err "
        f"{', '.join(f'{e:.2e}' for e in d_feat)} (bf16)")
    log(f"serving: one b8 request through predict_raw (uint8 frames, 4 s PCM): "
        f"{t_raw * 1e3:.1f} ms (first call {t_first * 1e3:.1f} ms), front end {fe_ms:.2f} ms "
        f"(CUDA events), launches per call {d_raw}; graph route {t_raw_graph * 1e3:.1f} ms "
        f"(capture call {t_raw_capture * 1e3:.0f} ms), max |score - eager| {d_raw_graph:.2e}")
    log("serving: b8 branch times (ms), kernel routes " + json.dumps(res["branch_ms_b8"]))
    log("serving: b8 branch times (ms), plain routes  " + json.dumps(res["plain_branch_ms_b8"]))
    for name, prof in res["profile"].items():
        log(f"serving: profile {name}: device busy {prof['device_busy_ms']:.2f} ms of "
            f"{prof['wall_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}; top "
            + json.dumps(prof["top_kernels_ms"]))
    # bf16 end to end: ~3 significant digits through some 300 layers
    if not (d_score <= 2e-2 and max(d_feat) <= 5e-2):
        fail("serving: kernel and plain routes disagree in bf16")
    if d_raw_graph != 0:
        fail(f"serving: predict_raw's graph and eager scores differ by {d_raw_graph:.3e}")
    # phase 16 serves the same requests at int8 and compares its logits and
    # IRv2 features
    with torch.inference_mode():
        logits = torch.cat([pred.forward(r, return_logits=True).float() for r in requests])
    feats = irv2_features(pred, requests[0])
    del pred, plain, graph
    torch.cuda.empty_cache()
    return launches, res_graph["launches"], (requests, logits, feats)


def phase_parity(cfg_kernel, cfg_plain, dev, gen, report, batch: int):
    import torch

    from deepfake_tpu_torch.serving import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pk = Predictor(cfg_kernel, device=dev, compiled=False)
    pp = Predictor(cfg_plain, device=dev, compiled=False)
    for (n1, a), (n2, b) in zip(pk.model.state_dict().items(), pp.model.state_dict().items()):
        if n1 != n2 or not torch.equal(a, b):
            fail(f"parity: the two models' weights differ at {n1}")
    inputs = fused_inputs(cfg_kernel, batch, dev, gen)
    scores = [p.predict(inputs) for p in (pk, pp)]
    d_score = float(np.abs(scores[0] - scores[1]).max())
    rel = branch_rel_err(pk, pp, inputs)
    report["parity"] = dict(batch=batch, max_abs_score_diff=d_score, branch_rel_err=rel,
                            scores_kernel=scores[0].tolist(), scores_plain=scores[1].tolist(),
                            graph_max_abs_score_diff_vs_eager=graph_parity(
                                cfg_kernel, pk, inputs, False, "fused"))
    log(f"parity f32 b{batch}: max |score diff| {d_score:.3e}; branch feature rel err "
        f"video {rel[0]:.2e} audio {rel[1]:.2e} paudio {rel[2]:.2e}")
    if not (d_score <= 1e-3 and max(rel) <= 1e-3):
        fail("kernel routes and plain routes disagree")


def clips(cfg, batch, dev, gen):
    """Random NTHWC clips of the video_swin model's input shape."""
    import torch

    from deepfake_tpu_torch.models.registry import example_inputs

    (zeros,) = example_inputs(cfg, batch, dev)
    return 0.5 * torch.randn(zeros.shape, generator=gen, device=dev)


def feature_rel_err(pa, pb, x) -> float:
    """max |a - b| / max |b| of the per-frame features of two video_swin
    predictors on the same clips."""
    import torch

    with torch.inference_mode():
        fa, fb = pa.forward(x)[1].float(), pb.forward(x)[1].float()
    return ((fa - fb).abs().max() / fb.abs().max().clamp(min=1e-6)).item()


def phase_video_swin(cfg, cfg_plain, dev, gen, report, key: str = "video_swin"):
    """video_swin serving through K3 and K4 (the main path of this slice),
    on the eager route and as CUDA graphs, then the same requests on the
    plain route with the same weights; ``key`` names the model in the log
    and the report."""
    import torch

    from deepfake_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    pred = Predictor(cfg, device=dev, compiled=False)
    torch.cuda.synchronize()
    m = cfg.model
    log(f"{key}: Predictor({cfg.parallel.compute_dtype}, embed {m.swin3d_embed_dim}, heads "
        f"{m.swin3d_heads}, depths {m.swin3d_depths}, window {m.swin3d_window}) built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in pred.model.parameters()) / 1e6:.1f} M params")
    plain = Predictor(cfg_plain, device=dev, compiled=False)
    graph = Predictor(cfg, device=dev)
    blocks = sum(cfg.model.swin3d_depths)
    n_lin, n_mlp = k4_launches(cfg)
    requests = [clips(cfg, 8, dev, gen) for _ in range(3)] + [clips(cfg, 1, dev, gen)]
    for p in (pred, plain):  # warm-up at both batch sizes
        serve(p, [requests[0], requests[-1]])
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    lat, per_req, scores = [], [], []
    for x in requests:
        before = counts()
        (t,), (sc,) = serve(pred, [x])
        after = counts()
        lat.append(t)
        scores.append(sc)
        per_req.append({k: after[k] - before[k] for k in after})
    launches = counts()  # ... and ends here
    for i, d in enumerate(per_req):
        if (d["window_attn3d_tokens"] != blocks or d["ln_linear"] != n_lin
                or d["mlp_tail"] != n_mlp or sum(d.values()) != blocks + n_lin + n_mlp):
            fail(f"{key} request {i}: launches {d}, expected {blocks} of K3, "
                 f"{n_lin} of K4's ln_linear, {n_mlp} of K4's mlp_tail and no other")
    lat_plain, scores_plain = serve(plain, requests)
    if counts() != launches:
        fail(f"{key}: the plain route launched a kernel")
    res_graph = graph_route(graph, pred, requests, scores, per_req, key)
    d_score = max(float(np.abs(a - b).max()) for a, b in zip(scores, scores_plain))
    d_feat = feature_rel_err(pred, plain, requests[0])
    res = dict(per_request_launches=per_req, latency_s=lat, p50_b8_s=statistics.median(lat[:3]),
               clips_per_s_b8=8 * 3 / sum(lat[:3]), b1_latency_s=lat[3],
               plain_latency_s=lat_plain, plain_p50_b8_s=statistics.median(lat_plain[:3]),
               plain_clips_per_s_b8=8 * 3 / sum(lat_plain[:3]),
               max_abs_score_diff_vs_plain_bf16=d_score, feature_rel_err_vs_plain_bf16=d_feat,
               profile={}, graph_route=res_graph)
    res["profile"] = {
        "kernel route b8": profile_call(lambda: pred.predict(requests[0]),
                                        res["p50_b8_s"] * 1e3),
        "kernel route b1": profile_call(lambda: pred.predict(requests[3]), lat[3] * 1e3),
        "plain route b8": profile_call(lambda: plain.predict(requests[0]),
                                       res["plain_p50_b8_s"] * 1e3)}
    report[key] = res
    log(f"video_swin: K3, K4 (ln_linear, mlp_tail) launches per request "
        f"{[(d['window_attn3d_tokens'], d['ln_linear'], d['mlp_tail']) for d in per_req]}")
    log(f"{key}: kernel route b8 p50 {res['p50_b8_s'] * 1e3:.2f} ms, "
        f"{res['clips_per_s_b8']:.2f} clips/s; b1 {lat[3] * 1e3:.2f} ms ({report['card']})")
    log(f"{key}: plain route  b8 p50 {res['plain_p50_b8_s'] * 1e3:.2f} ms, "
        f"{res['plain_clips_per_s_b8']:.2f} clips/s; b1 {lat_plain[3] * 1e3:.2f} ms; "
        f"vs kernel route: max |score diff| {d_score:.2e}, feature rel err {d_feat:.2e} (bf16)")
    for name, prof in res["profile"].items():
        log(f"{key}: profile {name}: device busy {prof['device_busy_ms']:.2f} ms of "
            f"{prof['wall_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}; top "
            + json.dumps(prof["top_kernels_ms"]))
    # bf16: four ulps of a score near 0.5, ~3x the measured 4.5e-3 on features
    if not (d_score <= 8e-3 and d_feat <= 1.5e-2):
        fail(f"{key}: kernel and plain routes disagree in bf16")
    del pred, plain, graph
    torch.cuda.empty_cache()
    return launches, res_graph["launches"]


def graph_parity(cfg_kernel, pk, x, raw: bool, what: str):
    """f32 (TF32 off): the kernel route's scores and logits as CUDA graphs
    against the eager route ``pk`` on the same request, equal to the bit."""
    from deepfake_tpu_torch.serving import Predictor

    pg = Predictor(cfg_kernel, device=pk.device)
    call = (lambda p: p.predict_raw(x)) if raw else (lambda p: p.predict(x))
    d = float(np.abs(call(pg) - call(pk)).max())
    log(f"{what} parity f32: graph against eager route, max |score diff| {d:.3e}")
    if d != 0:
        fail(f"{what}: graph and eager scores differ by {d:.3e} in f32")
    graph_equals_eager(pg, pk, x, what)
    return d


def phase_video_swin_parity(cfg_kernel, cfg_plain, dev, gen, report, batch: int,
                            key: str = "video_swin_parity"):
    import torch

    from deepfake_tpu_torch.serving import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pk = Predictor(cfg_kernel, device=dev, compiled=False)
    pp = Predictor(cfg_plain, device=dev, compiled=False)
    for (n1, a), (n2, b) in zip(pk.model.state_dict().items(), pp.model.state_dict().items()):
        if n1 != n2 or not torch.equal(a, b):
            fail(f"video_swin parity: the two models' weights differ at {n1}")
    x = clips(cfg_kernel, batch, dev, gen)
    blocks = sum(cfg_kernel.model.swin3d_depths)
    before = counts()
    scores = [p.predict(x) for p in (pk, pp)]
    after = counts()
    # f32: K4's SIMT route, the MLP tail as two ln_linear launches
    if (after["window_attn3d_tokens"] - before["window_attn3d_tokens"] != blocks
            or after["ln_linear"] - before["ln_linear"] != 4 * blocks
            or after["mlp_tail"] != before["mlp_tail"]):
        fail(f"{key}: the kernel route did not run K3 and K4 in every block")
    d_score = float(np.abs(scores[0] - scores[1]).max())
    rel = feature_rel_err(pk, pp, x)
    d_graph = graph_parity(cfg_kernel, pk, x, False, key)
    report[key] = dict(batch=batch, max_abs_score_diff=d_score, feature_rel_err=rel,
                       scores_kernel=scores[0].tolist(), scores_plain=scores[1].tolist(),
                       graph_max_abs_score_diff_vs_eager=d_graph)
    log(f"{key} f32 b{batch}: max |score diff| {d_score:.3e}; per-frame feature "
        f"rel err {rel:.2e}")
    # f32 (TF32 off): summation order only; measured 3e-8 and 2.4e-7
    if not (d_score <= 1e-5 and rel <= 1e-5):
        fail(f"{key}: kernel and plain routes disagree in f32")
    del pk, pp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phases 8 and 9

def audio_request(cfg, batch, dev, gen):
    wave, lengths = pcm_batch(cfg, batch, dev, gen)
    return {"audio_wave": wave, "audio_len": lengths}


def phase_audio(cfg, cfg_plain, dev, gen, report):
    """``audio`` serving from raw 16 kHz PCM at SwinV2-B's window-16 256^2
    geometry through predict_raw (the main path of this slice): K6 in the
    22 blocks of stages 0-2, K2 in stage 3; then the same requests on the
    plain route with the same weights."""
    import torch

    from deepfake_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    pred = Predictor(cfg, device=dev, compiled=False)
    torch.cuda.synchronize()
    log(f"audio: Predictor(SwinV2-B window {cfg.model.swin2d_window}, "
        f"{cfg.data.audio_size}^2, {cfg.parallel.compute_dtype}) built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in pred.model.parameters()) / 1e6:.1f} M params")
    plain = Predictor(cfg_plain, device=dev, compiled=False)
    graph = Predictor(cfg, device=dev)
    depths = cfg.model.swin2d_depths
    k6_blocks, k2_blocks = sum(depths[:-1]), depths[-1]
    requests = [audio_request(cfg, 8, dev, gen) for _ in range(3)] + [
        audio_request(cfg, 1, dev, gen)]
    for p in (pred, plain):  # warm-up at both batch sizes
        serve(p, [requests[0], requests[-1]])
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    lat, per_req, scores = [], [], []
    for x in requests:
        before = counts()
        (t,), (sc,) = serve(pred, [x])
        after = counts()
        lat.append(t)
        scores.append(sc)
        per_req.append({k: after[k] - before[k] for k in after})
    launches = counts()  # ... and ends here
    for i, d in enumerate(per_req):
        k2 = "window_attn_tokens" if i < 3 else "window_attn_heads"
        if (d["window_attention_multihead"] != k6_blocks or d[k2] != k2_blocks
                or sum(d.values()) != k6_blocks + k2_blocks):
            fail(f"audio request {i}: launches {d}, expected {k6_blocks} of K6, {k2_blocks} of "
                 f"K2 ({k2}) and no other")
    lat_plain, scores_plain = serve(plain, requests)
    if counts() != launches:
        fail("audio: the plain route launched a kernel")
    # the front end and the model, one graph a request shape
    res_graph = graph_route(graph, pred, requests, scores, per_req, "audio")
    d_score = max(float(np.abs(a - b).max()) for a, b in zip(scores, scores_plain))
    zeros = np.zeros(1, np.float32)
    with torch.inference_mode():
        inputs, _ = pred._assemble(requests[0], zeros)
    if inputs.dtype != torch.float32 or tuple(inputs.shape) != (8, cfg.data.audio_size,
                                                               cfg.data.audio_size, 3):
        fail(f"audio: the front end gave {inputs.dtype} {tuple(inputs.shape)}")
    fe_ms = cuda_time_ms(lambda: pred._assemble(requests[0], zeros), iters=5)
    model_ms = cuda_time_ms(lambda: pred.forward(inputs), iters=5)
    res = dict(per_request_launches=per_req, latency_s=lat, p50_b8_s=statistics.median(lat[:3]),
               clips_per_s_b8=8 * 3 / sum(lat[:3]), b1_latency_s=lat[3],
               plain_latency_s=lat_plain, plain_p50_b8_s=statistics.median(lat_plain[:3]),
               plain_clips_per_s_b8=8 * 3 / sum(lat_plain[:3]),
               max_abs_score_diff_vs_plain_bf16=d_score, frontend_ms_b8=fe_ms,
               model_ms_b8=model_ms, graph_route=res_graph)
    res["profile"] = {
        "kernel route b8": profile_call(lambda: pred.predict_raw(requests[0]),
                                        res["p50_b8_s"] * 1e3),
        "kernel route b1": profile_call(lambda: pred.predict_raw(requests[3]), lat[3] * 1e3),
        "plain route b8": profile_call(lambda: plain.predict_raw(requests[0]),
                                       res["plain_p50_b8_s"] * 1e3)}
    report["audio"] = res
    log(f"audio: K6, K2 launches per request "
        f"{[(d['window_attention_multihead'], d['window_attn_tokens'] + d['window_attn_heads']) for d in per_req]}")
    log(f"audio: kernel route b8 p50 {res['p50_b8_s'] * 1e3:.2f} ms, "
        f"{res['clips_per_s_b8']:.2f} clips/s; b1 {lat[3] * 1e3:.2f} ms ({report['card']})")
    log(f"audio: plain route  b8 p50 {res['plain_p50_b8_s'] * 1e3:.2f} ms, "
        f"{res['plain_clips_per_s_b8']:.2f} clips/s; b1 {lat_plain[3] * 1e3:.2f} ms; "
        f"vs kernel route: max |score diff| {d_score:.2e} (bf16)")
    log(f"audio: b8 device time: front end (resample, mel image, f32) {fe_ms:.3f} ms, "
        f"model {model_ms:.3f} ms (CUDA events)")
    for name, prof in res["profile"].items():
        log(f"audio: profile {name}: device busy {prof['device_busy_ms']:.2f} ms of "
            f"{prof['wall_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}; top "
            + json.dumps(prof["top_kernels_ms"]))
    # bf16 through 24 blocks of random weights, as the fused serving bound
    if not d_score <= 2e-2:
        fail("audio: kernel and plain routes disagree in bf16")
    del pred, plain, graph
    torch.cuda.empty_cache()
    return launches, res_graph["launches"]


def phase_audio_parity(cfg_kernel, cfg_plain, dev, gen, report, batch: int):
    """f32 (TF32 off): audio scores from the same PCM on the kernel route
    (K6's and K2's SIMT parity kernels) against the plain route."""
    import torch

    from deepfake_tpu_torch.serving import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pk = Predictor(cfg_kernel, device=dev, compiled=False)
    pp = Predictor(cfg_plain, device=dev, compiled=False)
    for (n1, a), (n2, b) in zip(pk.model.state_dict().items(), pp.model.state_dict().items()):
        if n1 != n2 or not torch.equal(a, b):
            fail(f"audio parity: the two models' weights differ at {n1}")
    x = audio_request(cfg_kernel, batch, dev, gen)
    before = counts()
    scores = [p.predict_raw(x) for p in (pk, pp)]
    after = counts()
    if after["window_attention_multihead"] - before["window_attention_multihead"] != sum(
            cfg_kernel.model.swin2d_depths[:-1]):
        fail("audio parity: the kernel route did not run K6 in every window-16 block")
    d_score = float(np.abs(scores[0] - scores[1]).max())
    with torch.inference_mode():
        mel, _ = pk._assemble(x, np.zeros(1, np.float32))
        lk, lp = (p.model(mel, return_logits=True).float() for p in (pk, pp))
    d_logit = ((lk - lp).abs().max() / lp.abs().max().clamp(min=1e-6)).item()
    report["audio_parity"] = dict(batch=batch, max_abs_score_diff=d_score,
                                  logit_rel_err=d_logit, scores_kernel=scores[0].tolist(),
                                  scores_plain=scores[1].tolist(),
                                  graph_max_abs_score_diff_vs_eager=graph_parity(
                                      cfg_kernel, pk, x, True, "audio"))
    log(f"audio parity f32 b{batch}: max |score diff| {d_score:.3e}; logit rel err "
        f"{d_logit:.2e}")
    # f32 (TF32 off): summation order and the two softmax forms only
    if not (d_score <= 1e-4 and d_logit <= 1e-4):
        fail("audio: kernel and plain routes disagree in f32")
    del pk, pp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phases 6 and 7

def phase_video_swin_train(cfg, dev, gen, report, key: str, steps: int = 2):
    """video_swin training at full width on the eager K5 route (Video
    Swin-B at (16,7,7) in main), from the init: Trainer.eval of one batch
    through K3 and K4, then ``steps`` optimizer steps on uint8 clips
    through the train-side FeatureAssembler."""
    import torch

    from deepfake_tpu_torch.train.trainer import Trainer

    o = cfg.optim
    rows = o.batch_size * o.accum_step
    raw = RawClips(cfg, rows, steps, dev, gen)
    blocks = sum(cfg.model.swin3d_depths)
    t0 = time.perf_counter()
    tk = Trainer(None, cfg, raw, logger=lambda line: None, device=dev, compiled=False)
    log(f"{key}: Trainer({cfg.parallel.compute_dtype} compute, "
        f"{cfg.parallel.param_dtype} masters, {o.batch_size} x {o.accum_step}, eager) built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in tk.model.parameters()) / 1e6:.1f} M params")
    val = train_eval(tk, raw.batches[0], blocks, key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path's run starts here
    r, _, (x, y) = assembled_steps(tk, raw, steps, k5_step_launches(cfg), key)
    launches = counts()  # ... and ends here
    r["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["p50_step_ms"] = statistics.median(r["step_ms"])
    r["clips_per_s"] = rows * 1e3 / r["p50_step_ms"]
    r["profile"] = profile_call(lambda: tk.train_step(x, y), r["p50_step_ms"])
    r["eval"] = val
    report[key] = {"K5 route": r}
    prof = r["profile"]
    log(f"{key} K5 route: steps {[round(t, 1) for t in r['step_ms']]} ms (assembly "
        f"{[round(t, 1) for t in r['assembly_ms']]} ms apart), {r['clips_per_s']:.2f} clips/s "
        f"({rows} clips a step), peak {r['max_memory_allocated_gb']:.2f} GB, losses "
        f"{r['losses']} ({report['card']}); profile of one step: device busy "
        f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms, idle share "
        f"{prof['device_idle_share']:.3f}; top " + json.dumps(prof["top_kernels_ms"]))
    del tk, raw
    torch.cuda.empty_cache()
    return launches


def train_eval(trainer, raw_batch, blocks: int, key: str):
    """Trainer.eval of one batch of uint8 clips, assembled by the evaluation
    FeatureAssembler, on the trainer's f32 masters: the serving kernels
    (K3, K4) with the weights cast to bf16 at use; on the compiled route
    through the evaluation batch's graph (its capture counts the launches:
    two warm-up runs and the captured one). The phases run it before their
    training steps: from the init's zero biases the steps take the weights
    to ~1e12, where K3's static-shift softmax (the JAX Pallas kernel's
    default form, exp(min(x - 24, 60)) with no row max) underflows a row
    of logits near -1e12 to 0 / 0, as the kernel it ports does."""
    from deepfake_tpu_torch.data.pipeline import FeatureAssembler

    x8, y = raw_batch
    batch = FeatureAssembler(trainer.cfg, device=trainer.device)({"video": x8}, y)
    before = counts()
    val = trainer.eval([batch])
    after = counts()
    ran = tuple(after[k] - before[k] for k in ("window_attn3d_tokens", "ln_linear", "mlp_tail"))
    runs = 1 if trainer.graphs is None else 3
    want = tuple(runs * n for n in (blocks, *k4_launches(trainer.cfg)))
    if ran != want or not (math.isfinite(val["loss"]) and 0 <= val["acc"] <= 1):
        fail(f"{key}: Trainer.eval gave {val} with K3, K4 launches {ran}, expected {want}")
    log(f"{key}: Trainer.eval of {len(y)} clips from the init: {val}, "
        f"K3 and K4 (ln_linear, mlp_tail) launches {ran}")
    return dict(val, k3_k4_launches=ran)


class RawClips:
    """``steps`` batches of ``rows`` seeded random uint8 clips [rows, T, H,
    W, 3] on the card with 0/1 labels: what a loader hands the train-side
    FeatureAssembler."""

    def __init__(self, cfg, rows: int, steps: int, dev, gen):
        import torch

        from deepfake_tpu_torch.models.registry import example_inputs

        (zeros,) = example_inputs(cfg, 1, dev)
        shape = (rows,) + tuple(zeros.shape[1:])
        self.batches = [(torch.randint(0, 256, shape, generator=gen, device=dev,
                                       dtype=torch.uint8),
                         (torch.rand(rows, generator=gen, device=dev) < 0.5).float())
                        for _ in range(steps)]

    def train_loader(self):
        return self.batches


def k5_step_launches(cfg):
    """K5's launches in one eager optimizer step: a forward and a backward
    per block and micro-batch, and no other kernel."""
    n = cfg.optim.accum_step * sum(cfg.model.swin3d_depths)
    return {"window_attn3d_train_fwd": n, "window_attn3d_train_bwd": n}


def assembled_steps(trainer, raw, n: int, want=None, key: str = "video_swin train"):
    """``n`` optimizer steps on the raw batches (cycled: uint8 clips, or the
    fused model's raw feature dicts), each first
    assembled by a train-side FeatureAssembler (augmentation on the card,
    its generator seeded as the trainer's config says): per step the
    assembly's and the step's host times apart (each ending in a
    synchronize), losses, launches and the weights after the steps. Fails
    on a non-finite loss or weight, or, with ``want``, on a step whose
    launches are not ``want``."""
    import torch

    from deepfake_tpu_torch.data.pipeline import FeatureAssembler

    asm = FeatureAssembler(trainer.cfg, train=True, device=trainer.device)
    asm_ms, step_ms, losses, per_step = [], [], [], []
    for i in range(n):
        x8, y = raw.batches[i % len(raw.batches)]
        t0 = time.perf_counter()
        x, y = asm(x8 if isinstance(x8, dict) else {"video": x8}, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = counts()
        metrics = trainer.train_step(x, y)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = counts()
        per_step.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        losses.append(float(metrics["loss"]))
        asm_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        if want is not None and per_step[-1] != want:
            fail(f"{key} step {i}: launches {per_step[-1]}, expected {want}")
    with torch.no_grad():
        weights = [p.detach().clone() for p in trainer.model.parameters()]
    bad = sum(not bool(torch.isfinite(w).all()) for w in weights)
    if bad or not all(math.isfinite(v) for v in losses):
        fail(f"{key}: losses {losses}, {bad} non-finite parameters after {n} steps")
    return dict(assembly_ms=asm_ms, step_ms=step_ms, losses=losses,
                per_step_launches=per_step), weights, (x, y)


def max_gap(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


# the graph route may differ from the eager route by this multiple of the
# spread of two eager runs from one state (outside the deterministic
# configuration some sums, cuDNN's and the bias tables' scatter-adds among
# them, may change their order from run to run), and by no less than this
# share of the quantity's scale (two runs may agree by chance)
SPREAD_MULTIPLE, SPREAD_FLOOR = 4.0, 1e-6


def phase_video_swin_train_graph(cfg, cfg_plain, dev, gen, report, steps: int = 3):
    """video_swin training at full width (Video Swin-S, micro-batch 8 x
    accum 4, from the init) fed by the train-side FeatureAssembler from
    uint8 clips: the eager K5 route (the kernel line's launches), a second
    eager run from the same state (their spread), the graph
    route (the default on the card) held to the eager route within
    SPREAD_MULTIPLE of that spread, and the plain route (kernels off) from
    the same weights, every route ``steps`` steps. The init's zero biases keep a rotation's
    zero-filled corners equal token to token through the first blocks, the
    first step's gradient reaches ~1e16 (there is no clip by default) and
    the second step's logits ~1e12 there: K5 has to hold the plain
    version's softmax at that size (a first design of its backward read
    NaN)."""
    import torch

    from deepfake_tpu_torch.train.trainer import Trainer

    o = cfg.optim
    rows = o.batch_size * o.accum_step
    raw = RawClips(cfg, rows, steps, dev, gen)
    blocks, accum = sum(cfg.model.swin3d_depths), o.accum_step
    quiet = lambda line: None
    key = "video_swin train"
    res = {}

    # the eager K5 route: the main path's run for the kernel line
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    te = Trainer(None, cfg, raw, logger=quiet, device=dev, compiled=False)
    init = {k: v.clone() for k, v in te.model.state_dict().items()}
    log(f"{key}: Trainer({cfg.parallel.compute_dtype} compute, {cfg.parallel.param_dtype} "
        f"masters, {o.batch_size} x {accum}) built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in te.model.parameters()) / 1e6:.1f} M params")
    val = train_eval(te, raw.batches[0], blocks, key)
    reset_counts()  # the main path's run starts here
    want = k5_step_launches(cfg)
    r, w_eager, (x, y) = assembled_steps(te, raw, steps, want, key + " eager")
    launches = counts()  # ... and ends here
    r["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["p50_step_ms"] = statistics.median(r["step_ms"])
    r["profile"] = profile_call(lambda: te.train_step(x, y), r["p50_step_ms"])
    r["eval"] = val
    res["eager"] = r
    init_losses = r["losses"]
    del te
    torch.cuda.empty_cache()

    # the spread: a second eager run from the same seed, state and clips
    te2 = Trainer(None, cfg, raw, logger=quiet, device=dev, compiled=False)
    r2, w_eager2, _ = assembled_steps(te2, raw, steps, key=key + " eager 2")
    del te2
    torch.cuda.empty_cache()
    loss_spread = max(abs(a - b) for a, b in zip(init_losses, r2["losses"]))
    w_spread = max_gap(w_eager, w_eager2)
    del w_eager2

    # the graph route: the first step captures, then every step replays
    torch.cuda.reset_peak_memory_stats()
    tg = Trainer(None, cfg, raw, logger=quiet, device=dev)
    val = train_eval(tg, raw.batches[0], blocks, key + " graph")
    rg, w_graph, _ = assembled_steps(tg, raw, steps, key=key + " graph")
    (g,) = (g for k, g in tg.graphs.graphs.items() if k[0] == "train")
    loss_gap = max(abs(a - b) for a, b in zip(init_losses, rg["losses"]))
    w_gap = max_gap(w_eager, w_graph)
    loss_tol = SPREAD_MULTIPLE * loss_spread + SPREAD_FLOOR * max(abs(v) for v in init_losses)
    w_scale = max(w.abs().max().item() for w in w_eager)
    w_tol = SPREAD_MULTIPLE * w_spread + SPREAD_FLOOR * w_scale
    del w_eager, w_graph
    if g.launches != want or g.replays != steps:
        fail(f"{key} graph: captured launches {g.launches} x {g.replays} replays, expected "
             f"{want} x {steps}")
    if rg["per_step_launches"][1:] != [{}] * (steps - 1):
        fail(f"{key} graph: a replay moved the launch counters: {rg['per_step_launches']}")
    if not (loss_gap <= loss_tol and w_gap <= w_tol):
        fail(f"{key}: the graph route's first {steps} steps differ from the eager route's by "
             f"{loss_gap:.3e} (losses) and {w_gap:.3e} (weights), past {SPREAD_MULTIPLE} x "
             f"the eager spread {loss_spread:.3e} / {w_spread:.3e} (+ floor): {loss_tol:.3e} / "
             f"{w_tol:.3e}")
    more, _, _ = assembled_steps(tg, raw, 2, key=key + " graph")  # steady-state replays
    rg["steady_step_ms"] = more["step_ms"]
    rg["steady_assembly_ms"] = more["assembly_ms"]
    rg["p50_step_ms"] = statistics.median(rg["step_ms"][1:] + more["step_ms"])
    rg["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rg["pool_bytes"] = tg.graphs.pool_bytes()
    rg["timed_replays"] = g.replays
    rg["graph_launches"] = {k: v * g.replays for k, v in g.launches.items()}
    rg["profile"] = profile_call(lambda: tg.train_step(x, y), rg["p50_step_ms"])
    rg["eval"] = val
    graph_launches = dict(rg["graph_launches"])
    res["graph"] = rg
    res["spread"] = dict(loss_spread=loss_spread, weight_spread=w_spread, loss_gap=loss_gap,
                         weight_gap=w_gap, loss_tol=loss_tol, weight_tol=w_tol,
                         multiple=SPREAD_MULTIPLE)
    del tg
    torch.cuda.empty_cache()

    # the plain route (kernels off) from the same weights
    tp = Trainer(None, cfg_plain, raw, logger=quiet, device=dev, compiled=False)
    tp.model.load_state_dict(init)
    del init
    before = counts()
    rp, _, _ = assembled_steps(tp, raw, steps, key=key + " plain")
    if counts() != before:
        fail(f"{key}: the plain route launched a kernel")
    res["plain"] = rp
    del tp
    torch.cuda.empty_cache()
    d_loss = abs(init_losses[0] - rp["losses"][0])
    res["first_step_loss_diff_vs_plain"] = d_loss
    report["video_swin_train"] = res

    for name, rr in (("eager", res["eager"]), ("graph", rg), ("plain", rp)):
        log(f"{key} {name:5s}: steps {[round(t, 1) for t in rr['step_ms']]} ms"
            + (f" (then {[round(t, 1) for t in rr['steady_step_ms']]})" if name == "graph" else "")
            + f", assembly {[round(t, 1) for t in rr['assembly_ms']]} ms, losses "
            f"{rr['losses']} ({report['card']})")
    for name, rr in (("eager", res["eager"]), ("graph", rg)):
        prof = rr["profile"]
        log(f"{key} {name}: p50 step {rr['p50_step_ms']:.1f} ms, "
            f"{rows * 1e3 / rr['p50_step_ms']:.2f} clips/s, peak "
            f"{rr['max_memory_allocated_gb']:.2f} GB; one step profiled: device busy "
            f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms, idle share "
            f"{prof['device_idle_share']:.3f}; top " + json.dumps(prof["top_kernels_ms"]))
    log(f"{key} graph: pool {rg['pool_bytes'] / 2 ** 20:.0f} MiB, K5 launches captured "
        f"{g.launches} x {rg['timed_replays']} timed replays = {graph_launches}; vs eager: "
        f"loss gap {loss_gap:.3e} (spread {loss_spread:.3e}), weight gap {w_gap:.3e} (spread "
        f"{w_spread:.3e})")
    # the first step's loss is a forward of the same weights on the same
    # clips: bf16 noise only, ~8 bf16 ulps of a loss near 0.69
    if not d_loss <= 2e-2:
        fail(f"{key}: first-step losses of the K5 and plain routes differ by {d_loss:.3e}")
    return launches, graph_launches, (raw, init_losses, loss_tol)


class RawFused:
    """``steps`` batches of ``rows`` seeded raw fused clips on the card (uint8
    frames and 4 s of 16 kHz PCM, valid 2.5-4 s, for the mel image and the
    waveform; fused_raw) with 0/1 labels."""

    def __init__(self, cfg, rows: int, steps: int, dev, gen):
        import torch

        self.batches = [(fused_raw(cfg, rows, dev, gen),
                         (torch.rand(rows, generator=gen, device=dev) < 0.5).float())
                        for _ in range(steps)]

    def train_loader(self):
        return self.batches


def fused_k5_step_launches(cfg):
    """K5's launches in one fused optimizer step: SwinV2-B's forward and
    backward per block and micro-batch, and no other hand-written kernel
    (IRv2 trains on cuDNN convs, not K1)."""
    n = cfg.optim.accum_step * sum(cfg.model.swin2d_depths)
    return {"window_attn3d_train_fwd": n, "window_attn3d_train_bwd": n}


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and torch.use_deterministic_algorithms
    (warnings only; tools/train_determinism.py), restored after."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def phase_fused_train(cfg, cfg_plain, dev, gen, report, steps: int = 3):
    """The fused model's training at full width (the preset: IRv2 on 32
    frames of 224^2, SwinV2-B window 7 on the 224^2 mel image, wav2vec2-base
    on the waveform, the 3-token head; micro-batch 8 x accum 4, bf16 compute,
    f32 masters), fed by the train-side FeatureAssembler from raw clips:
    ``steps`` steps on the eager K5 route (the kernel line's launches), the
    same steps as one CUDA graph a step (the default), two more replays,
    then both routes again in the deterministic configuration (cuDNN's
    deterministic algorithms, torch.use_deterministic_algorithms), where the
    graph equals the eager route to the bit in losses and weights (K5's
    dbias is summed in a fixed order), then the same steps on the plain
    route (K5 off: SwinV2's max-stabilised einsum softmax) from the same
    weights. Per route: step ms, clips/s, peak memory, one step profiled
    (idle share); the graph's pool. The timing rows are the default
    configuration's. Returns the kernel line's launches, the graph's, and
    the deterministic graph run (losses, weights) for phase 15."""
    import torch

    from deepfake_tpu_torch.train.trainer import Trainer

    o = cfg.optim
    rows = o.batch_size * o.accum_step
    raw = RawFused(cfg, rows, steps, dev, gen)
    want = fused_k5_step_launches(cfg)
    quiet = lambda line: None
    key = "fused train"
    res = {}

    def finish(r, trainer, x, y, skip_first=True):
        r["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        timed = r["step_ms"][1:] if skip_first else r["step_ms"]
        r["p50_step_ms"] = statistics.median(timed)
        r["clips_per_s"] = rows * 1e3 / r["p50_step_ms"]
        r["profile"] = profile_call(lambda: trainer.train_step(x, y), r["p50_step_ms"])
        return r

    # the eager K5 route: the main path's run for the kernel line
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    te = Trainer(None, cfg, raw, logger=quiet, device=dev, compiled=False)
    init = {k: v.clone() for k, v in te.model.state_dict().items()}
    log(f"{key}: Trainer({cfg.parallel.compute_dtype} compute, {cfg.parallel.param_dtype} "
        f"masters, {o.batch_size} x {o.accum_step}) built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in te.model.parameters()) / 1e6:.1f} M params")
    reset_counts()  # the main path's run starts here
    r, _, (x, y) = assembled_steps(te, raw, steps, want, key + " eager")
    launches = counts()  # ... and ends here
    res["eager"] = finish(r, te, x, y)
    del te
    torch.cuda.empty_cache()

    # the graph route: the first step captures, then every step replays
    torch.cuda.reset_peak_memory_stats()
    tg = Trainer(None, cfg, raw, logger=quiet, device=dev)
    rg, _, _ = assembled_steps(tg, raw, steps, key=key + " graph")
    (g,) = (g for k, g in tg.graphs.graphs.items() if k[0] == "train")
    if g.launches != want or g.replays != steps:
        fail(f"{key} graph: captured launches {g.launches} x {g.replays} replays, expected "
             f"{want} x {steps}")
    if rg["per_step_launches"][1:] != [{}] * (steps - 1):
        fail(f"{key} graph: a replay moved the launch counters: {rg['per_step_launches']}")
    more, _, _ = assembled_steps(tg, raw, 2, key=key + " graph")  # steady-state replays
    rg["steady_step_ms"] = more["step_ms"]
    rg["step_ms"] = rg["step_ms"] + more["step_ms"]
    rg["pool_bytes"] = tg.graphs.pool_bytes()
    rg["timed_replays"] = g.replays
    rg["graph_launches"] = {k: v * g.replays for k, v in g.launches.items()}
    res["graph"] = finish(rg, tg, x, y)
    graph_launches = dict(rg["graph_launches"])
    del tg
    torch.cuda.empty_cache()

    # the deterministic configuration: the graph against the eager route,
    # to the bit in losses and weights
    with deterministic():
        det = {}
        for name, compiled in (("eager", False), ("graph", True)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = Trainer(None, cfg, raw, logger=quiet, device=dev, compiled=compiled)
            det[name] = assembled_steps(t, raw, steps, key=f"{key} deterministic {name}")[:2]
            det[name][0]["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
            det[name][0]["pool_bytes"] = None if t.graphs is None else t.graphs.pool_bytes()
            del t
            torch.cuda.empty_cache()
    (rde, w_de), (rdg, w_dg) = det["eager"], det["graph"]
    w_gap = max_gap(w_de, w_dg)
    res["deterministic"] = dict(eager_losses=rde["losses"], graph_losses=rdg["losses"],
                                losses_equal=rdg["losses"] == rde["losses"], weight_gap=w_gap,
                                graph_step_ms=rdg["step_ms"],
                                graph_peak_gb=rdg["max_memory_allocated_gb"],
                                graph_pool_bytes=rdg["pool_bytes"])
    if rdg["losses"] != rde["losses"] or w_gap != 0.0:
        fail(f"{key} deterministic: the graph route's losses {rdg['losses']} and weights (by "
             f"{w_gap:.3e}) are not the eager route's {rde['losses']} to the bit")
    del w_de

    # the A/B: the plain route (K5 off) from the same weights
    torch.cuda.reset_peak_memory_stats()
    tp = Trainer(None, cfg_plain, raw, logger=quiet, device=dev, compiled=False)
    tp.model.load_state_dict(init)
    del init
    before = counts()
    rp, _, _ = assembled_steps(tp, raw, steps, key=key + " plain")
    if counts() != before:
        fail(f"{key}: the plain route launched a kernel")
    res["plain"] = finish(rp, tp, x, y)
    del tp
    torch.cuda.empty_cache()
    d_loss = abs(r["losses"][0] - rp["losses"][0])
    res["first_step_loss_diff_vs_plain"] = d_loss
    report["fused_train"] = res

    for name in ("eager", "graph", "plain"):
        rr = res[name]
        prof = rr["profile"]
        log(f"{key} {name:5s}: steps {[round(t, 1) for t in rr['step_ms']]} ms, assembly "
            f"{[round(t, 1) for t in rr['assembly_ms']]} ms, losses {rr['losses']}; p50 step "
            f"{rr['p50_step_ms']:.1f} ms, {rr['clips_per_s']:.2f} clips/s, peak "
            f"{rr['max_memory_allocated_gb']:.2f} GB; one step profiled: device busy "
            f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms, idle share "
            f"{prof['device_idle_share']:.3f} ({report['card']}); top "
            + json.dumps(prof["top_kernels_ms"]))
    dd = res["deterministic"]
    log(f"{key} graph: pool {rg['pool_bytes'] / 2 ** 20:.0f} MiB, K5 launches captured "
        f"{g.launches} x {rg['timed_replays']} replays = {graph_launches}; deterministic "
        f"configuration: graph losses {dd['graph_losses']} equal the eager route's to the bit "
        f"{dd['losses_equal']}, weights after {steps} steps differ by {dd['weight_gap']:.3e}")
    # the first step's loss is a forward of the same weights on the same
    # inputs: bf16 noise only
    if not d_loss <= 2e-2:
        fail(f"{key}: first-step losses of the K5 and plain routes differ by {d_loss:.3e}")
    return launches, graph_launches, (raw, rdg, w_dg, res["graph"]["p50_step_ms"])


def phase_mesh(cfg, dev, gen, report, det_graph, steps: int = 3):
    """Phase 15, the mesh on the card: a one-process NCCL group
    (world_size 1, rank 0) and its (1 data, 1 model) mesh. The fused model
    at 8 x 4, full width, on the graph route in the deterministic
    configuration: ``steps`` steps with the group against phase 12's
    deterministic graph steps without one, from the same seeded weights,
    batches and generator state, equal to the bit in losses and weights;
    a b8 fused Predictor request (predict_raw, graph) with the group against
    one without, equal to the bit. Prints the step ms beside phase 12's
    graph step, the collectives one step's graph holds (NCCL kernels in a
    profiled replay, and the calls the step function makes) and the bytes
    one step all-reduces."""
    import torch
    import torch.distributed as dist

    from deepfake_tpu_torch.parallel.dryrun import free_port
    from deepfake_tpu_torch.parallel.mesh import make_mesh
    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.trainer import Trainer

    raw, r_ref, w_ref, graph_p50 = det_graph
    key = "mesh"
    res = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        calls = collections.Counter()
        nbytes = collections.Counter()
        real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

        def counted(name):
            def call(tensor, *a, **kw):
                calls[name] += 1
                ts = tensor if isinstance(tensor, (list, tuple)) else [tensor]
                nbytes[name] += sum(t.numel() * t.element_size() for t in ts)
                return real[name](tensor, *a, **kw)
            return call

        with deterministic():
            tm = Trainer(None, cfg, raw, logger=lambda line: None, device=dev, mesh=mesh)
            for n in real:
                setattr(dist, n, counted(n))
            try:  # the step function runs in Python three times: two warm-ups, the capture
                rm, w_mesh, (x, y) = assembled_steps(tm, raw, steps, key=key + " train")
            finally:
                for n, f in real.items():
                    setattr(dist, n, f)
        gap = max_gap(w_ref, w_mesh)
        if rm["losses"] != r_ref["losses"] or gap != 0.0:
            fail(f"{key}: the one-process group's steps (losses {rm['losses']}) are not the "
                 f"steps without a group ({r_ref['losses']}) to the bit; weights by {gap:.3e}")
        per_step = {n: c // 3 for n, c in calls.items()}  # warm-up x 2 + capture
        per_step_bytes = {n: b // 3 for n, b in nbytes.items()}
        grad_bytes = 4 * sum(p.numel() for p in tm.model.parameters())
        ms = statistics.median(rm["step_ms"][1:])
        nccl = collections.Counter(k for k, _ in traced(lambda: tm.train_step(x, y))
                                   if "nccl" in k.lower())
        res["train"] = dict(losses=rm["losses"], weight_gap=gap, step_ms=rm["step_ms"],
                            p50_step_ms=ms, graph_p50_step_ms_phase12=graph_p50,
                            collective_calls_per_step=per_step,
                            collective_bytes_per_step=per_step_bytes,
                            gradient_bytes=grad_bytes, nccl_kernels_per_replay=dict(nccl))
        del tm
        torch.cuda.empty_cache()

        # serving: a b8 request with the group against one without
        request = fused_raw(cfg, 8, dev, gen)
        scores = []
        with deterministic():
            for m in (None, mesh):
                pred = Predictor(cfg, device=dev, mesh=m)
                scores.append(pred.forward(request, return_logits=True, raw=True))
                del pred
                torch.cuda.empty_cache()
        if not torch_equal(scores[0], scores[1]):
            fail(f"{key}: the Predictor with the group does not equal the one without to the bit")
        res["serving_equal"] = True
    finally:
        dist.destroy_process_group()
    report["mesh"] = res
    tr = res["train"]
    log(f"{key}: one-process NCCL group, mesh (1 data, 1 model): {steps} fused graph steps "
        f"equal the steps without a group to the bit (losses {tr['losses']}); step "
        f"{tr['p50_step_ms']:.1f} ms against phase 12's graph step {graph_p50:.1f} ms "
        f"(deterministic configuration here, default there; {report['card']}); collectives "
        f"a step: {json.dumps(tr['collective_calls_per_step'])} calls, "
        f"{json.dumps(tr['collective_bytes_per_step'])} bytes (the gradients "
        f"{tr['gradient_bytes'] / 1e9:.3f} GB), NCCL kernels in one replay "
        f"{json.dumps(tr['nccl_kernels_per_replay'])}; Predictor b8 with the group equals "
        f"the one without to the bit")


CKPT_MODEL_SAVE = 5  # the JAX default cadence: a save after step 4 of 5
# K5's kernels in a Chrome trace (hop::dq_bf16, hop::dkdv_bf16 and the
# forward's wtile::attn_bf16, whose instance K3 shares but which only K5
# runs in training)
K5_TRACE_NAMES = ("dq_bf16", "dkdv_bf16", "attn_bf16")


class AssembledFused:
    """The optimizer steps' batches of RawFused, assembled once by one
    train-side FeatureAssembler, so that every Trainer of phase 14 takes the
    same inputs (the uninterrupted run's step and the resumed run's); the
    val loader holds one micro-batch of the first."""

    def __init__(self, cfg, raw, dev):
        from deepfake_tpu_torch.compiled import map_leaves
        from deepfake_tpu_torch.data.pipeline import FeatureAssembler

        asm = FeatureAssembler(cfg, train=True, device=dev)
        self.batches = [asm(x8, y) for x8, y in raw.batches]
        b = cfg.optim.batch_size
        x, y = self.batches[0]
        self.val = [(map_leaves(lambda t: t[:b], x), y[:b])]

    def train_loader(self):
        return self.batches

    def val_loader(self):
        return self.val


def wait_for_line(path, text: str, proc, timeout: float, what: str) -> None:
    """Polls the log at ``path`` until it holds ``text``; fails when ``proc``
    ends first or ``timeout`` seconds pass."""
    t = time.perf_counter()
    while True:
        if os.path.exists(path) and text in open(path).read():
            return
        if proc.poll() is not None:
            fail(f"{what}: exited {proc.returncode} before '{text}': "
                 + (open(path).read()[-2000:] if os.path.exists(path) else ""))
        if time.perf_counter() - t > timeout:
            fail(f"{what}: no '{text}' in {timeout:.0f} s")
        time.sleep(0.1)


def phase_checkpoints(cfg, dev, gen, report, seed: int, ckpt_dir: str):
    """Checkpoints of the fused model at full width on the graph route (the
    preset: 8 x 4, bf16 compute, f32 masters), the Trainers in turn (each
    ~28 GB peak and a ~17 GB graph pool), on five seeded raw batches
    assembled once (AssembledFused):
      1. Trainer A captures its step and eval graphs (state and step left as
         they were), then runs Trainer.train for one epoch of the five steps with
         log.model_save = 5 (a save after step 4, the JAX cadence),
         log_step = 1, an HbmTracker census at step 5 and log.profile_dir
         set: the checkpoint's bytes and the save's ms (synchronised
         first), the loop's `duty |` line after step 5 and its ckpt share
         (one save in five steps of replays: the steady state), the trace file
         naming K5's kernels, the tracker file's lines, whether the curves
         were drawn (matplotlib) or not; step 5's loss and the weights
         after it (uninterrupted). K5's launches over the captures and the
         loop (counts set to 0 just before, read just after: the capture's;
         the replays' are the graph's launches x replays).
      2. Trainer B, built fresh, loads the checkpoint (ms): every tensor
         equal to the file's to the bit, step 4, epoch 0; with the dropout
         generator set to A's state at the save (the checkpoint does not
         hold it, as the JAX one does not hold Trainer.rng), its step 5,
         the first on its graph route (the capture), against A's.
      3. The checkpoint loaded again into B, whose step graph is captured:
         every state tensor's data_ptr unchanged, and step 5 replayed; then
         that loaded state copied back twice (from a copy on the card) for
         two eager steps 5 (the eager spread). Every
         step 5's loss equals A's to the bit (a forward of the same state
         with the same masks); the weights after it equal A's to the bit
         where the two eager steps agree to the bit, else within
         SPREAD_MULTIPLE of their spread (cuDNN's and other sums whose
         order may change from run to run).
      4. Predictor.from_checkpoint serves fused b8 on the graph route, a
         Predictor of the same state on the eager route: parameters equal to the checkpoint's (in bf16) to the
         bit, graph logits equal to eager to the bit, latency beside phase
         3's; K1 and K2 launched.
      5. The training CLI on 40 mp4v clips (32 train, 8 val; 48 frames of
         256^2, 4 s PCM sidecars) with -e 1 --model_save 2, stopped by
         SIGTERM after its first checkpoint (after step 1: the (t + 1) %
         model_save cadence), then --Resume from it, stopped by SIGTERM
         after epoch 0's val line (epoch 0 re-entered at step 2; its Train
         Loss and val AUC lines). Phase 11 runs the inference CLI with
         --Resume of A's checkpoint (in ``ckpt_dir``).
    Returns A's checkpoint, the kernel counts of A's loop and of the
    serving run, and the graph launches (captured x replays) of each."""
    import copy
    import gc
    import signal

    import torch

    from deepfake_tpu_torch.data.synthetic import make_synthetic_trainset
    from deepfake_tpu_torch.io import checkpoint as ckmod
    from deepfake_tpu_torch.io.checkpoint import momentum_names, read_checkpoint
    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.trainer import Trainer

    key = "checkpoints"
    card = report["card"]
    steps = CKPT_MODEL_SAVE
    o = cfg.optim
    data = AssembledFused(cfg, RawFused(cfg, o.batch_size * o.accum_step, steps, dev, gen), dev)
    res = {"card": card, "model_save": CKPT_MODEL_SAVE}
    repo = os.path.dirname(os.path.abspath(__file__))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        # 1. Trainer A: the loop, its save after step 4, its hooks
        ca = copy.deepcopy(cfg)
        # log_step 1: the host reads each step's metric, so "step" holds the
        # step's device time and "ckpt" the save alone
        ca.log.model_save, ca.log.log_step, ca.log.hbm_track_step = CKPT_MODEL_SAVE, 1, steps
        ca.log.ckpt_dir = ca.log.curve_dir = ckpt_dir  # phase 11 serves the checkpoint too
        ca.log.profile_dir = os.path.join(tmp, "trace")
        lines = []
        t_phase = time.perf_counter()
        a = Trainer(None, ca, data, logger=lines.append, device=dev)
        # one epoch of the loop, the cosine horizon (4 epochs x 5 steps)
        # fixed at construction as B's is
        ca.optim.epochs = 0
        rec = {"loss": [], "fsync_s": 0.0}
        real_step, real_save = a.train_step, a.save_ckpt
        real_payload, real_fsync = ckmod.checkpoint_payload, os.fsync

        def payload_spy(*args):
            t0 = time.perf_counter()
            out = real_payload(*args)
            rec["payload_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        def fsync_spy(fd):
            t0 = time.perf_counter()
            real_fsync(fd)
            rec["fsync_s"] += time.perf_counter() - t0

        def step_spy(x, y):
            out = real_step(x, y)
            rec["loss"].append(out["loss"].detach().clone())  # on the device: no sync
            return out

        def save_spy(epoch):
            rec["gen"] = a.dropout.get_state()  # the dropout stream before step 5
            torch.cuda.synchronize()  # the step in flight, then the save alone
            t0 = time.perf_counter()
            rec["path"] = real_save(epoch)
            rec["save_ms"] = (time.perf_counter() - t0) * 1e3
            return rec["path"]

        a.train_step, a.save_ckpt = step_spy, save_spy
        ckmod.checkpoint_payload, os.fsync = payload_spy, fsync_spy
        os.chdir(tmp)  # HbmTracker writes ./hbm_track/
        try:
            torch.cuda.synchronize()
            reset_counts()  # the training path's run starts here
            # the step and eval graphs captured first (the capture leaves
            # the state and step as they were): the loop's five steps are
            # replays, the steady state whose duty shares are wanted
            t0 = time.perf_counter()
            a._step_graph(data.batches[0])
            a._eval_step(*data.val[0])
            torch.cuda.synchronize()
            res["capture_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            a.train()
            torch.cuda.synchronize()
            loop_counts = counts()  # ... and ends here
        finally:
            os.chdir(cwd)
            ckmod.checkpoint_payload, os.fsync = real_payload, real_fsync
        res["loop_s"] = time.perf_counter() - t0
        res["save_payload_ms"] = rec["payload_ms"]
        res["save_fsync_ms"] = rec["fsync_s"] * 1e3
        (g,) = (g for k, g in a.graphs.graphs.items() if k[0] == "train")
        loop_graph = {k: v * g.replays for k, v in g.launches.items()}
        if g.replays != steps or not all(loop_counts[k] for k in ("window_attn3d_train_fwd",
                                                                  "window_attn3d_train_bwd")):
            fail(f"{key}: the loop replayed {g.replays} steps, K5 launches {loop_counts}")
        path = rec["path"]
        want_name = f"deepfake_modalityfused_batch{o.batch_size}_epoch0_step{steps - 1}"
        if os.path.basename(path) != want_name or a.step != steps:
            fail(f"{key}: saved {path} at model_save {CKPT_MODEL_SAVE}; the loop ended at "
                 f"step {a.step}")
        res["ckpt_bytes"] = os.path.getsize(path)
        res["save_ms"] = rec["save_ms"]
        duty = [s for s in lines if s.startswith("duty |")]
        m = re.search(r"ckpt ([\d.]+)%", duty[-1]) if duty else None
        if not m or not any(s.startswith("| epoch  0 | step    5") for s in lines):
            fail(f"{key}: no duty line with a ckpt share, or no step-5 loss line: {lines}")
        res["duty_line"] = duty[-1]
        res["ckpt_share"] = float(m.group(1)) / 100
        t0 = time.perf_counter()
        traces = os.listdir(ca.log.profile_dir)
        trace_text = open(os.path.join(ca.log.profile_dir, traces[0])).read() if traces else ""
        found = [n for n in K5_TRACE_NAMES if n in trace_text]
        res["trace"] = dict(files=len(traces), mib=len(trace_text) / 2 ** 20, k5_names=found)
        if found != list(K5_TRACE_NAMES):
            fail(f"{key}: the loop's trace ({len(traces)} files) names {found} of K5's kernels")
        del trace_text
        res["trace_read_s"] = time.perf_counter() - t0
        hbm_dir = os.path.join(tmp, "hbm_track")
        tracked = "".join(open(os.path.join(hbm_dir, f)).read() for f in os.listdir(hbm_dir))
        res["hbm_track_lines"] = len(tracked.strip().splitlines())
        if f"At step {steps} Total HBM bytes:" not in tracked or res["hbm_track_lines"] < 3:
            fail(f"{key}: the HbmTracker file holds {tracked[:500]!r}")
        res["curves"] = ("drawn" if any(f.endswith(".png") for f in os.listdir(ca.log.ckpt_dir))
                         else "not drawn: " + next((s for s in lines if "matplotlib" in s),
                                                   "no line"))
        loss_a = float(rec["loss"][steps - 1])
        w_a = [p.detach().clone() for p in a.model.parameters()]
        res["uninterrupted_step5_loss"] = loss_a
        del a, g, real_step, real_save
        gc.collect()
        torch.cuda.empty_cache()
        res["part_s"] = {"1_loop": time.perf_counter() - t_phase}

        # 2. Trainer B: a fresh run from the checkpoint
        t_part = time.perf_counter()
        b = Trainer(None, copy.deepcopy(cfg), data, logger=lambda s: None, device=dev)
        ptrs = [t.data_ptr() for t in b._state()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.load_ckpt(path)
        torch.cuda.synchronize()
        res["load_ms"] = (time.perf_counter() - t0) * 1e3
        saved = read_checkpoint(path)
        momentum = dict(zip(momentum_names(b.model, b.optimizer), b.optimizer.bufs))
        bad = [k for k, v in b.model.state_dict().items() if not torch.equal(v.cpu(),
                                                                             saved["model"][k])]
        bad += [k for k, v in momentum.items() if not torch.equal(v.cpu(), saved["momentum"][k])]
        if bad or (b.step, b.start_epoch) != (steps - 1, 0) or saved["epoch"] != 0:
            fail(f"{key}: loaded {len(bad)} tensors unequal to the file's ({bad[:3]}), step "
                 f"{b.step}, epoch {b.start_epoch}")
        res["tensors_checked"] = len(saved["model"]) + len(saved["momentum"])
        saved = saved["model"]  # for the Predictor's check below
        del momentum
        x5, y5 = data.batches[steps - 1]

        def step5(route: str, restore=None):
            if restore is not None:
                restore()
            b.dropout.set_state(rec["gen"])
            if route == "graph":
                out = b.train_step(x5, y5)
            else:  # the eager route's step function on the same Trainer
                b.optimizer.set_lr(b.lr(b.step))
                out = b._step(b._put_batch(x5, y5))
                b.step += 1
            loss = float(out["loss"])
            return loss, [p.detach().clone() for p in b.model.parameters()]

        loss_b, w_b = step5("graph")  # the capture, then a replay
        # 3. into the captured graph, then two eager steps from the same
        # loaded state (kept on the card and copied back, as the load
        # copies: a second read of the file would only cost time)
        before = [t.data_ptr() for t in b._state()]
        loaded = []

        def load():
            b.load_ckpt(path)
            loaded[:] = [t.detach().clone() for t in b._state()]

        def back_to_loaded():
            with torch.no_grad():
                for t, v in zip(b._state(), loaded):
                    t.copy_(v)
            b.step = steps - 1

        loss_r, w_r = step5("graph", load)
        kept = [t.data_ptr() for t in b._state()] == before == ptrs
        (gb,) = (g for k, g in b.graphs.graphs.items() if k[0] == "train")
        loss_e1, w_e1 = step5("eager", back_to_loaded)
        loss_e2, w_e2 = step5("eager", back_to_loaded)
        del loaded
        spread = max_gap(w_e1, w_e2)
        scale = max(w.abs().max().item() for w in w_a)
        tol = SPREAD_MULTIPLE * spread + SPREAD_FLOOR * scale
        gaps = {"resumed_vs_uninterrupted": max_gap(w_a, w_b),
                "replay_after_load_vs_eager": max_gap(w_r, w_e1),
                "replay_after_load_vs_uninterrupted": max_gap(w_a, w_r)}
        losses = {"uninterrupted": loss_a, "resumed_graph": loss_b, "loaded_replay": loss_r,
                  "eager": loss_e1, "eager_2": loss_e2}
        res.update(step5_losses=losses, weight_gaps=gaps, eager_spread=spread, weight_tol=tol,
                   data_ptrs_kept=kept, graph_replays=gb.replays)
        if not kept or gb.replays != 2:
            fail(f"{key}: load_ckpt moved a state tensor ({kept}) or the graph replayed "
                 f"{gb.replays} times")
        if len(set(losses.values())) != 1:
            fail(f"{key}: step 5's losses from one state differ: {losses}")
        if spread == 0.0 and any(gaps.values()):
            fail(f"{key}: two eager steps agree to the bit, the resumed ones do not: {gaps}")
        if any(v > tol for v in gaps.values()):
            fail(f"{key}: weights after step 5 differ by {gaps}, past {SPREAD_MULTIPLE} x the "
                 f"eager spread {spread:.3e} (+ floor)")
        del b, gb, w_a, w_b, w_r, w_e1, w_e2
        gc.collect()
        torch.cuda.empty_cache()
        res["part_s"]["2_3_resume"] = time.perf_counter() - t_part

        # 4. serving the checkpoint
        t_part = t0 = time.perf_counter()
        pred = Predictor.from_checkpoint(cfg, path, device=dev)
        res["from_checkpoint_s"] = time.perf_counter() - t0
        eager = Predictor(cfg, device=dev, compiled=False, state=saved)  # the file read once
        bad = [k for k, v in pred.model.state_dict().items()
               if not torch.equal(v.cpu(), saved[k].to(v.dtype))]
        if bad:
            fail(f"{key}: the Predictor's {bad[:3]} are not the checkpoint's")
        del saved
        requests = [fused_inputs(cfg, 8, dev, gen) for _ in range(3)]
        reset_counts()  # the serving path's run starts here
        t0 = time.perf_counter()
        serve(pred, requests[:1])  # captures
        res["first_call_s"] = time.perf_counter() - t0
        lat, _ = serve(pred, requests)
        serve_counts = counts()  # ... and ends here
        (gp,) = pred.graphs.graphs.values()
        serve_graph = {k: v * gp.replays for k, v in gp.launches.items()}
        if not (serve_counts["inception_block"] and serve_counts["window_attn_tokens"]):
            fail(f"{key}: serving the checkpoint launched {serve_counts}")
        logits = [graph_equals_eager(pred, eager, r, f"{key} serving") for r in requests[:2]]
        if torch_equal(*logits):
            fail(f"{key}: two requests gave the same logits")
        res["serving_p50_b8_ms"] = statistics.median(lat) * 1e3
        res["phase3_graph_p50_b8_ms"] = report["serving"]["graph_route"]["p50_b8_s"] * 1e3
        del pred, eager, logits
        torch.cuda.empty_cache()
        res["part_s"]["4_serve"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # 5. the CLIs on mp4 files
        root = os.path.join(tmp, "data")
        cli = os.path.join(tmp, "cli")
        os.makedirs(cli)
        t = time.perf_counter()
        B = o.batch_size  # one optimizer step of train clips, one batch of val clips
        make_synthetic_trainset(root, B * o.accum_step, B, frames=INGEST_FRAMES, size=INGEST_SIDE,
                                seconds=INGEST_SECONDS, seed=seed)
        res["write_s"] = time.perf_counter() - t
        env = dict(os.environ, PYTHONPATH=repo)
        train = [sys.executable, "-m", "deepfake_tpu_torch.train", "--preset", "fused",
                 "--data_root", root, "-e", "1", "--log_step", "1", "--model_save", "2",
                 "--random_seed", str(cfg.random_seed)]
        log1 = os.path.join(cli, "train_1.log")
        t = time.perf_counter()
        with open(os.path.join(cli, "train_1.out"), "w") as out:
            proc = subprocess.Popen(train + ["--log_dir", log1], cwd=cli, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)
            try:
                wait_for_line(log1, "checkpoint saved", proc, 600, "train CLI")
                proc.send_signal(signal.SIGTERM)
                code = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        res["cli_first_run_s"] = time.perf_counter() - t
        text1 = open(log1).read()
        out1 = open(os.path.join(cli, "train_1.out")).read()
        saves = re.findall(r"checkpoint saved: (\S+)", text1)
        ckpt = saves[0] if saves else ""
        if code != 0 or "Program Killed by signal" not in out1 or not os.path.exists(ckpt) \
                or not ckpt.endswith("_epoch0_step1") or "| epoch  0 | step    1" not in text1:
            fail(f"train CLI: exit {code} on SIGTERM; log {text1[-2000:]} {out1[-1500:]}")
        # resumed, and stopped once epoch 0 (re-entered at step 2) has its val line
        log2 = os.path.join(cli, "train_2.log")
        t = time.perf_counter()
        with open(os.path.join(cli, "train_2.out"), "w") as out:
            proc = subprocess.Popen(train + ["--log_dir", log2, "--Resume", "--fused_ckpt_path",
                                             ckpt], cwd=cli, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)
            try:
                wait_for_line(log2, "AUC:", proc, 600, "train CLI --Resume")
                proc.send_signal(signal.SIGTERM)
                code = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        res["cli_resumed_run_s"] = time.perf_counter() - t
        text2 = open(log2).read()
        steps2 = re.findall(r"\| epoch +(\d+) \| step +(\d+) \|", text2)
        if code != 0 or f"Load Finetuned Model From:{ckpt}" not in text2 \
                or steps2[:1] != [("0", "2")]:
            fail(f"train CLI --Resume: exit {code}, steps {steps2}; log {text2[-2500:]} "
                 + open(os.path.join(cli, "train_2.out")).read()[-1500:])
        res["cli_resumed_lines"] = [ln.split(" ", 2)[-1] for ln in text2.splitlines()
                                    if "Train Loss" in ln or "Phase:" in ln]
        res["part_s"]["5_cli"] = time.perf_counter() - t_part
    report["checkpoints"] = res
    log(f"{key}: fused 8 x 4, graph route: checkpoint {res['ckpt_bytes'] / 2 ** 30:.3f} GiB, "
        f"save {res['save_ms']:.0f} ms (to the host {res['save_payload_ms']:.0f}, fsync "
        f"{res['save_fsync_ms']:.0f}), load {res['load_ms']:.0f} ms; the loop's "
        f"{res['duty_line']!r} (ckpt share {res['ckpt_share']:.3f} at model_save "
        f"{CKPT_MODEL_SAVE}); curves {res['curves']}; trace {res['trace']}; tracker "
        f"{res['hbm_track_lines']} lines; captures {res['capture_s']:.1f} s, loop "
        f"{res['loop_s']:.1f} s, trace read {res['trace_read_s']:.1f} s; parts "
        + json.dumps({k: round(v, 1) for k, v in res["part_s"].items()}) + f" ({card})")
    log(f"{key}: step 5 resumed, replayed after a load into the captured graph and eager: "
        f"losses {res['step5_losses']} (equal to the bit); weights vs uninterrupted "
        f"{json.dumps(res['weight_gaps'])}, eager spread {res['eager_spread']:.3e}; data_ptrs "
        f"kept; {res['tensors_checked']} tensors equal to the file's ({card})")
    log(f"{key}: Predictor.from_checkpoint b8 graph p50 {res['serving_p50_b8_ms']:.2f} ms "
        f"(phase 3, random weights: {res['phase3_graph_p50_b8_ms']:.2f} ms), graph = eager to "
        f"the bit ({card})")
    log(f"{key}: {B + B * o.accum_step} mp4 clips written in {res['write_s']:.1f} s; train "
        f"CLI stopped by SIGTERM after its step-1 checkpoint ({res['cli_first_run_s']:.1f} s), "
        f"resumed at step 2 of epoch 0 and stopped after its val pass "
        f"({res['cli_resumed_run_s']:.1f} s): " + " / ".join(res["cli_resumed_lines"]))
    return path, (loop_counts, loop_graph), (serve_counts, serve_graph)


def phase_video_swin_train_parity(cfg_kernel, cfg_plain, dev, gen, report, batch: int,
                                  key: str = "video_swin_train_parity"):
    """f32 (TF32 off): every parameter gradient of one micro-batch on the K5
    route against the plain route, same weights and the same DropPath and
    dropout masks (each model's own dropout stream from the same seed)."""
    import torch

    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.losses import bce_with_logits

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mk = build_model(cfg_kernel, dev, train=True)
    mp = build_model(cfg_plain, dev, train=True)
    mp.load_state_dict(mk.state_dict())
    x = clips(cfg_kernel, batch, dev, gen)
    y = (torch.rand(batch, generator=gen, device=dev) < 0.5).float()
    blocks = sum(cfg_kernel.model.swin3d_depths)
    before = counts()
    losses = []
    for m in (mk, mp):
        loss = bce_with_logits(m(x, return_logits=True)[0], y)
        loss.backward()
        losses.append(loss.item())
    after = counts()
    if (after["window_attn3d_train_fwd"] - before["window_attn3d_train_fwd"] != blocks
            or after["window_attn3d_train_bwd"] - before["window_attn3d_train_bwd"] != blocks):
        fail(f"{key}: the K5 route did not run K5 in every block")
    worst, worst_name = 0.0, ""
    for (name, a), (_, b) in zip(mk.named_parameters(), mp.named_parameters()):
        rel = ((a.grad - b.grad).abs().max() / b.grad.abs().max().clamp(min=1e-12)).item()
        if not rel <= worst:
            worst, worst_name = rel, name
    report[key] = dict(batch=batch, losses=losses, max_grad_rel_err=worst, at=worst_name)
    log(f"{key} f32 b{batch}: losses {losses[0]:.7f} / {losses[1]:.7f}; "
        f"max |grad diff| / max |grad| {worst:.2e} ({worst_name})")
    # f32 (TF32 off), summation order only
    if not (math.isfinite(worst) and worst <= 1e-4):
        fail(f"{key}: K5 and plain route gradients disagree in f32")
    del mk, mp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 11: from files

# 60 clips: 7 batches of 8 and a ragged 4 (padded), more than the
# prefetcher holds ahead (depth 4 and 2 staged), so that a warm submit
# reaches the loader's steady rate
INGEST_CLIPS, INGEST_FRAMES, INGEST_SIDE, INGEST_SECONDS = 60, 48, 256, 4.0
LONG_VIDEO_FRAMES = 96  # 5 windows of 32 every 16: one b8 batch, 3 rows padding


def csv_rows(path):
    if not os.path.exists(path):
        return []
    return [line.strip().split(",") for line in open(path) if line.strip()]


def ingest_launches(graphs):
    """(the wrappers' counts, the captured launches x replays of ``graphs``)."""
    replayed = collections.Counter()
    for g in graphs.graphs.values():
        for name, n in g.launches.items():
            replayed[name] += n * g.replays
    return counts(), dict(replayed)


def phase_ingest(cfg_fused, cfg_swin, cfg_audio, dev, report, seed: int, ckpt: str,
                 after=None):
    """The main path from video files (data ingest, SubmitCtl and the CLI),
    on the graph route (the default on the card), each kernel's counts set to
    0 before its path and read after it:
      fused: a synthetic test set of INGEST_CLIPS mp4v clips (cv2.VideoWriter,
        48 frames of 256^2, 4 s PCM sidecars) scored with the weights of
        phase 14's checkpoint ``ckpt`` (Predictor.from_checkpoint) by SubmitCtl.submit in
        b8 batches (the last, of 4, padded to 8) through K1 and K2: the first run
        captures the graph, the second is timed (clips/s from files), a third
        under torch.profiler (the device's idle share); every score equal to
        the bit to predict_raw of its batch through the same Predictor; the
        loader alone (decode and collate) by seek and by sequential sampling
        (the same frames); then the CLI (python -m deepfake_tpu_torch.test
        --Resume --fused_ckpt_path ckpt) in a subprocess, stopped by SIGTERM
        once prediction.csv holds 8 rows and run again: each clip exactly
        once, every score equal to the bit to the in-process one.
      video_swin (Video Swin-S): score_long_video on one 96-frame clip through
        K3 and K4, equal to the bit to the mean of predict_raw over its windows.
      audio (SwinV2-B, window 16, 256^2): score_file on one clip through K6
        and K2, equal to predict_raw on the clip's features.
    ``after(root, names, scores)``, where given, runs last on the same test
    set (the fused in-process scores beside it). Returns {path: (counts,
    graph launches)}."""
    import copy
    import signal

    import cv2
    import torch

    from deepfake_tpu_torch.data.audio_io import extract_wav, pad_to_bucket
    from deepfake_tpu_torch.data.chunking import aggregate_window_scores, chunk_frames
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.data.synthetic import make_synthetic_testset
    from deepfake_tpu_torch.data.video_decode import sequential_frames
    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.submit import SubmitCtl, pad_rows

    res = {"card": report["card"],
           "decode": f"cv2 {cv2.__version__} from mp4v files written by cv2.VideoWriter",
           "clips": INGEST_CLIPS, "clip": f"{INGEST_FRAMES} frames of {INGEST_SIDE}^2, "
                                         f"{INGEST_SECONDS} s PCM sidecar"}
    paths = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        t = time.perf_counter()
        names = make_synthetic_testset(root, INGEST_CLIPS, frames=INGEST_FRAMES,
                                       size=INGEST_SIDE, seconds=INGEST_SECONDS, seed=seed)
        res["write_testset_s"] = time.perf_counter() - t
        cfg = copy.deepcopy(cfg_fused)
        cfg.data.data_root = root
        B = cfg.optim.batch_size = 8

        def data(c, csv):
            return DeepFakeDataModule(c, prediction_csv=os.path.join(tmp, csv)).setup("test")

        # the loader alone: decode and collate on the host
        loaded = {}
        for method in ("seek", "sequential"):
            c = copy.deepcopy(cfg)
            c.data.decode_method = method
            t = time.perf_counter()
            loaded[method] = list(data(c, "none.csv").test_dataloader())
            res[f"loader_ms_per_clip_{method}"] = (time.perf_counter() - t) * 1e3 / INGEST_CLIPS
        if [len(b[2]) for b in loaded["seek"]] != [B] * (INGEST_CLIPS // B) + [INGEST_CLIPS % B]:
            fail(f"ingest: batches {[len(b[2]) for b in loaded['seek']]}")
        for a, b in zip(loaded["seek"], loaded["sequential"]):
            if not np.array_equal(a[0]["video"], b[0]["video"]):
                fail("ingest: seek and sequential decode kept different frames")

        # fused: SubmitCtl on the graph route
        t = time.perf_counter()
        pred = Predictor.from_checkpoint(cfg, ckpt, device=dev)
        torch.cuda.synchronize()
        res["predictor_build_s"] = time.perf_counter() - t
        spans = []
        real = pred.predict_raw

        def timed_raw(feats):
            t0 = time.perf_counter()
            out = real(feats)  # ends in a device->host copy
            spans.append((t0, time.perf_counter()))
            return out

        pred.predict_raw = timed_raw

        def submit(csv, logger=lambda s: None):
            spans.clear()
            ctl = SubmitCtl(pred, cfg, data(cfg, csv), logger=logger,
                            prediction_csv=os.path.join(tmp, csv))
            t0 = time.perf_counter()
            out = ctl.submit()
            return out, time.perf_counter() - t0

        reset_counts()  # the fused ingest path's run starts here
        first, res["first_submit_s"] = submit("first.csv", log)
        res["first_batch_s"] = spans[0][1] - spans[0][0]  # warm-up and capture included
        second, wall = submit("second.csv")
        paths["fused"] = ingest_launches(pred.graphs)  # ... and ends here
        if len(pred.graphs.graphs) != 1:
            fail(f"ingest: {len(pred.graphs.graphs)} graphs for one batch shape")
        (g,) = pred.graphs.graphs.values()
        res["graph_launches_per_batch"] = dict(g.launches)
        if not (g.launches.get("inception_block") and g.launches.get("window_attn_tokens")):
            fail(f"ingest: the fused graph launched {g.launches}: K1 and K2 expected")
        if list(first) != names or list(second) != names or second != first:
            fail("ingest: a second submit gave other names or scores")
        res["submit_s"] = wall
        res["clips_per_s_from_files"] = INGEST_CLIPS / wall
        # steady state: from the end of the first batch to the end of the last
        res["clips_per_s_steady"] = (INGEST_CLIPS - B) / (spans[-1][1] - spans[0][1])
        res["batch_s"] = [b - a for a, b in spans]
        # every score against predict_raw of its batch from the host, same graph
        for feats, _labels, bnames in loaded["seek"]:
            want = real(pad_rows(feats, B))[:len(bnames)]
            if [first[n] for n in bnames] != [float(p) for p in want]:
                fail(f"ingest: submit's scores of {bnames} differ from predict_raw's")
        rows = csv_rows(os.path.join(tmp, "first.csv"))
        if [r[0] for r in rows] != names or [float(r[1]) for r in rows] != list(first.values()):
            fail("ingest: prediction.csv does not hold the scores submit returned")
        res["device_ms_per_batch"] = cuda_time_ms(g.graph.replay, iters=10)
        busy = sum(ms for _, ms in traced(lambda: submit("profiled.csv"),
                                          warm=lambda: real(pad_rows(loaded["seek"][0][0], B))))
        res["device_busy_ms"] = busy
        res["device_idle_share"] = 1.0 - busy / (wall * 1e3)
        res["graph_pool_mib"] = pred.graphs.pool_bytes() / 2 ** 20
        del pred, g, real
        torch.cuda.empty_cache()

        # the CLI in a subprocess: SIGTERM once 8 rows are written, then resumed
        cli = os.path.join(tmp, "cli")
        os.makedirs(cli)
        cmd = [sys.executable, "-m", "deepfake_tpu_torch.test", "--preset", "fused",
               "--data_root", root, "-b", str(B), "--random_seed", str(cfg.random_seed),
               "--Resume", "--fused_ckpt_path", ckpt]
        env = dict(os.environ, PYTHONPATH=repo)
        csv = os.path.join(cli, "prediction.csv")
        t = time.perf_counter()
        with open(os.path.join(tmp, "cli_1.log"), "w") as out:
            proc = subprocess.Popen(cmd, cwd=cli, env=env, stdout=out, stderr=subprocess.STDOUT)
            try:
                while len(csv_rows(csv)) < B and proc.poll() is None:
                    if time.perf_counter() - t > 600:
                        fail("ingest: the CLI wrote no batch in 600 s")
                    time.sleep(0.05)
                proc.send_signal(signal.SIGTERM)
                code = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        log1 = open(os.path.join(tmp, "cli_1.log")).read()
        stopped = len(csv_rows(csv))
        load_line = f"Load Finetuned Model From:{ckpt}"
        if code != 0 or "Program Killed by signal" not in log1 or load_line not in log1:
            fail(f"ingest: the CLI exited {code} on SIGTERM: {log1[-2000:]}")
        res["cli_rows_before_sigterm_stop"] = stopped
        res["cli_first_run_s"] = time.perf_counter() - t
        t = time.perf_counter()
        run = subprocess.run(cmd, cwd=cli, env=env, capture_output=True, text=True, timeout=900)
        res["cli_resumed_run_s"] = time.perf_counter() - t
        if run.returncode != 0 or load_line not in run.stdout:
            fail(f"ingest: the resumed CLI run failed: {run.stdout[-2000:]} {run.stderr[-2000:]}")
        rows = csv_rows(csv)
        full = csv_rows(os.path.join(cli, "prediction_full.csv"))
        if sorted(r[0] for r in rows) != sorted(names) or [r[0] for r in rows] != names:
            fail(f"ingest: the CLI's prediction.csv rows {[r[0] for r in rows]}")
        if full[0] != ["video_name", "y_pred"] or full[1:] != rows[stopped:]:
            fail("ingest: prediction_full.csv does not hold the resumed run's rows")
        res["cli_max_abs_diff_vs_in_process"] = max(
            abs(float(r[1]) - first[r[0]]) for r in rows)
        if res["cli_max_abs_diff_vs_in_process"] != 0.0:
            fail(f"ingest: the CLI's scores of the checkpoint differ from the in-process ones "
                 f"by {res['cli_max_abs_diff_vs_in_process']:.3e}")
        torch.cuda.empty_cache()

        # video_swin: one long clip by sliding windows
        long_root = os.path.join(tmp, "long")
        (long_name,) = make_synthetic_testset(long_root, 1, frames=LONG_VIDEO_FRAMES,
                                              size=INGEST_SIDE, seconds=1.0, seed=seed + 1)
        path = os.path.join(long_root, "phase2", "testset1seen", long_name)
        cfg_s = copy.deepcopy(cfg_swin)
        pred = Predictor(cfg_s, device=dev)
        ctl = SubmitCtl(pred, cfg_s, None, logger=lambda s: None)
        reset_counts()  # the long-video path's run starts here
        score = ctl.score_long_video(path)
        t = time.perf_counter()
        score_again = ctl.score_long_video(path)
        res["long_video_s"] = time.perf_counter() - t
        paths["video_swin"] = ingest_launches(pred.graphs)  # ... and ends here
        t = time.perf_counter()
        frames = sequential_frames(path, cfg_s.data.frame_size)
        res["long_video_decode_s"] = time.perf_counter() - t
        windows = chunk_frames(frames, cfg_s.data.chunk_frames, cfg_s.data.chunk_stride)
        if frames.shape[0] != LONG_VIDEO_FRAMES or windows.shape[0] != 5:
            fail(f"ingest: {frames.shape[0]} frames, {windows.shape[0]} windows")
        want = aggregate_window_scores(
            pred.predict_raw(pad_rows({"video": windows}, 8))[:5].tolist())
        if not (score == score_again == want):
            fail(f"ingest: score_long_video {score} {score_again}, predict_raw's mean {want}")
        launched = paths["video_swin"][0]
        if not (launched["window_attn3d_tokens"] and launched["ln_linear"]
                and launched["mlp_tail"]):
            fail(f"ingest: score_long_video launched {launched}: K3 and K4 expected")
        res["long_video"] = dict(frames=LONG_VIDEO_FRAMES, windows=5, score=score)
        del pred, ctl
        torch.cuda.empty_cache()

        # audio: score_file of one clip at window 16
        cfg_a = copy.deepcopy(cfg_audio)
        pred = Predictor(cfg_a, device=dev)
        path = os.path.join(root, "phase2", "testset1seen", names[0])
        reset_counts()  # the audio file path's run starts here
        got = pred.score_file(path)
        t = time.perf_counter()
        got_again = pred.score_file(path)
        res["audio_score_file_s"] = time.perf_counter() - t
        paths["audio"] = ingest_launches(pred.graphs)  # ... and ends here
        wave = extract_wav(path, cfg_a.data.wave_sample_rate)
        buckets = [int(x * cfg_a.data.wave_sample_rate) for x in cfg_a.data.wave_seconds_buckets]
        want = pred.predict_raw({"audio_wave": pad_to_bucket(wave, buckets)[None],
                                 "audio_len": np.array([len(wave)], np.int32)})[0]
        if not (got == got_again == float(want)):
            fail(f"ingest: audio score_file {got} {got_again}, predict_raw {want}")
        launched = paths["audio"][0]
        if not (launched["window_attention_multihead"] and launched["window_attn_heads"]):
            fail(f"ingest: audio score_file launched {launched}: K6 and K2 expected")
        del pred
        torch.cuda.empty_cache()
        if after is not None:
            after(root, names, first)
    res["launches"] = {k: v[0] for k, v in paths.items()}
    res["graph_launches"] = {k: v[1] for k, v in paths.items()}
    report["ingest"] = res
    log(f"ingest: {INGEST_CLIPS} clips from files, fused b8 on the graph route: "
        f"{res['clips_per_s_from_files']:.2f} clips/s over a warm submit "
        f"({res['clips_per_s_steady']:.2f} after the first batch); loader alone "
        f"{res['loader_ms_per_clip_seek']:.1f} ms a clip by seek, "
        f"{res['loader_ms_per_clip_sequential']:.1f} by sequential; device "
        f"{res['device_ms_per_batch']:.2f} ms a batch, idle share "
        f"{res['device_idle_share']:.3f} ({res['card']})")
    log(f"ingest: CLI stopped by SIGTERM with {res['cli_rows_before_sigterm_stop']} rows, "
        f"resumed to {INGEST_CLIPS}; max |score - in-process| "
        f"{res['cli_max_abs_diff_vs_in_process']:.3e}; long video {res['long_video_s']:.2f} s, "
        f"audio score_file {res['audio_score_file_s'] * 1e3:.1f} ms")
    return paths


# ---------------------------------------------------------------- phase 16: int8 serving

K7_SRC = K8_SRC = "deepfake_tpu_torch/csrc/int8_conv.cu"
K7_DESIGN = ("Hopper redesign: s8 wgmma m64nBNk32 fed by TMA (flat rows for 1x1, a 4D box a "
             "tap, or the overlapping wide-row map with a halo shared by the taps along H and "
             "border columns a box a tap), persistent producer warp + two consumer "
             "warpgroups, epilogue staged to 16-byte stores; the RGB stem f0 on a wgmma route "
             "that gathers its own tiles")
K7_REPLACES = ("none (not Pallas): deepfake_tpu/models/layers.py:256 quant_conv, XLA's int8 "
               "conv_general_dilated and its dequantising epilogue (layers.py:322-330)")
K8_AMAX_REPLACES = ("none (not Pallas): the max-abs of deepfake_tpu/models/layers.py:224 "
                    "act_scale_for (an XLA reduction)")
K8_QUANT_REPLACES = "none (not Pallas): deepfake_tpu/models/layers.py:249 quantize_to (XLA ops)"
K8_DESIGN = ("Hopper streams: a persistent grid sized to the SMs, block-contiguous chunks, four "
             "independent 16-byte evict-first loads in flight a thread; the max writes its "
             "scalar from the last block (no memset); the quantiser stores 16 bytes a thread, "
             "its quotient by the reciprocal (the division only near a half-integer, the same "
             "bits); called once a distinct activation, a K7 output's max taken in K7's "
             "epilogue")
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores, NVIDIA data sheet


def int8_bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def int8_convs(pred, request):
    """One request through ``pred`` (eager, at int8): the number of int8 conv
    calls; {(shape, out_amax): [first call (xq, weights, amax, relu, dtype,
    out_amax), count]}; the K8 calls {(op, input shape): count} (op "amax"
    or "quantize"); and the number of convs handed their input's max from
    the producer's K7 epilogue. Every int8 conv's amax is checked against
    act_amax_plain of its input, and every epilogue max against
    act_amax_plain of its output, to the bit."""
    import torch

    from deepfake_tpu_torch.ops import int8_conv as Q

    k8, edges = collections.Counter(), [0]
    check, conv = Q._check_act, Q.quantized_conv

    def k8_spy(name, x):  # act_amax and act_quantize check their input first
        k8[name[4:], tuple(x.shape)] += 1
        return check(name, x)

    def conv_spy(x, w, static, relu, group=None, x_q=None, out_amax=False):
        out, used, out_q = conv(x, w, static, relu, group, x_q, out_amax)
        if static is None and not torch_equal(used, Q.act_amax_plain(x)):
            fail(f"int8: a conv on {tuple(x.shape)} was handed amax {used.item()}, its input's "
                 f"is {Q.act_amax_plain(x).item()}")
        if out_q is not None:
            edges[0] += 1
            if not torch_equal(out_q.amax, Q.act_amax_plain(out)):
                fail(f"K7's out_amax at {tuple(x.shape)} -> {tuple(out.shape)}: "
                     f"{out_q.amax.item()} against {Q.act_amax_plain(out).item()}")
        return out, used, out_q

    Q._check_act, Q.quantized_conv = k8_spy, conv_spy
    try:
        with Q.recorded_convs() as calls, torch.inference_mode():
            pred.predict(request)
    finally:
        Q._check_act, Q.quantized_conv = check, conv
    by_shape = {}
    for c in calls:
        by_shape.setdefault((Q.conv_key(c[0], c[1], c[3]), c[5]), [c, 0])[1] += 1
    return len(calls), by_shape, dict(k8), edges[0]


def int8_conv_cost(xq, w):
    """(operations, bytes) of one K7 launch with bf16 output: 2 M N K; the
    int8 input and weights read once, the bf16 output written once, the
    scales, shift and amax."""
    from deepfake_tpu_torch.ops.int8_conv import out_size

    cout, kh, kw, cin = w.wq.shape
    Fn, H, W, _ = xq.shape
    Ho, Wo = out_size(H, W, kh, kw, w.stride, w.pad)
    M = Fn * Ho * Wo
    return 2.0 * M * cout * kh * kw * cin, xq.numel() + w.wq.numel() + 8 * cout + 4 + 2 * M * cout


def phase_int8_kernels(shapes, k8_calls, dev, gen, report):
    """K7 and K8 against their plain versions to the bit and timed, on one
    fused b8 request's calls (``shapes``: the int8 convs with K1 on and off;
    ``k8_calls``: the K8 calls of each, {(op, input shape): count}). K7 at
    every conv shape, bf16 and f32 out, with its output's max; K8 at every
    distinct input shape on seeded bf16 and f32 values (the batch's own
    scale, and a static scale at a quarter of the batch's max, which
    saturates). Each K7 shape's kernel (with ``out_amax`` where the path
    asks for it), plain, yardstick (cuDNN's bf16 conv; torch._int_mm,
    cuBLASLt, on the 1x1 convs) and bound ms; each K8 shape's kernel, plain,
    vector_norm and bound ms; sums per request (K8: the path's calls at
    int8, and a quantisation a conv at int8_static). Returns the K7, K8 amax
    and K8 quantize rows."""
    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.ops.int8_conv import (
        act_amax, act_amax_plain, act_quantize, act_quantize_plain, int8_conv, int8_conv_plain,
    )
    from deepfake_tpu_torch.ops.int8_conv import plan as int8_plan

    keys = ("ms", "plain_ms", "bound_ms", "cudnn_bf16_ms", "int_mm_ms", "ops", "bytes",
            "amax_ms", "amax_plain_ms", "amax_bound_ms", "amax_library_ms", "quant_ms",
            "quant_plain_ms", "quant_bound_ms", "static_quant_ms", "static_quant_bound_ms")
    totals = {k1: dict.fromkeys(keys, 0.0) for k1 in ("k1_on", "k1_off")}
    rows = []
    for k1, by_shape in shapes.items():
        for (key, out_amax), ((xq, w, amax, relu, _, _), count) in by_shape.items():
            for dtype in (torch.bfloat16, torch.float32):
                got, got_max = int8_conv(xq, w, amax, relu, dtype, out_amax=True)
                want = int8_conv_plain(xq, w, amax, relu, dtype)
                torch.cuda.synchronize()
                if not torch_equal(got, want):
                    fail(f"K7 {key} {dtype}: differs from its plain version by "
                         f"{(got.float() - want.float()).abs().max().item():.3e}")
                if not torch_equal(got_max, act_amax_plain(want)):
                    fail(f"K7 {key} {dtype}: out_amax {got_max.item()} against "
                         f"{act_amax_plain(want).item()}")
            del got, want
            cout, kh, kw, cin = w.wq.shape
            p = int8_plan(tuple(xq.shape), tuple(w.wq.shape), w.stride, tuple(w.pad))
            route = ("rgb" if p.rgb else "bytes" if p.kc == 0 else "flat" if p.flat
                     else ("halo" if p.halo else "wide") if p.wide else "tap")
            ops, nbytes = int8_conv_cost(xq, w)
            bound, _ = int8_bound(ops, nbytes)
            ms = cuda_time_ms(lambda: int8_conv(xq, w, amax, relu, torch.bfloat16, out_amax),
                              iters=10)
            plain = cuda_time_ms(lambda: int8_conv_plain(xq, w, amax, relu, torch.bfloat16),
                                 iters=1, warmup=0)
            # cuDNN's bf16 conv of the same shape (channels_last; the IRv2
            # paddings are symmetric on each axis)
            xb = torch.randn(xq.shape[0], cin, xq.shape[1], xq.shape[2], device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            wb = torch.randn(cout, cin, kh, kw, device=dev).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            cudnn = cuda_time_ms(lambda: F.conv2d(xb, wb, stride=w.stride,
                                                  padding=(w.pad[0], w.pad[2])), iters=10)
            del xb, wb
            int_mm = None
            if kh == kw == 1 and w.stride == 1 and cin % 8 == 0 and cout % 8 == 0:
                a2, b2 = xq.view(-1, cin), w.wq.view(cout, cin).t()
                int_mm = cuda_time_ms(lambda: torch._int_mm(a2, b2), iters=10)
            row = dict(k1=k1, shape=[list(key[0]), list(key[1]), key[2], list(key[3]), key[4]],
                       out_amax=out_amax, route=route, bn=p.bn, count=count, ms=ms,
                       plain_ms=plain, bound_ms=bound, cudnn_bf16_ms=cudnn, int_mm_ms=int_mm,
                       gop=ops / 1e9, mbytes=nbytes / 1e6)
            rows.append(row)
            tot = totals[k1]
            for k in ("ms", "plain_ms", "bound_ms", "cudnn_bf16_ms", "int_mm_ms"):
                tot[k] += count * (row[k] or 0.0)
            tot["ops"] += count * ops
            tot["bytes"] += count * nbytes
            log(f"K7 {k1} x{count} in [{','.join(map(str, xq.shape))}] w [{cout},{kh},{kw},{cin}] "
                f"s{w.stride} pad {w.pad} ({route}, bn {p.bn}{', out_amax' if out_amax else ''}): "
                f"kernel_ms={ms:.4f} plain_ms={plain:.3f} cudnn_bf16_ms={cudnn:.4f} "
                + (f"int_mm_ms={int_mm:.4f} " if int_mm is not None else "")
                + f"bound_ms={bound:.4f} ({ops / 1e9:.2f} GOP, {nbytes / 1e6:.1f} MB)")
    # K8 at every distinct input shape: the path's calls, and at int8_static
    # one quantisation a conv on its input
    static = {k1: collections.Counter() for k1 in shapes}
    for k1, by_shape in shapes.items():
        for (key, _), (_, count) in by_shape.items():
            static[k1][tuple(key[0])] += count
    k8_rows = []
    for shape in sorted({sh for k1 in shapes for sh in static[k1]}, key=math.prod):
        for dtype in (torch.float32, torch.bfloat16):  # bf16 last: timed below
            x = (0.5 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
            a = act_amax(x)
            torch.cuda.synchronize()
            if not torch_equal(a, act_amax_plain(x)):
                fail(f"K8 amax at {shape} {dtype}: {a.item()} against "
                     f"{act_amax_plain(x).item()}")
            for scale in (a, 0.25 * a):  # the batch's max; a static scale below it
                q = act_quantize(x, scale)
                torch.cuda.synchronize()
                if not torch_equal(q, act_quantize_plain(x, scale)):
                    fail(f"K8 quantize at {shape} {dtype} differs from its plain version")
            if q.abs().max().item() != 127:
                fail(f"K8 quantize at {shape}: a quarter of the max did not saturate")
        r = dict(shape=list(shape), mbytes=2 * x.numel() / 1e6,
                 amax_ms=cuda_time_ms(lambda: act_amax(x), iters=10),
                 amax_plain_ms=cuda_time_ms(lambda: act_amax_plain(x), iters=3),
                 amax_library_ms=cuda_time_ms(
                     lambda: torch.linalg.vector_norm(x, ord=math.inf), iters=10),
                 quant_ms=cuda_time_ms(lambda: act_quantize(x, a), iters=10),
                 quant_plain_ms=cuda_time_ms(lambda: act_quantize_plain(x, a), iters=3),
                 amax_bound_ms=int8_bound(0, 2 * x.numel() + 4)[0],
                 quant_bound_ms=int8_bound(0, 3 * x.numel() + 4)[0],
                 calls={k1: dict(amax=k8_calls[k1].get(("amax", shape), 0),
                                 quantize=k8_calls[k1].get(("quantize", shape), 0),
                                 static_quantize=static[k1].get(shape, 0)) for k1 in shapes})
        k8_rows.append(r)
        for k1 in shapes:
            c, tot = r["calls"][k1], totals[k1]
            for k in ("amax_ms", "amax_plain_ms", "amax_bound_ms", "amax_library_ms"):
                tot[k] += c["amax"] * r[k]
            for k in ("quant_ms", "quant_plain_ms", "quant_bound_ms"):
                tot[k] += c["quantize"] * r[k]
            tot["static_quant_ms"] += c["static_quantize"] * r["quant_ms"]
            tot["static_quant_bound_ms"] += c["static_quantize"] * r["quant_bound_ms"]
        log(f"K8 at [{','.join(map(str, shape))}] ({r['mbytes']:.1f} MB bf16), calls "
            f"{json.dumps(r['calls'])}: amax {r['amax_ms']:.4f} (plain {r['amax_plain_ms']:.4f}, "
            f"vector_norm {r['amax_library_ms']:.4f}, bound {r['amax_bound_ms']:.4f}) quantize "
            f"{r['quant_ms']:.4f} (plain {r['quant_plain_ms']:.4f}, bound "
            f"{r['quant_bound_ms']:.4f})")
        del x, q
    report["int8_kernels"] = rows
    report["int8_k8_kernels"] = k8_rows
    report["int8_kernel_totals"] = totals
    torch.cuda.empty_cache()
    for name in ("int8_conv", "act_amax", "act_quantize"):
        wrappers()[name].launches = 0
    on, off = totals["k1_on"], totals["k1_off"]
    _, by = int8_bound(on["ops"], on["bytes"])
    log(f"K7 per fused b8 request, K1 on (24 convs): kernel_ms={on['ms']:.3f} "
        f"plain_ms={on['plain_ms']:.2f} cudnn_bf16_ms={on['cudnn_bf16_ms']:.3f} "
        f"int_mm_ms (1x1 only)={on['int_mm_ms']:.3f} bound_ms={on['bound_ms']:.4f} ({by}); "
        f"K1 off (244 convs): kernel_ms={off['ms']:.3f} plain_ms={off['plain_ms']:.2f} "
        f"cudnn_bf16_ms={off['cudnn_bf16_ms']:.3f} bound_ms={off['bound_ms']:.4f}")
    for k1, t in totals.items():
        log(f"K8 per fused b8 request, {k1}: amax {t['amax_ms']:.4f} ms (vector_norm of the "
            f"same tensors {t['amax_library_ms']:.4f}, bound {t['amax_bound_ms']:.4f}), quantize "
            f"{t['quant_ms']:.4f} (bound {t['quant_bound_ms']:.4f}), in all "
            f"{t['amax_ms'] + t['quant_ms']:.4f} (bound "
            f"{t['amax_bound_ms'] + t['quant_bound_ms']:.4f}); int8_static's quantisations "
            f"{t['static_quant_ms']:.4f} (bound {t['static_quant_bound_ms']:.4f})")
    per = "one fused b8 request, K1 on: the 24 IRv2 convs outside the blocks, bf16 out"
    per_k8 = ("one fused b8 request, K1 on: the calls the path makes on its bf16 activations "
              "(7 maxima, 19 quantisations), each shape timed alone")
    extra = lambda t, *ks: {k: t[k] for k in ks}
    return [
        dict(name="int8_conv (K7)", route="cuda", source=K7_SRC, replaces=K7_REPLACES,
             design=K7_DESIGN,
             launches=None, max_abs_err=0.0, ms=on["ms"], plain_ms=on["plain_ms"],
             bound_ms=on["bound_ms"], bound_by=by, library_ms=on["cudnn_bf16_ms"],
             library="cuDNN bf16 conv of each shape (F.conv2d), summed",
             int_mm_ms_1x1=on["int_mm_ms"], per=per,
             k1_off=extra(off, "ms", "plain_ms", "bound_ms", "cudnn_bf16_ms", "int_mm_ms")),
        dict(name="act_amax (K8, launch 1)", route="cuda", source=K8_SRC,
             replaces=K8_AMAX_REPLACES, design=K8_DESIGN, launches=None, max_abs_err=0.0,
             ms=on["amax_ms"], plain_ms=on["amax_plain_ms"], bound_ms=on["amax_bound_ms"],
             bound_by="bytes", library_ms=on["amax_library_ms"],
             library="torch.linalg.vector_norm(x, ord=inf) of each input, summed", per=per_k8,
             k1_off=extra(off, "amax_ms", "amax_plain_ms", "amax_bound_ms", "amax_library_ms")),
        dict(name="act_quantize (K8, launch 2)", route="cuda", source=K8_SRC,
             replaces=K8_QUANT_REPLACES, design=K8_DESIGN, launches=None, max_abs_err=0.0,
             ms=on["quant_ms"], plain_ms=on["quant_plain_ms"], bound_ms=on["quant_bound_ms"],
             bound_by="bytes", library_ms=None, per=per_k8,
             int8_static=extra(on, "static_quant_ms", "static_quant_bound_ms"),
             k1_off=extra(off, "quant_ms", "quant_plain_ms", "quant_bound_ms"))]


def corr(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, np.float64).ravel(),
                             np.asarray(b, np.float64).ravel())[0, 1])


def phase_int8(cfg, dev, gen, report, requests, bf16_logits, bf16_feats):
    """Fused serving at model.irv2_quant = int8, then int8_static after
    SubmitCtl.calibrate on one b8 batch, on phase 3's weights (the same
    seed) and requests (three b8, one b1): the eager route with the launch
    counters (24 K7, 7 + 19 K8 per request at int8; 24 K7 and 24 K8 at
    int8_static, no amax), then as CUDA graphs (graph = eager to the bit;
    graph_route's checks), both routes' logits equal to the per-conv
    route's (per_conv_quantization) to the bit, K7's and K8's device ms a
    graph request (profiler), static on its calibration batch equal to
    dynamic to the bit, and each mode's logits' and IRv2 features' correlation with
    phase 3's bf16 route (>= 0.99, tests/test_quantize.py:153's bar on the
    features; the logits of random weights move little with the trunk);
    then one b8 request
    with irv2_fused_blocks off (244 K7); then K7 and K8 against their plain
    versions at every conv shape of both (``phase_int8_kernels``). Returns
    the kernel rows, their launches and graph launches set."""
    import copy

    import torch

    from deepfake_tpu_torch.ops.int8_conv import per_conv_quantization
    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.submit import SubmitCtl

    res, shapes, k8 = {}, {}, {}
    # K7, K8 max and K8 quantisation launches a request
    want_k = {"int8": (24, 7, 19), "int8_static": (24, 0, 24)}
    eager_of = {}
    launches = graph_launches = None
    for quant in ("int8", "int8_static"):
        c = copy.deepcopy(cfg)
        c.model.irv2_quant = quant
        eager = Predictor(c, device=dev, compiled=False)
        graph = Predictor(c, device=dev)
        if quant == "int8":
            n, shapes["k1_on"], k8["k1_on"], edges = int8_convs(eager, requests[0])
            if n != 24 or edges != 12:
                fail(f"int8: a fused b8 request made {n} int8 convs, {edges} of them handed "
                     "their input's max by K7's epilogue; expected 24 and 12")
        else:
            t = time.perf_counter()
            calibrated = [SubmitCtl(p, c, None, logger=lambda s: None).calibrate([requests[0]])
                          for p in (eager, graph)]
            res["calibrate_s"] = time.perf_counter() - t
            if calibrated != [24, 24]:
                fail(f"int8_static: calibrate recorded {calibrated} scales, expected 24 each")
        serve(eager, [requests[0], requests[-1]])  # warm-up at both batch sizes
        torch.cuda.synchronize()
        reset_counts()  # this mode's main-path run starts here
        lat, per_req, scores = [], [], []
        for r in requests:
            before = counts()
            (t,), (sc,) = serve(eager, [r])
            after = counts()
            lat.append(t)
            scores.append(sc)
            per_req.append({k: after[k] - before[k] for k in after})
        counted = counts()  # ... and ends here
        want = dict(zip(("int8_conv", "act_amax", "act_quantize"), want_k[quant]),
                    inception_block=40)
        for i, d in enumerate(per_req):
            if any(d[k] != v for k, v in want.items()) or not d["window_attn_tokens"] + d[
                    "window_attn_heads"]:
                fail(f"{quant} request {i}: launches {d}, expected {want} and K2")
        rg = graph_route(graph, eager, requests, scores, per_req, f"{quant} serving")
        with torch.inference_mode():
            logits = torch.cat([eager.forward(r, return_logits=True).float() for r in requests])
            replayed = torch.cat([graph.forward(r, return_logits=True).float()
                                  for r in requests])
            with per_conv_quantization():
                per_conv = torch.cat([eager.forward(r, return_logits=True).float()
                                      for r in requests])
        if not (torch_equal(logits, per_conv) and torch_equal(replayed, per_conv)):
            fail(f"{quant} serving: the logits differ from the per-conv route's by "
                 f"{(logits - per_conv).abs().max().item():.3e} (eager), "
                 f"{(replayed - per_conv).abs().max().item():.3e} (graph)")
        # K7's and K8's device time in one graph request (profiler)
        by_name = device_kernel_ms(lambda: graph.predict(requests[0]), iters=3)
        dev_ms = {k: sum(t for name, t in by_name.items() if "i8::" in name and f(name))
                  for k, f in (("k7", lambda n: "_stream<" not in n),
                               ("k8_amax", lambda n: "amax_stream<" in n),
                               ("k8_quantize", lambda n: "quantize_stream<" in n))}
        eager_of[quant] = eager
        rho = corr(logits.cpu(), bf16_logits.cpu())
        rho_feat = corr(irv2_features(eager, requests[0]).cpu(), bf16_feats.cpu())
        res[quant] = dict(p50_b8_s=statistics.median(lat[:3]),
                          clips_per_s_b8=8 * 3 / sum(lat[:3]), b1_latency_s=lat[3],
                          per_request_launches=per_req, graph_route=rg,
                          device_ms_graph_b8=dev_ms, per_conv_route_logits_equal=True,
                          logit_corr_vs_bf16=rho, irv2_feature_corr_vs_bf16=rho_feat,
                          max_abs_logit_diff_vs_bf16=(logits - bf16_logits).abs().max().item(),
                          profile={"eager b8": profile_call(lambda: eager.predict(requests[0]),
                                                            statistics.median(lat[:3]) * 1e3)})
        if quant == "int8":
            launches, graph_launches = counted, rg["launches"]
        bf = report["serving"]["graph_route"]
        log(f"{quant} serving: eager b8 p50 {res[quant]['p50_b8_s'] * 1e3:.2f} ms, "
            f"{res[quant]['clips_per_s_b8']:.2f} clips/s, b1 {lat[3] * 1e3:.2f} ms, idle share "
            f"{res[quant]['profile']['eager b8']['device_idle_share']:.3f}; graph route b8 p50 "
            f"{rg['p50_b8_s'] * 1e3:.2f} ms, {rg['clips_per_s_b8']:.2f} clips/s, b1 "
            f"{rg['b1_latency_s'] * 1e3:.2f} ms, idle share "
            f"{rg['profile']['graph route b8']['device_idle_share']:.3f} (bf16 route, phase 3: "
            f"graph b8 p50 {bf['p50_b8_s'] * 1e3:.2f} ms, {bf['clips_per_s_b8']:.2f} clips/s, "
            f"b1 {bf['b1_latency_s'] * 1e3:.2f} ms, idle share "
            f"{bf['profile']['graph route b8']['device_idle_share']:.3f}); launches per request "
            f"{json.dumps({k: per_req[0][k] for k in want})}; device ms of a graph b8 request "
            f"{json.dumps({k: round(v, 4) for k, v in dev_ms.items()})}; logits equal to the "
            f"per-conv route's (eager and graph); logits' correlation with the bf16 "
            f"route {rho:.5f}, max |diff| {res[quant]['max_abs_logit_diff_vs_bf16']:.3e}; IRv2 "
            f"features' (b8, 256 frames x 1536) {rho_feat:.5f} ({report['card']})")
        if not (rho >= 0.99 and rho_feat >= 0.99):
            fail(f"{quant} serving: correlation with the bf16 route {rho:.5f} (logits), "
                 f"{rho_feat:.5f} (IRv2 features)")
        del graph
        torch.cuda.empty_cache()
    # static on its calibration batch runs the dynamic ops on the same scales
    a, b = (eager_of[q].forward(requests[0], return_logits=True) for q in ("int8", "int8_static"))
    if not torch_equal(a, b):
        fail("int8_static on its calibration batch differs from int8")
    del eager_of, a, b
    torch.cuda.empty_cache()
    # K1 off: all 244 convs int8
    c = copy.deepcopy(cfg)
    c.model.irv2_quant = "int8"
    c.model.irv2_fused_blocks = False
    off = Predictor(c, device=dev, compiled=False)
    n, shapes["k1_off"], k8["k1_off"], edges = int8_convs(off, requests[0])
    calls = [sum(c for (op, _), c in k8["k1_off"].items() if op == o) for o in ("amax", "quantize")]
    if n != 244 or edges != 102 or calls != [87, 189]:
        fail(f"int8 with K1 off: a fused b8 request made {n} int8 convs, {edges} of them handed "
             f"their input's max by K7's epilogue, {calls} K8 maxima and quantisations; expected "
             "244, 102 and [87, 189]")
    (t_off,), _ = serve(off, [requests[0]])
    res["k1_off"] = dict(latency_b8_s=t_off, int8_convs=n)
    log(f"int8 serving, K1 off: one b8 request through 244 int8 convs, eager {t_off * 1e3:.1f} "
        f"ms (warm)")
    del off
    torch.cuda.empty_cache()
    rows = phase_int8_kernels(shapes, k8, dev, gen, report)
    del shapes
    torch.cuda.empty_cache()
    for row, name, d in zip(rows, ("int8_conv", "act_amax", "act_quantize"),
                            ("k7", "k8_amax", "k8_quantize")):
        row["launches"] = launches[name]
        row["graph_launches"] = graph_launches.get(name, 0)
        row["device_ms"] = res["int8"]["device_ms_graph_b8"][d]
        row["device_ms_int8_static"] = res["int8_static"]["device_ms_graph_b8"][d]
    report["int8"] = res
    return rows


def int8_cli(root, names, scores, ckpt, seed: int, report):
    """The inference CLI at --set model.irv2_quant=int8 over phase 11's test
    set (its checkpoint, --Resume): every clip once, finite scores in [0, 1],
    their distance from phase 11's bf16 in-process scores printed."""
    with tempfile.TemporaryDirectory() as cwd:
        cmd = [sys.executable, "-m", "deepfake_tpu_torch.test", "--preset", "fused",
               "--data_root", root, "-b", "8", "--random_seed", str(seed), "--Resume",
               "--fused_ckpt_path", ckpt, "--set", "model.irv2_quant=int8"]
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t = time.perf_counter()
        run = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t
        if run.returncode != 0:
            fail(f"int8 CLI: exit {run.returncode}: {run.stdout[-2000:]} {run.stderr[-2000:]}")
        rows = csv_rows(os.path.join(cwd, "prediction.csv"))
    got = [float(r[1]) for r in rows]
    if [r[0] for r in rows] != names or not all(0.0 <= p <= 1.0 for p in got):
        fail(f"int8 CLI: prediction.csv rows {rows[:3]}...")
    diff = max(abs(p - scores[n]) for n, p in zip(names, got))
    report["int8"]["cli"] = dict(wall_s=wall, clips=len(rows), max_abs_score_diff_vs_bf16=diff)
    log(f"int8 CLI: {len(rows)} clips from files at irv2_quant=int8 in {wall:.1f} s (process "
        f"start, build and capture included); max |score - bf16 in-process| {diff:.3e}")


# --------------------------------------------------- phase 17: model options

REMAT_POLICIES = ("", "dots", "dots,dots,off,off")


def remat_step_launches(cfg, depths):
    """K5's launches in one remat step of a model whose K5 blocks are
    ``depths`` a stage: a forward per block and micro-batch, another per
    checkpointed block (its recompute in the backward), a backward per
    block."""
    from deepfake_tpu_torch.models.layers import block_remat

    p, n = cfg.parallel, cfg.optim.accum_step
    again = sum(d for i, d in enumerate(depths)
                if block_remat(p.remat, p.remat_policy, i) is not None)
    return {"window_attn3d_train_fwd": n * (sum(depths) + again),
            "window_attn3d_train_bwd": n * sum(depths)}


def with_remat(cfg, policy: str):
    c = copy.deepcopy(cfg)
    c.parallel.remat, c.parallel.remat_policy = True, policy
    return c


def remat_graph_steps(cfg, raw, steps, depths, dev, key):
    """``steps`` graph steps of a remat Trainer (capture, then replays):
    losses, weights, the captured K5 launches (checked), p50 of the
    replays' step ms, peak GB and the graph pool."""
    import torch

    from deepfake_tpu_torch.train.trainer import Trainer

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    t = Trainer(None, cfg, raw, logger=lambda line: None, device=dev)
    r, w, _ = assembled_steps(t, raw, steps, key=key)
    (g,) = (g for k, g in t.graphs.graphs.items() if k[0] == "train")
    want = remat_step_launches(cfg, depths)
    if g.launches != want or g.replays != steps:
        fail(f"{key}: captured launches {g.launches} x {g.replays} replays, expected {want} x "
             f"{steps}")
    if r["per_step_launches"][1:] != [{}] * (steps - 1):
        fail(f"{key}: a replay moved the launch counters: {r['per_step_launches']}")
    r.update(launches=dict(g.launches), p50_step_ms=statistics.median(r["step_ms"][1:]),
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
             allocated_before_gb=base, pool_bytes=t.graphs.pool_bytes())
    del t
    torch.cuda.empty_cache()
    return r, w


def phase_remat(cfg, cfg_swin, dev, report, det_graph, swin_train):
    """Phase 17 (a), activation checkpointing (``parallel.remat``) at full
    width on the graph route. The fused model at 8 x 4 at each of
    REMAT_POLICIES, in the deterministic configuration: three steps equal
    phase 12's deterministic graph steps without remat to the bit, in losses
    and weights (the recompute draws the forward's masks again); K5's
    forward launches once more per recomputed SwinV2-B block and
    micro-batch (192 a step at "" and "dots", 112 at "dots,dots,off,off",
    where stages 0-1's 2 + 2 blocks recompute), its backward 96. Video
    Swin-S at 8 x 4 at "" on phase 6's clips: losses within phase 6's spread
    rule of its eager steps, K5's forward 192 a step. Each beside phase 12's
    and phase 6's graph step ms, peak GB and pool. Returns the K5 launches a
    step by path and policy."""
    import torch

    raw, rdg, w_dg, _ = det_graph
    steps = len(rdg["losses"])
    res, launches = {"fused": {}, "video_swin": {}}, {"fused": {}, "video_swin": {}}
    det = report["fused_train"]["deterministic"]
    with deterministic():
        for policy in REMAT_POLICIES:
            c = with_remat(cfg, policy)
            key = f"remat {policy!r} fused graph"
            r, w = remat_graph_steps(c, raw, steps, c.model.swin2d_depths, dev, key)
            gap = max_gap(w_dg, w)
            del w
            if r["losses"] != rdg["losses"] or gap != 0.0:
                fail(f"{key}: losses {r['losses']} and weights (by {gap:.3e}) are not phase 12's "
                     f"deterministic graph steps' {rdg['losses']} to the bit")
            res["fused"][policy] = {k: r[k] for k in (
                "losses", "step_ms", "p50_step_ms", "max_memory_allocated_gb",
                "allocated_before_gb", "pool_bytes", "launches")}
            launches["fused"][policy] = r["launches"]
    raw_s, eager_losses, loss_tol = swin_train
    c = with_remat(cfg_swin, "")
    key = "remat '' video_swin graph"
    r, w = remat_graph_steps(c, raw_s, len(eager_losses), c.model.swin3d_depths, dev, key)
    del w
    loss_gap = max(abs(a - b) for a, b in zip(r["losses"], eager_losses))
    if not loss_gap <= loss_tol:
        fail(f"{key}: losses {r['losses']} differ from phase 6's eager steps {eager_losses} by "
             f"{loss_gap:.3e}, past its spread rule {loss_tol:.3e}")
    res["video_swin"][""] = {k: r[k] for k in (
        "losses", "step_ms", "p50_step_ms", "max_memory_allocated_gb", "allocated_before_gb",
        "pool_bytes", "launches")}
    res["video_swin"][""]["loss_gap"] = loss_gap
    launches["video_swin"][""] = r["launches"]
    report["remat"] = res
    p12 = det["graph_step_ms"]
    log(f"remat fused 8 x 4, deterministic graph ({report['card']}): off (phase 12) steps "
        f"{[round(t, 1) for t in p12]} ms, p50 of replays {statistics.median(p12[1:]):.1f} ms, "
        f"peak {det['graph_peak_gb']:.2f} GB, pool {det['graph_pool_bytes'] / 2 ** 20:.0f} MiB")
    for policy, rr in res["fused"].items():
        log(f"remat fused {policy!r}: steps {[round(t, 1) for t in rr['step_ms']]} ms, p50 of "
            f"replays {rr['p50_step_ms']:.1f} ms, peak {rr['max_memory_allocated_gb']:.2f} GB "
            f"({rr['allocated_before_gb']:.2f} before), pool {rr['pool_bytes'] / 2 ** 20:.0f} "
            f"MiB, K5 {rr['launches']} a step; losses equal phase 12's to the bit")
    g6 = report["video_swin_train"]["graph"]
    rr = res["video_swin"][""]
    log(f"remat video_swin 8 x 4 graph ({report['card']}): off (phase 6) p50 "
        f"{g6['p50_step_ms']:.1f} ms, peak {g6['max_memory_allocated_gb']:.2f} GB, pool "
        f"{g6['pool_bytes'] / 2 ** 20:.0f} MiB; '' steps {[round(t, 1) for t in rr['step_ms']]} "
        f"ms, p50 of replays {rr['p50_step_ms']:.1f} ms, peak {rr['max_memory_allocated_gb']:.2f} "
        f"GB, pool {rr['pool_bytes'] / 2 ** 20:.0f} MiB, K5 {rr['launches']} a step, loss gap "
        f"{loss_gap:.3e} (tolerance {loss_tol:.3e})")
    return launches


def phase_attention_pool(cfg, dev, gen, report, steps: int = 3):
    """Phase 17 (b), Video Swin-S at ``--video_pool Attention`` (the head's
    convs, BatchNorms, CLS token and six encoder layers in PyTorch; the
    backbone on K3 and K4): three b8 requests on the eager route and as a
    graph, the graph's scores, logits and 512-d frame tokens equal to the
    eager route's to the bit, K3 and K4 launching per request as at mean
    pooling (``k4_launches``); then ``steps`` training steps at 8 x 4 (K5,
    the head's BatchNorms on batch statistics) eager, eager again and as a
    graph, the graph within phase 6's spread rule. Returns the launches of
    one eager request and of one step."""
    import torch

    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.trainer import Trainer

    c = copy.deepcopy(cfg)
    c.model.video_pool = "Attention"
    key = "video_swin attention pool"
    res = {}
    eager = Predictor(c, device=dev, compiled=False)
    graph = Predictor(c, device=dev)
    requests = [clips(c, 8, dev, gen) for _ in range(3)]
    reset_counts()
    eager.predict(requests[0])
    per_req = counts()
    ln, tail = k4_launches(c)
    want = {"window_attn3d_tokens": sum(c.model.swin3d_depths), "ln_linear": ln,
            "mlp_tail": tail}
    got = {k: per_req[k] for k in want}
    if got != want:
        fail(f"{key}: one eager b8 request launched {got}, expected {want} (mean pooling's)")
    lat_e, _ = serve(eager, requests)
    serve(graph, requests[:1])  # the capture
    lat_g, _ = serve(graph, requests)
    logits = [graph_equals_eager(graph, eager, r, key) for r in requests]
    if torch_equal(logits[0], logits[1]):
        fail(f"{key}: two requests gave the same logits")
    feat = graph.forward(requests[0])[1]
    if tuple(feat.shape) != (8, c.data.num_frames // c.model.swin3d_patch[0], 512):
        fail(f"{key}: frame tokens of shape {tuple(feat.shape)}")
    res["serve"] = dict(eager_ms=[t * 1e3 for t in lat_e], graph_ms=[t * 1e3 for t in lat_g],
                        launches_per_request=got, graph_pool_bytes=graph.graphs.pool_bytes())
    del eager, graph
    torch.cuda.empty_cache()

    o = c.optim
    raw = RawClips(c, o.batch_size * o.accum_step, steps, dev, gen)
    runs = []
    for compiled in (False, False, True):
        torch.cuda.reset_peak_memory_stats()
        t = Trainer(None, c, raw, logger=lambda line: None, device=dev, compiled=compiled)
        before = counts()
        r, w, _ = assembled_steps(t, raw, steps, key=f"{key} train")
        after = counts()
        r["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        runs.append((r, w, {k: after[k] - before[k] for k in after if after[k] != before[k]}))
        del t
        torch.cuda.empty_cache()
    (r1, w1, step_launches), (r2, w2, _), (rg, wg, _) = runs
    loss_spread = max(abs(a - b) for a, b in zip(r1["losses"], r2["losses"]))
    loss_tol = SPREAD_MULTIPLE * loss_spread + SPREAD_FLOOR * max(abs(v) for v in r1["losses"])
    w_tol = (SPREAD_MULTIPLE * max_gap(w1, w2)
             + SPREAD_FLOOR * max(x.abs().max().item() for x in w1))
    loss_gap = max(abs(a - b) for a, b in zip(r1["losses"], rg["losses"]))
    w_gap = max_gap(w1, wg)
    del w1, w2, wg
    if not (loss_gap <= loss_tol and w_gap <= w_tol):
        fail(f"{key} train: the graph's losses and weights differ from the eager route's by "
             f"{loss_gap:.3e} / {w_gap:.3e}, past the spread rule {loss_tol:.3e} / {w_tol:.3e}")
    k5_want = k5_step_launches(c)
    if {k: v // steps for k, v in step_launches.items()} != k5_want:
        fail(f"{key} train: {steps} eager steps launched {step_launches}, expected {k5_want} a "
             f"step")
    res["train"] = dict(eager_losses=r1["losses"], graph_losses=rg["losses"],
                        eager_step_ms=r1["step_ms"], graph_step_ms=rg["step_ms"],
                        eager_peak_gb=r1["max_memory_allocated_gb"],
                        graph_peak_gb=rg["max_memory_allocated_gb"], loss_gap=loss_gap,
                        loss_tol=loss_tol, weight_gap=w_gap, weight_tol=w_tol)
    report["attention_pool"] = res
    tr = res["train"]
    log(f"{key} b8 ({report['card']}): eager {[round(t, 2) for t in res['serve']['eager_ms']]} "
        f"ms, graph {[round(t, 2) for t in res['serve']['graph_ms']]} ms (equal to the bit), "
        f"launches a request {got}; train 8 x 4: eager steps "
        f"{[round(t, 1) for t in tr['eager_step_ms']]} ms, graph "
        f"{[round(t, 1) for t in tr['graph_step_ms']]} ms, peak {tr['graph_peak_gb']:.2f} GB, "
        f"graph vs eager {loss_gap:.3e} / {w_gap:.3e} (tolerance {loss_tol:.3e} / {w_tol:.3e})")
    return {**per_req, **{k: v // steps for k, v in step_launches.items()}}


def phase_cnns(dev, gen, report, seed: int):
    """Phase 17 (c), the alternative CNNs (models/iresnet.py): iResNet with
    bottleneck blocks (2, 2, 2, 2) and Res34 on one b8 x 32-frame batch
    (256 images of 224^2), seeded weights and BatchNorm statistics: bf16
    against f32 on the card (TF32 off), the relative error (max |diff| /
    max |f32|), each one's ms (CUDA events), and one train-mode forward and
    backward in bf16 compute on f32 masters (BatchNorm on batch statistics;
    ms, finite gradients)."""
    import torch

    from deepfake_tpu_torch.models.iresnet import IResNet, Res34
    from deepfake_tpu_torch.models.layers import init_weights

    x = torch.randn(256, 224, 224, 3, generator=gen, device=dev)
    xb = x.bfloat16()
    res = {}
    for name, build in (("iresnet_bottleneck", lambda: IResNet("bottleneck", (2, 2, 2, 2))),
                        ("res34", Res34)):
        m = build().to(dev)
        init_weights(m, torch.Generator(dev).manual_seed(seed))
        randomize_bn(m, gen)
        mb = copy.deepcopy(m)
        with torch.no_grad():
            for p in mb.parameters():
                p.data = p.data.bfloat16()
        with torch.inference_mode():
            want, got = m(x), mb(xb).float()
            ms = cuda_time_ms(lambda: m(x)), cuda_time_ms(lambda: mb(xb))
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if not (bool(torch.isfinite(got).all()) and rel <= 5e-2):
            fail(f"{name}: bf16 against f32 on the card: relative error {rel:.3e}")
        m.train()

        def step():
            for p in m.parameters():
                p.grad = None
            (m(xb).float() ** 2).mean().backward()

        step()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        train_ms = cuda_time_ms(step, iters=1, warmup=0)
        grads_ok = all(bool(torch.isfinite(p.grad).all()) for p in m.parameters())
        if not grads_ok:
            fail(f"{name}: a train-mode backward gave non-finite gradients")
        res[name] = dict(out_shape=list(want.shape), rel_err_bf16=rel, f32_ms=ms[0],
                         bf16_ms=ms[1], train_fwd_bwd_ms=train_ms,
                         train_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"{name} b256 x 224^2 ({report['card']}): out {list(want.shape)}, bf16 vs f32 "
            f"relative error {rel:.3e}; f32 {ms[0]:.2f} ms, bf16 {ms[1]:.2f} ms; train forward "
            f"+ backward (bf16 compute) {train_ms:.2f} ms, peak "
            f"{res[name]['train_peak_gb']:.2f} GB, gradients finite")
        del m, mb, want, got
        torch.cuda.empty_cache()
    report["cnns"] = res


def phase_inference_dropout(cfg, dev, gen, report):
    """Phase 17 (d), ``model.parity_inference_dropout`` on fused b8 requests
    (the IRv2 pool's, NeXtVLAD's and the paudio feature's dropouts active at
    serving): two equal requests give equal scores, on each route, the
    graph equals the eager route to the bit (scores and logits), and the
    logits differ from a flag-off Predictor's (the dropouts act)."""
    from deepfake_tpu_torch.serving import Predictor

    c = copy.deepcopy(cfg)
    c.model.parity_inference_dropout = True
    eager = Predictor(c, device=dev, compiled=False)
    graph = Predictor(c, device=dev)
    r = fused_inputs(c, 8, dev, gen)
    other = fused_inputs(c, 8, dev, gen)
    scores = {}
    for name, pred in (("eager", eager), ("graph", graph)):
        _, (a, b) = serve(pred, [r, r])
        if not np.array_equal(a, b):
            fail(f"inference dropout {name}: two equal requests gave {a} and {b}")
        scores[name] = a
    for req in (r, other, r):
        on = graph_equals_eager(graph, eager, req, "inference dropout")
    del eager, graph
    off = Predictor(cfg, device=dev, compiled=False).forward(r, return_logits=True)
    off = off[0] if isinstance(off, tuple) else off
    moved = (on.float() - off.float()).abs().max().item()
    if torch_equal(on, off):
        fail("inference dropout: the logits equal the flag-off Predictor's (no dropout acted)")
    report["inference_dropout"] = dict(scores=scores["graph"].tolist(), max_logit_change=moved)
    log(f"inference dropout fused b8 ({report['card']}): repeated requests equal, graph equal to "
        f"eager to the bit, logits {moved:.3e} from the flag-off Predictor's at most; scores "
        f"{np.round(scores['graph'], 4).tolist()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", help="write the detailed report as JSON to this path")
    args = ap.parse_args()

    # cuBLAS repeats its sums only with a fixed workspace, set before its
    # first call (phases 12 and 15 run the deterministic configuration)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from deepfake_tpu_torch.config import Config
    from deepfake_tpu_torch.kernels import build

    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "k1": [], "k2": [], "k3": [], "k4": [], "k5": [], "k6": []}
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t = time.perf_counter()
    ptxas = build.build_all()
    report["build_s"] = time.perf_counter() - t
    log(f"build: {report['build_s']:.1f} s for {list(build.SOURCES)}")
    for name, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    gen = torch.Generator(dev).manual_seed(args.seed)
    laps, mark = {}, [time.perf_counter()]

    def lap(name: str):
        """The seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        laps[name] = now - mark[0]
        mark[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = ([phase_k1(dev, gen, 8 * 32, report)] + phase_k2(dev, gen, 8, report)
               + [phase_k3(dev, gen, 8, report)] + phase_k4(dev, gen, 8, report)
               + phase_k5(dev, gen, 8, report) + [phase_k6(dev, gen, 8, report)])
    # K3 and K5 at Video Swin-B's (16,7,7) window, N = 784 (streamed)
    long_window = dict(stages=SWIN3D_B16_STAGES, window=WINDOW_B16, n=N3_B16,
                       label="Video Swin-B")
    kernels += ([phase_k3(dev, gen, 8, report, b1=False, **long_window)]
                + phase_k5(dev, gen, 8, report, **long_window))
    # K5 at SwinV2-B's 7x7 windows (N = 49), the fused model's training path
    kernels += phase_k5(dev, gen, 8, report, window=7, n=49, label="SwinV2-B",
                        cases=k5_cases_swinv2(dev, 8), cosine=True, path="fused")
    # head dims other than 32 in every kernel of window attention
    head_dims = phase_head_dims(dev, gen, 8, report)
    for i, key in ((1, "k2"), (3, "k3"), (6, "k5_fwd"), (7, "k5_bwd"), (8, "k6")):
        kernels[i]["head_dims"] = head_dims[key]
    # K4 at Video Swin-L's stage 3 (C = 1536: rows wider than the LayerNorm
    # panel), per b8 request's two stage-3 blocks
    for i, row in zip((4, 5), phase_k4(dev, gen, 8, report, stages=SWIN3D_L_STAGE3)):
        kernels[i]["swin_l_stage3"] = {k: row[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "max_abs_err_f32")}
    lap("2 kernels")

    def config(dtype: str, kernels: bool, preset=None):
        cfg = Config.preset(preset) if preset else Config()
        cfg.random_seed = args.seed
        cfg.parallel.compute_dtype = dtype
        cfg.model.irv2_fused_blocks = cfg.model.swin2d_attn_kernel = kernels
        cfg.model.swin3d_attn_kernel = kernels
        if preset == "audio":
            # SwinV2-B at its published window-16, 256^2 geometry
            # (configs/swinv2/swinv2_base_patch4_window16_256.yaml)
            cfg.data.audio_size = 256
            cfg.model.swin2d_window = 16
            cfg.model.swin2d_pretrained_windows = (0, 0, 0, 0)
        return cfg

    def config_b16(dtype: str, kernels: bool):
        # Video Swin-B at its Something-Something v2 window (16,7,7) on 32
        # frames of 224 (swin_base_patch244_window1677_sthv2.py), depths
        # 2/2/18/2 as the preset
        cfg = config(dtype, kernels, "video_swin")
        cfg.model.swin3d_embed_dim = 128
        cfg.model.swin3d_heads = (4, 8, 16, 32)
        cfg.model.swin3d_window = WINDOW_B16
        return cfg

    # launches: the eager main path's run; graph_launches: the timed graph
    # replays of the same requests (each graph's captured launches a replay)
    def record(rows, counted, names):
        for row, name in zip(rows, names):
            row["launches"] = counted[0][name]
            row["graph_launches"] = None if counted[1] is None else counted[1].get(name, 0)

    served = phase_serving(config("bfloat16", True), config("bfloat16", False), dev, gen, report)
    record(kernels[0:3], served, ("inception_block", "window_attn_tokens", "window_attn_heads"))
    lap("3 fused serving")
    # int8 serving of the IRv2 trunk (K7, K8) on phase 3's weights and requests
    kernels += phase_int8(config("bfloat16", True), dev, gen, report, *served[2])
    del served
    lap("16 int8 serving")
    record(kernels[3:6], phase_video_swin(config("bfloat16", True, "video_swin"),
                                          config("bfloat16", False, "video_swin"), dev, gen,
                                          report),
           ("window_attn3d_tokens", "ln_linear", "mlp_tail"))
    # Video Swin-L (swin_large_patch244_window877): serving through K3 and
    # K4, K4's LayerNorm at C = 1536 in stage 3
    swin_l, swin_l_graph = phase_video_swin(
        config("bfloat16", True, SWIN_L), config("bfloat16", False, SWIN_L), dev, gen, report,
        key="video_swin_large")
    for i, name in ((3, "window_attn3d_tokens"), (4, "ln_linear"), (5, "mlp_tail")):
        kernels[i]["launches_swin_l"] = swin_l[name]
        kernels[i]["graph_launches_swin_l"] = swin_l_graph.get(name, 0)
    lap("4 video_swin serving, S and L")
    # training: the eager K5 route, then the graph route (the default)
    *swin_counted, swin_train = phase_video_swin_train_graph(
        config("bfloat16", True, "video_swin"), config("bfloat16", False, "video_swin"), dev,
        gen, report)
    record(kernels[6:8], swin_counted, ("window_attn3d_train_fwd", "window_attn3d_train_bwd"))
    lap("6 video_swin training")
    record(kernels[8:9], phase_audio(config("bfloat16", True, "audio"),
                                     config("bfloat16", False, "audio"), dev, gen, report),
           ("window_attention_multihead",))
    lap("8 audio serving")
    # Video Swin-B at (16,7,7): serving (K3 at N = 784, K4 at C = 128-1024),
    # then training (K5 at N = 784) on the K5 route
    record(kernels[9:10], phase_video_swin(config_b16("bfloat16", True),
                                           config_b16("bfloat16", False), dev, gen, report,
                                           key="video_swin_b16"),
           ("window_attn3d_tokens",))
    record(kernels[10:12], (phase_video_swin_train(config_b16("bfloat16", True), dev, gen,
                                                   report, key="video_swin_b16 train"), None),
           ("window_attn3d_train_fwd", "window_attn3d_train_bwd"))
    lap("10 video_swin_b16")
    # fused training at 8 x 4 (K5 at N = 49 in SwinV2-B), then its CLI
    fused_eager, fused_graph, det_graph = phase_fused_train(
        config("bfloat16", True, "fused"), config("bfloat16", False, "fused"), dev, gen, report)
    record(kernels[12:14], (fused_eager, fused_graph),
           ("window_attn3d_train_fwd", "window_attn3d_train_bwd"))
    lap("12 fused training")
    # the mesh: a one-process NCCL group against phase 12's steps without one
    phase_mesh(config("bfloat16", True, "fused"), dev, gen, report, det_graph)
    lap("15 mesh")
    # the remaining model options: remat against phase 12's and phase 6's
    # steps, Video Swin's attention-pooling head, the alternative CNNs and
    # inference-time dropout
    remat = phase_remat(config("bfloat16", True, "fused"), config("bfloat16", True, "video_swin"),
                        dev, report, det_graph, swin_train)
    del det_graph, swin_train
    for i, path, name in ((12, "fused", "window_attn3d_train_fwd"),
                          (13, "fused", "window_attn3d_train_bwd"),
                          (6, "video_swin", "window_attn3d_train_fwd"),
                          (7, "video_swin", "window_attn3d_train_bwd")):
        kernels[i]["launches_remat"] = {p or "all": r[name] for p, r in remat[path].items()}
    pooled = phase_attention_pool(config("bfloat16", True, "video_swin"), dev, gen, report)
    for i, name in ((3, "window_attn3d_tokens"), (4, "ln_linear"), (5, "mlp_tail"),
                    (6, "window_attn3d_train_fwd"), (7, "window_attn3d_train_bwd")):
        kernels[i]["launches_attention_pool"] = pooled.get(name, 0)
    phase_cnns(dev, gen, report, args.seed)
    phase_inference_dropout(config("bfloat16", True), dev, gen, report)
    lap("17 model options")
    # checkpoints (save, resume, serve), the loop's hooks, the training CLI;
    # the checkpoint lives on for phase 11's inference CLI
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt, (loop, loop_graph), (served, served_graph) = phase_checkpoints(
            config("bfloat16", True, "fused"), dev, gen, report, args.seed, ckpt_dir)
        lap("14 checkpoints")
        # the main path from files: ingest, SubmitCtl and the CLI (graph route)
        # ... and the inference CLI at int8 on the same files (phase 16's (d))
        cli = lambda root, names, scores: int8_cli(root, names, scores, ckpt, args.seed, report)
        ingest = phase_ingest(config("bfloat16", True), config("bfloat16", True, "video_swin"),
                              config("bfloat16", True, "audio"), dev, report, args.seed, ckpt,
                              after=cli)
        lap("11 ingest")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for i, counted, graphed, name in (
            (12, loop, loop_graph, "window_attn3d_train_fwd"),
            (13, loop, loop_graph, "window_attn3d_train_bwd"),
            (0, served, served_graph, "inception_block"),
            (1, served, served_graph, "window_attn_tokens")):
        kernels[i]["launches_checkpoints"] = counted[name]
        kernels[i]["graph_launches_checkpoints"] = graphed.get(name, 0)
    for i, path, name in ((0, "fused", "inception_block"), (1, "fused", "window_attn_tokens"),
                          (3, "video_swin", "window_attn3d_tokens"),
                          (4, "video_swin", "ln_linear"), (5, "video_swin", "mlp_tail"),
                          (8, "audio", "window_attention_multihead"),
                          (2, "audio", "window_attn_heads")):
        kernels[i]["launches_ingest"] = ingest[path][0][name]
        kernels[i]["graph_launches_ingest"] = ingest[path][1].get(name, 0)
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"kernel {k['name']}: {k['per']}: kernel_ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
            f"library_ms={lib} bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) "
            f"launches on the main path={k['launches']} (graph route {k['graph_launches']})")
    phase_parity(config("float32", True), config("float32", False), dev, gen, report, batch=2)
    phase_video_swin_parity(config("float32", True, "video_swin"),
                            config("float32", False, "video_swin"), dev, gen, report, batch=2)
    phase_video_swin_train_parity(config("float32", True, "video_swin"),
                                  config("float32", False, "video_swin"), dev, gen, report,
                                  batch=1)
    phase_audio_parity(config("float32", True, "audio"), config("float32", False, "audio"), dev,
                       gen, report, batch=2)
    phase_video_swin_parity(config_b16("float32", True), config_b16("float32", False), dev, gen,
                            report, batch=1, key="video_swin_b16_parity")
    phase_video_swin_train_parity(config_b16("float32", True), config_b16("float32", False), dev,
                                  gen, report, batch=1, key="video_swin_b16_train_parity")
    lap("5, 7, 9, 10 f32 parity")
    report["phase_s"] = laps
    log("phases (s): " + json.dumps({k: round(v, 1) for k, v in laps.items()}))

    report["profiler_traces"] = dict(TRACES)
    log(f"profiler: traced calls {json.dumps(TRACES)}")
    report["total_s"] = time.perf_counter() - t_all
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log(f"total: {report['total_s']:.1f} s")
    print(json.dumps({"ingest": report["ingest"]}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
