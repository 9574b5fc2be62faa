#!/usr/bin/env python3
"""Where does K2's time go on a fused b8 request? K2's device time beside
SDPA's, launch by launch, on the card.

    python3 deepfake_tpu_torch/tools/k2_step0.py [--out PATH]

Runs the tree's K2 (``window_attention_tokens`` at B_ >= 2,
``window_attention_heads`` at b1's B_ = 1) at the 24 launches of a fused b8
request (SwinV2-B at 224: stages 0-2 alternate unshifted and shifted
blocks, stage 3 is two unshifted blocks) and the 2 of a b1 request, bf16,
and reads for each distinct shape, with torch.profiler over 10 calls:
  k2          K2's device time (and its CUDA-event time over 10
              back-to-back calls, which for launches this short is partly
              the host's)
  sdpa        scaled_dot_product_attention on head-major q^ s, k^, v with
              bias + mask as attn_mask (chip_smoke.py's yardstick: q and k
              normalised outside the timed call)
  sdpa_norm   the same with the normalisation of q and k (f32, then bf16)
              inside the timed call, as K2 does it
  sdpa_layout sdpa_norm plus the copies between the token-major qkv slices
              and the head-major layout SDPA takes, both ways
Prints the card's name and power limit, one line per shape and the sums per
request; --out writes the numbers as JSON. A development tool, off every
serving path; PERF.md's Step 0 table of K2 was timed by it on the K2 of commit 622cde6.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import common  # this folder's shared helpers; it puts the checkout's root on sys.path

ROOT = common.ROOT

# (resolution, heads, C, depth) of SwinV2-B's stages at 224, window 7
STAGES = [(56, 4, 128, 2), (28, 8, 256, 2), (14, 16, 512, 18), (7, 32, 1024, 2)]
N = 49



def event_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cases(batch: int):
    """(name, resolution, B_, H, C, shifted, launches a request) of one
    request."""
    out = []
    for res, H, C, depth in STAGES:
        nW = (res // min(res, 7)) ** 2
        if res > 7:
            out.append((f"res {res}", res, batch * nW, H, C, False, (depth + 1) // 2))
            out.append((f"res {res} shifted", res, batch * nW, H, C, True, depth // 2))
        else:
            out.append((f"res {res}", res, batch * nW, H, C, False, depth))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from deepfake_tpu_torch.models.swin2d import shift_attn_mask
    from deepfake_tpu_torch.ops import window_attn_kernel as k2
    from deepfake_tpu_torch.ops.window_attn import l2_normalize

    if not torch.cuda.is_available():
        raise SystemExit("k2_step0: needs an NVIDIA GPU")
    card = common.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    dt = torch.bfloat16
    res = {"card": card, "rows": [], "per_request": {}}
    for batch in (8, 1):
        tot = dict.fromkeys(("k2", "k2_events", "sdpa", "sdpa_norm", "sdpa_layout"), 0.0)
        for name, side, B_, H, C, shifted, count in cases(batch):
            D = C // H
            qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(dt)
            bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=gen, device=dev))
            ls = torch.exp(torch.clamp(math.log(10.0) + 0.3 * torch.randn(
                H, 1, 1, generator=gen, device=dev), max=math.log(100.0)))
            mask = (torch.from_numpy(shift_attn_mask(side, side, 7, 3)).to(dev)
                    if shifted else None)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            kw = dict(bias=bias, mask=mask, logit_scale=ls)
            heads = lambda t: t.reshape(B_, N, H, D).transpose(1, 2)
            hq, hk, hv = (heads(t).contiguous() for t in (q, k, v))
            if B_ >= 2:
                run = lambda: k2.window_attention_tokens(q, k, v, num_heads=H, **kw)
            else:
                run = lambda: k2.window_attention_heads(hq, hk, hv, **kw)
            am = bias[None].to(dt)
            if mask is not None:
                nW = mask.shape[0]
                am = (am.view(1, 1, H, N, N) + mask.to(dt).view(1, nW, 1, N, N)).expand(
                    B_ // nW, nW, H, N, N).reshape(B_, H, N, N)
            qn = (l2_normalize(hq.float()) * ls).to(dt)
            kn = l2_normalize(hk.float()).to(dt)
            sdpa = lambda: F.scaled_dot_product_attention(qn, kn, hv, attn_mask=am, scale=1.0)
            sdpa_norm = lambda: F.scaled_dot_product_attention(
                (l2_normalize(hq.float()) * ls).to(dt), l2_normalize(hk.float()).to(dt), hv,
                attn_mask=am, scale=1.0)
            sdpa_layout = lambda: F.scaled_dot_product_attention(
                (l2_normalize(heads(q).float()) * ls).to(dt), l2_normalize(heads(k).float()).to(dt),
                heads(v).contiguous(), attn_mask=am, scale=1.0).transpose(1, 2).reshape(B_, N, C)
            row = dict(request=f"b{batch}", case=name, B_=B_, H=H, C=C, launches=count,
                       k2=common.device_ms(run), k2_events=event_ms(run), sdpa=common.device_ms(sdpa),
                       sdpa_norm=common.device_ms(sdpa_norm), sdpa_layout=common.device_ms(sdpa_layout))
            res["rows"].append(row)
            for key in tot:
                tot[key] += count * row[key]
            print(f"b{batch} {name:16s} B_={B_:4d} H={H:2d} x{count:2d}: "
                  + " ".join(f"{key}={row[key]:.4f}" for key in tot), flush=True)
            del qkv, q, k, v, hq, hk, hv, am, qn, kn
        res["per_request"][f"b{batch}"] = tot
        print(f"per b{batch} request (ms): " + " ".join(f"{k}={v:.4f}" for k, v in tot.items()),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
