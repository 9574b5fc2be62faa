#!/usr/bin/env python3
"""Whether fused training repeats to the bit on the card, and where it does
not: why the graph route is held to the eager route within a multiple of
two eager runs' spread (chip_smoke.py phase 12, tests/test_torch_cuda.py)
and not to the bit.

    python3 deepfake_tpu_torch/tools/train_determinism.py [--out PATH]

(1) Three fused bf16 steps at the card tests' small geometry (micro-batch 2
x accum 2, lr 0.01, every dropout at its default), twice eagerly and once as
CUDA graphs from one seed, with ``torch.backends.cudnn.deterministic`` off
and on: the losses, whether each route's are equal to the bit, and the
largest weight difference. (2) K5's forward and backward twice on the same
inputs at SwinV2-B's stage-0 shape (shifted, b8) and stage-3 shape: whether
out, dq | dk | dv and dbias repeat to the bit (dbias is summed across
blocks with atomics). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import common  # noqa: F401 (puts the checkout's root on sys.path)

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(common.ROOT, "tests"))
    import test_torch_cuda as tc

    from deepfake_tpu_torch.models.swin2d import shift_attn_mask
    from deepfake_tpu_torch.ops import window_attn3d_train as k5

    print(common.card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": common.card(), "steps": {}, "k5": {}}
    batches = tc._fused_batches(dev, 3)
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        runs = {}
        for name, compiled in (("eager", False), ("eager_again", False), ("graph", True)):
            t = tc._fused_trainer(dev, compiled, batches)
            runs[name] = (tc._steps(t, batches), tc._weights(t))
            del t
        row = {name: losses for name, (losses, _) in runs.items()}
        for other in ("eager_again", "graph"):
            row[f"{other}_losses_equal"] = runs[other][0] == runs["eager"][0]
            row[f"{other}_weight_gap"] = tc._gap(runs["eager"][1], runs[other][1])
        out["steps"][f"cudnn_deterministic={det}"] = row
        print(f"cudnn.deterministic={det}: {json.dumps(row)}", flush=True)
    torch.backends.cudnn.deterministic = False
    for B_, H, C, side in ((512, 4, 128, 56), (8, 32, 1024, 7)):
        qkv, bias, dout = tc._cosine_qkv(dev, B_, H, C, torch.bfloat16, seed=3)
        mask = (torch.from_numpy(shift_attn_mask(side, side, 7, 3)).to(dev, torch.bfloat16)
                if side > 7 else None)
        kw = dict(num_heads=H, bias=bias, mask=mask, scale=1.0)
        f = [k5.window_attn3d_train_fwd(qkv, **kw) for _ in range(2)]
        b = [k5.window_attn3d_train_bwd(qkv, dout, **kw) for _ in range(2)]
        torch.cuda.synchronize()
        row = {"out_equal": torch.equal(*f), "dqkv_equal": torch.equal(b[0][0], b[1][0]),
               "dbias_equal": torch.equal(b[0][1], b[1][1]),
               "dbias_gap": (b[0][1] - b[1][1]).abs().max().item(),
               "dbias_max": b[0][1].abs().max().item()}
        out["k5"][f"B_={B_} H={H} C={C} {'shifted' if mask is not None else 'unshifted'}"] = row
        print(f"K5 N=49 B_={B_} H={H}: {json.dumps(row)}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
