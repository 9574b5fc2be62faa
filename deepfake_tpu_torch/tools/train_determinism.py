#!/usr/bin/env python3
"""Whether fused training repeats to the bit on the card, and where it does
not: why the graph route is held to the eager route within a multiple of
two eager runs' spread (chip_smoke.py phase 12, tests/test_torch_cuda.py)
and not to the bit, and whether the graph route departs from the eager
route by more than eager runs depart from each other.

    python3 deepfake_tpu_torch/tools/train_determinism.py [--runs N] [--out PATH]

(1) Three fused bf16 steps at the card tests' small geometry (micro-batch 2
x accum 2, lr 0.01, every dropout at its default), N times eagerly and N
times as CUDA graphs from one seed (default N = 2), K5 on: every run's
losses, each route's spread of every step's loss, the largest weight
difference within each route and across the routes, and for each ordered
pair of eager runs whether the card test's rule (every graph run within 4x
the pair's loss spread of the pair's first run) holds. (2) The same, twice
eagerly and twice as graphs, with every source of run-to-run difference
switched off that can be: K5 off (SwinV2's plain softmax),
``cudnn.deterministic``, ``torch.use_deterministic_algorithms`` (its
warnings name the ops that have no deterministic form): where eager runs
repeat to the bit, a graph that does not equal them to the bit is a fault
of the graph route. (3) K5's forward and backward twice on the same inputs
at SwinV2-B's stage-0 shape (shifted, b8) and stage-3 shape: whether out,
dq | dk | dv and dbias repeat to the bit (dbias is summed across blocks
with atomics). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import warnings

import common  # noqa: F401 (puts the checkout's root on sys.path)

import torch


def trainer(dev, compiled: bool, batches, fields, tc):
    """The card tests' small fused Trainer (tests/test_torch_cuda.py's
    ``_fused_trainer``) with ``fields`` set."""
    from deepfake_tpu_torch.config import Config
    from deepfake_tpu_torch.train.trainer import Trainer

    cfg = Config()
    for k, v in fields.items():
        cfg.set(k, v)
    return Trainer(None, cfg, tc._OneBatch(*batches[0]), logger=lambda line: None, device=dev,
                   compiled=compiled)


def summary(got, tc) -> dict:
    """Each route's losses, spreads and weight gaps, and for each ordered
    pair of eager runs whether every graph run keeps the card test's rule."""
    row = {f"{route}_losses": [losses for losses, _ in runs] for route, runs in got.items()}
    for route, runs in got.items():
        row[f"{route}_loss_spread_by_step"] = [max(v) - min(v)
                                               for v in zip(*(losses for losses, _ in runs))]
        row[f"{route}_weight_gap"] = max((tc._gap(a[1], b[1])
                                          for a, b in itertools.combinations(runs, 2)),
                                         default=0.0)
    row["graph_vs_eager_weight_gap"] = max(tc._gap(e[1], g[1]) for e in got["eager"]
                                           for g in got["graph"])
    first = got["eager"][0][0]
    row["eager_repeats_to_the_bit"] = (row["eager_weight_gap"] == 0.0
                                       and all(losses == first for losses, _ in got["eager"]))
    row["graph_equals_eager_to_the_bit"] = (row["graph_vs_eager_weight_gap"] == 0.0
                                            and all(losses == first for losses, _ in got["graph"]))
    rule = []
    for (want, _), (again, _) in itertools.permutations(got["eager"], 2):
        tol = tc._spread_tolerance(max(abs(a - b) for a, b in zip(want, again)),
                                   max(abs(v) for v in want))
        rule.append(all(max(abs(a - b) for a, b in zip(losses, want)) <= tol
                        for losses, _ in got["graph"]))
    row["card_test_rule_holds_by_eager_pair"] = rule
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    # cuBLAS repeats its sums only with a fixed workspace, set before its
    # first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    k5_off = dict(tc.FUSED_TRAIN, **{"model.swin2d_attn_kernel": False})
    for name, fields, runs, det in (("default", tc.FUSED_TRAIN, args.runs, False),
                                    ("deterministic", k5_off, 2, True)):
        torch.backends.cudnn.deterministic = det
        torch.use_deterministic_algorithms(det, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = {"eager": [], "graph": []}
            for route in ("eager", "graph") * runs:
                t = trainer(dev, route == "graph", batches, fields, tc)
                got[route].append((tc._steps(t, batches), tc._weights(t)))
                del t
        row = summary(got, tc)
        row["nondeterministic_ops"] = sorted({str(w.message)[:160] for w in caught
                                              if "deterministic" in str(w.message)})
        out["steps"][name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    torch.use_deterministic_algorithms(False)
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
