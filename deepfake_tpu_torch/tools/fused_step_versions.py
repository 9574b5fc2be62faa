#!/usr/bin/env python3
"""The fused model's training step in versions, in turns on the card:
chip_smoke.py's phase 12 geometry (the fused preset at micro-batch 8 x
accumulation 4, bf16 compute, K5 on, fed by the train-side
FeatureAssembler from seeded raw clips) on its default route, one CUDA graph
a step.

    python3 deepfake_tpu_torch/tools/fused_step_versions.py _checkout/parent . \\
        .+CUBLAS_WORKSPACE_CONFIG=:4096:8 [--steps 6] [--out PATH]

A version is a checkout, with environment settings after "+" signs. Each
run is a process of its own that imports the package and chip_smoke.py of
its checkout (a parent unpacked with git archive into an ignored folder
builds its kernels into its own _build/). The runs go through the versions,
then again in reverse order; each prints the step times (the first step
captures the graph) and the median of the others, in ms by the host's clock
with a synchronize after each step. Prints the card's name and power
limit; --out writes the runs as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def one(root: str, steps: int) -> dict:
    """One checkout's run, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from deepfake_tpu_torch.config import Config
    from deepfake_tpu_torch.train.trainer import Trainer

    cfg = Config.preset("fused")
    cfg.random_seed = 0
    cfg.parallel.compute_dtype = "bfloat16"
    cfg.model.irv2_fused_blocks = cfg.model.swin2d_attn_kernel = True
    cfg.model.swin3d_attn_kernel = True
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    rows = cfg.optim.batch_size * cfg.optim.accum_step
    raw = cs.RawFused(cfg, rows, 3, dev, gen)
    trainer = Trainer(None, cfg, raw, logger=lambda line: None, device=dev)
    r, _, _ = cs.assembled_steps(trainer, raw, steps, key="fused graph")
    return dict(root=root, module=os.path.dirname(cs.__file__), step_ms=r["step_ms"],
                p50_ms=statistics.median(r["step_ms"][1:]), losses=r["losses"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="*", help="checkout[+KEY=VALUE...]")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.steps)), flush=True)
        return 0
    if len(args.versions) < 2:
        raise SystemExit("fused_step_versions: give two versions or more")
    import common  # the card's name; puts this checkout on sys.path

    print(common.card(), flush=True)
    runs = []
    for version in args.versions + args.versions[::-1]:
        root, *settings = version.split("+")
        env = dict(os.environ, **dict(kv.split("=", 1) for kv in settings))
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                              "--steps", str(args.steps)], capture_output=True, text=True,
                             env=env)
        if out.returncode:
            raise SystemExit(f"{version}: exit {out.returncode}\n{out.stdout[-3000:]}"
                             f"{out.stderr[-3000:]}")
        run = dict(json.loads(out.stdout.strip().splitlines()[-1]), version=version)
        runs.append(run)
        print(f"{version}: steps {[round(t, 1) for t in run['step_ms']]} ms, p50 "
              f"{run['p50_ms']:.1f} ms, losses {run['losses']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=common.card(), runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
