"""The multichip dry run: one fused training step over a (data, model) mesh
of CPU processes (the port's counterpart of __graft_entry__.py::
dryrun_multichip, :80-210).

    python -m deepfake_tpu_torch.parallel.dryrun 8
    DEEPFAKE_TPU_DRYRUN_TOY=1 python -m deepfake_tpu_torch.parallel.dryrun 4   # small hosts

``dryrun_multichip(n)`` spawns n processes on the CPU, each a rank of a gloo
group on localhost, forms the (n / 2 data, 2 model) mesh (n odd: (n, 1))
and runs one fused training step at the JAX dry run's shapes: the tiny
fused config (IRv2 at 96^2, SwinV2 embed 32 at 56^2, wav2vec2 64 wide), 8
frames and a 4-layer wav2vec2 (``DEEPFAKE_TPU_DRYRUN_TOY=1``: 1 frame, 2
layers), one clip per data rank, no accumulation, f32 (the CPU's type).
Each rank asserts a finite loss; rank 0 asserts that every replicated
parameter is the same on every rank and every split parameter the same on
the ranks of its model index, and prints ``dryrun_multichip(n): mesh=(a
data, b model), loss=... OK``. A failed rank raises in the caller.
"""

from __future__ import annotations

import hashlib
import os
import socket
import sys

import numpy as np
import torch


def tiny_fused_config(toy: bool):
    """The JAX dry run's config (__graft_entry__.py::_fused_cfg(tiny=True)
    and its dry-run settings), in the port's Config."""
    from deepfake_tpu_torch.config import Config

    cfg = Config()
    for key, value in {
            "data.modality": "fused", "data.num_frames": 1 if toy else 8, "data.frame_size": 96,
            "data.audio_size": 56, "data.wave_seconds_buckets": (0.5,),
            "model.swin2d_embed_dim": 32, "model.swin2d_depths": (2, 2),
            "model.swin2d_heads": (2, 4), "model.wav_layers": 2 if toy else 4,
            "model.wav_hidden": 64, "model.wav_heads": 4, "model.wav_intermediate": 128,
            "model.wav_conv_dim": 32, "optim.accum_step": 1, "optim.epochs": 1,
            "parallel.compute_dtype": "float32"}.items():
        cfg.set(key, value)
    return cfg


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _rank(rank: int, n: int, port: int, toy: bool, model_axis: int) -> None:
    import torch.distributed as dist

    from deepfake_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from deepfake_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank)
    try:
        mesh = make_mesh(n // model_axis, model_axis)
        cfg = tiny_fused_config(toy)
        cfg.optim.batch_size = mesh.data  # one clip a data rank
        d = cfg.data
        b, t, s, a = mesh.data, d.num_frames, d.frame_size, d.audio_size
        rng = np.random.default_rng(0)
        inputs = (rng.standard_normal((b, t, s, s, 3)).astype(np.float32),
                  rng.standard_normal((b, a, a, 3)).astype(np.float32),
                  rng.standard_normal((b, int(d.wave_seconds_buckets[0] * d.wave_sample_rate)))
                  .astype(np.float32))
        labels = (rng.random(b) > 0.5).astype(np.float32)

        class Data:
            def train_loader(self):
                return [(inputs, labels)]

            val_loader = train_loader

        trainer = Trainer(None, cfg, Data(), logger=lambda line: None, device="cpu", mesh=mesh)
        loss = float(trainer.train_step(*shard_batch(inputs, labels, mesh))["loss"])
        assert np.isfinite(loss), f"rank {rank}: non-finite loss {loss}"
        # every rank's parameters, by digest: replicated ones the same on
        # every rank, split ones on every rank of one model index
        mine = {k: (k in mesh.sharded, mesh.m, digest(p))
                for k, p in trainer.model.named_parameters()}
        every = [None] * n
        dist.all_gather_object(every, mine)
        if rank == 0:
            for k, (split, _, _) in mine.items():
                groups = {}
                for r in every:
                    groups.setdefault(r[k][1] if split else 0, set()).add(r[k][2])
                bad = {m: h for m, h in groups.items() if len(h) != 1}
                assert not bad, f"{k}: the ranks disagree ({'split' if split else 'replicated'})"
            print(f"dryrun_multichip({n}): mesh=({mesh.data} data, {mesh.model} model), "
                  f"loss={loss:.5f} OK", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """One fused training step over an n-process (n / 2, 2) CPU mesh; see
    the module's note."""
    import torch.multiprocessing as mp

    toy = os.environ.get("DEEPFAKE_TPU_DRYRUN_TOY") == "1"
    model_axis = 2 if n_devices % 2 == 0 else 1
    mp.spawn(_rank, args=(n_devices, free_port(), toy, model_axis), nprocs=n_devices,
             join=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
