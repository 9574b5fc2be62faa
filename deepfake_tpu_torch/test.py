"""The inference CLI: score a test set into a submission (the port's
counterpart of the repository's root test.py, the reference's test.py:28-74).

    python -m deepfake_tpu_torch.test --preset fused --data_root /data/multi-ffdv
    python -m deepfake_tpu_torch.test --preset fused --data_root ... -cuda False   # on the CPU

Reads ``<data_root>/phase2/testset1seen/*.mp4`` in the order of
``<data_root>/phase2/prediction.txt.csv`` (PCM from ``<clip>.wav`` / ``.npy``
sidecars, or ffmpeg), appends ``name,score`` lines to ``./prediction.csv``
after every batch (a stopped run resumes: the names already there are
skipped), then writes ``./prediction_full.csv`` with this run's rows and a
header. Runs on the card unless ``-cuda False`` asks for the CPU; without a
card and without that flag it raises. The weights are seeded random, or
with ``--Resume`` those of the modality's checkpoint path
(``--fused_ckpt_path`` ...: a training checkpoint, served by
``Predictor.from_checkpoint``);
a reference ``.pth`` or ``.safetensors`` path raises: importing reference
checkpoints waits for such files in the repository. Launched by torchrun
(WORLD_SIZE > 1) or with ``parallel.multihost``, each rank joins the group
(parallel/mesh.py) and serves its data rank's rows of every batch; rank 0
writes the files:

    torchrun --nproc_per_node=4 -m deepfake_tpu_torch.test --preset fused --data_root ...
"""

from __future__ import annotations

import os
import signal
import sys


def main(argv=None):
    from deepfake_tpu_torch.config import get_config
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.io.checkpoint import resume_path
    from deepfake_tpu_torch.models.registry import resolve_device
    from deepfake_tpu_torch.parallel.mesh import join_group, local_device
    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.submit import SubmitCtl
    from deepfake_tpu_torch.utils.logging import Logger
    from deepfake_tpu_torch.utils.seeding import seed_everything

    cfg = get_config(argv)
    device = resolve_device(local_device(cfg))
    mesh = join_group(cfg, device)
    logger = Logger(cfg.log.log_dir) if mesh is None or mesh.rank == 0 else (lambda line: None)
    logger(f"processId: {os.getpid()}")
    logger(cfg.to_json())

    def handle_exit(*_a):
        print("Program Killed by signal")
        sys.exit(0)

    signal.signal(signal.SIGTERM, handle_exit)
    signal.signal(signal.SIGINT, handle_exit)
    ckpt = resume_path(cfg)
    predictor = (Predictor.from_checkpoint(cfg, ckpt, device=device, mesh=mesh) if ckpt
                 else Predictor(cfg, device=device, mesh=mesh))
    if ckpt:
        logger(f"Load Finetuned Model From:{ckpt}")
    seed_everything(cfg.random_seed, predictor.device)
    dm = DeepFakeDataModule(cfg, device=predictor.device, mesh=mesh).setup("test")
    ctl = SubmitCtl(predictor, cfg, dm, logger=logger)
    result = ctl.submit()
    ctl.write_full(result)
    return result


if __name__ == "__main__":
    main()
