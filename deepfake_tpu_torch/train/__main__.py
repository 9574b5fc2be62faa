"""The training CLI (the port's counterpart of the repository's root
train.py; reference: train.py:29-75).

    python -m deepfake_tpu_torch.train --preset fused --data_root /data/multi-ffdv
    python -m deepfake_tpu_torch.train --preset fused --data_root ... -cuda False   # on the CPU

Builds the configured model in train mode (seeded random weights), the data
module's train and val splits (``<data_root>/phase1/{trainset,valset}`` with
``<data_root>/{train,val}_label.txt``; PCM from ``<clip>.wav`` / ``.npy``
sidecars, or ffmpeg), each behind a ``ModelFeedLoader`` (the train one
augments), and the ``Trainer``; then trains (``Train Loss`` lines every
``--log_step`` steps, the val loss, accuracy and AUC after each epoch), or
with ``--val_model`` evaluates on the val split only, or with
``--skip_learning`` stops there. Runs on the card unless ``-cuda False``
asks for the CPU; without a card and without that flag it raises.
Launched by torchrun (WORLD_SIZE > 1) or with ``parallel.multihost``, each
rank joins the group (NCCL on its card ``cuda:LOCAL_RANK``, gloo with ``-cuda
False``) as a rank of the ``parallel.data_axis`` x ``parallel.model_axis``
mesh (parallel/mesh.py), decodes its data rank's rows and trains its share;
rank 0 logs and saves:

    torchrun --nproc_per_node=4 -m deepfake_tpu_torch.train --preset fused --data_root ... \
        --set parallel.model_axis=2
SIGTERM and SIGINT end the run between two steps. A checkpoint is saved to
``./checkpoints`` (``log.ckpt_dir``) after each step t with (t + 1) %
``--model_save`` == 0, the JAX cadence. ``--Resume`` with the modality's
checkpoint path (``--fused_ckpt_path``, ``--audio_ckpt_path``,
``--video_ckpt_path``, ``--paudio_ckpt_path``) resumes from it: the weights,
BatchNorm statistics, momentum and step, re-entering the saved epoch from its
first batch. A reference ``.pth`` or ``.safetensors`` path, and the
pretrained-weight flags, raise: importing reference checkpoints waits for
such files in the repository.
"""

from __future__ import annotations

import json
import os
import signal
import sys


def main(argv=None):
    from deepfake_tpu_torch.config import get_config
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.data.pipeline import ModelFeedLoader
    from deepfake_tpu_torch.io.checkpoint import resume_path
    from deepfake_tpu_torch.models.registry import resolve_device
    from deepfake_tpu_torch.parallel.mesh import join_group, local_device
    from deepfake_tpu_torch.train.trainer import Trainer
    from deepfake_tpu_torch.utils.logging import Logger

    cfg = get_config(argv)
    device = resolve_device(local_device(cfg))
    mesh = join_group(cfg, device)
    logger = Logger(cfg.log.log_dir) if mesh is None or mesh.rank == 0 else (lambda line: None)
    logger(f"processId: {os.getpid()}")
    logger(f"parent processId: {os.getppid()}")
    logger(cfg.to_json())

    def handle_exit(*_a):
        print("Program Killed by signal")
        sys.exit(0)

    signal.signal(signal.SIGTERM, handle_exit)
    signal.signal(signal.SIGINT, handle_exit)
    ckpt = resume_path(cfg)
    dm = DeepFakeDataModule(cfg, device=device, mesh=mesh).setup("fit")

    class Feeds:
        """The loaders, built once: the train loader moves its shuffle epoch
        on each pass."""

        train = ModelFeedLoader(dm.train_dataloader(), cfg, train=True, device=device, mesh=mesh)
        val = ModelFeedLoader(dm.val_dataloader(), cfg, train=False, device=device, mesh=mesh)

        def train_loader(self):
            return self.train

        def val_loader(self):
            return self.val

    trainer = Trainer(None, cfg, Feeds(), logger=logger, device=device, mesh=mesh)
    if ckpt:
        trainer.load_ckpt(ckpt)
    if cfg.optim.val_model:
        logger(f"val: {json.dumps(trainer.eval(Feeds.val))}")
    elif not cfg.optim.skip_learning:
        trainer.train()
    return trainer


if __name__ == "__main__":
    main()
