"""The offline audio pass (the repository's root audio_preprocess.py, the
reference's audio_preprocess.py:8-41):

    python -m deepfake_tpu_torch.audio_preprocess --data_root /data/multi-ffdv [--split test]
    python -m deepfake_tpu_torch.audio_preprocess --data_root ... --format jpeg [-cuda False]

``--format pcm`` (default) writes each clip's 16 kHz PCM as a ``<clip>.npy``
sidecar next to it, which the loaders read instead of demuxing. ``--format
jpeg`` writes the reference's mel JPEGs (``<data_root>/{trainAudioImgs,
ValAudioImgs,TestAudioImgs}/<clip>.jpg``) from the port's mel image, on the
card unless ``-cuda False``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

_SPLIT_DIRS = {
    "train": os.path.join("phase1", "trainset"),
    "val": os.path.join("phase1", "valset"),
    "test": os.path.join("phase2", "testset1seen"),
}


def write_pcm_sidecars(dataset_path, names, sample_rate, logger):
    from deepfake_tpu_torch.data.audio_io import extract_wav

    for index, name in enumerate(names):
        path = os.path.join(dataset_path, name)
        target = os.path.splitext(path)[0] + ".npy"
        if os.path.exists(target):
            continue
        if index % 100 == 0:
            rate = int(index / max(len(names), 1) * 100)
            logger("[" + "*" * rate + "-" * (100 - rate) + f"] ({index}/{len(names)})")
        np.save(target, extract_wav(path, sample_rate).astype(np.float32))


def main(argv=None):
    from deepfake_tpu_torch.config import _str2bool
    from deepfake_tpu_torch.data.audio_images import write_mel_jpegs
    from deepfake_tpu_torch.data.dataset import VIDEO_EXTS
    from deepfake_tpu_torch.utils.logging import Logger

    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    p.add_argument("--format", type=str, default="pcm", choices=["pcm", "jpeg"])
    p.add_argument("--force_generate", action="store_true",
                   help="rewrite JPEGs that already exist")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("-cuda", "--use_cuda", type=_str2bool, default=True)
    args = p.parse_args(argv)

    logger = Logger(args.log_dir)
    dataset_path = os.path.join(args.data_root, _SPLIT_DIRS[args.split])
    names = sorted(n for n in os.listdir(dataset_path) if n.lower().endswith(VIDEO_EXTS))
    logger(f"Processing Audio File! ({len(names)} videos)")
    if args.format == "jpeg":
        write_mel_jpegs(args.data_root, args.split, dataset_path, names, args.sample_rate,
                        logger, args.batch, force=args.force_generate,
                        device=None if args.use_cuda else "cpu")
    else:
        write_pcm_sidecars(dataset_path, names, args.sample_rate, logger)
    logger("Processing Complete")


if __name__ == "__main__":
    main()
