"""Training checkpoints: save and restore (deepfake_tpu/io/checkpoint.py:26-60).

    path = save_checkpoint("ckpt/deepfake_modalityfused_batch8_epoch0_step4", trainer, epoch=0)
    epoch = restore_checkpoint(path, trainer)   # trainer.step is restored too
    state = read_checkpoint(path)               # the payload, on the CPU
    path = resume_path(cfg)                     # the CLIs' --Resume checkpoint, or None

A checkpoint holds what the JAX package's does and nothing more:

  ``step``      the optimizer steps taken (an int);
  ``model``     the model's ``state_dict``: the parameters and the
                persistent buffers (BatchNorm's running statistics, the
                JAX ``batch_stats``), under the port's names;
  ``momentum``  ``schedule.SGD``'s momentum buffers (the optax trace), keyed
                by their parameters' names;
  ``epoch``     the epoch the save was made in (an int).

The dropout generator is not saved, as the JAX ``Trainer.rng`` is not: after
a restore the Trainer draws from its own seeded stream. The file is a
``torch.save`` of CPU tensors, read back with ``torch.load(...,
weights_only=True)``.

Under a mesh (parallel/mesh.py) a checkpoint does not depend on it: the
save gathers the model ranks' slices of each split tensor and rank 0 writes
whole tensors, the file a single-device run writes (the JAX checkpoint is
``device_get``'s whole arrays); a restore copies each rank's slice.

A save writes a temporary file in the same directory, flushes it to the disk
and renames it onto the path (``os.replace``): a run stopped mid-save leaves
the previous file under that name whole, and no half file there. A restore
is strict: every key and shape must match both ways, checked before any
tensor is written, and a mismatch raises naming the key. It copies into the
model's and the optimizer's tensors in place (``copy_``), never rebinding
one: a captured CUDA graph holds their addresses (``compiled.py``), so a
replay after a restore reads the restored values.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import torch
import torch.distributed as dist
from torch import nn

from deepfake_tpu_torch.parallel.mesh import full_tensor, local_slice

KEYS = ("step", "model", "momentum", "epoch")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def resume_path(cfg):
    """With ``--Resume``, the modality's checkpoint path (None where it has
    none set), as the root train.py and test.py pick it; raises for a
    reference ``.pth`` / ``.safetensors`` file, which those send to the
    reference import."""
    if not cfg.model.resume:
        return None
    ckpt = {"audio": cfg.model.audio_ckpt_path, "video": cfg.model.video_ckpt_path,
            "paudio": cfg.model.paudio_ckpt_path,
            "fused": cfg.model.fused_ckpt_path}.get(cfg.data.modality)
    if ckpt and (ckpt.endswith(".pth") or ckpt.endswith(".safetensors")):
        raise NotImplementedError(
            f"--Resume {ckpt}: importing the reference's checkpoints waits for reference files "
            "in the repository")
    return ckpt


def momentum_names(model: nn.Module, optimizer) -> list:
    """The names of the parameters ``optimizer`` steps, in its order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for p in optimizer.params]


def checkpoint_payload(trainer, epoch: int = 0) -> Dict:
    """``trainer``'s step, model state, momentum and ``epoch``, copied to the
    CPU; under a mesh (``trainer.mesh``) each tensor whole, its model ranks'
    slices gathered (a collective: every rank calls it)."""
    mesh = getattr(trainer, "mesh", None)
    whole = lambda n, t: _cpu(full_tensor(n, t, mesh))
    return {
        "step": int(trainer.step),
        "model": {k: whole(k, v) for k, v in trainer.model.state_dict().items()},
        "momentum": {n: whole(n, b) for n, b in zip(
            momentum_names(trainer.model, trainer.optimizer), trainer.optimizer.bufs)},
        "epoch": int(epoch),
    }


def save_checkpoint(path: str, trainer, epoch: int = 0) -> str:
    """Writes ``checkpoint_payload(trainer, epoch)`` to ``path`` (a file,
    replaced atomically); returns its absolute path. Under a mesh every rank
    calls it, rank 0 writes, and the ranks meet after the write."""
    mesh = getattr(trainer, "mesh", None)
    payload = checkpoint_payload(trainer, epoch)
    path = os.path.abspath(path)
    if mesh is None or mesh.rank == 0:
        write_checkpoint(path, payload)
    if mesh is not None:
        dist.barrier()
    return path


def write_checkpoint(path: str, payload: Dict) -> str:
    """``payload`` to ``path`` through a temporary file in its directory,
    flushed to the disk, then renamed onto it; returns the absolute path."""
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".{os.path.basename(path)}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def read_checkpoint(path: str) -> Dict:
    """The payload of a checkpoint file, its tensors on the CPU."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or set(payload) != set(KEYS):
        got = sorted(payload) if isinstance(payload, dict) else type(payload).__name__
        raise ValueError(f"{path}: not a checkpoint of the port (keys {got}, expected "
                         f"{sorted(KEYS)})")
    return payload


def check_tensors(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor],
                  what: str) -> None:
    """Raises unless ``src`` has exactly ``dst``'s keys, each of its shape."""
    missing = [k for k in dst if k not in src]
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {missing[0]!r}"
                       + (f" and {len(missing) - 1} more" if len(missing) > 1 else ""))
    extra = [k for k in src if k not in dst]
    if extra:
        raise KeyError(f"{what}: the checkpoint has {extra[0]!r}, which the model does not"
                       + (f" (and {len(extra) - 1} more)" if len(extra) > 1 else ""))
    for k, t in dst.items():
        if tuple(src[k].shape) != tuple(t.shape):
            raise ValueError(f"{what}: {k!r} has shape {tuple(src[k].shape)} in the "
                             f"checkpoint, {tuple(t.shape)} in the model")


@torch.no_grad()
def copy_tensors(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor]) -> None:
    for k, t in dst.items():
        t.copy_(src[k])


def load_model_state(model: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """``state`` (a checkpoint's ``model``) into ``model``'s own parameters
    and buffers, strictly and in place."""
    dst = model.state_dict(keep_vars=True)
    check_tensors(dst, state, "model")
    copy_tensors(dst, state)
    return model


def restore_checkpoint(path: str, trainer) -> int:
    """Loads ``path`` into ``trainer`` (model state, momentum, step) in place;
    returns the saved epoch. Under a mesh each rank takes its slices of the
    whole tensors, so a file from any mesh loads onto any other. Nothing is
    written unless everything matches."""
    payload = read_checkpoint(path)
    mesh = getattr(trainer, "mesh", None)
    for part in ("model", "momentum"):
        payload[part] = {k: local_slice(k, v, mesh) for k, v in payload[part].items()}
    model = trainer.model.state_dict(keep_vars=True)
    momentum = dict(zip(momentum_names(trainer.model, trainer.optimizer),
                        trainer.optimizer.bufs))
    check_tensors(model, payload["model"], "model")
    check_tensors(momentum, payload["momentum"], "momentum")
    copy_tensors(model, payload["model"])
    copy_tensors(momentum, payload["momentum"])
    trainer.step = int(payload["step"])
    return int(payload["epoch"])
