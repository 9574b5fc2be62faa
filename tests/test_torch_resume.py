"""The port's checkpoints in use, on the CPU: a round trip through
``save_ckpt`` / ``load_ckpt`` on the audio config of tests/test_trainer.py
(SwinV2 at 56^2, one stage), the load's strictness and in-place copies,
an interrupted save; and ``Trainer.train``'s loop against the JAX one (a
one-layer model in each package): the log lines in the same order, the
checkpoints, curves and tracker files at the same steps, and a resumed
run re-entering the saved epoch."""

import os
import re

import numpy as np
import pytest
import torch

from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.io.checkpoint import read_checkpoint, save_checkpoint
from deepfake_tpu_torch.train.trainer import Trainer

from tests.test_trainer import SyntheticAudioData  # a separable set: label 1 where the mean > 0
from tests.torch_fused_train_helpers import one_torch_thread  # noqa: F401 (a fixture)


def _audio_cfg(tmp_path) -> Config:
    cfg = Config()
    for k, v in {"data.modality": "audio", "data.audio_size": 56, "model.swin2d_embed_dim": 16,
                 "model.swin2d_depths": (2,), "model.swin2d_heads": (2,),
                 "model.swin2d_pretrained_windows": (0,), "parallel.compute_dtype": "float32",
                 "optim.batch_size": 8, "optim.accum_step": 2, "optim.epochs": 8,
                 "optim.learning_rate": 1e-2, "log.log_step": 1, "log.model_save": 10 ** 9,
                 "log.ckpt_dir": str(tmp_path)}.items():
        cfg.set(k, v)
    return cfg


@pytest.fixture
def trained(tmp_path):
    """An audio Trainer after 4 steps (one thread: the workers share the
    cores), its checkpoint and its eval."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = SyntheticAudioData()
        trainer = Trainer(None, _audio_cfg(tmp_path), data, logger=lambda s: None, device="cpu")
        for inputs, labels in data.train_loader():
            trainer.train_step(inputs, labels)
        path = trainer.save_ckpt(epoch=3)
        yield trainer, path, trainer.eval(data.val_loader())
    finally:
        torch.set_num_threads(n)


def test_checkpoint_round_trip_restores_the_eval_loss_in_place(trained):
    """After tests/test_trainer.py:148-184: zero every parameter and
    momentum buffer, load: the eval loss within 1e-6 of the saved model's,
    ``step`` and ``start_epoch`` restored, and every tensor a step moves
    (``Trainer._state``) keeps its storage (a captured graph reads it)."""
    trainer, path, before = trained
    assert os.path.basename(path) == "deepfake_modalityaudio_batch8_epoch3_step4"
    ptrs = [t.data_ptr() for t in trainer._state()]
    with torch.no_grad():
        for t in [*trainer.model.parameters(), *trainer.optimizer.bufs]:
            t.zero_()
    trainer.step = 0
    zeroed = trainer.eval(trainer.data.val_loader())
    assert abs(zeroed["loss"] - before["loss"]) > 1e-3
    trainer.load_ckpt(path)
    after = trainer.eval(trainer.data.val_loader())
    assert abs(after["loss"] - before["loss"]) < 1e-6
    assert (trainer.step, trainer.start_epoch) == (4, 3)
    assert [t.data_ptr() for t in trainer._state()] == ptrs
    payload = read_checkpoint(path)
    for b, (name, p) in zip(trainer.optimizer.bufs, trainer.model.named_parameters()):
        assert torch.equal(b, payload["momentum"][name]) and b.abs().max() > 0, name


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "momentum"])
def test_restore_is_strict_and_names_the_key(trained, tmp_path, fault):
    """A checkpoint that lacks a key, has one the model does not, has a
    tensor of another shape, or lacks a momentum buffer raises, naming the
    key, and leaves the Trainer as it was."""
    trainer, path, _ = trained
    payload = read_checkpoint(path)
    key = "layers_0_blocks_1.attn.qkv_weight"
    if fault == "missing":
        del payload["model"][key]
    elif fault == "extra":
        key = "layers_0_blocks_1.attn.no_such_weight"
        payload["model"][key] = torch.zeros(3)
    elif fault == "shape":
        payload["model"][key] = payload["model"][key][:, :-1]
    else:
        del payload["momentum"][key]
    bad = str(tmp_path / "bad")
    torch.save(payload, bad)
    before = [t.clone() for t in trainer._state()]
    with pytest.raises((KeyError, ValueError), match=re.escape(key)):
        trainer.load_ckpt(bad)
    assert all(torch.equal(a, b) for a, b in zip(trainer._state(), before))
    assert trainer.step == 4


def test_interrupted_save_leaves_the_previous_checkpoint(trained, monkeypatch):
    """A save that fails midway (the write raises after half its bytes)
    leaves the previous checkpoint under the name whole and loadable, and
    no temporary file beside it."""
    trainer, path, _ = trained
    good = read_checkpoint(path)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
    real_save = torch.save

    def half_then_fail(obj, f, *a, **kw):
        real_save(obj, f, *a, **kw)
        f.truncate(f.tell() // 2)
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", half_then_fail)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, trainer, epoch=5)
    monkeypatch.undo()
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]
    kept = read_checkpoint(path)
    assert kept["epoch"] == good["epoch"] == 3
    assert all(torch.equal(kept["model"][k], v) for k, v in good["model"].items())


# ---------------------------------------------------------------- the loop
def _kind(line: str) -> str:
    """A log line's kind, its numbers and paths left out."""
    for prefix, kind in (("model parameters", "params"), ("[INFO] Start", "start"),
                         ("dataload : elapse", "dataload"), ("step : elapse", "step"),
                         ("| epoch", "loss"), ("checkpoint saved", "ckpt"), ("duty |", "duty"),
                         ("Phase:train", "train"), ("Phase:val", "val"),
                         ("Load Finetuned", "load")):
        if line.startswith(prefix):
            return kind
    return line


def _loop_cfg(cfg, ckpt_dir):
    for k, v in {"data.modality": "audio", "data.audio_size": 56, "optim.batch_size": 2,
                 "optim.accum_step": 1, "optim.epochs": 1, "log.log_step": 2,
                 "log.model_save": 2, "log.hbm_track_step": 2, "log.ckpt_dir": ckpt_dir,
                 "log.curve_dir": ckpt_dir}.items():
        obj = cfg
        for p in k.split(".")[:-1]:
            obj = getattr(obj, p)
        setattr(obj, k.split(".")[-1], v)
    return cfg


RESUME_FROM = "deepfake_modalityaudio_batch2_epoch1_step5"


def _runs(trainer, lines, root):
    """Trainer.train in ``root``, then in ``root``/resume from the step-5
    checkpoint; the log lines (``lines``, the trainer's logger's list) and
    the step after each."""
    os.chdir(root)
    trainer.train()
    first, step = list(lines), int(getattr(trainer, "state", trainer).step)
    lines.clear()
    os.makedirs(os.path.join(root, "resume"))
    os.chdir(os.path.join(root, "resume"))
    trainer.load_ckpt(os.path.join(root, "ckpt", RESUME_FROM))
    trainer.train()
    return first, step, list(lines), int(getattr(trainer, "state", trainer).step)


def _jax_loop(root, data):
    """The JAX Trainer.train on a Dense(1) of the image mean."""
    import flax.linen as fnn
    import jax

    from deepfake_tpu.config import Config as JConfig
    from deepfake_tpu.parallel.mesh import make_mesh
    from deepfake_tpu.train.trainer import Trainer as JTrainer

    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            return fnn.Dense(1)(x.mean(axis=(1, 2)))[:, 0]

    cfg = _loop_cfg(JConfig(), os.path.join(root, "ckpt"))
    lines = []
    return _runs(JTrainer(Tiny(), cfg, data, logger=lines.append,
                          mesh=make_mesh(devices=jax.devices()[:1])), lines, root)


def _port_loop(root, data):
    """The port's Trainer.train on a Linear(1) of the image mean."""
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(3, 1)

        def forward(self, x, return_logits=True):
            return self.fc(x.mean(dim=(1, 2)))[:, 0]

    cfg = _loop_cfg(Config(), os.path.join(root, "ckpt"))
    cfg.parallel.compute_dtype = "float32"
    lines = []
    return _runs(Trainer(Tiny(), cfg, data, logger=lines.append, device="cpu"), lines, root)


def test_train_loop_follows_the_jax_loop(tmp_path, monkeypatch):
    """``Trainer.train`` against the JAX ``Trainer.train`` over 2 epochs of 3
    steps, log_step 2, model_save 2 and hbm_track_step 2, each package in a
    directory of its own: the same kinds of log line in the same order (the
    timers' lines, the losses, the saves, the ``duty |`` lines with the
    same phases, the epoch summaries), checkpoints of the same names after
    steps 1, 3 and 5 (the (t + 1) % model_save cadence), the same loss
    curves (where matplotlib imports) and a tracker file of census lines.
    Then each package's Trainer loads its step-5 checkpoint (epoch 1) and
    trains again: the saved epoch re-entered from its first batch, steps
    6-8, and the same lines again."""
    monkeypatch.chdir(tmp_path)  # restored after the test
    data = SyntheticAudioData(n=6, batch=2)
    runs = {}
    for name, loop in (("jax", _jax_loop), ("port", _port_loop)):
        root = tmp_path / name
        root.mkdir()
        lines, step, resumed, step2 = loop(str(root), data)
        ckpts = sorted(c for c in os.listdir(root / "ckpt") if not c.endswith("_step7"))
        hbm = os.listdir(root / "hbm_track")
        runs[name] = dict(kinds=[_kind(s) for s in lines], step=step, ckpts=ckpts,
                          resumed=[_kind(s) for s in resumed], step2=step2, hbm=hbm,
                          duty=[re.sub(r"[\d.]+%", "%", s) for s in lines if s.startswith("duty")],
                          epochs=[s.split("|")[1].strip() for s in resumed
                                  if s.startswith("| epoch")],
                          track=open(root / "hbm_track" / hbm[0]).read() if hbm else "")
    j, t = runs["jax"], runs["port"]
    assert t["kinds"] == j["kinds"] and t["resumed"] == j["resumed"]
    assert t["duty"] == j["duty"] and len(t["duty"]) == 3
    assert "ckpt" in t["duty"][0] and "input_wait" in t["duty"][0]
    assert (t["step"], t["step2"]) == (j["step"], j["step2"]) == (6, 8)
    assert [c for c in t["ckpts"] if not c.endswith(".png")] == [
        f"deepfake_modalityaudio_batch2_epoch{e}_step{s}" for e, s in ((0, 1), (0, 3), (1, 5))]
    assert t["ckpts"] == j["ckpts"]
    assert t["epochs"] == j["epochs"] == ["epoch  1"] * 2  # steps 6 and 8, log_step 2
    assert len(t["hbm"]) == 1 and "At step 2 Total HBM bytes:" in t["track"]
    assert t["track"].count("At step") == j["track"].count("At step") == 3


@pytest.mark.parametrize("modality", ["audio", "paudio", "video_swin", "fused"])
def test_serving_and_training_models_hold_the_same_state(tmp_path, modality, one_torch_thread):
    """A checkpoint comes from a train-mode model and is served by an
    eval-mode one: for every modality (fused holding the video branch) the
    two have the same persistent state, key for key and shape for shape, so
    ``Predictor.from_checkpoint`` loads a training checkpoint strictly."""
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.serving import Predictor

    from tests.torch_port_helpers import SMALL_FUSED, both_configs

    over = dict(SMALL_FUSED, **{"data.modality": modality})
    if modality == "video_swin":
        from tests.test_torch_swin3d import SMALL_VIDEO_SWIN

        over = SMALL_VIDEO_SWIN
    cfg = both_configs(over)[1]
    shapes = lambda m: {k: tuple(v.shape) for k, v in m.state_dict().items()}
    train = build_model(cfg, "cpu", train=True)
    assert shapes(build_model(cfg, "cpu")) == shapes(train)

    class NoBatches:
        def train_loader(self):
            return []

    with torch.no_grad():
        for p in train.parameters():
            p.mul_(0.5)
    trainer = Trainer(train, cfg, NoBatches(), logger=lambda s: None, device="cpu")
    path = save_checkpoint(str(tmp_path / "ckpt"), trainer)
    served = Predictor.from_checkpoint(cfg, path, device="cpu").model.state_dict()
    for k, v in train.state_dict().items():
        assert torch.equal(served[k], v.to(served[k].dtype)), k
