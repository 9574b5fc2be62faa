"""Training and evaluation on one device (deepfake_tpu/train/trainer.py:68-413).

    trainer = Trainer(None, cfg, data)       # builds cfg's model, on the card
    trainer.train()                          # the epoch loop with log lines
    metrics = trainer.train_step(x, y)       # one optimizer step
    trainer.eval(data.val_loader())          # loss, acc, AUC

``data`` exposes ``train_loader()`` and ``val_loader()``, iterables of
(inputs, labels) batches (numpy or torch). One train-loader yield is one
optimizer step of ``batch_size * accum_step`` rows, split into ``accum_step``
micro-batches of ``batch_size``; their gradients are summed and divided by
``accum_step``, then SGD with momentum and coupled weight decay steps at the
cosine rate of this step (schedule.py), ``t_max = epochs * len(train_loader)``.
The loss is the BCE from logits, in the logits' type; inputs take
``parallel.compute_dtype``, the parameters stay in ``parallel.param_dtype``.

The JAX trainer's mesh, ``chained_train_steps``, checkpoints,
``load_pretrained_backbones``, profiler and duty-cycle timers are not ported.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.models.layers import set_dropout_generator
from deepfake_tpu_torch.models.registry import build_model, compute_dtype, resolve_device
from deepfake_tpu_torch.train.losses import bce_with_logits
from deepfake_tpu_torch.train.schedule import clip_by_global_norm, make_optimizer, make_schedule
from deepfake_tpu_torch.utils.logging import AverageMeter, Logger
from deepfake_tpu_torch.utils.metrics import roc_auc
from deepfake_tpu_torch.utils.seeding import seed_everything


class Trainer:
    """Trains ``model`` (or, when None, ``build_model(cfg, train=True)``) on
    ``device``: the card unless the caller passes ``device="cpu"``; raises
    when there is no card and none was named."""

    def __init__(self, model: Optional[nn.Module], cfg: Config, data,
                 logger: Optional[Logger] = None, device=None):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # f32 means parity: full-precision products, no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.logger = logger or Logger()
        self.accum = max(1, cfg.optim.accum_step)
        gens = seed_everything(cfg.random_seed, self.device)
        if model is None:
            model = build_model(cfg, self.device, train=True)
        self.model = set_dropout_generator(model.to(self.device), gens.dropout).train()
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger(f"model parameters: {n_params / 1e6:.2f}M")

        # one loader yield is one optimizer step, so the cosine horizon is
        # epochs * steps per epoch (trainer.py:108-133)
        try:
            steps_per_epoch = len(data.train_loader())
        except TypeError:
            steps_per_epoch = 1000
            self.logger("[WARN] train loader has no len(); cosine schedule horizon assumes "
                        "1000 optimizer steps/epoch")
        o = cfg.optim
        self.t_max = max(1, o.epochs * steps_per_epoch)
        self.lr = make_schedule(o.learning_rate, self.t_max, o.schedule)
        self.optimizer = make_optimizer(self.model.parameters(), o.learning_rate, o.momentum,
                                        o.weight_decay)
        self.step = 0

    # ------------------------------------------------------------------ steps
    def _put_batch(self, inputs, labels):
        def put(x, dtype):
            t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            return t.to(self.device, dtype)

        return put(inputs, self.dtype), put(labels, torch.float32)

    def _logits(self, x):
        out = self.model(x, return_logits=True)
        return out[0] if isinstance(out, tuple) else out

    def train_step(self, inputs, labels) -> Dict[str, torch.Tensor]:
        """One optimizer step over ``accum`` micro-batches; returns the mean
        micro-batch loss and accuracy as device scalars."""
        x, y = self._put_batch(inputs, labels)
        if x.shape[0] % self.accum:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split into "
                             f"{self.accum} micro-batches")
        self.model.train()
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        losses, accs = [], []
        for xm, ym in zip(x.chunk(self.accum), y.chunk(self.accum)):
            logits = self._logits(xm)
            loss = bce_with_logits(logits, ym)
            loss.backward()
            losses.append(loss.detach())
            with torch.no_grad():
                accs.append(((torch.sigmoid(logits) >= 0.5) == (ym >= 0.5)).float().mean())
        with torch.no_grad():
            grads = [p.grad for p in params if p.grad is not None]
            for g in grads:
                g.div_(self.accum)
            clip_by_global_norm(grads, self.cfg.optim.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr(self.step)
        self.optimizer.step()
        self.step += 1
        return {"loss": torch.stack(losses).float().mean(), "acc": torch.stack(accs).mean()}

    @torch.no_grad()
    def _eval_step(self, inputs, labels) -> Dict[str, torch.Tensor]:
        """Per-sample loss, correctness and probability, in eval mode."""
        x, y = self._put_batch(inputs, labels)
        self.model.eval()
        try:
            logits = self._logits(x)
        finally:
            self.model.train()
        probs = torch.sigmoid(logits)
        lab = y.to(logits.dtype)
        loss_vec = (torch.clamp(logits, min=0) - logits * lab
                    + torch.log1p(torch.exp(-torch.abs(logits))))
        correct = ((probs >= 0.5) == (y >= 0.5)).float()
        return {"loss_vec": loss_vec, "correct": correct, "probs": probs}

    # ------------------------------------------------------------------- loops
    def train(self):
        cfg = self.cfg
        logger = self.logger
        loss_stat = AverageMeter()
        logger(f"[INFO] Start training, lr = {cfg.optim.learning_rate:.6f}")
        for epoch in range(cfg.optim.epochs + 1):  # epochs 0 .. epochs, as the JAX loop
            for inputs, labels in self.data.train_loader():
                metrics = self.train_step(inputs, labels)
                t = self.step
                if t % cfg.log.log_step == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    loss_stat.update(m["loss"])
                    logger("| epoch {:2d} | step {:4d} | lr {:.4E} | Train Loss Avg {:3.5f} "
                           "| Train Acc {:1.5f}".format(epoch, t, self.lr(t), loss_stat.avg,
                                                        m["acc"]))
            val = self.eval(self.data.val_loader())
            logger(f"Phase:train, Avg Loss:{loss_stat.avg}")
            logger(f"Phase:val, Avg Loss:{val['loss']}, Acc:{val['acc']}, AUC:{val['auc']}")
            loss_stat.reset()

    def eval(self, loader: Iterable) -> Dict[str, float]:
        """Mean loss and accuracy over the loader's rows, and the ROC-AUC."""
        loss_stat, acc_stat = AverageMeter(), AverageMeter()
        all_probs, all_labels = [], []
        for inputs, labels in loader:
            out = {k: v.float().cpu().numpy() for k, v in self._eval_step(inputs, labels).items()}
            n = out["probs"].shape[0]
            loss_stat.update(float(np.mean(out["loss_vec"])), n)
            acc_stat.update(float(np.mean(out["correct"])), n)
            all_probs.append(out["probs"])
            all_labels.append(labels.cpu().numpy() if torch.is_tensor(labels) else
                              np.asarray(labels))
        probs = np.concatenate(all_probs) if all_probs else np.zeros(0)
        labels = np.concatenate(all_labels) if all_labels else np.zeros(0)
        return {"loss": loss_stat.avg, "acc": acc_stat.avg, "auc": roc_auc(probs, labels)}
