"""Training and evaluation on one device (deepfake_tpu/train/trainer.py:68-413).

    trainer = Trainer(None, cfg, data)       # builds cfg's model, on the card
    trainer.train()                          # the epoch loop with log lines
    metrics = trainer.train_step(x, y)       # one optimizer step
    loss = trainer.chained_train_steps(3)(x, y)  # three steps, one batch, no sync
    trainer.eval(data.val_loader())          # loss, acc, AUC

``data`` exposes ``train_loader()`` and ``val_loader()``, iterables of
(inputs, labels) batches (numpy or torch). Inputs are one array or, for the
fused model, the nested tuple (video, audio, (wave, lengths)). One
train-loader yield is one optimizer step of ``batch_size * accum_step``
rows; every array of the inputs is split along its first axis into
``accum_step`` micro-batches of ``batch_size``; their gradients are summed
and divided by ``accum_step``, clipped by their global norm where
``optim.grad_clip`` is set, then SGD with momentum and coupled weight decay
steps at the cosine rate of this step (schedule.py), ``t_max = epochs *
len(train_loader)``. The loss is the BCE from logits, in the logits' type,
plus ``optim.align_loss_rate`` times the fused model's InfoNCE alignment
loss where ``optim.use_align_loss`` is set (deepfake_tpu/train/trainer.py:
170-209). Float inputs take ``parallel.compute_dtype`` and integer ones
(wave lengths) int64; the parameters stay in ``parallel.param_dtype``.
BatchNorm's running statistics move with each micro-batch's forward.

Routes. On the card a Trainer is compiled by default (``compiled=True``),
the counterpart of the JAX Trainer's jitted step and eval step: each step
signature (the input and label shapes and dtypes, ``accum``) runs as one
CUDA graph (``compiled.py``) that holds the ``accum`` micro-batch forwards
and backwards, the division by ``accum``, the clip, the update at this
step's rate and the metrics (loss and accuracy as device scalars); each
evaluation batch shape runs as a graph of its own (a ragged last batch is
one more). ``compiled=False`` is the eager route, which runs the same step
function op by op; the CPU is always eager. A failed capture or replay
raises: nothing falls back to the eager route. The traps a training graph
has, and what the route does about each:

  1. The learning rate changes every step. It lives in a device scalar
     (``SGD.lr``) that the host writes before each step, and the update
     (``schedule.SGD``, foreach ops) reads it on the device; the momentum
     buffers exist from the start, zeros, so every step runs one code path.
  2. Dropout and DropPath draw from the Trainer's own CUDA generator. It is
     registered with the graph (``register_generator_state``), so each
     replay draws from the generator's current offset and advances it by
     what one step draws: the masks of the replays are those that eager
     steps from the same state would draw.
  3. A capture runs the step twice eagerly first (its warm-up) and once
     under capture; both move the weights, the momentum, BatchNorm
     statistics and the generator. They are saved before and restored after
     (``Trainer.step`` is not moved), so the graph route's first step is
     step 0, as the eager route's is.
  4. The kernel wrappers count launches when a graph is captured, not when
     it is replayed: a graph's hand-written launches are ``Graph.launches``
     (one capture's count) times ``Graph.replays``.

The host reads a metric only at ``log_step``. ``chained_train_steps(n)``
replays the step graph n times on one device-resident batch, writing each
step's rate in between, with no host sync (deepfake_tpu/train/
trainer.py:240-270). The JAX trainer's mesh, checkpoints,
``load_pretrained_backbones``, profiler and duty-cycle timers are not
ported.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from deepfake_tpu_torch.compiled import GraphCache, map_leaves, signature
from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.models.layers import set_dropout_generator
from deepfake_tpu_torch.models.registry import build_model, compute_dtype, resolve_device
from deepfake_tpu_torch.train.losses import bce_with_logits
from deepfake_tpu_torch.train.schedule import SGD, clip_by_global_norm, make_schedule
from deepfake_tpu_torch.utils.logging import AverageMeter, Logger
from deepfake_tpu_torch.utils.metrics import roc_auc
from deepfake_tpu_torch.utils.seeding import seed_everything


class Trainer:
    """Trains ``model`` (or, when None, ``build_model(cfg, train=True)``) on
    ``device``: the card unless the caller passes ``device="cpu"``; raises
    when there is no card and none was named. ``compiled``: on the card,
    each step and evaluation batch shape runs as one CUDA graph (see the
    module's note)."""

    def __init__(self, model: Optional[nn.Module], cfg: Config, data,
                 logger: Optional[Logger] = None, device=None, compiled: bool = True):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        self.graphs = GraphCache(self.device) if compiled and self.device.type == "cuda" else None
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # f32 means parity: full-precision products, no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.logger = logger or Logger()
        self.accum = max(1, cfg.optim.accum_step)
        self.align = cfg.optim.use_align_loss and cfg.data.modality == "fused"
        gens = seed_everything(cfg.random_seed, self.device)
        if model is None:
            model = build_model(cfg, self.device, train=True)
        self.dropout = gens.dropout
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
        self.optimizer = SGD(self.model.parameters(), o.momentum, o.weight_decay)
        self.step = 0

    # ------------------------------------------------------------------ steps
    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        """A float input in the compute type, an integer one in int64."""
        return x.to(self.dtype if x.is_floating_point() else torch.int64)

    def _put_batch(self, inputs, labels):
        def put(x):
            return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(self.device)

        return (map_leaves(lambda x: self._cast(put(x)), inputs),
                put(labels).to(torch.float32))

    def _logits(self, x):
        out = self.model(x, return_logits=True)
        return out[0] if isinstance(out, tuple) else out

    def _loss(self, x, y):
        """(loss, logits) of one micro-batch in train mode: the BCE, plus the
        weighted alignment loss where the config asks for it."""
        if self.align:
            logits, align = self.model(x, return_logits=True, with_align_loss=True)
            return bce_with_logits(logits, y) + self.cfg.optim.align_loss_rate * align, logits
        logits = self._logits(x)
        return bce_with_logits(logits, y), logits

    def _step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch on the device, at the rate in
        ``optimizer.lr``: the function that the eager route runs and that a
        graph captures. Reads no value back to the host."""
        x, y = batch
        x, y = map_leaves(self._cast, x), y.to(torch.float32)
        self.model.train()
        params = self.optimizer.params
        for p in params:
            p.grad = None
        losses, accs = [], []
        for i, ym in enumerate(y.chunk(self.accum)):
            xm = map_leaves(lambda t: t.chunk(self.accum)[i], x)
            loss, logits = self._loss(xm, ym)
            loss.backward()
            losses.append(loss.detach())
            with torch.no_grad():
                accs.append(((torch.sigmoid(logits) >= 0.5) == (ym >= 0.5)).float().mean())
        with torch.no_grad():
            # a parameter the loss does not reach steps with a zero gradient
            # (decay and momentum), as in the optax chain
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            torch._foreach_div_(grads, float(self.accum))
            clip_by_global_norm(grads, self.cfg.optim.grad_clip)
            self.optimizer.step(grads)
        return {"loss": torch.stack(losses).float().mean(), "acc": torch.stack(accs).mean()}

    def _state(self) -> List[torch.Tensor]:
        """Everything a step moves: parameters, buffers, momentum."""
        return [*self.model.parameters(), *self.model.buffers(), *self.optimizer.bufs]

    def _step_graph(self, batch):
        """The graph of this batch's step signature, captured at its first
        step with the weights, momentum, buffers and dropout generator as
        they were before the capture's warm-up (trap 3)."""
        key = signature("train", self.cfg.data.modality, batch) + (self.accum,)
        g = self.graphs.graphs.get(key)
        if g is None:
            with torch.no_grad():
                saved = [t.detach().clone() for t in self._state()]
            gen_state = self.dropout.get_state()
            g = self.graphs.graph(key, self._step, batch, generators=(self.dropout,))
            with torch.no_grad():
                for t, s in zip(self._state(), saved):
                    t.copy_(s)
            self.dropout.set_state(gen_state)
        return g

    def train_step(self, inputs, labels) -> Dict[str, torch.Tensor]:
        """One optimizer step over ``accum`` micro-batches; returns the mean
        micro-batch loss and accuracy as device scalars (a graph's static
        outputs on the compiled route: the next step overwrites them)."""
        n = len(labels)
        if n % self.accum:
            raise ValueError(f"a batch of {n} rows does not split into "
                             f"{self.accum} micro-batches")
        self.optimizer.set_lr(self.lr(self.step))
        if self.graphs is None:
            out = self._step(self._put_batch(inputs, labels))
        else:
            out = self._step_graph((inputs, labels)).replay((inputs, labels))
        self.step += 1
        return out

    def chained_train_steps(self, n: int):
        """A function (inputs, labels) -> the last step's loss (an f32 device
        scalar): n optimizer steps on one batch, which on the compiled route
        is copied to the device once and replayed n times, each step's rate
        written in between, with no host sync."""
        def chain(inputs, labels) -> torch.Tensor:
            if self.graphs is None:
                batch = self._put_batch(inputs, labels)
                step = lambda: self._step(batch)
            else:
                g = self._step_graph((inputs, labels))
                g.copy_in((inputs, labels))
                step = g.replay
            for _ in range(n):
                self.optimizer.set_lr(self.lr(self.step))
                out = step()
                self.step += 1
            return out["loss"].float().clone()

        return chain

    @torch.no_grad()
    def _eval_batch(self, batch) -> Dict[str, torch.Tensor]:
        x, y = batch
        x, y = map_leaves(self._cast, x), y.to(torch.float32)
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

    def _eval_step(self, inputs, labels) -> Dict[str, torch.Tensor]:
        """Per-sample loss, correctness and probability, in eval mode; on the
        compiled route through the graph of the batch's shape."""
        if self.graphs is None:
            return self._eval_batch(self._put_batch(inputs, labels))
        key = signature("eval", self.cfg.data.modality, (inputs, labels))
        return self.graphs.run(key, self._eval_batch, (inputs, labels))

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
