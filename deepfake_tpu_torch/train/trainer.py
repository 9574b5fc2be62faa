"""Training and evaluation on one device or over a mesh
(deepfake_tpu/train/trainer.py:68-413).

    trainer = Trainer(None, cfg, data)       # builds cfg's model, on the card
    trainer = Trainer(None, cfg, data, mesh=mesh)  # one rank of a (data, model) mesh
    trainer.train()                          # the epoch loop with log lines
    metrics = trainer.train_step(x, y)       # one optimizer step
    loss = trainer.chained_train_steps(3)(x, y)  # three steps, one batch, no sync
    trainer.eval(data.val_loader())          # loss, acc, AUC
    path = trainer.save_ckpt(epoch)          # cfg.log.ckpt_dir/deepfake_modality..._step{t}
    trainer.load_ckpt(path)                  # resume: step, start_epoch, weights, momentum

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
  5. Activation checkpointing (``parallel.remat``, models/layers.py::
     remat_block) runs a block's forward again in the backward, and its
     masks must be the forward's. A capture cannot read or set the dropout
     generator's offset, so each checkpointed block run of a step recomputes
     from a twin generator of its own, registered with the graph and put,
     before each replay, at the offset the generator had when that block
     ran (``RecomputeStreams``, one a step graph: the offsets differ from one
     signature to the next; the eager route copies the state instead).

The host reads a metric only at ``log_step``. ``chained_train_steps(n)``
replays the step graph n times on one device-resident batch, writing each
step's rate in between, with no host sync (deepfake_tpu/train/
trainer.py:240-270).

The loop (``train``) is the JAX one (deepfake_tpu/train/trainer.py:314-384):
epochs ``start_epoch`` .. ``optim.epochs``, the step count ``t`` going on
from ``self.step``; ``StepTimer`` marks and ``DutyCycle`` buckets
(``input_wait``, ``step``, ``ckpt``; a ``duty |`` line every ``log_step``
steps); each step inside a ``StepWatchdog`` section and a profiler range;
``HbmTracker`` after every step (a census every ``log.hbm_track_step``); a
checkpoint, then the train and val curves, after each step t with (t + 1) %
``log.model_save`` == 0 (the JAX cadence, kept); the val pass at each
epoch's end; a torch.profiler trace of the whole loop into
``log.profile_dir`` where it is set. ``save_ckpt`` / ``load_ckpt`` write and
read ``io/checkpoint.py``'s file; a load copies into the existing tensors,
so the captured step and eval graphs replay the loaded weights, and a
resumed run re-enters the saved epoch from its first batch
(``start_epoch``), as the JAX run does. The JAX trainer's reference
``.pth`` imports are not ported.

The mesh (``parallel/mesh.py``; the JAX Trainer's ``mesh``, trainer.py:86,
142-160, 286-300). One process a device, each a rank of a (data, model)
grid. ``train_step`` and ``eval`` then take this data rank's rows: its
slice of each micro-batch (``parallel.mesh.shard_batch`` of a global batch;
the data module's loaders built with the mesh decode those rows only), and
for ``eval`` a batch padded to a multiple of the data axis whose padding
rows carry NaN labels (``parallel.mesh.shard_eval_batch``). The model is split over the
model axis (``shard_model``) before the optimizer is built, so each
momentum buffer follows its parameter's slice. In the step function, after
the ``accum`` micro-batches' gradients are summed and divided, one
all-reduce over the data axis takes their mean (XLA's psum), inside the
step's CUDA graph; the clip's global norm sums the squares of split
gradients over the model axis and counts replicated ones once; loss and
accuracy are all-reduced to global means. BatchNorm's statistics and the
InfoNCE loss are over the global batch (models/layers.py, models/fusion.py)
unless the data axis does not divide ``optim.batch_size``, when every data
rank takes the whole training batch and nothing is all-reduced over data but
the gradients (``parallel.mesh.batch_state``, set for each step and each
evaluation batch: the latter is padded, so it always splits). The dropout
generator is seeded from (seed, data rank): the model ranks of a data rank
draw the same masks. ``eval`` gathers the per-row outputs over the data
axis and drops the padding rows. Logging, curves and checkpoint files are
rank 0's; a checkpoint holds whole tensors
(the model ranks' slices gathered), the file a single-device run writes,
and loads onto any mesh. The watchdog and HbmTracker (``./hbm_track/rank<r>``)
run on every rank.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from deepfake_tpu_torch.compiled import GraphCache, map_leaves, signature
from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from deepfake_tpu_torch.models.layers import RecomputeStreams, set_dropout_generator
from deepfake_tpu_torch.models.registry import (
    build_model, compute_dtype, irv2_quant, pack_int8_weights, resolve_device, set_irv2_quant,
)
from deepfake_tpu_torch.parallel import mesh as pm
from deepfake_tpu_torch.train.losses import bce_with_logits
from deepfake_tpu_torch.train.schedule import SGD, clip_by_global_norm, make_schedule
from deepfake_tpu_torch.utils.logging import AverageMeter, Drawer, DutyCycle, Logger, StepTimer
from deepfake_tpu_torch.utils.metrics import roc_auc
from deepfake_tpu_torch.utils.profiling import HbmTracker, StepAnnotation, trace
from deepfake_tpu_torch.utils.seeding import make_generators, seed_everything
from deepfake_tpu_torch.utils.watchdog import StepWatchdog


class Trainer:
    """Trains ``model`` (or, when None, ``build_model(cfg, train=True)``) on
    ``device``: the card unless the caller passes ``device="cpu"``; raises
    when there is no card and none was named. ``compiled``: on the card,
    each step and evaluation batch shape runs as one CUDA graph (see the
    module's note)."""

    def __init__(self, model: Optional[nn.Module], cfg: Config, data,
                 logger: Optional[Logger] = None, device=None, compiled: bool = True,
                 mesh: Optional[pm.Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.rank0 = mesh is None or mesh.rank == 0
        self.data = data
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        self.graphs = GraphCache(self.device) if compiled and self.device.type == "cuda" else None
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # f32 means parity: full-precision products, no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.logger = (logger or Logger()) if self.rank0 else (lambda line: None)
        self.accum = max(1, cfg.optim.accum_step)
        self.modality = cfg.data.modality
        self.align = cfg.optim.use_align_loss and cfg.data.modality == "fused"
        gens = seed_everything(cfg.random_seed, self.device)
        if model is None:
            model = build_model(cfg, self.device, train=True)
        self.dropout = gens.dropout
        if mesh is not None:
            # every rank builds the same weights from the seed, then keeps its
            # slices; the dropout stream is the data rank's
            self.dropout = make_generators(cfg.random_seed + 7919 * mesh.d, self.device).dropout
            pm.shard_model(model.to(self.device), mesh)
        self.train_sharded = pm.splits_train_batch(cfg, mesh)
        self.model = set_dropout_generator(model.to(self.device), self.dropout).train()
        # model.irv2_quant: the IRv2 trunk evaluates in int8, its training
        # steps take the float path (the JAX Trainer's one model for both,
        # deepfake_tpu/models/registry.py:77, layers.py:305)
        self.quant = irv2_quant(cfg)
        set_irv2_quant(self.model, self.quant)
        # trap 5: the checkpointed blocks, and the RecomputeStreams of the
        # step graph being captured (None outside a capture)
        self._remat = [m for m in self.model.modules() if getattr(m, "remat", None) is not None]
        self.recompute = None
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
        self.sharded = pm.sharded_flags(self.model, self.optimizer.params, mesh)
        self.step = 0
        self.start_epoch = 0

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
        if self.recompute is not None:
            self.recompute.begin_step()
        params = self.optimizer.params
        for p in params:
            p.grad = None
        losses, accs = [], []
        for i, ym in enumerate(y.chunk(self.accum)):
            xm = map_leaves(lambda t: t.chunk(self.accum)[i], x)
            with pm.batch_state(self.mesh, self.train_sharded):
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
            if self.mesh is not None:
                grads = pm.all_reduce_mean(grads, self.mesh)
                for p in params:  # the mean lives in one flat buffer now
                    p.grad = None
            clip_by_global_norm(grads, self.cfg.optim.grad_clip, self.sharded,
                                None if self.mesh is None else self.mesh.model_group)
            self.optimizer.step(grads)
            metrics = torch.stack([torch.stack(losses).float().mean(), torch.stack(accs).mean()])
            if self.mesh is not None:
                metrics = pm.all_reduce_mean([metrics], self.mesh)[0]
        return {"loss": metrics[0], "acc": metrics[1]}

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
            # trap 5: this graph's own twins and offsets (the offsets depend on
            # the signature: a wave's length sets what its dropouts draw)
            rc = RecomputeStreams(self.dropout) if self._remat else None
            self._attach_recompute(rc)
            try:
                g = self.graphs.graph(key, self._step, batch,
                                      generators=(self.dropout,) if rc is None else
                                      lambda: rc.generators,
                                      prologue=None if rc is None else rc.sync)
            finally:
                self._attach_recompute(None)
            with torch.no_grad():
                for t, s in zip(self._state(), saved):
                    t.copy_(s)
            self.dropout.set_state(gen_state)
        return g

    def _attach_recompute(self, rc: Optional[RecomputeStreams]) -> None:
        self.recompute = rc
        for m in self._remat:
            m.recompute_streams = rc

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
            # an evaluation batch is padded to split over the data axis
            with pm.batch_state(self.mesh, True):
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
        timer = StepTimer(logger, cfg.log.log_step)
        duty = DutyCycle(logger, cfg.log.log_step)
        loss_stat = AverageMeter()
        train_draw = Drawer(self.modality, "train", cfg.log.curve_dir, logger)
        val_draw = Drawer(self.modality, "val", cfg.log.curve_dir, logger)
        logger(f"[INFO] Start training, lr = {cfg.optim.learning_rate:.6f}")
        hbm = HbmTracker("./hbm_track/" if self.mesh is None or self.mesh.world == 1 else
                         f"./hbm_track/rank{self.mesh.rank}/", every=cfg.log.hbm_track_step,
                         device_type=self.device.type)
        watchdog = StepWatchdog(cfg.log.step_deadline_s, on_stall=logger)
        t = self.step
        profiled = trace(cfg.log.profile_dir) if cfg.log.profile_dir else contextlib.nullcontext()
        try:
            with profiled:
                for epoch in range(self.start_epoch, cfg.optim.epochs + 1):
                    timer.mark("dataload")
                    for inputs, labels in self.data.train_loader():
                        duty.add("input_wait", timer.report("dataload"))
                        timer.mark("step")
                        with watchdog.watch(f"train_step {t}"), StepAnnotation("train", t):
                            metrics = self.train_step(inputs, labels)
                        hbm.step()
                        hbm.track()
                        t += 1
                        if t % cfg.log.log_step == 0 and self.rank0:
                            m = {k: float(v) for k, v in metrics.items()}
                            loss_stat.update(m["loss"])
                            train_draw.update(m["loss"])
                            logger("| epoch {:2d} | step {:4d} | lr {:.4E} | Train Loss Avg "
                                   "{:3.5f} | Train Acc {:1.5f}".format(
                                       epoch, t, self.lr(t), loss_stat.avg, m["acc"]))
                            timer.report("step")
                        # "step" holds the metric read above, where the host
                        # waits for the card; saves and curves are "ckpt"
                        duty.add("step", timer.elapsed("step"))
                        if (t + 1) % cfg.log.model_save == 0:
                            timer.mark("ckpt")
                            self.save_ckpt(epoch)  # every rank: it gathers the slices
                            if self.rank0:
                                train_draw.draw(epoch)
                                val_draw.draw(epoch)
                            duty.add("ckpt", timer.elapsed("ckpt"))
                        duty.step()
                        timer.mark("dataload")
                    val = self.eval(self.data.val_loader(), val_draw)
                    logger(f"Phase:train, Avg Loss:{loss_stat.avg}")
                    logger(f"Phase:val, Avg Loss:{val['loss']}, Acc:{val['acc']}, "
                           f"AUC:{val['auc']}")
                    loss_stat.reset()
                    train_draw.reset()
                    val_draw.reset()
        finally:
            watchdog.close()

    def eval(self, loader: Iterable, draw: Optional[Drawer] = None) -> Dict[str, float]:
        """Mean loss and accuracy over the loader's rows, and the ROC-AUC;
        each batch's mean loss into ``draw`` where one is given. Under a mesh
        over the data ranks' rows gathered, padding rows (NaN labels) dropped
        (deepfake_tpu/train/trainer.py:386-406). At ``model.irv2_quant`` the
        IRv2 trunk runs int8 on the current weights, folded and quantised
        first."""
        if self.quant is not None:
            pack_int8_weights(self.model)
        loss_stat, acc_stat = AverageMeter(), AverageMeter()
        all_probs, all_labels = [], []
        for inputs, labels in loader:
            out = self._eval_step(inputs, labels)
            lab = torch.as_tensor(labels.cpu().numpy() if torch.is_tensor(labels) else
                                  np.asarray(labels), dtype=torch.float32)
            if self.mesh is not None:
                out = dict(out, labels=lab.to(out["probs"].device))
                out = {k: pm.gather_from(v.float(), self.mesh.data_group, dim=0)
                       for k, v in out.items()}
            out = {k: v.float().cpu().numpy() for k, v in out.items()}
            if self.mesh is not None:
                real = ~np.isnan(out["labels"])
                out = {k: v[real] for k, v in out.items()}
                lab = torch.from_numpy(out.pop("labels"))
            n = out["probs"].shape[0]
            loss = float(np.mean(out["loss_vec"]))
            loss_stat.update(loss, n)
            acc_stat.update(float(np.mean(out["correct"])), n)
            all_probs.append(out["probs"])
            all_labels.append(lab.numpy())
            if draw is not None:
                draw.update(loss)
        probs = np.concatenate(all_probs) if all_probs else np.zeros(0)
        labels = np.concatenate(all_labels) if all_labels else np.zeros(0)
        return {"loss": loss_stat.avg, "acc": acc_stat.avg, "auc": roc_auc(probs, labels)}

    # ----------------------------------------------------------- checkpoints
    def save_ckpt(self, epoch: int) -> str:
        """The step, weights, BatchNorm statistics, momentum and ``epoch`` to
        ``log.ckpt_dir``/deepfake_modality{m}_batch{b}_epoch{e}_step{t}."""
        path = os.path.join(
            self.cfg.log.ckpt_dir,
            f"deepfake_modality{self.modality}_batch{self.cfg.optim.batch_size}"
            f"_epoch{epoch}_step{self.step}")
        path = save_checkpoint(path, self, epoch)
        self.logger(f"checkpoint saved: {path}")
        return path

    def load_ckpt(self, path: str) -> None:
        """Resume from ``save_ckpt``'s file: the weights, statistics and
        momentum copied into this Trainer's tensors, ``step`` and
        ``start_epoch`` (the saved epoch, re-entered from its first batch)."""
        self.start_epoch = restore_checkpoint(path, self)
        self.logger(f"Load Finetuned Model From:{path}")
