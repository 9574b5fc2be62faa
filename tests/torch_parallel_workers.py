"""The ranks of the port's mesh tests (tests/test_torch_parallel.py and
tests/test_torch_parallel_dp.py): each job runs as one rank of a gloo group
of CPU processes that ``spawn`` starts (torch on one thread each), reads
its inputs from a directory and leaves its results there. Imports no JAX.

The model is the small fused one (``SMALL_FUSED``) in f32, micro-batch 2 x
accumulation 2, every drop rate 0 unless a job says otherwise, from the
weights in ``setup.pt`` (a state dict, or the JAX tree carried across with
load_jax_variables)."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from deepfake_tpu_torch.parallel.dryrun import free_port

SMALL_FUSED = {
    "data.modality": "fused", "data.num_frames": 2, "data.frame_size": 96,
    "data.audio_size": 56, "model.swin2d_embed_dim": 16, "model.swin2d_depths": (2, 2),
    "model.swin2d_heads": (2, 4), "model.wav_layers": 2, "model.wav_hidden": 64,
    "model.wav_heads": 4, "model.wav_intermediate": 128, "model.wav_conv_dim": 64,
    "parallel.compute_dtype": "float32",
}
TRAIN = dict(SMALL_FUSED, **{
    "model.classify_drop": 0.0, "model.swin_drop": 0.0, "optim.batch_size": 2,
    "optim.accum_step": 2, "optim.learning_rate": 0.1, "optim.epochs": 3,
    "model.swin2d_attn_kernel": True})
# the alignment loss on; its InfoNCE at temperature 0.1, not the preset's
# 0.01: at 0.01 the softmax over the batch saturates and a rounding-level
# change of the features (a mesh's other summation order) moves a gradient
# by percents (NeXtVLAD's bn1 weight: 7.7% on the (2, 1) mesh in f32); at
# 0.1 every quantity keeps within 0.3 of its tolerance. The preset's 0.01
# runs in float64 (``witness``), where the (2, 1) step equals one device's
ALIGN = dict(TRAIN, **{"optim.use_align_loss": True, "model.soft": 0.1})
# the alignment loss at the preset's temperature (0.01): the float64 witness
ALIGN_PRESET = dict(TRAIN, **{"optim.use_align_loss": True})


# an evaluation batch that the data axis of 2 does not divide
ODD_BATCH = {"optim.batch_size": 3, "optim.accum_step": 1}


class Batches:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def train_loader(self):
        return [(self.x, self.y)]

    def val_loader(self):
        return [(self.x, self.y)]


def config(overrides):
    from deepfake_tpu_torch.config import Config

    cfg = Config()
    for k, v in overrides.items():
        cfg.set(k, v)
    return cfg


def port_model(cfg, start, dropout: bool = False):
    """The training model with the start weights (a state dict, a JAX
    variables tree, {} for the seeded ones, or "conditioned" for those
    conditioned as ``condition`` says); every Dropout-like module at
    rate 0 unless ``dropout``."""
    from deepfake_tpu_torch.io.jax_weights import load_jax_variables
    from deepfake_tpu_torch.models.layers import Dropout
    from deepfake_tpu_torch.models.registry import build_model

    with _as_built():
        m = build_model(cfg, "cpu", train=True)
    if _F64:
        _to_float64(m)
    if not dropout:
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.rate = 0.0
    if start == "conditioned":
        return condition(m)
    if "params" in start:
        return load_jax_variables(m, start)
    if start:
        m.load_state_dict(start)
    return m


def one_step(trainer, x, y):
    """One step; returns (loss, the gradients the optimizer took, by
    parameter name: the data-axis mean, this rank's slices)."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    seen = {}
    step = trainer.optimizer.step

    def spy(grads):  # the gradients as the update reads them; nothing writes them after
        seen.update({names[id(p)]: g.detach() for p, g in zip(trainer.optimizer.params, grads)})
        step(grads)

    trainer.optimizer.step = spy
    try:
        loss = float(trainer.train_step(x, y)["loss"])
    finally:
        trainer.optimizer.step = step
    return loss, seen


def stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def whole(tensors, mesh):
    """Each tensor by name, its model ranks' slices gathered (collective),
    on rank 0; an empty dict on the others."""
    from deepfake_tpu_torch.parallel.mesh import full_tensor

    out = {}
    for k, v in tensors.items():
        t = full_tensor(k, v, mesh)
        if mesh.rank == 0:
            out[k] = t.detach().clone()
    return out


def mesh_step(cfg, start, x, y, data: int, model: int, tag: str, out: str):
    """One step at a (data, model) mesh from ``start`` on the global batch
    (x, y); rank 0 saves the loss, the gradients, the weights after the
    step and the BatchNorm statistics, whole, under ``tag``. Returns the
    Trainer and its mesh."""
    from deepfake_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from deepfake_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(data, model)
    t = Trainer(port_model(cfg, start), cfg, Batches(x, y), logger=lambda line: None,
                device="cpu", mesh=mesh)
    del start  # a JAX tree of the whole model: not held through the step
    loss, grads = one_step(t, *shard_batch(x, y, mesh, cfg.optim.accum_step))
    res = {"loss": loss, "grads": whole(grads, mesh),
           "params": whole(dict(t.model.named_parameters()), mesh), "stats": stats(t.model),
           "sharded": sorted(mesh.sharded)}
    if mesh.rank == 0:
        torch.save(res, os.path.join(out, f"{tag}.pt"))
    del res, grads
    return t, mesh


def digests(model, mesh):
    """Every rank's (split?, model index, digest) of each parameter, on
    rank 0 (collective)."""
    from deepfake_tpu_torch.parallel.dryrun import digest

    mine = {k: (k in mesh.sharded, mesh.m, digest(p)) for k, p in model.named_parameters()}
    every = [None] * mesh.world
    dist.all_gather_object(every, mine)
    return every


# ---------------------------------------------------------------- float64

_F64 = []  # the torch state float64() replaced, while it is on


def _swap(to64: bool):
    """Turns the port's f32 arithmetic to float64 (``to64``) or back;
    returns the state it replaced."""
    from deepfake_tpu_torch.models import registry

    saved = (torch.float32, torch.Tensor.float, torch.get_default_dtype(),
             registry._DTYPES["float32"])
    if to64:
        torch.float32 = torch.float64
        torch.Tensor.float = lambda self, *a, **kw: self.double(*a, **kw)
        torch.set_default_dtype(torch.float64)
        registry._DTYPES["float32"] = torch.float64
    return saved


def _restore(saved):
    from deepfake_tpu_torch.models import registry

    torch.float32 = saved[0]
    if torch.Tensor.float is not saved[1]:
        del torch.Tensor.float  # TensorBase's method again
    torch.set_default_dtype(saved[2])
    registry._DTYPES["float32"] = saved[3]


@contextlib.contextmanager
def float64():
    """While it runs, the port computes in float64 where it computes in f32
    (this process only): the compute type "float32" is torch.float64,
    ``Tensor.float()`` gives float64, ``torch.float32`` names float64, new
    tensors are float64, and ``port_model`` builds its model in f32 (the
    seeded weights drawn as in f32) and converts it. Not a route of the
    port: a witness that removes rounding, so that a mesh's step and one
    device's can be held to each other at ~1e-10."""
    _F64.append(_swap(True))
    try:
        yield
    finally:
        _restore(_F64.pop())


@contextlib.contextmanager
def _as_built():
    """f32 for the length of a model's construction under float64()."""
    if not _F64:
        yield
        return
    _restore(_F64[-1])
    try:
        yield
    finally:
        _swap(True)


def _to_float64(model):
    """Parameters, buffers and the tensors modules keep as plain attributes
    (SwinV2's coordinate table) in float64."""
    model.double()
    for mod in model.modules():
        for k, v in list(vars(mod).items()):
            if torch.is_tensor(v) and v.is_floating_point():
                setattr(mod, k, v.double())
    return model


def check_float64(got, want):
    """A float64 step against another: the loss within 1e-10 relative; every
    gradient within 1e-10 of the largest |gradient| of its parameter, or
    within 1e-14 of the step's largest |gradient| where that is more (a
    gradient that is zero but for rounding: a bias under a BatchNorm or a
    softmax, measured at 1e-14 of the step's largest and below); every
    BatchNorm statistic within 1e-10 of max(1, its largest |value|)."""
    assert abs(got["loss"] - want["loss"]) <= 1e-10 * abs(want["loss"]), (
        got["loss"], want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    top = max(w.abs().max().item() for w in want["grads"].values())
    for name, w in want["grads"].items():
        assert w.dtype == torch.float64, name
        err = (got["grads"][name] - w).abs().max().item()
        assert err <= max(1e-10 * w.abs().max().item(), 1e-14 * top), ("grad", name, err, top)
    assert len(got["stats"]) == len(want["stats"])
    for name, w in want["stats"].items():
        err = (got["stats"][name] - w).abs().max().item()
        assert err <= 1e-10 * max(1.0, w.abs().max().item()), (name, err)


# ----------------------------------------------------------------- jobs

def job_mesh22(rank, out):
    """(2, 2): one step (test (a), (b)); the checkpoint both ways (f); two
    steps with the dropouts on (e)."""
    from deepfake_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from deepfake_tpu_torch.train.trainer import Trainer

    s = torch.load(os.path.join(out, "setup.pt"), weights_only=False)
    cfg = config(s["overrides"])
    x, y = s["x"], s["y"]
    t, mesh = mesh_step(cfg, s.pop("start"), x, y, 2, 2, "mesh22", out)
    t.save_ckpt(0)  # cfg.log.ckpt_dir: whole tensors, written by rank 0
    del t
    # a single-device checkpoint onto the (2, 2) mesh (over the seeded weights)
    t = Trainer(port_model(cfg, {}), cfg, Batches(x, y), logger=lambda line: None,
                device="cpu", mesh=make_mesh(2, 2))
    t.load_ckpt(s["single_ckpt"])
    loaded = whole(dict(t.model.named_parameters()), t.mesh)
    moments = whole(dict(zip((n for n, _ in t.model.named_parameters()), t.optimizer.bufs)),
                    t.mesh)
    if rank == 0:
        torch.save({"params": loaded, "momentum": moments, "step": t.step},
                   os.path.join(out, "loaded22.pt"))
    del t, loaded, moments
    # the dropouts on: two steps, then every rank's parameters
    cfg_d = config(dict(s["overrides"], **{"model.classify_drop": 0.1, "model.swin_drop": 0.1}))
    td = Trainer(port_model(cfg_d, {}, dropout=True), cfg_d, Batches(x, y),
                 logger=lambda line: None, device="cpu", mesh=make_mesh(2, 2))
    for _ in range(2):
        td.train_step(*shard_batch(x, y, td.mesh, cfg_d.optim.accum_step))
    every = digests(td.model, td.mesh)
    if rank == 0:
        torch.save(every, os.path.join(out, "dropout22.pt"))


def job_mesh2(rank, out):
    """At two ranks: (2, 1) and (1, 2), one step each (test (a)); (1, 2)
    with activation checkpointing (``parallel.remat``, policy "dots": the
    recompute runs the split layers' collectives again); (2, 1)
    with the alignment loss (c); Predictor and SubmitCtl at data 2 (g), and
    the Predictor's refusal of inference-time dropout there; the
    data module's loaders at data 2 (``loaders``); the float64 witness of
    the (2, 1) steps (``witness``)."""
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.parallel.mesh import make_mesh
    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.submit import SubmitCtl

    s = torch.load(os.path.join(out, "setup.pt"), weights_only=False)
    cfg = config(s["overrides"])
    x, y = s["x"], s["y"]
    remat = config(dict(s["overrides"], **{"parallel.remat": True,
                                           "parallel.remat_policy": "dots"}))
    for c, data, model, tag in ((cfg, 2, 1, "mesh21"), (cfg, 1, 2, "mesh12"),
                                (remat, 1, 2, "remat12"), (config(ALIGN), 2, 1, "align21")):
        # the conditioned seeded weights, built by each rank; the Trainer
        # is freed at once
        mesh_step(c, "conditioned", x, y, data, model, tag, out)
    # evaluation at data 2 on a ragged batch of 5
    from deepfake_tpu_torch.parallel.mesh import shard_eval_batch
    from deepfake_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(2, 1)
    t = Trainer(port_model(cfg, "conditioned"), cfg, Batches(x, y), logger=lambda line: None,
                device="cpu", mesh=mesh)
    metrics = t.eval([shard_eval_batch(*s["eval"], mesh)])
    del t
    # serving at data 2: the same ragged batch through predict, and SubmitCtl
    scfg = config(s["serve"])
    pred = Predictor(scfg, device="cpu", mesh=mesh)  # the seeded weights
    scores = pred.predict(s["serve_x"])
    dm = DeepFakeDataModule(scfg, prediction_csv=s["csv"], device="cpu", mesh=mesh).setup("test")
    result = SubmitCtl(pred, scfg, dm, logger=lambda line: None, prediction_csv=s["csv"]).submit()
    del pred, dm
    try:  # one device's inference-dropout masks are not per-rank draws
        Predictor(config(dict(s["serve"], **{"model.parity_inference_dropout": True})),
                  device="cpu", mesh=mesh)
        dropout = None
    except ValueError as e:
        dropout = str(e)
    res = {"scores": scores, "result": result, "eval": metrics, "int8": int8_scores(s, mesh),
           "inference_dropout": dropout, "loaders": loaders(rank, s["loader"], mesh, out)}
    release()
    res["witness"] = witness(rank, s["x"], s["y"], mesh)
    torch.save(res, os.path.join(out, f"serve{rank}.pt"))


INT8 = ("int8", "int8_static")


def int8_scores(s, mesh=None):
    """Serving's (scores, logits) at ``model.irv2_quant`` int8 and
    int8_static (every IRv2 conv int8: K1 off), on the ragged batch
    ``s["int8_x"]``, for the fused model and the video model (its frames
    alone); static after Predictor.calibrate on ``s["serve_x"]``. Under a
    data-2 mesh each rank runs its rows, the per-tensor max taken over
    both."""
    from deepfake_tpu_torch.serving import Predictor

    got = {}
    for modality in ("fused", "video"):
        pick = (lambda x: x) if modality == "fused" else (lambda x: x[0])
        for quant in INT8:
            cfg = config(dict(s["serve"], **{"data.modality": modality, "model.irv2_quant": quant,
                                             "model.irv2_fused_blocks": False}))
            pred = Predictor(cfg, device="cpu", mesh=mesh)
            if quant == "int8_static":
                assert pred.calibrate([pick(s["serve_x"])]) == 244
            x = pick(s["int8_x"])
            got[modality, quant] = (pred.predict(x), pred.forward(x, return_logits=True).numpy())
            del pred
    return got


def loaders(rank, overrides, mesh, out):
    """The data module's loaders built with the (2, 1) mesh on the synthetic
    set: at batch 2 x 2 an evaluation over the val loader (its ragged last
    batch padded), then one step from the train loader's one yield (this
    data rank's slice of each micro-batch, augmented, waves padded to the
    largest bucket), saved whole by rank 0 as ``loader21``; at batch 3,
    which the data axis does not divide (a training batch would be
    replicated), an evaluation over the val loader. Returns the two
    evaluations' metrics."""
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.data.pipeline import ModelFeedLoader
    from deepfake_tpu_torch.train.trainer import Trainer

    got = {}
    for tag, over in (("eval", overrides), ("odd_eval", dict(overrides, **ODD_BATCH))):
        cfg = config(over)
        dm = DeepFakeDataModule(cfg, device="cpu", mesh=mesh).setup("fit")
        feed = lambda raw, train: ModelFeedLoader(raw, cfg, train, device="cpu", mesh=mesh)
        t = Trainer(port_model(cfg, "conditioned"), cfg, Batches(None, None),
                    logger=lambda line: None, device="cpu", mesh=mesh)
        got[tag] = t.eval(feed(dm.val_dataloader(), False))
        if tag == "eval":
            ((x, y),) = list(feed(dm.train_dataloader(), True))
            loss, grads = one_step(t, x, y)
            res = {"loss": loss, "grads": whole(grads, mesh),
                   "params": whole(dict(t.model.named_parameters()), mesh),
                   "stats": stats(t.model)}
            if rank == 0:
                torch.save(res, os.path.join(out, "loader21.pt"))
            del res, grads
        del t
    return got


def witness(rank, x, y, mesh):
    """In float64, with the seeded weights and no conditioning: the (2, 1)
    step, plain and with the alignment loss at the preset's temperature,
    against one device's; rank 0 checks the plain step, rank 1 the other,
    one rank after the other (a float64 Trainer of the small fused model
    holds ~3 GB). Returns (the single-device loss, check_float64's
    verdict)."""
    from deepfake_tpu_torch.parallel.mesh import shard_batch
    from deepfake_tpu_torch.train.trainer import Trainer

    over = (TRAIN, ALIGN_PRESET)[rank]
    with float64():
        mine = None
        for o in (TRAIN, ALIGN_PRESET):
            cfg = config(o)
            t = Trainer(port_model(cfg, {}), cfg, Batches(x, y), logger=lambda line: None,
                        device="cpu", mesh=mesh)
            loss, grads = one_step(t, *shard_batch(x, y, mesh, cfg.optim.accum_step))
            if o is over:
                mine = {"loss": loss, "grads": grads, "stats": stats(t.model)}
            del t, grads
            release()
        for turn in range(mesh.world):
            if turn == rank:
                want = single_step(config(over), {}, x, y)[0]
                res = want["loss"], verdict(check_float64, mine, want)
                del want, mine
                release()
            dist.barrier()
        return res


def _entry(rank, world, port, job, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        globals()[job](rank, out)
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, out: str):
    """``job`` (a function of this module) started on ``world`` gloo ranks;
    returns a function that waits for them and raises where a rank failed."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(_entry, args=(world, free_port(), job, out), nprocs=world, join=False)

    def wait():
        while not ctx.join():
            pass

    return wait


def batch(seed: int = 60):
    """4 fused clips as numpy (frames, mel images, 1 s waves with valid
    lengths whose longest differs between the micro-batches and between the
    data ranks' rows), labels."""
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((4, 2, 96, 96, 3)).astype(np.float32)
    audio = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    wave = rng.standard_normal((4, 16000)).astype(np.float32)
    lengths = np.asarray([16000, 12000, 9000, 11000], np.int64)
    return (video, audio, (wave, lengths)), np.asarray([0.0, 1.0, 1.0, 0.0], np.float32)


# ------------------------------------------------------ the single device

def single_step(cfg, start, x, y, threads: int = 1):
    """The same step without a group: the loss, gradients, weights after
    the step and BatchNorm statistics (as ``mesh_step`` saves them), and the
    Trainer."""
    from deepfake_tpu_torch.train.trainer import Trainer

    t = Trainer(port_model(cfg, start), cfg, Batches(x, y), logger=lambda line: None,
                device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        loss, grads = one_step(t, x, y)
    finally:
        torch.set_num_threads(n)
    return {"loss": loss, "grads": grads,
            "params": {k: p.detach().clone() for k, p in t.model.named_parameters()},
            "stats": stats(t.model)}, t


SPREAD = 4.0  # the multiple of the port's own spread a quantity may differ by


def _quantities(run):
    yield ("loss",), run["loss"]
    for part in ("grads", "params", "stats"):
        for name, t in run[part].items():
            yield (part, name), t


def reference(cfg, start, x, y):
    """The single-device step (``single_step``) and its spread: for each
    quantity, the largest difference from it of a run that differs by
    rounding alone: frames perturbed at 1e-5 relative and two torch threads
    (tests/torch_fused_train_helpers.py), and the rows of each micro-batch
    in reverse order (every batched sum in another order, as a mesh's split
    of a micro-batch gives). Each run is reduced to its differences as it
    ends, so one run at a time is held."""
    base = single_step(cfg, start, x, y)[0]
    noise = np.random.default_rng(62).standard_normal(x[0].shape).astype(np.float32)
    xp = (x[0] * (1 + 1e-5 * noise),) + tuple(x[1:])
    bs = len(y) // cfg.optim.accum_step
    rev = [i * bs + j for i in range(cfg.optim.accum_step) for j in reversed(range(bs))]
    flip = lambda t: tuple(flip(e) for e in t) if isinstance(t, tuple) else t[rev]
    spread = {}
    for args, threads in (((xp, y), 1), ((x, y), 2), ((flip(x), y[rev]), 1)):
        other = single_step(cfg, start, *args, threads=threads)[0]
        for (key, a), (_, b) in zip(_quantities(base), _quantities(other)):
            d = float((a - b).abs().max()) if torch.is_tensor(a) else abs(a - b)
            spread[key] = max(spread.get(key, 0.0), d)
        del other
        release()
    return base, spread


def check_step(got, want, spread, start_params):
    """``got`` against ``want``: the loss within 1e-5 relative, every
    gradient and every parameter's update within 1e-4 of the largest
    |gradient| / |update| of that parameter, every BatchNorm statistic
    within 1e-5 of max(1, its largest |value|); each, where larger, within
    SPREAD x its spread (``reference``)."""
    sp = spread["loss",]
    assert abs(got["loss"] - want["loss"]) <= max(1e-5 * abs(want["loss"]), SPREAD * sp), (
        got["loss"], want["loss"], sp)
    assert set(got["params"]) == set(want["params"])
    for name, w in want["grads"].items():
        big = w.abs().max().item()
        err = (got["grads"][name] - w).abs().max().item()
        sp = spread["grads", name]
        assert err <= max(1e-4 * big, SPREAD * sp), ("grad", name, err, big, sp)
    for name, p in want["params"].items():
        upd, want_upd = got["params"][name] - start_params[name], p - start_params[name]
        big = want_upd.abs().max().item()
        assert big > 0, name
        err = (upd - want_upd).abs().max().item()
        sp = spread["params", name]
        assert err <= max(1e-4 * big, SPREAD * sp), ("update", name, err, big, sp)
    assert "norm.running_var" in want["stats"] and len(got["stats"]) == len(want["stats"])
    for name, w in want["stats"].items():
        err = (got["stats"][name] - w).abs().max().item()
        sp = spread["stats", name]
        assert err <= max(1e-5 * max(1.0, w.abs().max().item()), SPREAD * sp), (name, err, sp)


def verdict(check, *args):
    """None where ``check(*args)`` passes, else its AssertionError's text."""
    try:
        check(*args)
    except AssertionError as e:
        return f"{type(e).__name__}: {e}"
    return None


def release() -> None:
    """Hands the memory of the freed model copies back to the system: the
    test worker that ran a mesh file goes on to run other files."""
    import ctypes
    import gc

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: the memory stays with the process
        pass


def take(path):
    """A rank's result file, loaded and removed (they are hundreds of MB)."""
    res = torch.load(path, weights_only=False)
    os.remove(path)
    return res


def condition(model, shift: float = 3.0):
    """``model`` in place: every IRv2 BatchNorm bias + ``shift`` (each ReLU
    after one sits off its kink; tests/torch_fused_train_helpers.py), and
    CONDITION's shifts."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p += CONDITION.get(name, shift if _irv2_bn_bias(name) else 0.0)
    return model


def _irv2_bn_bias(name: str) -> bool:
    return name.startswith("video_extractor.inception.") and name.endswith(".bn.bias")


# Kinks the f32 comparison keeps off, besides IRv2's BatchNorm biases + 3
# (tests/torch_fused_train_helpers.py): NeXtVLAD's L1 normalisation takes
# |vlad| of residuals x_dot - cluster_weights2 that sit near zero, and the
# gating's ReLU reads a BatchNorm over one channel. A rounding-level change
# of the features (a mesh's other summation order) flips the sign of one
# such value and moves a gradient by percents: measured on the (2, 1) mesh,
# cluster_weights2's gradient by 2% in f32. In float64, with nothing
# conditioned, the (2, 1) step equals one device's (``witness``,
# check_float64).
CONDITION = {"video_extractor.video_nextvlad.cluster_weights2": -4.0,
             "video_extractor.bn0.bias": 3.0}

