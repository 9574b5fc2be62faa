"""The comparison of the port's fused training step with the JAX package's,
shared by tests/test_torch_fused_train.py and tests/test_torch_fused_train_plain.py.

Two optimizer steps of the port's ``Trainer`` and of the JAX ``Trainer`` on
the small fused geometry (``SMALL_FUSED``: IRv2 at 96^2 x 2 frames, SwinV2
embed 16 at 56^2 with window 7, a 2-layer wav2vec2, the fusion head), f32,
micro-batch 2 x accumulation 2, every drop rate 0, lr 0.1 and t_max 3, from
the same random weights and BatchNorm statistics (random, with the JAX
tree's shapes, carried across with load_jax_variables). The JAX fused model
hard-codes rates the config does not reach (SwinV2's DropPath, wav2vec2's
dropouts, LayerDrop and SpecAugment), so it is built by hand with them at
zero, and the port's Dropout-like modules are set to zero to match; the
JAX ``Trainer`` takes a model, so no JAX file changes for that.

Routes: the port with ``swin2d_attn_kernel`` on (SwinV2 training through
K5's plain versions, its autograd Function) against the JAX model under
``DEEPFAKE_TPU_2D_TRAIN_KERNEL=1`` (``pallas_window_attention_nhc_train`` in
interpret mode); the same with ``optim.use_align_loss``; and both on their
plain routes (the max-stabilised einsum softmax), one file each, so that
the test workers share them. Each traces the JAX Trainer's own step
(``_train_step_impl``: the accumulation scan, the loss with the align
term, optax's update), since the route and the align loss are read while
tracing; the JAX Trainer's constructor is skipped (``_jax_trainer``).

Conditioning. IRv2 training at this size is chaotic: BatchNorm over 4 values
a channel in its 1x1 stage, and ReLU and max-pool switches, turn f32
rounding into visible gradient differences. Measured on the port alone, on
the CPU: frames that differ by 1e-6 relative move IRv2's gradients by up to
40% of their largest value, and its output by 2e-3. So the test (1) shifts
every IRv2 BatchNorm bias by +3, which keeps each ReLU after a BatchNorm off
its kink (the same random weights on both sides; the worst gradient
difference under that perturbation falls to ~2e-3); (2) runs flax's
BatchNorm with its two-pass variance: its default one-pass E[x^2] - E[x]^2
loses ~2e-4 of the largest output at IRv2's post-ReLU activations (mean /
std ~7.5; 16x the port's error against an f64 reference), the same function
computed less exactly; (3) holds each quantity to the larger of the stated
tolerance and 4x its spread: the largest difference between the port's run
and two runs of its own that differ from it by rounding alone, one on frames
perturbed at 1e-5 relative (the size of the difference the two packages' f32
rounding leaves after IRv2's stem, 5e-6 to 2.5e-5), one on two torch threads
instead of one (other summation orders throughout, as another package's are;
alone, it moves a BatchNorm statistic as far as the JAX package does). A
wrong formula moves a quantity by far more than that spread; rounding, in
two packages that sum in other orders, by less.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_tpu_torch.io.jax_weights import load_jax_variables
from deepfake_tpu_torch.models.layers import Dropout

from tests.torch_port_helpers import SMALL_FUSED, both_configs, random_variables

SPREAD = 4.0  # the multiple of the port's own spread a quantity may differ by

OVERRIDES = dict(SMALL_FUSED, **{
    "model.classify_drop": 0.0, "model.swin_drop": 0.0, "optim.batch_size": 2,
    "optim.accum_step": 2, "optim.learning_rate": 0.1, "optim.epochs": 3})


class _Batches:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def train_loader(self):
        return [(self.x, self.y)]

    def val_loader(self):
        return [(self.x, self.y)]


def _batch():
    """4 clips: frames, mel images, and 1 s waves with valid lengths (each
    micro-batch's longest differs)."""
    rng = np.random.default_rng(60)
    video = rng.standard_normal((4, 2, 96, 96, 3)).astype(np.float32)
    audio = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    wave = rng.standard_normal((4, 16000)).astype(np.float32)
    lengths = np.asarray([16000, 12000, 9000, 11000], np.int32)
    return (video, audio, (wave, lengths)), np.asarray([0.0, 1.0, 1.0, 0.0], np.float32)


def _jax_fused(jcfg):
    """The JAX fused model of FusionModel.from_config with every drop rate 0."""
    from deepfake_tpu.models.audio2d import Audio2D
    from deepfake_tpu.models.fusion import FusionModel
    from deepfake_tpu.models.nextvlad import InceptionVideoClassifier
    from deepfake_tpu.models.registry import wav_config
    from deepfake_tpu.models.swin2d import SwinTransformerV2

    m = jcfg.model
    wav = dataclasses.replace(
        wav_config(jcfg), feat_proj_dropout=0.0, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0)
    video = InceptionVideoClassifier(num_classes=m.num_classes, drop_rate=0.0, use_feat=True,
                                     bn_momentum=m.bn_momentum)
    audio = SwinTransformerV2(
        img_size=jcfg.data.audio_size, num_classes=m.num_classes, use_feat=True,
        embed_dim=m.swin2d_embed_dim, depths=tuple(m.swin2d_depths),
        num_heads=tuple(m.swin2d_heads), window_size=m.swin2d_window,
        pretrained_window_sizes=tuple(m.swin2d_pretrained_windows), drop_path_rate=0.0)
    paudio = Audio2D(num_classes=m.num_classes, use_feat=True, model_drop=0.0, wav_config=wav)
    return FusionModel(video_extractor=video, audio_extractor=audio, paudio_extractor=paudio,
                       out_dim=m.num_classes, soft=m.soft, classify_drop=0.0)


def _jax_trainer(jmodel, jcfg):
    """The JAX Trainer's step without its constructor: the constructor's
    model.init under jit takes a minute here and its state is replaced by
    the test's anyway. ``_train_step_impl`` reads model, cfg, accum,
    modality and tx, set as the constructor sets them (one loader yield a
    step, so t_max = epochs)."""
    from deepfake_tpu.train.schedule import make_optimizer
    from deepfake_tpu.train.trainer import Trainer as JTrainer

    o = jcfg.optim
    jt = JTrainer.__new__(JTrainer)
    jt.model, jt.cfg, jt.modality = jmodel, jcfg, jcfg.data.modality
    jt.accum = max(1, o.accum_step)
    jt.t_max = o.epochs
    jt.tx = make_optimizer(o.learning_rate, jt.t_max, o.momentum, o.weight_decay, o.grad_clip,
                           o.schedule)
    return jt


@pytest.fixture(scope="module")
def jax_side():
    """The JAX Trainer's step over the fused model, and the start: random
    params and BatchNorm statistics."""
    jcfg, _ = both_configs(OVERRIDES)
    x, y = _batch()
    jmodel = _jax_fused(jcfg)
    jt = _jax_trainer(jmodel, jcfg)
    one = (jnp.asarray(x[0][:1]), jnp.asarray(x[1][:1]), jnp.asarray(x[2][0][:1]))
    start = random_variables(jmodel, one, seed=61, train=False, deterministic=True)
    _shift_irv2_bn(start["params"]["video_extractor"]["inception"])
    return jt, start, x, y


def _shift_irv2_bn(tree, shift: float = 3.0):
    """Every IRv2 BatchNorm's bias + ``shift``: the ReLU after each sits
    far from its kink (see the module's note)."""
    for k, v in tree.items():
        if k == "bn":
            v["bias"] = v["bias"] + np.float32(shift)
        elif hasattr(v, "items"):
            _shift_irv2_bn(v, shift)


@pytest.fixture
def one_torch_thread():
    """torch on one thread for the test: the suite's workers share the cores,
    and the port's IRv2 of small tensors spends its time in OpenMP barriers
    waiting for threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def flax_two_pass_variance(monkeypatch):
    """flax's BatchNorm with its two-pass variance (see the module's note)."""
    import flax.linen.normalization as N

    one_pass = N._compute_stats
    monkeypatch.setattr(N, "_compute_stats",
                        lambda *a, **kw: one_pass(*a, **dict(kw, use_fast_variance=False)))


def _flat_stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def check_two_steps(monkeypatch, jax_side, route: str, align: bool) -> None:
    """Losses within 1e-5 relative; every parameter's update (new - old)
    within 1e-4 of its largest |update|; every BatchNorm running mean and
    variance (IRv2's, NeXtVLAD's and the fusion head's) within 1e-5 of
    max(1, its largest |value|); each, where larger, within SPREAD x its
    spread (the module's note). ``k5``: the port's SwinV2 blocks run K5's
    plain versions (counted) and the JAX blocks the nhc_train Pallas kernel
    (counted); ``plain``: neither runs."""
    from deepfake_tpu.ops import pallas_window_attn as P
    from deepfake_tpu.train.trainer import TrainState
    from deepfake_tpu_torch.models import swin2d
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.trainer import Trainer

    jt, start, x, y = jax_side
    kernel = route == "k5"
    monkeypatch.setenv("DEEPFAKE_TPU_PALLAS_INTERPRET", "1")
    if kernel:
        monkeypatch.setenv("DEEPFAKE_TPU_2D_TRAIN_KERNEL", "1")
    else:
        monkeypatch.delenv("DEEPFAKE_TPU_2D_TRAIN_KERNEL", raising=False)
    jcalls, tcalls = [0], [0]

    def counted(fn, calls):
        def spy(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return spy

    monkeypatch.setattr(P, "pallas_window_attention_nhc_train",
                        counted(P.pallas_window_attention_nhc_train, jcalls))
    monkeypatch.setattr(swin2d, "window_attn3d_train",
                        counted(swin2d.window_attn3d_train, tcalls))
    monkeypatch.setattr(jt.cfg.optim, "use_align_loss", align)

    # the JAX side: a step traced for this route, from the start state
    params0 = jax.tree.map(jnp.asarray, start["params"])
    stats0 = jax.tree.map(jnp.asarray, start["batch_stats"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params0, batch_stats=stats0,
                       opt_state=jt.tx.init(params0))
    step = jax.jit(jt._train_step_impl)
    want = []
    inputs, labels = jax.tree.map(jnp.asarray, (x, y))
    for i in range(2):
        state, metrics = step(state, inputs, labels, jax.random.PRNGKey(i))
        want.append(float(metrics["loss"]))
    end = {"params": jax.device_get(state.params),
           "batch_stats": jax.device_get(state.batch_stats)}
    assert (jcalls[0] > 0) == kernel

    _, tcfg = both_configs(dict(OVERRIDES, **{"model.swin2d_attn_kernel": kernel,
                                              "optim.use_align_loss": align}))

    def port_model(variables):
        m = build_model(tcfg, "cpu", train=True)
        for mod in m.modules():
            if isinstance(mod, Dropout):  # SwinV2's DropPath, wav2vec2's rates
                mod.rate = 0.0
        return load_jax_variables(m, variables)

    def port_steps(frames, threads: int = 1):
        xs = (frames,) + x[1:]
        tt = Trainer(port_model(start), tcfg, _Batches(xs, y), logger=lambda line: None,
                     device="cpu")
        torch.set_num_threads(threads)
        try:
            losses = [float(tt.train_step(xs, y)["loss"]) for _ in range(2)]
        finally:
            torch.set_num_threads(1)
        return losses, dict(tt.model.named_parameters()), _flat_stats(tt.model)

    got, params, stats = port_steps(x[0])
    assert (tcalls[0] > 0) == kernel
    # the port's own spread (the module's note)
    noise = np.random.default_rng(62).standard_normal(x[0].shape).astype(np.float32)
    others = [port_steps(x[0] * (1 + 1e-5 * noise)), port_steps(x[0], threads=2)]

    def spread(pick):
        """The largest difference of ``pick(run)`` between this run and the others."""
        a = pick((got, params, stats))
        return max(float((a - pick(o)).abs().max()) if torch.is_tensor(a) else abs(a - pick(o))
                   for o in others)

    for i, w in enumerate(want):
        sp = spread(lambda r: r[0][i])
        assert abs(got[i] - w) <= max(1e-5 * abs(w), SPREAD * sp), (got, want, sp)

    old = dict(port_model(start).named_parameters())
    ref_model = port_model(end)
    ref = dict(ref_model.named_parameters())
    for name, p in params.items():
        upd, want_upd = (p - old[name]).detach(), (ref[name] - old[name]).detach()
        big = want_upd.abs().max().item()
        assert big > 0, name
        sp = spread(lambda r: r[1][name])
        err = (upd - want_upd).abs().max().item()
        assert err <= max(1e-4 * big, SPREAD * sp), (name, err, big, sp)
    want_stats = _flat_stats(ref_model)
    assert len(stats) == len(want_stats) > 0
    assert "norm.running_var" in stats  # the fusion head's
    for name, w in want_stats.items():
        sp = spread(lambda r: r[2][name])
        err = (stats[name] - w).abs().max().item()
        assert err <= max(1e-5 * max(1.0, w.abs().max().item()), SPREAD * sp), (name, err, sp)
