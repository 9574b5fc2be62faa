"""The port's ``video_swin`` training path against the JAX package's, on the
CPU: a Swin3D block's gradients, two optimizer steps of the Trainer, and the
pieces around them (DropPath, the cosine schedule and SGD, the entry points
that refuse to run without a card).

The JAX side runs its training route through ``pallas_window_attention_nhc_train``
in interpret mode (``DEEPFAKE_TPU_PALLAS_INTERPRET=1``), with
``DEEPFAKE_TPU_TRAIN_PROFIT_STEPS=1`` so that the small shapes take it; the
port runs K5's plain forward and backward through its autograd Function.
Weights go across with load_jax_variables. All f32.
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_tpu_torch.io.jax_weights import load_jax_variables
from deepfake_tpu_torch.models.layers import DropPath

from tests.test_torch_swin3d import SMALL_VIDEO_SWIN
from tests.torch_port_helpers import SMALL_FUSED, both_configs, random_variables
from tests.torch_port_helpers import torch_on_one_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture
def jax_train_kernel(monkeypatch):
    """The JAX training route through the nhc_train Pallas kernel
    (swin3d.py:500-513) at the tests' small shapes."""
    monkeypatch.setenv("DEEPFAKE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DEEPFAKE_TPU_TRAIN_PROFIT_STEPS", "1")


def _spy_nhc_train(monkeypatch):
    """Count the calls of the JAX training kernel."""
    from deepfake_tpu.ops import pallas_window_attn as P

    calls = [0]
    fn = P.pallas_window_attention_nhc_train

    def spy(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(P, "pallas_window_attention_nhc_train", spy)
    return calls


def _assert_grads_close(tmodel, grads, tol: float):
    """Every parameter gradient of ``tmodel`` against the JAX gradient tree
    (carried into the port's layout by load_jax_variables): max |diff| <=
    tol * max |JAX grad|."""
    ref = copy.deepcopy(tmodel)
    load_jax_variables(ref, {"params": jax.device_get(grads)})
    want = dict(ref.named_parameters())
    n = 0
    for name, p in tmodel.named_parameters():
        g, w = p.grad, want[name].detach()
        big = w.abs().max().item()
        assert g is not None and big > 0, name
        err = (g - w).abs().max().item()
        assert err <= tol * big, (name, err, big)
        n += 1
    assert n == len(want)


@pytest.mark.parametrize("route,window", [("k5", (8, 7, 7)), ("plain", (8, 7, 7)),
                                          ("k5", (16, 7, 7))],
                         ids=["k5", "plain", "k5_window16x7x7"])
def test_swin_block3d_train_grads_match_jax(monkeypatch, jax_train_kernel, route, window):
    """One shifted SwinBlock3D in train mode (drop_path 0): every parameter
    gradient of mean(out^2) within 1e-4 of its largest |value| of the JAX
    block's, and the loss within 1e-5 relative. ``k5``: K5's plain versions
    against the JAX nhc_train kernel route (one call); ``plain``: the port's
    plain route against the JAX einsum route (after
    tests/test_pallas_kernels.py:270-299). ``k5_window16x7x7``: Video
    Swin-B's Something-Something v2 window (N = 784) on 16 temporal tokens,
    where the temporal shift clamps to 0."""
    from deepfake_tpu.models.swin3d import SwinBlock3D as J
    from deepfake_tpu_torch.models.swin3d import SwinBlock3D as T

    kernel = route == "k5"
    calls = _spy_nhc_train(monkeypatch)
    grid = (window[0], 14, 14)
    shift = (window[0] // 2, 3, 3)
    x = (0.5 * np.random.default_rng(40).standard_normal((1, *grid, 64))).astype(np.float32)
    jblock = J(dim=64, num_heads=2, window_size=window, shift_size=shift, drop_path=0.0,
               use_pallas=kernel)
    variables = random_variables(jblock, jnp.asarray(x), seed=41, deterministic=True)

    def loss(p):
        out = jblock.apply({"params": p}, jnp.asarray(x), False,
                           rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.mean(out ** 2)

    want_loss, grads = jax.value_and_grad(loss)(variables["params"])
    assert calls[0] == (1 if kernel else 0)
    if window[0] == 16:
        # the loss of the JAX block's output averaged in f64: XLA's f32 mean
        # on the CPU drifts by ~2e-5 of it over the 16-frame input's 200k values
        out = jblock.apply({"params": variables["params"]}, jnp.asarray(x), False,
                           rngs={"dropout": jax.random.PRNGKey(2)})
        want_loss = np.mean(np.asarray(out, np.float64) ** 2)

    tblock = T(64, grid, 2, window, shift, kernels=kernel).train()
    assert tblock.ws == window and tblock.ss == (0, 3, 3)  # the temporal shift clamps
    load_jax_variables(tblock, variables)
    got_loss = (tblock(torch.from_numpy(x)) ** 2).mean()
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    _assert_grads_close(tblock, grads, 1e-4)


class _Batches:
    """One loader yield per epoch: ``x`` clips and ``y`` labels."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def train_loader(self):
        return [(self.x, self.y)]

    def val_loader(self):
        return [(self.x, self.y)]


def test_trainer_two_steps_match_jax_trainer(monkeypatch, jax_train_kernel):
    """Two optimizer steps of the port's Trainer against the JAX Trainer on
    the small video_swin geometry (N = 392 at stage 0), batch 2 x accum 2,
    f32, drop rates 0, lr 0.1 and t_max 3 (the cosine and the momentum both
    act), the port's Trainer built compiled (its default, eager on the CPU),
    from the same weights (random, with the JAX tree's shapes, set into
    the JAX trainer's state and carried across with load_jax_variables): the
    losses within 1e-5 relative, and every parameter's update (new - old)
    within 1e-4 of its largest |update|. The JAX step runs its nhc_train
    kernel in every block; the port's runs K5's plain versions."""
    from deepfake_tpu.models.registry import build_model as jbuild
    from deepfake_tpu.parallel.mesh import make_mesh
    from deepfake_tpu.train.trainer import Trainer as JTrainer
    from deepfake_tpu.utils.logging import Logger as JLogger
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.trainer import Trainer

    calls = _spy_nhc_train(monkeypatch)
    jcfg, tcfg = both_configs(dict(SMALL_VIDEO_SWIN, **{
        "model.swin3d_drop_path": 0.0, "model.classify_drop": 0.0, "optim.batch_size": 2,
        "optim.accum_step": 2, "optim.learning_rate": 0.1, "optim.epochs": 3}))
    rng = np.random.default_rng(42)
    x = rng.standard_normal((4, 16, 56, 56, 3)).astype(np.float32)
    y = np.asarray([0.0, 1.0, 1.0, 0.0], np.float32)
    data = _Batches(x, y)

    jmodel = jbuild(jcfg)
    jt = JTrainer(jmodel, jcfg, data, logger=JLogger(None),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    assert jt.t_max == 3
    params0 = random_variables(jmodel, jnp.asarray(x[:1]), seed=43, deterministic=True)["params"]
    jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, params0))
    want = []
    for i in range(2):
        inputs, labels = jt._put_batch(x, y)
        jt.state, metrics = jt._train_step(jt.state, inputs, labels, jax.random.PRNGKey(i))
        want.append(float(metrics["loss"]))
    params2 = jax.device_get(jt.state.params)
    assert calls[0] > 0

    def port_model(params):
        m = build_model(tcfg, "cpu", train=True)
        return load_jax_variables(m, {"params": params})

    # compiled=True (the default) is the eager route on the CPU
    tt = Trainer(port_model(params0), tcfg, data, logger=lambda line: None, device="cpu",
                 compiled=True)
    assert tt.t_max == 3 and tt.graphs is None
    got = [float(tt.train_step(x, y)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)

    old = dict(port_model(params0).named_parameters())
    ref = dict(port_model(params2).named_parameters())
    for name, p in tt.model.named_parameters():
        upd, want_upd = (p - old[name]).detach(), (ref[name] - old[name]).detach()
        big = want_upd.abs().max().item()
        assert big > 0, name
        assert (upd - want_upd).abs().max().item() <= 1e-4 * big, name


def test_trainer_eval_and_train_loop_run():
    """The Trainer's eval (per-sample loss, accuracy, AUC) and its epoch
    loop with log lines run on the CPU."""
    from deepfake_tpu_torch.train.trainer import Trainer

    _, tcfg = both_configs(dict(SMALL_VIDEO_SWIN, **{
        "optim.batch_size": 2, "optim.accum_step": 1, "optim.epochs": 0, "log.log_step": 1}))
    rng = np.random.default_rng(44)
    x = rng.standard_normal((2, 16, 56, 56, 3)).astype(np.float32)
    y = np.asarray([0.0, 1.0], np.float32)
    lines = []
    tt = Trainer(None, tcfg, _Batches(x, y), logger=lines.append, device="cpu")
    res = tt.eval([(x, y)])
    assert np.isfinite(res["loss"]) and res["acc"] in (0.0, 0.5, 1.0) and res["auc"] in (0.0, 1.0)
    tt.train()
    assert tt.step == 1 and tt.model.training
    assert any("Train Loss Avg" in s for s in lines) and any("AUC" in s for s in lines)


def test_drop_path_draws_one_mask_per_sample():
    """DropPath keeps or drops whole samples with probability 1 - rate,
    scales the kept ones by 1 / (1 - rate), draws from its generator, and
    is the identity in eval mode."""
    rate = 0.25
    dp = DropPath(rate, torch.Generator().manual_seed(0)).train()
    x = torch.ones(4000, 3, 5)
    y = dp(x)
    per_sample = y.reshape(4000, -1)
    kept = per_sample[:, 0] != 0
    assert torch.all(per_sample == per_sample[:, :1])  # one draw per sample
    assert torch.allclose(per_sample[kept], torch.full_like(per_sample[kept], 1 / (1 - rate)))
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.03
    again = DropPath(rate, torch.Generator().manual_seed(0)).train()(x)
    assert torch.equal(again, y)
    assert dp.eval()(x) is x
    with pytest.raises(RuntimeError, match="generator"):
        DropPath(rate).train()(x)


def test_cosine_schedule_and_sgd_two_steps():
    """cosine_annealing holds at eta_min past t_max; SGD with momentum and
    coupled weight decay (schedule.SGD, its rate a device scalar), at lr(0)
    then lr(1), against the update computed by hand: d = g + wd * p; buf =
    d, then m * buf + d; p -= lr * buf."""
    from deepfake_tpu_torch.train.schedule import SGD, cosine_annealing

    lr0, t_max, m, wd = 0.1, 3, 0.9, 0.05
    sched = cosine_annealing(lr0, t_max)
    assert sched(0) == lr0 and abs(sched(3)) < 1e-12 and sched(7) == sched(3)
    assert abs(sched(1) - lr0 * 0.5 * (1 + math.cos(math.pi / 3))) < 1e-12
    p0 = np.asarray([1.0, -2.0, 0.5])
    gs = [np.asarray([0.3, 0.1, -0.2]), np.asarray([-0.4, 0.2, 0.6])]
    w = torch.nn.Parameter(torch.tensor(p0, dtype=torch.float64))
    opt = SGD([w], m, wd)
    p, buf = p0.copy(), None
    for t, g in enumerate(gs):
        opt.set_lr(sched(t))
        opt.step([torch.tensor(g)])
        d = g + wd * p
        buf = d if buf is None else m * buf + d
        p = p - sched(t) * buf
        np.testing.assert_allclose(w.detach().numpy(), p, rtol=1e-12)


@pytest.mark.parametrize("clip", [None, 0.5], ids=["no_clip", "clip"])
def test_foreach_sgd_matches_torch_sgd_and_optax(clip):
    """schedule.SGD (foreach ops, the rate a device scalar, momentum
    buffers from zero) over three cosine steps on f32 tensors of several
    shapes, with the global-norm clip or without: within 1e-6 of the largest
    |parameter| of torch.optim.SGD(momentum, weight_decay) and of the JAX
    package's optax chain (clip -> add_decayed_weights -> sgd(momentum))."""
    import optax
    from deepfake_tpu.train.schedule import make_optimizer as jmake
    from deepfake_tpu_torch.train.schedule import SGD, clip_by_global_norm, cosine_annealing

    lr0, t_max, m, wd = 0.1, 4, 0.9, 0.05
    sched = cosine_annealing(lr0, t_max)
    rng = np.random.default_rng(47)
    shapes = [(3, 5), (7,), (2, 2, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    ours = [torch.tensor(p) for p in p0]
    opt = SGD([torch.nn.Parameter(p) for p in ours], m, wd)
    ref = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    topt = torch.optim.SGD(ref, lr=lr0, momentum=m, weight_decay=wd)
    tx = jmake(lr0, t_max, m, wd, grad_clip=clip)
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    for t, g in enumerate(gs):
        grads = [torch.tensor(x) for x in g]
        clip_by_global_norm(grads, clip)
        opt.set_lr(sched(t))
        opt.step(grads)
        for w, gr in zip(ref, grads):
            w.grad = gr.clone()
        for group in topt.param_groups:
            group["lr"] = sched(t)
        topt.step()
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
    for a, b, c in zip(opt.params, ref, jp):
        tol = 1e-6 * max(1.0, float(np.abs(np.asarray(c)).max()))
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(c), rtol=0, atol=tol)


def test_trainer_chained_steps_equal_single_steps():
    """chained_train_steps(2) on the CPU (eager) equals two train_step calls
    on the same batch from the same Trainer state: the same weights, step
    count and last loss, bit for bit; DropPath active, so the dropout
    stream advances alike on both routes."""
    from deepfake_tpu_torch.train.trainer import Trainer

    _, tcfg = both_configs(dict(SMALL_VIDEO_SWIN, **{
        "optim.batch_size": 1, "optim.accum_step": 2, "model.swin3d_drop_path": 0.5}))
    rng = np.random.default_rng(48)
    x = rng.standard_normal((2, 16, 56, 56, 3)).astype(np.float32)
    y = np.asarray([0.0, 1.0], np.float32)
    a = Trainer(None, tcfg, _Batches(x, y), logger=lambda line: None, device="cpu")
    b = Trainer(None, tcfg, _Batches(x, y), logger=lambda line: None, device="cpu")
    last = [a.train_step(x, y)["loss"] for _ in range(2)][-1]
    got = b.chained_train_steps(2)(x, y)
    assert a.step == b.step == 2 and got.dtype == torch.float32
    assert torch.equal(got, last.float())
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name


def test_bce_with_logits_matches_jax():
    from deepfake_tpu.train.losses import bce_with_logits as jbce
    from deepfake_tpu_torch.train.losses import bce_with_logits

    rng = np.random.default_rng(45)
    logits = (3 * rng.standard_normal(16)).astype(np.float32)
    labels = (rng.random(16) > 0.5).astype(np.float32)
    got = bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, float(jbce(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)


def test_roc_auc_matches_jax():
    from deepfake_tpu.utils.metrics import roc_auc as jauc
    from deepfake_tpu_torch.utils.metrics import roc_auc

    rng = np.random.default_rng(46)
    s = np.round(rng.random(50), 1)  # ties
    lab = (rng.random(50) > 0.4).astype(np.float32)
    assert roc_auc(s, lab) == pytest.approx(jauc(s, lab), abs=1e-12)
    assert math.isnan(roc_auc(s, np.ones(50)))


def test_trainer_without_cuda_raises_unless_cpu_asked(monkeypatch):
    from deepfake_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = both_configs(SMALL_VIDEO_SWIN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(None, tcfg, _Batches(None, None))


def test_build_model_train_mode():
    """build_model(train=True): train mode, f32 parameters, the drop rates
    of the config (linspace(0, drop_path, blocks)), seeded dropout; the
    other modalities build in train mode too (tests/test_torch_fused_modules.py)."""
    from deepfake_tpu_torch.models.registry import build_model

    _, tcfg = both_configs(dict(SMALL_VIDEO_SWIN, **{"model.swin3d_drop_path": 0.3,
                                                     "parallel.compute_dtype": "bfloat16"}))
    m = build_model(tcfg, "cpu", train=True)
    assert m.training and all(p.dtype == torch.float32 for p in m.parameters())
    rates = [b.drop_path.rate for b in m.videoSwinT.modules() if hasattr(b, "drop_path")]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 4))
    assert m.classifier.mlp.drop.rate == tcfg.model.classify_drop
    assert m.classifier.mlp.drop.generator is not None
    assert build_model(both_configs(SMALL_FUSED)[1], "cpu", train=True).training


def test_kernels_without_backward_raise_under_autograd():
    """K4's and K3's wrappers refuse an input that requires grad while
    autograd records (they have no backward); under no_grad they run."""
    from deepfake_tpu_torch.ops.ln_linear_kernel import ln_linear
    from deepfake_tpu_torch.ops.window_attn3d_kernel import window_attn3d_tokens

    x, w = torch.ones(3, 16, requires_grad=True), torch.ones(8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ln_linear(x, w)
    q = torch.zeros(1, 392, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        window_attn3d_tokens(q, q, q, num_heads=1, bias=torch.zeros(1, 392, 392), scale=0.2)
    with torch.no_grad():
        assert ln_linear(x, w).shape == (3, 8)


def test_k5_rejects_what_it_does_not_take():
    """K5's checks raise before any launch: a head dim outside 1-128, a mask
    that does not tile the windows, a type it does not take; a model in
    train mode refuses an inference bias cache. A window of N = 784
    ((16,7,7)) and head dims 1 to 128 pass them (K5 takes any N and every
    such head dim)."""
    from deepfake_tpu_torch.models.swin3d import WindowAttention3D
    from deepfake_tpu_torch.ops.window_attn3d_train import _check

    assert _check(torch.zeros(4, 784, 96), 1, torch.zeros(1, 784, 784),
                  torch.zeros(4, 784, 784))[:4] == (4, 784, 32, 32)
    for d in (1, 4, 8, 12, 20, 36, 64, 128):
        assert _check(torch.zeros(1, 392, 3 * d), 1, torch.zeros(1, 392, 392), None)[3] == d
    for d in (129, 136):
        with pytest.raises(ValueError, match="head dims 1 to 128"):
            _check(torch.zeros(1, 392, 3 * d), 1, torch.zeros(1, 392, 392), None)
    with pytest.raises(ValueError, match="does not tile 3 windows"):
        _check(torch.zeros(3, 392, 96), 1, torch.zeros(1, 392, 392), torch.zeros(2, 392, 392))
    with pytest.raises(ValueError, match="f32 or bf16"):
        _check(torch.zeros(1, 392, 96, dtype=torch.float16), 1, torch.zeros(1, 392, 392), None)
    attn = WindowAttention3D(32, (8, 7, 7), 1, (8, 7, 7), kernels=True)
    attn.precompute_bias()
    with pytest.raises(RuntimeError, match="inference cache"):
        attn.train()(torch.zeros(1, 392, 32))


@pytest.mark.parametrize("B_,H,N,n_masks,masked", [
    (1024, 3, 392, 128, True), (1024, 3, 392, 128, False), (128, 3, 392, 128, True),
    (24, 12, 392, 8, True), (1021, 3, 392, 1, False), (16, 24, 392, 8, True),
    (8, 2, 196, 4, True), (3, 1, 512, 1, False),
    (256, 6, 392, 32, True), (64, 12, 392, 8, True), (64, 12, 392, 8, False),
    (128, 3, 392, 128, False), (32, 6, 392, 32, True), (8, 12, 392, 8, True),
    (2, 24, 392, 2, True), (8, 2, 98, 4, True)],
    ids=["stage0_shifted", "stage0", "b1_stage0_shifted", "b3_stage2_shifted", "ungrouped_1021",
         "stage3_shifted", "clamped_196", "n512",
         "stage1_shifted", "stage2_shifted", "stage2", "b1_stage0", "b1_stage1_shifted",
         "b1_stage2_shifted", "b1_stage3_shifted", "clamped_98"])
def test_k5_window_groups_cover_every_window_once(B_, H, N, n_masks, masked):
    """The bf16 schedule of K5's forward and of both backward launches:
    every (window, head, 64-row tile) falls in exactly one block, a block
    takes at most G windows, and a masked block only windows that read one
    mask index (w % n_masks), so they can share its bias + mask tile."""
    from collections import Counter

    from deepfake_tpu_torch.ops.window_attn3d_train import block_windows, window_group

    g = window_group(B_, H, N, n_masks, masked, 132)
    blocks = block_windows(B_, H, N, n_masks, masked, g)
    seen = Counter((w, h, tile) for h, tile, ws in blocks for w in ws)
    tiles = -(-N // 64)
    assert set(seen) == {(w, h, t) for w in range(B_) for h in range(H) for t in range(tiles)}
    assert max(seen.values()) == 1
    assert all(0 < len(ws) <= g for _, _, ws in blocks)
    if masked:
        assert all(len({w % n_masks for w in ws}) == 1 for _, _, ws in blocks)
    if B_ == 1021:  # a prime: the last block of the group takes fewer windows
        assert g > 1 and B_ % g
