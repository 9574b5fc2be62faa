"""The pieces of the port's fused training path against the JAX package's,
on the CPU: SwinV2 training through K5's plain versions (a block's
gradients, and K5 at SwinV2's 49-token windows), BatchNorm's batch
statistics, wav2vec2's SpecAugment, LayerDrop and dropouts, InfoNCE and
VAModel, the Trainer's nested micro-batches, the train-mode models of every
modality, IRv2 training on convolutions, and the training CLI. The JAX side
runs its Pallas kernels in interpret mode; all f32.
tests/test_torch_fused_train.py holds two whole Trainer steps.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_tpu_torch.io.jax_weights import load_jax_variables
from deepfake_tpu_torch.models.layers import BatchNorm, Dropout, DropPath
from deepfake_tpu_torch.models.wav2vec2 import LayerDrop, SpecAugment

from tests.test_torch_train import _assert_grads_close, _spy_nhc_train
from tests.torch_fused_train_helpers import one_torch_thread  # noqa: F401 (fixture)
from tests.torch_port_helpers import SMALL_FUSED, both_configs, random_variables
from tests.torch_port_helpers import torch_on_one_thread  # noqa: F401 (an autouse fixture)


def _counting(monkeypatch, module, name):
    calls = [0]
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("route", ["k5", "plain"])
def test_swin2d_block_train_grads_match_jax(monkeypatch, route):
    """One shifted SwinV2 block in train mode (res 14, window 7, shift 3, C
    64, 4 heads, drop_path 0; after tests/test_pallas_kernels.py:507-555):
    the loss mean(out^2) within 1e-5 relative and every parameter gradient,
    logit_scale and the CPB-MLP included, within 1e-4 of its largest |value|
    of the JAX block's. ``k5``: the port's K5 route (its plain versions,
    one call) against DEEPFAKE_TPU_2D_TRAIN_KERNEL=1 (the nhc_train Pallas
    kernel in interpret mode, one call); ``plain``: the max-stabilised
    cosine softmax on both sides."""
    from deepfake_tpu.models.swin2d import SwinBlock as J
    from deepfake_tpu_torch.models import swin2d
    from deepfake_tpu_torch.models.swin2d import SwinBlock as T

    kernel = route == "k5"
    monkeypatch.setenv("DEEPFAKE_TPU_PALLAS_INTERPRET", "1")
    if kernel:
        monkeypatch.setenv("DEEPFAKE_TPU_2D_TRAIN_KERNEL", "1")
    else:
        monkeypatch.delenv("DEEPFAKE_TPU_2D_TRAIN_KERNEL", raising=False)
    jcalls = _spy_nhc_train(monkeypatch)
    tcalls = _counting(monkeypatch, swin2d, "window_attn3d_train")
    x = (0.5 * np.random.default_rng(70).standard_normal((2, 196, 64))).astype(np.float32)
    jblock = J(dim=64, input_resolution=(14, 14), num_heads=4, window_size=7, shift_size=3,
               drop_path=0.0)
    variables = random_variables(jblock, jnp.asarray(x), seed=71, deterministic=True)

    def loss(p):
        out = jblock.apply({"params": p}, jnp.asarray(x), False,
                           rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.mean(out ** 2)

    want_loss, grads = jax.value_and_grad(loss)(variables["params"])
    assert jcalls[0] == (1 if kernel else 0)

    tblock = T(64, (14, 14), 4, 7, 3, attn_kernel=kernel).train()
    load_jax_variables(tblock, variables)
    got_loss = (tblock(torch.from_numpy(x)) ** 2).mean()
    got_loss.backward()
    assert tcalls[0] == (1 if kernel else 0)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    _assert_grads_close(tblock, grads, 1e-4)


@pytest.mark.parametrize("masked", [True, False], ids=["shifted", "unshifted"])
def test_k5_plain_matches_pallas_nhc_train_at_swinv2_windows(masked):
    """K5's autograd Function (plain forward and backward) at SwinV2's
    7x7 windows (N = 49: one partial 64-row tile a window) with the
    inputs SwinV2 training gives it: q^ times per-head scales up to 100, k^
    unit rows, scale 1, the 16 sigmoid bias, the -100 shift mask of a 14x14
    grid (4 windows, b2): out, dq, dk, dv and dbias against
    pallas_window_attention_nhc_train under jax.vjp, atol 2e-4 / rtol 1e-4."""
    from deepfake_tpu.models.swin2d import shift_attn_mask
    from deepfake_tpu.ops.pallas_window_attn import pallas_window_attention_nhc_train
    from deepfake_tpu_torch.ops.window_attn3d_train import window_attn3d_train

    B_, H, N, D = 8, 4, 49, 16
    C = H * D
    rng = np.random.default_rng(72)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    scales = np.asarray([10.0, 30.0, 60.0, 100.0], np.float32)
    q = (unit(rng.standard_normal((B_, N, H, D))) * scales[:, None]).reshape(B_, N, C)
    k = unit(rng.standard_normal((B_, N, H, D))).reshape(B_, N, C)
    v = rng.standard_normal((B_, N, C))
    q, k, v = (a.astype(np.float32) for a in (q, k, v))
    bias = (16 / (1 + np.exp(-rng.standard_normal((H, N, N))))).astype(np.float32)
    mask = shift_attn_mask(14, 14, 7, 3) if masked else None
    g = rng.standard_normal((B_, N, C)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def attn(q, k, v, b):
        return pallas_window_attention_nhc_train(q, k, v, num_heads=H, bias=b, mask=jmask,
                                                 scale=1.0)

    out, vjp = jax.vjp(attn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = [out, *vjp(jnp.asarray(g))]
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    got_out = window_attn3d_train(qkv, num_heads=H, bias=tbias, scale=1.0,
                                  mask=None if mask is None else torch.from_numpy(mask))
    got_out.backward(torch.from_numpy(g))
    got = [got_out, *qkv.grad.split(C, dim=-1), tbias.grad]
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("axis,shape", [(1, (2, 5, 7)), (-1, (2, 6))], ids=["axis1", "axis-1"])
@pytest.mark.parametrize("momentum", [0.1, 0.08])
def test_batchnorm_train_matches_flax(axis, shape, momentum):
    """BatchNorm in training against flax ``torch_batchnorm`` (layers.py:
    129-146) at batch 2: the output and the running mean and variance after
    each of two updates within 1e-6 of max(1, |value|). Torch's own
    BatchNorm, which feeds the running variance the unbiased variance, misses
    by n / (n - 1) of the batch variance's share (n = 2 for the fusion
    head's axis -1: a factor 2)."""
    from deepfake_tpu.models.layers import torch_batchnorm

    rng = np.random.default_rng(73)
    C = shape[axis]
    jbn = torch_batchnorm(C, momentum, axis=axis)
    x0 = (2 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    stats = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x0),
                     use_running_average=False)["batch_stats"]
    stats = {"mean": 0.1 * rng.standard_normal(C).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    params = {"scale": (1 + 0.2 * rng.standard_normal(C)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    tbn = BatchNorm(C, axis=axis, momentum=momentum).train()
    load_jax_variables(tbn, {"params": params, "batch_stats": stats})
    ref = torch.nn.BatchNorm1d(C, momentum=momentum).train()
    with torch.no_grad():
        ref.running_mean.copy_(torch.from_numpy(stats["mean"]))
        ref.running_var.copy_(torch.from_numpy(stats["var"]))
    close = lambda a, b: np.abs(a - b).max() <= 1e-6 * max(1.0, np.abs(b).max())
    for step in range(2):
        x = (x0 * (1 + step) + 0.3 * step).astype(np.float32)
        y, upd = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                           use_running_average=False, mutable=["batch_stats"])
        stats = jax.device_get(upd["batch_stats"])
        got = tbn(torch.from_numpy(x)).detach().numpy()
        assert close(got, np.asarray(y)), step
        assert close(tbn.running_mean.numpy(), stats["mean"]), step
        assert close(tbn.running_var.numpy(), stats["var"]), step
        ref(torch.from_numpy(x).movedim(axis, 1))
    assert not close(ref.running_var.detach().numpy(), stats["var"])


def test_spec_augment_dilation_matches_jnp_convolve():
    """SpecAugment's span mask equals the JAX package's
    ``jnp.convolve(starts, ones(length), 'full')[:T] > 0`` on the same
    starts (wav2vec2.py:279-283), spans at the edges included."""
    rng = np.random.default_rng(74)
    starts = (rng.random((3, 40)) < 0.08).astype(np.float32)
    starts[0, 0] = starts[1, -1] = 1.0
    want = np.stack([np.convolve(s, np.ones(10, np.float32), "full")[:40] > 0 for s in starts])
    jwant = jax.vmap(lambda s: jnp.convolve(s, jnp.ones(10), mode="full")[:40])(starts) > 0
    got = SpecAugment(0.05, 10).spans(torch.from_numpy(starts)).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, np.asarray(jwant))


def test_spec_augment_writes_the_embedding_into_masked_frames():
    x = torch.randn(4, 50, 6)
    embed = torch.arange(6.0)
    aug = SpecAugment(0.2, 10).train()
    aug.generator = torch.Generator().manual_seed(3)
    y = aug(x, embed)
    masked = (y == embed).all(-1)
    assert masked.any() and not masked.all()
    assert torch.equal(y[~masked], x[~masked])
    assert aug.eval()(x, embed) is x


def test_layer_drop_keeps_or_skips_the_whole_layer():
    """A dropped layer returns its input exactly, a kept one its output;
    eval mode and rate 0 always return the output."""
    x, y = torch.randn(2, 5, 4), torch.randn(2, 5, 4)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(LayerDrop(1.0, gen).train()(x, y), x)
    assert torch.equal(LayerDrop(0.0, gen).train()(x, y), y)
    assert torch.equal(LayerDrop(1.0, gen).eval()(x, y), y)
    picks = [LayerDrop(0.5, gen).train()(x, y) for _ in range(40)]
    assert all(torch.equal(p, x) or torch.equal(p, y) for p in picks)
    assert any(torch.equal(p, x) for p in picks) and any(torch.equal(p, y) for p in picks)


def _wav_model(**rates):
    from deepfake_tpu_torch.models.layers import init_weights, set_dropout_generator
    from deepfake_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

    c = Wav2Vec2Config(conv_dim=(32,) * 7, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=64, **rates)
    m = init_weights(Wav2Vec2Model(c), torch.Generator().manual_seed(0))
    return set_dropout_generator(m, torch.Generator().manual_seed(1))


def test_wav2vec2_train_mode_with_zero_rates_equals_eval():
    zero = dict(feat_proj_dropout=0.0, hidden_dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0)
    m = _wav_model(**zero)
    wave = torch.randn(2, 8000)
    lengths = torch.tensor([8000, 6000])
    with torch.no_grad():
        assert torch.equal(m.train()((wave, lengths)), m.eval()((wave, lengths)))
    m = _wav_model()  # the JAX defaults: every mask on
    with torch.no_grad():
        a, b = m.train()((wave, lengths)), m.eval()((wave, lengths))
    assert a.shape == b.shape and not torch.equal(a, b)


def _kept(kind: str, seed: int, x: torch.Tensor, rate: float) -> torch.Tensor:
    """What one module of ``kind`` seeded with ``seed`` keeps of ``x``, as a
    bool tensor: elements, samples, layers (400 calls) or frames."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "dropout":
        return Dropout(rate, gen).train()(x)[..., 0] != 0
    if kind == "drop_path":
        return DropPath(rate, gen).train()(x)[:, 0, 0] != 0
    if kind == "layer_drop":
        drop = LayerDrop(rate, gen).train()
        return torch.stack([drop(x, 2 * x)[0, 0, 0] == 2 for _ in range(400)])
    aug = SpecAugment(rate, 10).train()
    aug.generator = gen
    return (aug(x, torch.zeros(x.shape[-1])) != 0).all(-1)


@pytest.mark.parametrize("kind", ["dropout", "drop_path", "layer_drop", "spec_augment"])
def test_masks_repeat_from_one_seed_and_keep_their_share(kind):
    """Each Dropout-like module draws from its generator only: one seed gives
    the same masks twice, another seed others. The kept share lies within 4
    sigma of 1 - rate (SpecAugment: (1 - 0.05)^10, the share no span of 10
    covers; its sigma counts one draw per 10 frames, since spans overlap)."""
    x = torch.ones(64, 100, 4)
    rate = 0.05 if kind == "spec_augment" else 0.3
    a, b = _kept(kind, 5, x, rate), _kept(kind, 5, x, rate)
    assert torch.equal(a, b) and not torch.equal(a, _kept(kind, 6, x, rate))
    keep = (1 - rate) ** 10 if kind == "spec_augment" else 1 - rate
    n = a.numel() / (10 if kind == "spec_augment" else 1)
    share = a.float().mean().item()
    sigma = math.sqrt(keep * (1 - keep) / n)
    assert abs(share - keep) <= 4 * sigma, (share, keep, sigma)


def test_trainer_splits_nested_inputs_into_micro_batches():
    """A (video, audio, (wave, lengths)) batch: every leaf split into accum
    micro-batches along axis 0, float leaves in the compute type, the
    integer lengths int64 (never the compute type), labels f32."""
    from deepfake_tpu_torch.train.trainer import Trainer

    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(()))

        def forward(self, x, return_logits=False):
            seen.append(x)
            video, audio, (wave, lengths) = x
            return self.w + video.float().mean((1, 2)) + lengths.float() * 0

    _, cfg = both_configs(dict(SMALL_FUSED, **{
        "optim.batch_size": 2, "optim.accum_step": 3, "parallel.compute_dtype": "bfloat16"}))
    rng = np.random.default_rng(75)
    video = rng.standard_normal((6, 3, 4)).astype(np.float32)
    audio = rng.standard_normal((6, 5)).astype(np.float32)
    wave = rng.standard_normal((6, 7)).astype(np.float32)
    lengths = np.arange(6, dtype=np.int32) + 100
    y = np.asarray([0, 1, 0, 1, 1, 0], np.float32)
    batch = ((video, audio, (wave, lengths)), y)
    data = type("Data", (), {"train_loader": lambda self: [batch]})()
    tt = Trainer(Probe(), cfg, data, logger=lambda line: None, device="cpu")
    tt.train_step((video, audio, (wave, lengths)), y)
    assert len(seen) == 3
    for i, (v, a, (w, n)) in enumerate(seen):
        rows = slice(2 * i, 2 * i + 2)
        assert v.dtype == a.dtype == w.dtype == torch.bfloat16 and n.dtype == torch.int64
        assert torch.equal(v, torch.from_numpy(video[rows]).to(torch.bfloat16))
        assert torch.equal(n, torch.from_numpy(lengths[rows]).long())
    (inputs, labels) = tt._put_batch((video, audio, (wave, lengths)), y)
    assert inputs[2][1].dtype == torch.int64 and labels.dtype == torch.float32


@pytest.mark.parametrize("modality", ["fused", "video", "audio", "paudio"])
def test_build_model_trains_every_modality(modality):
    """build_model(train=True) for the fused model and its branches: train
    mode, f32 masters under bf16 compute, every Dropout-like module with
    the dropout generator, the config's rates (swin_drop, classify_drop,
    bn_momentum) and the JAX package's hard-coded ones (SwinV2's DropPath
    linspace(0, 0.1, blocks), wav2vec2's 0.1, SpecAugment's 0.05)."""
    from deepfake_tpu_torch.models.registry import build_model

    _, cfg = both_configs(dict(SMALL_FUSED, **{
        "data.modality": modality, "parallel.compute_dtype": "bfloat16",
        "model.swin_drop": 0.2, "model.classify_drop": 0.3, "model.bn_momentum": 0.05}))
    m = build_model(cfg, "cpu", train=True)
    assert m.training and all(p.dtype == torch.float32 for p in m.parameters())
    drops = [d for d in m.modules() if isinstance(d, Dropout)]
    assert drops and all(d.generator is not None for d in drops)
    rates = {type(d).__name__: set() for d in drops}
    for d in drops:
        rates[type(d).__name__].add(d.rate)
    if modality in ("fused", "audio"):
        np.testing.assert_allclose(sorted(rates["DropPath"]), np.linspace(0, 0.1, 4), atol=1e-9)
    if modality in ("fused", "paudio"):
        assert rates["LayerDrop"] == {0.1} and rates["SpecAugment"] == {0.05}
    if modality in ("fused", "video"):
        bns = [b for b in m.modules() if isinstance(b, BatchNorm)]
        irv2 = [b.momentum for n, b in m.named_modules()
                if isinstance(b, BatchNorm) and ".inception." in f".{n}."]
        assert irv2 and set(irv2) == {0.1}  # IRv2's ConvBnRelu keep torch's default
        assert {b.momentum for b in bns} - {0.1} <= {0.05, 0.08}
    if modality == "fused":
        assert m.norm.momentum == 0.08 and m.attn_drop.rate == 0.3
        assert 0.2 in rates["Dropout"]
    with torch.no_grad():
        p = next(m.parameters())
        assert p.dtype == torch.float32


def test_build_model_train_without_cuda_raises_unless_cpu_asked(monkeypatch):
    from deepfake_tpu_torch.models.registry import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(both_configs(SMALL_FUSED)[1], train=True)


def test_infonce_pair_loss_matches_jax():
    from deepfake_tpu.models.fusion import infonce_pair_loss as jnce
    from deepfake_tpu_torch.models.fusion import infonce_pair_loss

    rng = np.random.default_rng(76)
    a, b = (0.1 * rng.standard_normal((5, 8))).astype(np.float32), \
        (0.1 * rng.standard_normal((5, 8))).astype(np.float32)
    want = float(jnce(jnp.asarray(a), jnp.asarray(b), 0.01))
    got = infonce_pair_loss(torch.from_numpy(a), torch.from_numpy(b), 0.01).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_vamodel_matches_jax():
    """VAModel (fusion.py:147-167): both extractors read one input, each
    feature projected, InfoNCE of the pair; small Dense extractors on both
    sides, the same weights."""
    from flax import linen as fnn

    from deepfake_tpu.models.fusion import VAModel as J
    from deepfake_tpu_torch.models.fusion import VAModel as T
    from deepfake_tpu_torch.models.layers import Linear

    class JFeat(fnn.Module):
        features: int

        @fnn.compact
        def __call__(self, x, deterministic=True):
            return fnn.Dense(self.features)(x)

    class TFeat(torch.nn.Module):
        def __init__(self, i, o):
            super().__init__()
            self.Dense_0 = Linear(i, o)

        def forward(self, x):
            return self.Dense_0(x)

    x = np.random.default_rng(77).standard_normal((6, 12)).astype(np.float32)
    jm = J(video_extractor=JFeat(20), audio_extractor=JFeat(24), common_dim=16)
    variables = random_variables(jm, jnp.asarray(x), seed=78)
    want = float(jm.apply(variables, jnp.asarray(x)))
    tm = load_jax_variables(T(TFeat(12, 20), TFeat(12, 24), video_dim=20, audio_dim=24,
                              common_dim=16), variables)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).item(), want, rtol=1e-5)


def test_irv2_trains_on_convolutions_never_k1(monkeypatch, one_torch_thread):
    """With ``irv2_fused_blocks`` the residual blocks run K1 (its plain
    version here) in eval mode only; in training every block takes the conv
    path with batch statistics (inception_resnet_v2.py:172), and the pool's
    dropout acts."""
    from deepfake_tpu_torch.models import inception_resnet_v2 as irv2
    from deepfake_tpu_torch.models.registry import build_model

    calls = _counting(monkeypatch, irv2, "inception_block")
    _, cfg = both_configs(dict(SMALL_FUSED, **{"data.modality": "video",
                                               "model.irv2_fused_blocks": True}))
    m = build_model(cfg, "cpu", train=True)
    m(torch.randn(1, 2, 96, 96, 3)).sum().backward()
    assert calls[0] == 0
    assert m.inception.drop.rate == cfg.model.swin_drop
    block = m.inception.c_0  # one block in eval mode takes K1
    with torch.no_grad():
        block.eval()(torch.randn(1, 2080, 5, 5).contiguous(memory_format=torch.channels_last))
    assert calls[0] == 1


def test_training_cli_trains_and_evaluates_on_the_cpu(tmp_path, monkeypatch, one_torch_thread):
    """``python -m deepfake_tpu_torch.train`` in process on a synthetic fused
    set (mp4v clips with PCM sidecars) at the tests' small geometry on the
    CPU: one optimizer step (4 clips = 2 x 2), its Train Loss line and the
    val AUC line, and with ``--model_save 2`` a checkpoint after step 1 (the
    JAX cadence: (t + 1) % model_save == 0); ``--Resume`` from it continues
    at its step and epoch (epoch 0 re-entered: step 2, no second save); a
    reference ``.pth`` path raises."""
    from deepfake_tpu_torch.data.synthetic import make_synthetic_trainset
    from deepfake_tpu_torch.train.__main__ import main

    root = tmp_path / "data"
    make_synthetic_trainset(str(root), 4, 2, frames=6, size=96, seconds=0.5)
    monkeypatch.chdir(tmp_path)
    log = tmp_path / "train.log"
    argv = ["--preset", "fused", "--data_root", str(root), "-cuda", "False", "-b", "2",
            "--accum_step", "2", "-e", "0", "--log_step", "1", "--num_frames", "2", "-nu", "2",
            "--model_save", "2", "--log_dir", str(log),
            "--set", "data.wave_seconds_buckets=[0.5, 1.0]"]
    for k, v in SMALL_FUSED.items():
        if k not in ("data.modality", "data.num_frames"):
            argv += ["--set", f"{k}={list(v) if isinstance(v, tuple) else v}"]
    trainer = main(argv)
    text = log.read_text()
    assert trainer.step == 1 and "Train Loss Avg" in text and "AUC:" in text
    ckpt = tmp_path / "checkpoints" / "deepfake_modalityfused_batch2_epoch0_step1"
    assert f"checkpoint saved: {ckpt}" in text
    resumed = main(argv + ["--Resume", "--fused_ckpt_path", str(ckpt)])
    text = log.read_text()
    assert resumed.step == 2 and resumed.start_epoch == 0
    assert f"Load Finetuned Model From:{ckpt}" in text
    assert "| epoch  0 | step    2 |" in text and "checkpoint saved" not in text
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [  # and the train curve
        "Modality:fused_Phase:train_Epoch0.png", ckpt.name]
    with pytest.raises(NotImplementedError, match="reference files"):
        main(argv + ["--Resume", "--fused_ckpt_path", "fused.pth"])


def test_training_cli_val_model_matches_jax_eval(tmp_path, monkeypatch, one_torch_thread):
    """``python -m deepfake_tpu_torch.train --val_model`` in process at the
    small geometry on the CPU, from a checkpoint of weights carried across
    from the JAX tree (--Resume): the logged ``val:`` loss, accuracy and AUC
    against the JAX Trainer.eval (train.py:84-85) with the same weights on
    the same batches (the port's val split, 4 clips in 2 batches, assembled
    by its val loader), loss and accuracy within rtol 1e-5 and the AUC
    equal."""
    import json

    from deepfake_tpu.parallel.mesh import make_mesh
    from deepfake_tpu.train.trainer import Trainer as JTrainer, TrainState
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.data.pipeline import ModelFeedLoader
    from deepfake_tpu_torch.data.synthetic import make_synthetic_trainset
    from deepfake_tpu_torch.io.checkpoint import save_checkpoint
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.__main__ import main
    from deepfake_tpu_torch.train.trainer import Trainer
    from tests.torch_fused_train_helpers import _jax_fused

    root = tmp_path / "data"
    make_synthetic_trainset(str(root), 2, 4, frames=6, size=96, seconds=0.5)
    monkeypatch.chdir(tmp_path)
    over = dict(SMALL_FUSED, **{"data.data_root": str(root), "optim.batch_size": 2,
                                "data.wave_seconds_buckets": (0.5, 1.0), "data.num_workers": 2})
    jcfg, tcfg = both_configs(over)
    jmodel = _jax_fused(jcfg)
    one = (jnp.zeros((1, 2, 96, 96, 3)), jnp.zeros((1, 56, 56, 3)), jnp.zeros((1, 8000)))
    variables = random_variables(jmodel, one, seed=81, train=False, deterministic=True)
    model = load_jax_variables(build_model(tcfg, "cpu", train=True), variables)
    class NoData:
        def train_loader(self):
            return [None]

    ckpt = save_checkpoint(str(tmp_path / "carried"),
                           Trainer(model, tcfg, NoData(), logger=lambda line: None, device="cpu"))
    log = tmp_path / "train.log"
    argv = ["--preset", "fused", "--data_root", str(root), "-cuda", "False", "-b", "2",
            "--num_frames", "2", "-nu", "2", "--log_dir", str(log), "--val_model", "--Resume",
            "--fused_ckpt_path", ckpt, "--set", "data.wave_seconds_buckets=[0.5, 1.0]"]
    for k, v in SMALL_FUSED.items():
        if k not in ("data.modality", "data.num_frames"):
            argv += ["--set", f"{k}={list(v) if isinstance(v, tuple) else v}"]
    main(argv)
    (line,) = [s for s in log.read_text().splitlines() if "val: " in s]
    got = json.loads(line.split("val: ", 1)[1])

    dm = DeepFakeDataModule(tcfg, device="cpu").setup("fit")
    batches = [(jax.tree.map(lambda t: t.numpy(), x), y.numpy())
               for x, y in ModelFeedLoader(dm.val_dataloader(), tcfg, train=False, device="cpu")]
    assert len(batches) == 2
    jt = JTrainer.__new__(JTrainer)
    jt.model, jt.cfg, jt.modality = jmodel, jcfg, "fused"
    jt.mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    jt.data_sharding = jax.sharding.NamedSharding(jt.mesh, jax.sharding.PartitionSpec("data"))
    jt.repl = jax.sharding.NamedSharding(jt.mesh, jax.sharding.PartitionSpec())
    jt.logger = lambda line: None
    params = jax.tree.map(jnp.asarray, variables["params"])
    jt.state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=None)
    jt._eval_step = jax.jit(jt._eval_step_impl)
    try:
        want = jt.eval(batches)
    finally:
        jax.clear_caches()  # the fused eval's executable: the worker runs other files after
    np.testing.assert_allclose([got["loss"], got["acc"]], [want["loss"], want["acc"]], rtol=1e-5)
    assert got["auc"] == pytest.approx(want["auc"], rel=1e-6, nan_ok=True)
