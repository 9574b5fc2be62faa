"""int8 serving of the IRv2 trunk (``model.irv2_quant``) in the port against
the JAX package, on the CPU in f32: the quantisation primitives, the
integer convolution, ConvBnRelu at each IRv2 shape class, a residual block
and the backbone; calibration of int8_static; the config, scope and
SubmitCtl plumbing. The port's K7 and K8 wrappers take their plain versions
here (tests/test_torch_cuda.py holds the kernels to them on the card); the
JAX side runs its XLA int8 path. Random numpy weights go through
``load_jax_variables``; torch runs on one thread. The models, and
calibration against the JAX package's, are in
tests/test_torch_int8_models.py.

Tolerances (each test names its own): the primitives and the integer
accumulator to the bit (the same arithmetic); the conv's f32 output within
rtol 1e-6 (XLA's epilogue may fuse what the port rounds apart);
ConvBnRelu's int8 weights and activations equal in >= 99.99% of entries and
never more than 1 apart (XLA's rsqrt differs from torch's in the last bit
in about a third of the BatchNorm gains, so a folded weight near a .5
boundary may round the other way), its output within 5e-3 of max |y_jax|
(one quantisation step of a weight or an input moves an output by about
1/127 of that term); the quality bar against the float path of
tests/test_quantize.py:77-86 (corr > 0.999, relative error < 0.05); a block
within 0.02 of max |y| and the backbone within 0.03 (the one-step
differences above, carried through 7 and 244 quantised convs; the
backbone's reason is in its test), both at corr >= 0.999."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import random_variables

from deepfake_tpu_torch.io.jax_weights import load_jax_variables
from deepfake_tpu_torch.ops import int8_conv as Q


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corr(a, b):
    return float(np.corrcoef(np.asarray(a, np.float64).ravel(),
                             np.asarray(b, np.float64).ravel())[0, 1])


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _owners(model):
    from deepfake_tpu_torch.models.layers import Int8Owner

    return [m for m in model.modules() if isinstance(m, Int8Owner)]


def _set_quant(model, quant):
    for m in _owners(model):
        m.quant = quant


# ---------------------------------------------------------------- (a) primitives

def test_primitives_match_jax_to_the_bit():
    """quantize_sym per tensor and per output channel, quantize_to and the
    act scale max(amax, 1e-12) / 127 (K8's plain versions among them)
    against the JAX functions, to the bit: random values, exact .5 ties
    (half to even), an all-zero tensor (the 1e-12 floor) and saturation."""
    from deepfake_tpu.models.layers import quantize_sym, quantize_to

    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((3, 3, 24, 16))).astype(np.float32)  # HWIO
    jq, js = quantize_sym(jnp.asarray(x))
    tq, ts = Q.quantize_sym(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    jq, js = quantize_sym(jnp.asarray(x), axis=(0, 1, 2))
    tq, ts = Q.quantize_sym(torch.from_numpy(x).permute(3, 0, 1, 2), dim=(1, 2, 3))
    np.testing.assert_array_equal(tq.permute(1, 2, 3, 0).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.reshape(-1).numpy(), np.asarray(js).reshape(-1))

    ties = ((rng.integers(-200, 200, 4096) + 0.5) / 8).astype(np.float32)
    cases = [(x.ravel(), None), (ties, np.float32(127 / 8)), (np.zeros(64, np.float32), None),
             (x.ravel(), np.float32(0.5))]  # batch max, ties at scale 1/8, zeros, saturation
    for v, amax in cases:
        tx = torch.from_numpy(v)
        t_amax = Q.act_amax(tx) if amax is None else torch.tensor([amax])
        j_amax = jnp.max(jnp.abs(jnp.asarray(v))) if amax is None else jnp.float32(amax)
        assert t_amax.item() == float(j_amax)
        j_scale = jnp.maximum(j_amax, 1e-12) / 127.0  # layers.py:247
        assert Q.act_scale(t_amax).item() == float(j_scale)
        got = Q.act_quantize(tx, t_amax)
        np.testing.assert_array_equal(got.numpy(), np.asarray(quantize_to(jnp.asarray(v), j_scale)))
    assert Q.act_quantize(torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 3.5]) / 8,
                          torch.tensor([127 / 8])).tolist() == [0, 2, 2, 0, -2, 4]
    assert Q.act_quantize(torch.from_numpy(x.ravel()), torch.tensor([0.5])).abs().max() == 127
    zq, zs = Q.quantize_sym(torch.zeros(5))
    assert zq.abs().max() == 0 and zs.item() == float(jnp.float32(1e-12) / 127.0)


# ---------------------------------------------------------------- (b) the integer conv

CONVS = {  # (cin, cout, kernel, stride, (top, bottom, left, right)): the IRv2 classes
    "3x3_s2_valid_cin3": (3, 32, (3, 3), 2, (0, 0, 0, 0)),
    "3x3_s1_valid": (32, 32, (3, 3), 1, (0, 0, 0, 0)),
    "3x3_pad1": (32, 48, (3, 3), 1, (1, 1, 1, 1)),
    "5x5_pad2": (48, 64, (5, 5), 1, (2, 2, 2, 2)),
    "1x7": (128, 160, (1, 7), 1, (0, 0, 3, 3)),
    "7x1": (160, 192, (7, 1), 1, (3, 3, 0, 0)),
    "1x3": (192, 224, (1, 3), 1, (0, 0, 1, 1)),
    "3x1": (224, 256, (3, 1), 1, (1, 1, 0, 0)),
    "3x3_s2_cin288": (288, 320, (3, 3), 2, (0, 0, 0, 0)),
    "1x1_cin2080": (2080, 1088, (1, 1), 1, (0, 0, 0, 0)),
}


@pytest.mark.parametrize("cin,cout,kernel,stride,pad", list(CONVS.values()), ids=list(CONVS))
def test_integer_conv_matches_jax_quant_conv(cin, cout, kernel, stride, pad):
    """The plain int8 conv against JAX ``quant_conv`` (layers.py:256-270) on
    the same int8 operands: the int32 accumulator exact (XLA's int8 conv
    against the port's float64 one), the dequantised output within rtol
    1e-6; and at Cin 2080 all operands +-127, |acc| = 2080 x 127^2."""
    from deepfake_tpu.models.layers import quant_conv

    rng = np.random.default_rng(1)
    side = 3 if cin == 2080 else 11
    xq = rng.integers(-127, 128, (2, side, side, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, kernel + (cin, cout)).astype(np.int8)  # HWIO
    if cin == 2080:
        xq = np.where(rng.random(xq.shape) < 0.5, -127, 127).astype(np.int8)
        wq = np.full(wq.shape, 127, np.int8)
        xq[0, 0, 0, :] = 127
    ws = (rng.random(cout) * 0.02 + 1e-3).astype(np.float32)
    shift = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    amax = np.float32(3.7)
    jpad = [(pad[0], pad[1]), (pad[2], pad[3])]
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride), jpad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    w = Q.Int8Weights(torch.from_numpy(wq).permute(3, 0, 1, 2).contiguous(),
                      torch.from_numpy(ws), torch.from_numpy(shift), stride, pad)
    got_acc = Q.conv_acc_plain(torch.from_numpy(xq), w)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc))
    if cin == 2080:
        assert got_acc.abs().max().item() == 2080 * 127 * 127
    xs = jnp.maximum(amax, 1e-12) / 127.0
    want = quant_conv(jnp.asarray(xq), jnp.asarray(wq), stride, jpad,
                      out_scale=(xs * jnp.asarray(ws)).reshape(1, 1, 1, -1),
                      out_bias=jnp.asarray(shift))
    got = Q.int8_conv(torch.from_numpy(xq), w, torch.tensor([amax]), False, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


# ---------------------------------------------------------------- (c) ConvBnRelu

CLASSES = {  # JAX ConvBnRelu arguments: (cin, cout, kernel, stride, padding)
    "f0_cin3_s2": (3, 32, (3, 3), 2, "VALID"),
    "3x3_valid": (32, 32, (3, 3), 1, "VALID"),
    "3x3_pad1": (32, 64, (3, 3), 1, 1),
    "5x5_pad2": (48, 64, (5, 5), 1, 2),
    "1x7": (128, 160, (1, 7), 1, (0, 3)),
    "7x1": (160, 192, (7, 1), 1, (3, 0)),
    "1x3": (192, 224, (1, 3), 1, (0, 1)),
    "3x1": (224, 256, (3, 1), 1, (1, 0)),
    "3x3_s2_cin256": (256, 288, (3, 3), 2, "VALID"),
    "1x1": (320, 32, (1, 1), 1, 0),
}


def _convbnrelu_pair(cin, cout, kernel, stride, padding, seed, quant="int8"):
    from deepfake_tpu.models.layers import ConvBnRelu as J
    from deepfake_tpu_torch.models.layers import ConvBnRelu as T

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 13, 13, cin)).astype(np.float32)
    jf = J(cout, kernel, stride, padding, use_bias=False)
    v = random_variables(jf, jnp.asarray(x), seed=seed)
    tm = load_jax_variables(T(cin, cout, kernel, stride, padding), v)
    tm.quant = quant
    return x, v, J(cout, kernel, stride, padding, use_bias=False, quant=quant), jf, tm


@pytest.mark.parametrize("cin,cout,kernel,stride,padding", list(CLASSES.values()),
                         ids=list(CLASSES))
def test_convbnrelu_int8_matches_jax(cin, cout, kernel, stride, padding):
    """ConvBnRelu's int8 branch (layers.py:273-330) against JAX's: the folded
    int8 weights and the int8 input equal in >= 99.99% of entries and never
    more than 1 apart; the output within 5e-3 of max |y_jax|; against the
    float path corr > 0.999 and relative error < 0.05."""
    from deepfake_tpu.models.layers import quantize_sym, quantize_to

    x, v, jq, jf, tm = _convbnrelu_pair(cin, cout, kernel, stride, padding, seed=2)
    p, st = v["params"], v["batch_stats"]
    g = jnp.asarray(p["bn"]["scale"]) * jax.lax.rsqrt(jnp.asarray(st["bn"]["var"]) + 1e-3)
    jwq, jws = quantize_sym(jnp.asarray(p["conv"]["kernel"]) * g, axis=(0, 1, 2))
    twq = tm.pack_int8().wq.permute(1, 2, 3, 0).numpy()
    jxq = quantize_to(jnp.asarray(x), jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-12) / 127)
    tx = torch.from_numpy(x)
    txq = Q.act_quantize(tx, Q.act_amax(tx)).numpy()
    for got, want in ((twq, np.asarray(jwq)), (txq, np.asarray(jxq))):
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() >= 0.9999, (d.max(), (d == 0).mean())
    y_jax = np.asarray(jq.apply(v, jnp.asarray(x)))
    y_float = np.asarray(jf.apply(v, jnp.asarray(x)))
    with torch.inference_mode():
        y = _nhwc(tm(_nchw(x)))
    assert y.shape == y_jax.shape
    assert np.abs(y - y_jax).max() <= 5e-3 * np.abs(y_jax).max()
    assert _corr(y, y_float) > 0.999 and _rel(y, y_float) < 0.05


# ---------------------------------------------------------------- (d) block and backbone

def test_residual_block_a_int8_matches_jax():
    """Block A without K1 (six quantised ConvBnRelus and the int8 residual
    1x1, test_quantize.py:104-119) against the JAX block at int8: corr >=
    0.999, max |diff| <= 0.02 max |y|."""
    from deepfake_tpu.models.inception_resnet_v2 import BlockA as J
    from deepfake_tpu_torch.models.inception_resnet_v2 import BlockA as T

    x = np.random.default_rng(3).standard_normal((1, 8, 8, 320)).astype(np.float32)
    v = random_variables(J(), jnp.asarray(x), seed=3)
    want = np.asarray(J(quant="int8").apply(v, jnp.asarray(x)))
    tm = load_jax_variables(T(0.17, fused=False), v)
    _set_quant(tm, "int8")
    with torch.inference_mode():
        got = _nhwc(tm(_nchw(x)))
    assert _corr(got, want) >= 0.999 and _rel(got, want) <= 0.02


def test_irv2_backbone_int8_matches_jax():
    """The IRv2 trunk at 96 x 96, 2 frames, all 244 convs int8 (K1 off),
    against the JAX trunk at int8 (test_quantize.py:138-153): corr >=
    0.999, max |diff| <= 0.03 max |y| (not 0.02: a one-step flip at an early
    conv carries through the trunk like quantisation noise itself; over
    weight and input seeds 0-5 the port is 0.0168-0.0279 of max |y| from
    JAX's int8 trunk, which is 0.0194-0.0301 from JAX's float trunk, and
    0.0204 at this seed), 244 K7 calls."""
    from deepfake_tpu.models.inception_resnet_v2 import InceptionResNetV2 as J
    from deepfake_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2 as T

    x = np.random.default_rng(4).standard_normal((2, 96, 96, 3)).astype(np.float32) * 0.5
    v = random_variables(J(), jnp.asarray(x), seed=4)
    want = np.asarray(jax.jit(J(quant="int8").apply)(v, jnp.asarray(x)))
    tm = load_jax_variables(T(fused_blocks=False, quant="int8"), v)
    with Q.recorded_convs() as calls, torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert len(calls) == 244 and np.isfinite(got).all()
    assert _corr(got, want) >= 0.999 and _rel(got, want) <= 0.03


# ---------------------------------------------------------------- (f) static mode, one conv

def test_static_scales_are_running_max_over_batches():
    """calibrate_act_scales keeps the running max over its batches whatever
    their order (test_quantize.py:186-202): the scalar equals max |big| in
    both orders, and the conv counts as calibrated."""
    from deepfake_tpu_torch.models.layers import ConvBnRelu
    from deepfake_tpu_torch.models.registry import calibrate_act_scales

    rng = np.random.default_rng(6)
    small = _nchw(rng.standard_normal((1, 6, 6, 8)).astype(np.float32))
    big = small * 4.0
    m = ConvBnRelu(8, 8, (3, 3), 1, 1)
    m.quant = "int8_static"
    got = []
    for order in ([small, big], [big, small]):
        assert calibrate_act_scales(m, m, order) == 1
        got.append(m.act_amax.item())
    assert got[0] == got[1] == big.abs().max().item()
    assert m.calibrated == {"act_amax"}


def test_static_on_the_calibration_batch_equals_dynamic():
    """Static mode on its own calibration batch runs the ops of dynamic mode
    on the same scales: equal to the bit; uncalibrated static equals dynamic
    to the bit too (the JAX fallback, layers.py:235-247); static on a batch
    of four times the scale saturates and differs."""
    from deepfake_tpu_torch.models.inception_resnet_v2 import BlockA
    from deepfake_tpu_torch.models.registry import calibrate_act_scales, reset_calibration

    x = _nchw(np.random.default_rng(5).standard_normal((1, 8, 8, 320)).astype(np.float32))
    block = BlockA(0.17, fused=False)
    _set_quant(block, "int8")
    with torch.inference_mode():
        dynamic, dynamic4 = block(x), block(4 * x)
        _set_quant(block, "int8_static")
        uncalibrated = block(x)
    assert torch.equal(uncalibrated, dynamic)
    assert calibrate_act_scales(block, block, [x]) == 7
    with torch.inference_mode():
        assert torch.equal(block(x), dynamic)
        assert not torch.equal(block(4 * x), dynamic4)
    reset_calibration(block)
    assert not any(m.calibrated for m in _owners(block))


# ---------------------------------------------------------------- (f2) one max and one quantisation a tensor

# act_amax and act_quantize calls of one IRv2 forward by mode and K1: with K1
# on, 7 maxima (the frames, f4's pooled input, the stem's shared input, b3_1's
# pooled input, the inputs of the two reductions and of the 1536 conv) and 19
# quantisations for 24 convs; with K1 off each residual block also reduces its
# input once for its branch heads and its concatenation for its 1x1
K8_CALLS = {("int8", True): (7, 19), ("int8", False): (87, 189),
            ("int8_static", True): (0, 24), ("int8_static", False): (0, 244)}


def _irv2_trunk(fused):
    """A port IRv2 trunk with seeded random weights and BatchNorm
    statistics, and two frames of 96 x 96."""
    from deepfake_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2
    from deepfake_tpu_torch.models.layers import BatchNorm, init_weights

    gen = torch.Generator().manual_seed(9)
    model = init_weights(InceptionResNetV2(fused_blocks=fused), gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 96, 96, 3)).astype(
        np.float32)) * 0.5
    return model, x


@pytest.mark.parametrize("fused", [True, False], ids=["k1_on", "k1_off"])
@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_each_activation_is_reduced_and_quantised_once(monkeypatch, quant, fused):
    """One IRv2 forward (2 frames of 96): K8's plain versions run K8_CALLS'
    numbers of times (in dynamic mode, and while int8_static calibrates;
    calibrated, none of the maxima); the amax each int8 conv is handed
    equals act_amax_plain of its own input to the bit (from K7's epilogue,
    a shared quantisation or its own max); the output equals the per-conv
    route's (one act_amax and one act_quantize a conv) to the bit, and so
    under the pointwise scope gate, where float convs sit between int8
    ones."""
    from deepfake_tpu_torch.models.registry import calibrate_act_scales

    model, x = _irv2_trunk(fused)
    _set_quant(model, quant)
    counts, seen = {"amax": 0, "quantize": 0}, []
    amax_plain, quantize_plain, conv = Q.act_amax_plain, Q.act_quantize_plain, Q.quantized_conv

    def counted(name, fn):
        def spy(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return spy

    def conv_spy(x, *a, **kw):
        out = conv(x, *a, **kw)
        seen.append(torch.equal(out[1], amax_plain(x)))
        return out

    monkeypatch.setattr(Q, "act_amax_plain", counted("amax", amax_plain))
    monkeypatch.setattr(Q, "act_quantize_plain", counted("quantize", quantize_plain))
    monkeypatch.setattr(Q, "quantized_conv", conv_spy)
    with torch.inference_mode():
        if quant == "int8_static":
            assert calibrate_act_scales(model, model, [x]) == (24 if fused else 244)
            assert (counts["amax"], counts["quantize"]) == K8_CALLS["int8", fused]
            counts.update(amax=0, quantize=0)
        got = model(x)
        assert (counts["amax"], counts["quantize"]) == K8_CALLS[quant, fused]
        if quant == "int8":
            assert len(seen) == (24 if fused else 244) and all(seen)
        with Q.per_conv_quantization():
            counts.update(amax=0, quantize=0)
            assert torch.equal(model(x), got)
            n = 24 if fused else 244
            assert (counts["amax"], counts["quantize"]) == (n if quant == "int8" else 0, n)
        monkeypatch.setenv(Q.SCOPE_ENV, "pointwise")
        got = model(x)
        with Q.per_conv_quantization():
            assert torch.equal(model(x), got)


# ---------------------------------------------------------------- (g) plumbing

def test_irv2_quant_and_scope_values(monkeypatch):
    """model.irv2_quant takes none, int8 and int8_static from --set; any
    other value raises at build (the JAX package would run the float path).
    DEEPFAKE_TPU_INT8_SCOPE: all by default, pointwise routes a 3x3 conv to
    the float path (equal to the float module to the bit) and keeps a 1x1
    int8, wide takes stride-1 convs of cin >= 32; an unknown value raises
    (the JAX gate reads it as all)."""
    from deepfake_tpu_torch.config import get_config
    from deepfake_tpu_torch.models.layers import ConvBnRelu
    from deepfake_tpu_torch.models.registry import build_model

    for q in ("none", "int8", "int8_static"):
        assert get_config(["--set", f"model.irv2_quant={q}"]).model.irv2_quant == q
    cfg = get_config(["--set", "model.irv2_quant=int4", "--modality", "video"])
    with pytest.raises(ValueError, match="irv2_quant"):
        build_model(cfg, "cpu")

    monkeypatch.delenv(Q.SCOPE_ENV, raising=False)
    assert Q.int8_scope() == "all" and Q.int8_shape_allowed((3, 3), 2, 3)
    x = _nchw(np.random.default_rng(7).standard_normal((1, 8, 8, 16)).astype(np.float32))
    monkeypatch.setenv(Q.SCOPE_ENV, "pointwise")
    assert not Q.int8_shape_allowed((3, 3), 1, 320) and Q.int8_shape_allowed((1, 1), 1, 320)
    with torch.inference_mode():
        m = ConvBnRelu(16, 8, (3, 3), 1, 1)
        want = m(x)
        m.quant = "int8"
        assert torch.equal(m(x), want)
        m1 = ConvBnRelu(16, 8, (1, 1))
        want = m1(x)
        m1.quant = "int8"
        assert not torch.equal(m1(x), want)
    monkeypatch.setenv(Q.SCOPE_ENV, "wide")
    assert Q.int8_shape_allowed((3, 3), 1, 320) and not Q.int8_shape_allowed((3, 3), 1, 3)
    assert not Q.int8_shape_allowed((3, 3), 2, 320)
    monkeypatch.setenv(Q.SCOPE_ENV, "everything")
    with pytest.raises(ValueError, match=Q.SCOPE_ENV):
        with torch.inference_mode():
            m(x)


def test_training_ignores_quant():
    """A train-mode ConvBnRelu with quant set takes the float path with
    batch statistics (test_quantize.py:89-101): output and running
    statistics equal the float module's; a training model is built without
    quant."""
    from deepfake_tpu_torch.config import Config
    from deepfake_tpu_torch.models.layers import ConvBnRelu, Int8Owner
    from deepfake_tpu_torch.models.registry import build_model

    x = _nchw(np.random.default_rng(8).standard_normal((2, 6, 6, 8)).astype(np.float32))
    runs = []
    for quant in (None, "int8"):
        torch.manual_seed(0)
        m = ConvBnRelu(8, 8, (3, 3), 1, 1).train()
        m.quant = quant
        runs.append((m(x), m.bn.running_mean.clone(), m.bn.running_var.clone()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    cfg = Config()
    for k, val in {"data.modality": "video", "data.num_frames": 2, "data.frame_size": 96,
                   "model.irv2_quant": "int8"}.items():
        cfg.set(k, val)
    train = build_model(cfg, "cpu", train=True)
    assert all(m.quant is None for m in train.modules() if isinstance(m, Int8Owner))
    serve = build_model(cfg, "cpu")
    assert serve.quant == "int8"
    assert all(m.quant == "int8" for m in serve.modules() if isinstance(m, Int8Owner))


# ---------------------------------------------------------------- (e) K7's host plan

# the conv shapes of one fused b8 request (256 frames of 224): the 24 convs
# outside K1's blocks and, with K1 off, the blocks' 17 distinct convs more
# (deepfake_tpu_torch/tools/k7_versions.py::irv2_convs, which the card
# tests and the tool share)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "deepfake_tpu_torch", "tools"))
import k7_versions  # noqa: E402

IRV2 = {("k1_on-" if not c[6] else "k1_off-") + c[0]: c[1:5]
        for c in k7_versions.irv2_convs(256, 224)}
ODD = {  # x [F, H, W, Cin], w [Cout, KH, KW, Cin], stride, (top, bottom, left, right)
    "cout48_m_ragged": ((3, 7, 9, 32), (48, 3, 3, 32), 1, (1, 1, 1, 1)),
    "cout80_1x1": ((2, 5, 7, 64), (80, 1, 1, 64), 1, (0, 0, 0, 0)),
    "cout288_s2_odd": ((2, 13, 11, 256), (288, 3, 3, 256), 2, (0, 0, 0, 0)),
    "cout320_s2_odd_pad": ((3, 9, 15, 48), (320, 3, 3, 48), 2, (1, 0, 0, 1)),
    "1x7_asym": ((2, 6, 11, 128), (40, 1, 7, 128), 1, (0, 0, 2, 4)),
    "7x1_cin160": ((2, 12, 5, 160), (192, 7, 1, 160), 1, (3, 3, 0, 0)),
    "5x5_s2_wide": ((1, 6, 300, 16), (24, 5, 5, 16), 2, (2, 2, 2, 2)),
    "1x1_cin2080": ((2, 5, 5, 2080), (1088, 1, 1, 2080), 1, (0, 0, 0, 0)),
    "3x3_left_border2": ((2, 7, 20, 48), (64, 3, 3, 48), 1, (1, 1, 2, 0)),
    "cin3_s2_odd": ((2, 15, 13, 3), (32, 3, 3, 3), 2, (0, 1, 1, 0)),
    "cin3_cout80_wide_row": ((1, 5, 261, 3), (80, 3, 3, 3), 1, (1, 1, 1, 1)),
}


def _k7_reads(x_shape, w_shape, stride, pad, tiles=None, loads=True):
    """K7's loads for the row tiles ``tiles`` (all where None), following
    its plan, the producer's schedule (csrc/int8_conv.cu: per unit, stages of
    128 / kc chunks of kc bytes; chunk c of a tap, or a box wholly outside
    both tensors past the last) and TMA's rules for the maps of
    ``tensor_maps`` (box start, traversal stride, ceil(box / stride)
    elements a dimension, zeros outside the tensor). Returns (the number of
    row tiles; rows [tiles, 128], each tile row's output row or -1 where the
    epilogue drops it, as the kernel's row table; addr [tiles, 128, slots],
    the input byte each slot of K loads into the row, -1 for a zero; kcol
    [tiles, slots], the weights' K byte each slot meets, -1 for a zero);
    without ``loads`` the rows alone."""
    Fn, H, W, cin = x_shape
    cout, kh, kw, _ = w_shape
    Ho, Wo = Q.out_size(H, W, kh, kw, stride, pad)
    M, K = Fn * Ho * Wo, kh * kw * cin
    p = Q.plan(x_shape, w_shape, stride, pad)
    bf, bh, bw = p.box
    if p.rgb:  # segments of bw pixels of an output row, K gathered from KH row segments
        tw = -(-Wo // bw)
        n = Fn * Ho * tw
        rt = np.arange(n) if tiles is None else np.asarray(tiles)
        fy, seg = np.divmod(rt, tw)
        f, oy = np.divmod(fy, Ho)
        r = np.arange(Q.TILE_ROWS)
        ox = seg[:, None] * bw + r[None]
        rows = np.where((r < bw) & (ox < Wo), fy[:, None] * Wo + ox, -1)
        if not loads:
            return n, rows
        k = np.arange(Q.RGB_K)
        ky, rem = np.divmod(k, kw * cin)
        kx, ci = np.divmod(rem, cin)
        iy = oy[:, None, None] * stride - pad[0] + ky
        ix = (seg[:, None, None] * bw * stride - pad[2] + r[None, :, None] * stride + kx)
        ok = (k < K) & (r[None, :, None] < bw) & (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        addr = np.where(ok, ((f[:, None, None] * H + iy) * W + ix) * cin + ci, -1)
        return n, rows, addr, np.broadcast_to(np.where(k < K, k, -1), (len(rt), Q.RGB_K))
    maps = Q.tensor_maps(x_shape, w_shape, stride, pad, p)
    pl, pr = p.border
    # the parts of the output columns, as csrc/int8_conv.cu's Part: (map, box,
    # columns, first column, the right border's gap (column tile, width),
    # taps along W a row of K holds, bytes of K a tap, A's W step, taps
    # along H a stage holds)
    parts = [(maps["a"], p.box, Wo - pl - pr, pl, (1 << 30, 0), 1 if p.wide else kw,
              kw * cin if p.wide else cin, 1 if p.wide else stride, kh if p.halo else 1)]
    if pl + pr:
        parts.append((maps["a2"], (*p.border_box, 1), pl + pr, 0, (pl, Wo - pl - pr), kw, cin,
                      stride, 1))
    group = Q.STAGE_BYTES // p.kc
    r = np.arange(Q.TILE_ROWS)
    byte = np.arange(p.kc)
    n, out = 0, []
    for amap, (bf, bh, bw), cols, x0, (gap_at, gap), tkw, tc, xs, ksh in parts:
        tf, th, tw = -(-Fn // bf), -(-Ho // bh), -(-cols // bw)
        m = -(-M // Q.TILE_ROWS) if p.flat else tf * th * tw
        rt = np.arange(n, n + m) if tiles is None else np.asarray(tiles)
        rt = rt[(rt >= n) & (rt < n + m)] - n
        n += m
        counts = [-(-b // e) for b, e in zip(amap["box"], amap["elem"])]
        R = math.prod(counts[1:])  # the box's rows, dimension 1 fastest
        assert R == (Q.TILE_ROWS if p.flat else (bh + ksh - 1) * bw * bf) and (ksh == 1 or bf == 1)
        bix = np.unravel_index(np.arange(R), counts[:0:-1])[::-1]
        live = r < (Q.TILE_ROWS if p.flat else bf * bh * bw)
        if p.flat:
            rows = rt[:, None] * Q.TILE_ROWS + r[None]
            rows = np.where(rows < M, rows, -1)
            origin = [rt * Q.TILE_ROWS]
        else:
            xt = rt % tw
            ox0 = x0 + xt * bw + np.where(xt >= gap_at, gap, 0)
            oy0, f0 = rt // tw % th * bh, rt // (tw * th) * bf
            fi, rem = np.divmod(r, bh * bw)
            yi, xi = np.divmod(rem, bw)
            f, y, x = f0[:, None] + fi, oy0[:, None] + yi, ox0[:, None] + xi
            inside = live & (f < Fn) & (y < Ho) & (x < x0 + cols + gap)
            rows = np.where(inside, (f * Ho + y) * Wo + x, -1)
            origin = [ox0 * xs - pad[2], oy0 * stride - pad[0], f0]
        if not loads:
            out.append(rows)
            continue
        kchunks = -(-tc // p.kc)
        chunks = kh // ksh * tkw * kchunks
        slots = -(-chunks // group) * group
        addr = np.full((len(rt), Q.TILE_ROWS, slots * ksh * p.kc), -1, np.int64)
        kcol = np.full((len(rt), slots * ksh * p.kc), -1, np.int64)
        for c in range(slots):
            real = c < chunks
            tap, c0 = divmod(c, kchunks) if real else (0, kchunks)
            c0 *= p.kc
            ky, kx = tap // tkw * ksh, tap % tkw
            start = [c0] + [o + d for o, d in zip(origin, ([0] if p.flat else [kx, ky, 0]))]
            ok = np.ones((len(rt), R), bool)
            at = np.zeros((len(rt), R), np.int64)
            for d in range(1, len(counts)):
                i = start[d][:, None] + amap["elem"][d] * bix[d - 1][None]
                ok &= (i >= 0) & (i < amap["dims"][d])
                at += i * amap["strides"][d - 1]
            i0 = c0 + byte
            box = np.where(ok[..., None] & (i0 < amap["dims"][0])[None, None],
                           at[..., None] + i0[None, None], -1)  # [tiles, R, kc]
            for h in range(ksh):  # tap ky + h: the box's rows from h bw on
                src = r + h * bw
                blk = slice((c * ksh + h) * p.kc, (c * ksh + h + 1) * p.kc)
                addr[:, live & (src < R), blk] = box[:, src[live & (src < R)]]
                col = ((ky + h) * tkw + kx) * tc + c0 if real else K
                kcol[:, blk] = np.where(col + byte < K, col + byte, -1)
        out.append((rows, addr, kcol))
    if not loads:
        return n, np.concatenate(out)
    width = max(a.shape[2] for _, a, _ in out)
    pad_to = lambda t, v: np.pad(t, [(0, 0)] * (t.ndim - 1) + [(0, width - t.shape[-1])],
                                 constant_values=v)
    return (n, np.concatenate([o[0] for o in out]),
            np.concatenate([pad_to(o[1], -1) for o in out]),
            np.concatenate([pad_to(o[2], -1) for o in out]))


def _check_tma_plan(p, x_shape, w_shape, stride, pad):
    """A TMA plan's limits: the chunk, tiles and boxes K7 is built for; the
    maps' boxes <= 256 elements a dimension, an inner box of 16-byte
    multiples as wide as its swizzle, byte strides of 16-byte multiples,
    traversal strides <= 8."""
    cin = x_shape[3]
    cout, kh, kw, _ = w_shape
    assert p.kc in Q.CHUNKS and p.bn in Q.N_TILES and math.prod(p.box) <= Q.TILE_ROWS
    assert p.flat == (kh == kw == 1 and stride == 1) and not p.rgb
    maps = Q.tensor_maps(x_shape, w_shape, stride, pad, p)
    for m in maps.values():
        assert all(1 <= b <= Q.TMA_BOX_MAX for b in m["box"]) and all(1 <= e <= 8 for e in m["elem"])
        assert m["box"][0] % 16 == 0 and m["box"][0] == p.kc and m["elem"][0] == 1
        assert all(s % 16 == 0 for s in m["strides"]) and len(m["strides"]) == len(m["dims"]) - 1
    assert maps["w"]["dims"] == (kh * kw * cin, cout)


@pytest.mark.parametrize("x_shape,w_shape,stride,pad", list(IRV2.values()) + list(ODD.values()),
                         ids=list(IRV2) + list(ODD))
def test_k7_plan_covers_every_output_once_within_tma_limits(x_shape, w_shape, stride, pad):
    """K7's host plan (ops/int8_conv.py::plan, tensor_maps) at every conv
    shape of a fused b8 request and a few odd ones: the maps' boxes stay in
    TMA's limits (<= 256 elements a dimension, an inner box of 16-byte
    multiples as wide as its swizzle, byte strides of 16-byte multiples,
    traversal strides <= 8); every output channel is one column tile's and
    every output pixel one tile row's, exactly once; and in the first, the
    last and some seeded tiles, each tile row meets each weight of K in one
    slot, whose load is the input byte the conv reads there (stride 2 by
    the traversal stride or the wide rows' step), and a zero where it reads
    padding; every other slot is zero in A or in W. Pure Python: no
    kernel."""
    Fn, H, W, cin = x_shape
    cout, kh, kw, _ = w_shape
    p = Q.plan(x_shape, w_shape, stride, pad)
    Ho, Wo = Q.out_size(H, W, kh, kw, stride, pad)
    if cin % 16:  # the RGB stem: K in one k32 step, segments of an output row
        assert p.kc == 0 and p.rgb and cin <= 4 and kh * kw * cin <= Q.RGB_K
        assert p.bn in Q.N_TILES and p.bn <= Q.RGB_BN and p.box[:2] == (1, 1)
        assert p.box[2] <= Q.TILE_ROWS and ((p.box[2] - 1) * stride + kw) * cin <= 1056
    else:
        _check_tma_plan(p, x_shape, w_shape, stride, pad)
    n_tiles = -(-cout // p.bn)
    assert (n_tiles - 1) * p.bn < cout <= n_tiles * p.bn
    n, rows = _k7_reads(x_shape, w_shape, stride, pad, loads=False)
    np.testing.assert_array_equal(np.bincount(rows[rows >= 0], minlength=Fn * Ho * Wo), 1)
    pick = np.unique(np.r_[0, n - 1, np.random.default_rng(7).integers(0, n, 8)])
    _, rows, addr, kcol = _k7_reads(x_shape, w_shape, stride, pad, pick)
    K = kh * kw * cin
    f, rem = np.divmod(rows, Ho * Wo)
    oy, ox = np.divmod(rem, Wo)
    ky, rem = np.divmod(np.arange(K), kw * cin)
    kx, ci = np.divmod(rem, cin)
    iy = oy[..., None] * stride - pad[0] + ky  # [tiles, 128, K]
    ix = ox[..., None] * stride - pad[2] + kx
    want = np.where((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W),
                    ((f[..., None] * H + iy) * W + ix) * cin + ci, -1)
    for t in range(len(pick)):
        live = rows[t] >= 0
        a, k = addr[t][live], np.broadcast_to(kcol[t], addr[t][live].shape)
        meet = (a >= 0) & (k >= 0)  # the slots whose product can be nonzero
        got = np.full(want[t][live].shape, -1, np.int64)
        hit = np.zeros(got.shape, np.int64)
        r = np.nonzero(meet)[0]
        np.add.at(hit, (r, k[meet]), 1)
        got[r, k[meet]] = a[meet]
        np.testing.assert_array_equal(hit, want[t][live] >= 0)
        np.testing.assert_array_equal(got, want[t][live])


@pytest.mark.parametrize("name", list(ODD))
def test_k7_plan_emulated_equals_the_conv(name):
    """K7's loads emulated from its plan (``_k7_reads``) at the odd shapes
    (M and Cout that no tile divides, stride 2 on odd sides, asymmetric
    padding, 1x7 and 7x1, Cin 2080), with random stale bytes in the tile
    rows past a box: each tile's s32 sums of the slots' products, scattered
    by the epilogue's row table, equal ``conv_acc_plain`` exactly."""
    x_shape, w_shape, stride, pad = ODD[name]
    cout = w_shape[0]
    K = math.prod(w_shape[1:])
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, x_shape).astype(np.int8)
    wq = rng.integers(-127, 128, w_shape).astype(np.int8)
    _, rows, addr, kcol = _k7_reads(x_shape, w_shape, stride, pad)
    xflat = np.r_[xq.reshape(-1).astype(np.int64), 0]  # index -1: a zero
    wk = np.c_[wq.reshape(cout, K).astype(np.int64), np.zeros(cout, np.int64)]
    out = np.zeros((rows.max() + 1, cout), np.int64)
    for t in range(rows.shape[0]):
        a = xflat[addr[t]]
        stale = rows[t] < 0
        a[stale] = rng.integers(-127, 128, a[stale].shape)
        acc = a @ wk[:, kcol[t]].T
        live = rows[t] >= 0
        out[rows[t][live]] += acc[live]
    w = Q.Int8Weights(torch.from_numpy(wq), torch.ones(cout), torch.zeros(cout), stride, pad)
    want = Q.conv_acc_plain(torch.from_numpy(xq), w).reshape(-1, cout).numpy()
    np.testing.assert_array_equal(out, want)
