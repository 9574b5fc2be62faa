"""The port's alternative CNNs (deepfake_tpu_torch/models/iresnet.py) against
the JAX package's iresnet.py, weights carried across with
load_jax_variables: iResNet with bottleneck (2, 2, 2, 2) and basic
(2, 2, 3, 2) blocks at 64^2 (the shapes of tests/test_alt_cnns.py), and
Res34 at 224^2, batch 1, in eval mode (running statistics) and in train
mode (batch statistics, the updated running statistics too). f32 on the
CPU, max abs error <= 1e-4 of the output's scale. flax's BatchNorm and
GroupNorm run their two-pass variance (tests/torch_fused_train_helpers.py::
flax_two_pass_variance): the default one-pass E[x^2] - E[x]^2 is the same
function computed less exactly. Train mode at batch 1 normalises the last
stage over 4 values a channel: there every BatchNorm bias is shifted by +3
(both sides), which keeps the ReLUs after them off their kink, as the fused
training tests do (tests/torch_fused_train_helpers.py); unshifted, a 1e-6
relative perturbation of the input moves the output by 3.6e-4, and the port
and JAX each sit ~1e-4 from a float64 run."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfake_tpu_torch.io.jax_weights import load_jax_variables

from tests.torch_fused_train_helpers import flax_two_pass_variance  # noqa: F401
from tests.torch_port_helpers import random_variables

CASES = {
    "iresnet_bottleneck": (dict(block="bottleneck", layers=(2, 2, 2, 2)), 64),
    "iresnet_basic": (dict(block="basic", layers=(2, 2, 3, 2)), 64),
    "res34": ({}, 224),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name):
    from deepfake_tpu.models import iresnet as J
    from deepfake_tpu_torch.models import iresnet as T

    kw, side = CASES[name]
    jm, tm = (J.Res34(), T.Res34()) if name == "res34" else (J.IResNet(**kw), T.IResNet(**kw))
    return jm, tm, side


def _shift_bn_biases(tree, bn=False):
    return {k: _shift_bn_biases(v, bn or "bn" in k) if hasattr(v, "items") else
            v + 3.0 if bn and k == "bias" else v for k, v in tree.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(CASES))
def test_alt_cnn_matches_jax(flax_two_pass_variance, name, train):
    jm, tm, side = _models(name)
    x = np.random.default_rng(3).standard_normal((1, side, side, 3)).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=4, train=False)
    if train:
        variables = dict(variables, params=_shift_bn_biases(variables["params"]))
    load_jax_variables(tm, variables)
    if train:
        want, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        tm.train()
    else:
        want = jm.apply(variables, jnp.asarray(x), train=False)
    want = np.asarray(want)
    xt = torch.from_numpy(x.copy())
    with torch.no_grad():
        got = tm(xt).numpy()
    assert np.array_equal(xt.numpy(), x), "the forward wrote into its input"
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-4 * max(scale, 1.0), rtol=0)
    if train:  # the running statistics moved as flax moves them
        stats = {}

        def walk(tree, path=()):
            for k, v in tree.items():
                if hasattr(v, "items"):
                    walk(v, path + (k,))
                else:
                    stats[".".join(path) + (".running_mean" if k == "mean" else ".running_var")] = v

        walk(new["batch_stats"])
        state = tm.state_dict()
        assert stats
        for key, v in stats.items():
            np.testing.assert_allclose(state[key].numpy(), np.asarray(v), atol=1e-5, rtol=1e-4,
                                       err_msg=key)


def test_res34_takes_224_only_and_rezero():
    """Res34 raises for inputs other than 224^2 (its avg_pool 7 reads the
    7x7 map), and its ReZero variant starts as the residual-free block
    (alpha 0 mutes the shortcut)."""
    from deepfake_tpu_torch.models.iresnet import Res34, Res34ResidualBlock

    with pytest.raises(ValueError, match="224"):
        Res34()(torch.zeros(1, 112, 112, 3))
    blk = Res34ResidualBlock(8, 8, re_zero=True)
    x = torch.randn(1, 8, 6, 6, generator=torch.Generator().manual_seed(0))
    plain = Res34ResidualBlock(8, 8)
    plain.load_state_dict({k: v for k, v in blk.state_dict().items() if k != "alpha"})
    with torch.no_grad():
        got = blk(x)
        left = plain.gn2(plain.conv2(plain.gn1(plain.conv1(x))))
    torch.testing.assert_close(got, torch.nn.functional.gelu(left), rtol=0, atol=0)
