"""A Trainer at ``model.irv2_quant=int8`` (the JAX Trainer builds one model for
training and evaluation, deepfake_tpu/models/registry.py:77, and its
ConvBnRelu takes the int8 path whenever it is not training,
deepfake_tpu/models/layers.py:305): the port's ``Trainer.eval`` runs the IRv2
trunk in int8 on the current weights, folded and quantised before each pass,
against the JAX Trainer's eval step (``_eval_step_impl``) on the fused model
at the small geometry of tests/torch_fused_train_helpers.py, every conv int8
(K1 off on both sides), f32, the same random weights; and its training step
equals a float Trainer's to the bit. torch runs on one thread.

Tolerance: logits within 0.02 max(1, |logit|), as
tests/test_torch_int8_models.py holds the int8 fused model (one-step rounding
flips carried through the trunk like quantisation noise)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_fused_train_helpers import OVERRIDES, _batch, _Batches
from tests.torch_port_helpers import (  # noqa: F401
    both_configs, random_variables, torch_on_one_thread,
)

from deepfake_tpu_torch.io.jax_weights import load_jax_variables

INT8 = dict(OVERRIDES, **{"model.irv2_quant": "int8"})


def _logit(p):
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


@pytest.fixture(scope="module")
def start():
    """The JAX fused model at int8 (K1 off), random variables, the batch."""
    from deepfake_tpu.models.registry import build_model

    jcfg, _ = both_configs(INT8)
    jcfg.model.irv2_pallas_blocks = False
    jmodel = build_model(jcfg)
    x, y = _batch()
    one = (jnp.asarray(x[0][:1]), jnp.asarray(x[1][:1]), jnp.asarray(x[2][0][:1]))
    return jcfg, jmodel, random_variables(jmodel, one, seed=71, train=False,
                                          deterministic=True), x, y


def _port_trainer(variables, quant, x, y):
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.trainer import Trainer

    _, tcfg = both_configs(dict(INT8, **{"model.irv2_quant": quant,
                                         "model.irv2_fused_blocks": False}))
    model = load_jax_variables(build_model(tcfg, "cpu", train=True), variables)
    return Trainer(model, tcfg, _Batches(x, y), logger=lambda line: None, device="cpu")


def test_trainer_evaluates_in_int8_like_the_jax_trainer(start):
    """Trainer.eval at int8 runs the 244 int8 convs a batch on weights packed
    from the current ones, and its per-clip probabilities match the JAX
    Trainer's eval step; a float Trainer's evaluation differs from it."""
    from deepfake_tpu.train.trainer import Trainer as JTrainer
    from deepfake_tpu_torch.ops.int8_conv import recorded_convs

    jcfg, jmodel, v, x, y = start
    jt = JTrainer.__new__(JTrainer)
    jt.model, jt.cfg, jt.modality = jmodel, jcfg, "fused"
    step = jax.jit(jt._eval_step_impl)
    want = step(v["params"], v["batch_stats"], jax.tree.map(jnp.asarray, x), jnp.asarray(y))
    want = _logit(want["probs"])

    tt = _port_trainer(v, "int8", x, y)
    assert all(p.dtype == torch.float32 for p in tt.model.parameters())
    with recorded_convs() as calls:
        metrics = tt.eval([(x, y)])
    assert len(calls) == 244 and np.isfinite(metrics["loss"])
    got = _logit(tt._eval_step(x, y)["probs"].numpy())
    np.testing.assert_allclose(got, want, rtol=0.02, atol=0.02)
    plain = _logit(_port_trainer(v, "none", x, y)._eval_step(x, y)["probs"].numpy())
    assert not np.array_equal(plain, got)


def test_trainer_at_int8_trains_on_the_float_path(start):
    """A training step at irv2_quant=int8 equals the float Trainer's to the
    bit (loss, every parameter, every BatchNorm statistic), and makes no int8
    conv; an evaluation pass after it packs the stepped weights."""
    from deepfake_tpu_torch.ops.int8_conv import recorded_convs

    _, _, v, x, y = start
    runs = []
    for quant in ("int8", "none"):
        tt = _port_trainer(v, quant, x, y)
        with recorded_convs() as calls:
            loss = tt.train_step(x, y)["loss"]
        assert not calls
        runs.append((tt, float(loss)))
    (q, lq), (f, lf) = runs
    assert lq == lf
    for (n, a), (_, b) in zip(q.model.state_dict().items(), f.model.state_dict().items()):
        assert torch.equal(a, b), n
    q.eval([(x, y)])
    conv = q.model.video_extractor.inception.stem.f1
    w = conv.pack_int8()
    assert torch.equal(conv.int8_packed.wq, w.wq) and torch.equal(conv.int8_packed.ws, w.ws)
