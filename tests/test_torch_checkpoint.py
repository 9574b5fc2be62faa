"""The port's training checkpoints against the JAX package's orbax ones, on
the CPU, at the small video_swin geometry and with the weights setup of
tests/test_torch_train.py: two optimizer steps of each package's Trainer
from the same weights, a save, a restore, a third step; then each package
serves its checkpoint (``Predictor.from_checkpoint``,
``SubmitCtl.load_checkpoint``). The JAX trainer is traced once for the file
(a module fixture); its step runs the einsum route, the port's K5's plain
versions. f32, drop rates 0."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_tpu_torch.io.checkpoint import read_checkpoint
from deepfake_tpu_torch.io.jax_weights import load_jax_variables

from tests.test_torch_swin3d import SMALL_VIDEO_SWIN
from tests.torch_port_helpers import both_configs, random_variables

SAVE_EPOCH = 1  # the epoch the checkpoints are saved in


class _Batches:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def train_loader(self):
        return [(self.x, self.y)]

    def val_loader(self):
        return [(self.x, self.y)]


def _trace(opt_state):
    """The momentum tree (optax's TraceState.trace) of the JAX optimizer state."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda n: hasattr(n, "trace")):
        if hasattr(leaf, "trace"):
            return leaf.trace
    raise AssertionError("no TraceState in the optimizer state")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages: 2 steps, save, step 3 (uninterrupted); the JAX Trainer
    restored from its checkpoint takes step 3 again; the port's checkpoint
    is loaded into a fresh Trainer, which takes step 3."""
    from deepfake_tpu.models.registry import build_model as jbuild
    from deepfake_tpu.parallel.mesh import make_mesh
    from deepfake_tpu.train.trainer import Trainer as JTrainer
    from deepfake_tpu.utils.logging import Logger as JLogger
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.trainer import Trainer

    tmp = tmp_path_factory.mktemp("ckpt")
    jcfg, tcfg = both_configs(dict(SMALL_VIDEO_SWIN, **{
        "model.swin3d_drop_path": 0.0, "model.classify_drop": 0.0, "optim.batch_size": 2,
        "optim.accum_step": 2, "optim.learning_rate": 0.1, "optim.epochs": 3}))
    jcfg.log.ckpt_dir, tcfg.log.ckpt_dir = str(tmp / "jax"), str(tmp / "port")
    jcfg.model.swin3d_pallas_attn = False
    jcfg.parallel.infer_bias_cache = False
    rng = np.random.default_rng(42)
    x = rng.standard_normal((4, 16, 56, 56, 3)).astype(np.float32)
    y = np.asarray([0.0, 1.0, 1.0, 0.0], np.float32)
    data = _Batches(x, y)

    jmodel = jbuild(jcfg)
    jt = JTrainer(jmodel, jcfg, data, logger=JLogger(None),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    params0 = random_variables(jmodel, jnp.asarray(x[:1]), seed=43, deterministic=True)["params"]
    # placed as the step places its outputs, so that the step compiles once
    jt.state = jt.state.replace(params=jax.tree.map(jax.device_put, params0, jt.param_sharding))

    def jstep(i):
        inputs, labels = jt._put_batch(x, y)
        jt.state, metrics = jt._train_step(jt.state, inputs, labels, jax.random.PRNGKey(i))
        return float(metrics["loss"])

    jlosses = [jstep(0), jstep(1)]
    jpath = jt.save_ckpt(SAVE_EPOCH)
    jlosses.append(jstep(2))
    jt.state = jt.state.replace(params=jax.tree.map(jnp.zeros_like, jt.state.params))
    jt.load_ckpt(jpath)
    restored = jax.device_get(jt.state)
    j_resumed = jstep(2)

    def port_model(params):
        return load_jax_variables(build_model(tcfg, "cpu", train=True), {"params": params})

    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers share the cores
    try:
        ta = Trainer(port_model(params0), tcfg, data, logger=lambda s: None, device="cpu")
        tlosses = [float(ta.train_step(x, y)["loss"]) for _ in range(2)]
        tpath = ta.save_ckpt(SAVE_EPOCH)
        tlosses.append(float(ta.train_step(x, y)["loss"]))
        uninterrupted = {k: v.clone() for k, v in ta.model.state_dict().items()}
        tb = Trainer(None, tcfg, data, logger=lambda s: None, device="cpu")
        ptrs = [t.data_ptr() for t in tb._state()]
        tb.load_ckpt(tpath)
        loaded = (tb.step, tb.start_epoch, [t.data_ptr() for t in tb._state()] == ptrs)
        t_resumed = float(tb.train_step(x, y)["loss"])
        resumed = {k: v.clone() for k, v in tb.model.state_dict().items()}
    finally:
        torch.set_num_threads(n)
    return dict(jcfg=jcfg, tcfg=tcfg, x=x, jmodel=jmodel, params0=params0, jpath=jpath,
                tpath=tpath, restored=restored, jlosses=jlosses, j_resumed=j_resumed,
                tlosses=tlosses, t_resumed=t_resumed, loaded=loaded,
                uninterrupted=uninterrupted, resumed=resumed, port_model=port_model)


def _assert_close_by_scale(got, want, base, tol, what):
    """Every tensor of ``got`` within tol x the largest |want - base| (an
    update) of ``want``, or of |want| where ``base`` is None."""
    assert set(got) == set(want), what
    for k in want:
        scale = (want[k] - base[k] if base is not None else want[k]).abs().max().item()
        assert scale > 0, (what, k)
        err = (got[k] - want[k]).abs().max().item()
        assert err <= tol * scale, (what, k, err, scale)


def test_checkpoint_matches_jax_orbax_checkpoint(runs):
    """The port's checkpoint after 2 steps against the JAX one restored by
    orbax: step and epoch equal; every parameter within 1e-4 of its largest
    update, the momentum (the optax trace laid onto the port's names by
    load_jax_variables) within 1e-4 of its largest |value|; the two
    packages' first two losses within 1e-5 relative."""
    r = runs
    payload = read_checkpoint(r["tpath"])
    assert payload["step"] == int(r["restored"].step) == 2
    assert payload["epoch"] == SAVE_EPOCH
    np.testing.assert_allclose(r["tlosses"][:2], r["jlosses"][:2], rtol=1e-5)
    old = r["port_model"](r["params0"]).state_dict()
    want = load_jax_variables(r["port_model"](r["params0"]), {
        "params": r["restored"].params, "batch_stats": r["restored"].batch_stats}).state_dict()
    _assert_close_by_scale(payload["model"], want, old, 1e-4, "parameters")
    trace = r["port_model"](_trace(r["restored"].opt_state))
    _assert_close_by_scale(payload["momentum"], dict(trace.named_parameters()), None, 1e-4,
                           "momentum")


def test_resumed_step_matches_jax_and_the_uninterrupted_step(runs):
    """Step 3 after a restore: the port's loss within 1e-5 relative of the
    JAX Trainer's restored step 3 (which repeats its own uninterrupted
    one); the port's resumed step equal to the bit to its uninterrupted
    step (the loss and every parameter and buffer after it); the fresh
    Trainer's step, start epoch and tensors' storage taken from and kept
    by the load."""
    r = runs
    np.testing.assert_allclose(r["j_resumed"], r["jlosses"][2], rtol=1e-6)
    np.testing.assert_allclose(r["t_resumed"], r["j_resumed"], rtol=1e-5)
    assert r["loaded"] == (2, SAVE_EPOCH, True)
    assert r["t_resumed"] == r["tlosses"][2]
    for k, v in r["uninterrupted"].items():
        assert torch.equal(r["resumed"][k], v), k


def test_predictor_and_submitctl_serve_the_checkpoint_like_jax(runs):
    """``Predictor.from_checkpoint`` of the port's checkpoint (device="cpu")
    against the JAX ``Predictor.from_checkpoint`` of the JAX one: scores on
    the same clips within 1e-4. ``SubmitCtl.load_checkpoint`` of each
    package (the port's swapping a random-weight Predictor for the
    checkpoint's) scores as its package's Predictor does."""
    from deepfake_tpu.parallel.mesh import make_mesh
    from deepfake_tpu.serving import Predictor as JPredictor
    from deepfake_tpu.train.submit import SubmitCtl as JCtl
    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.submit import SubmitCtl

    r = runs
    x = r["x"][:2]
    mesh = make_mesh(devices=jax.devices()[:1])
    jctl = JCtl(r["jmodel"], r["jcfg"], None, logger=lambda s: None,
                variables={"params": r["params0"]}, mesh=mesh)
    jctl.load_checkpoint(r["jpath"])
    jscores = np.asarray(jctl._fwd(jctl.variables, jctl._put(x)))
    # the JAX Predictor.predict raises for video_swin (the model returns
    # (scores, features)): its variables through the SubmitCtl's forward,
    # which keeps the scores (one compile for both)
    jpred = JPredictor.from_checkpoint(r["jcfg"], r["jpath"], mesh=mesh)
    want = np.asarray(jctl._fwd(jpred.variables, jctl._put(x)))
    got = Predictor.from_checkpoint(r["tcfg"], r["tpath"], device="cpu").predict(x)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(jscores, want, atol=1e-6, rtol=0)

    lines = []
    ctl = SubmitCtl(Predictor(r["tcfg"], device="cpu"), r["tcfg"], None, logger=lines.append)
    random_scores = ctl.predictor.predict(x)
    ctl.load_checkpoint(r["tpath"])
    assert ctl.predictor.device.type == "cpu" and ctl.predictor.graphs is None
    np.testing.assert_array_equal(ctl.predictor.predict(x), got)
    assert np.abs(random_scores - got).max() > 1e-3
    assert lines == [f"Load Finetuned Model From:{r['tpath']}"]


def test_serving_model_loads_the_training_state_strictly(runs):
    """A serving model (eval mode, built without the training switches) has
    the training model's persistent state, key for key and shape for shape,
    and a checkpoint's weights land in it before the inference caches: the
    SwinV2/Swin3D bias caches are those of the loaded weights."""
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.serving import Predictor

    r = runs
    payload = read_checkpoint(r["tpath"])
    serving = build_model(r["tcfg"], "cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in serving.items()} == {
        k: tuple(v.shape) for k, v in payload["model"].items()}
    pred = Predictor.from_checkpoint(r["tcfg"], r["tpath"], device="cpu")
    fresh = copy.deepcopy(pred.model)
    for mod, ref in zip(pred.model.modules(), fresh.modules()):
        if getattr(mod, "bias_cache", None) is not None:
            assert torch.equal(mod.bias_cache, ref.relative_bias())
    for k, v in pred.model.state_dict().items():
        assert torch.equal(v, payload["model"][k].to(v.dtype)), k
