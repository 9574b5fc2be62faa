"""The port's mesh at four CPU ranks (gloo; one spawn for the (2, 2) mesh and
one for the dry run) against the port's single-device Trainer and the JAX
package's single-device step, and the set of parameters the port splits
against the JAX rules. The JAX mesh computes what its one-device mesh
computes (tests/test_parallel.py:148-181), so the (2, 2) step held to the
JAX one-device step holds the port against the JAX mesh without running
the slow 8-device JAX step: one JAX trace in the file.
tests/torch_parallel_workers.py has the ranks' jobs and the tolerances;
tests/test_torch_parallel_dp.py the two-rank meshes and serving."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_workers as W
from tests.torch_fused_train_helpers import OVERRIDES, _batch, _jax_fused, _jax_trainer
from tests.torch_port_helpers import both_configs, random_variables


def _condition(params):
    """The JAX tree conditioned as W.condition conditions the port's:
    IRv2's BatchNorm biases + 3, W.CONDITION's shifts."""
    from tests.torch_fused_train_helpers import _shift_irv2_bn

    _shift_irv2_bn(params["video_extractor"]["inception"])
    for name, shift in W.CONDITION.items():
        *path, leaf = name.split(".")
        node = params
        for k in path:
            node = node[k]
        node[leaf] = node[leaf] + np.float32(shift)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The (2, 2) job and, while its ranks run, the JAX step from the same
    carried-across weights; then the port's single-device step with its
    spread (W.reference) and each check's verdict, computed as the ranks'
    result files are read (each removed as it is read, the directory at the
    end: they are hundreds of MB)."""
    from deepfake_tpu.train.trainer import TrainState
    from deepfake_tpu_torch.io.checkpoint import read_checkpoint, save_checkpoint

    out = tmp_path_factory.mktemp("mesh22")
    jcfg, _ = both_configs(OVERRIDES)
    x, y = _batch()
    x = (x[0], x[1], (x[2][0], x[2][1].astype(np.int64)))
    jmodel = _jax_fused(jcfg)
    one = (jnp.asarray(x[0][:1]), jnp.asarray(x[1][:1]), jnp.asarray(x[2][0][:1]))
    start = random_variables(jmodel, one, seed=61, train=False, deterministic=True)
    _condition(start["params"])
    over = dict(W.TRAIN, **{"log.ckpt_dir": str(out / "ckpt")})
    cfg = W.config(over)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # a single-device checkpoint after one step, for the ranks to load
        trainer = W.single_step(cfg, start, x, y)[1]
        single_ckpt = save_checkpoint(str(out / "single" / "ckpt"), trainer)
        del trainer
        torch.save({"overrides": over, "start": start, "x": x, "y": y,
                    "single_ckpt": single_ckpt}, out / "setup.pt")
        # the JAX step while the ranks run, the port's reference runs after
        # them: four ranks of ~2.5 GB beside both would hold ~14 GB at once
        wait = W.spawn("job_mesh22", 4, str(out))
        # the JAX step (plain route, flax's two-pass BatchNorm variance)
        import flax.linen.normalization as N

        jt = _jax_trainer(jmodel, jcfg)
        with pytest.MonkeyPatch.context() as mp:
            one_pass = N._compute_stats
            mp.setattr(N, "_compute_stats",
                       lambda *a, **kw: one_pass(*a, **dict(kw, use_fast_variance=False)))
            mp.delenv("DEEPFAKE_TPU_2D_TRAIN_KERNEL", raising=False)
            params0 = jax.tree.map(jnp.asarray, start["params"])
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params0,
                               batch_stats=jax.tree.map(jnp.asarray, start["batch_stats"]),
                               opt_state=jt.tx.init(params0))
            state, metrics = jax.jit(jt._train_step_impl)(
                state, *jax.tree.map(jnp.asarray, (x, y)), jax.random.PRNGKey(0))
        jax_end = {"params": jax.device_get(state.params),
                   "batch_stats": jax.device_get(state.batch_stats)}
        del state, params0, jt
        jax.clear_caches()  # the fused step's executable: hundreds of MB
        wait()
        base, spread = W.reference(cfg, start, x, y)
        start_params = dict(W.port_model(cfg, start).named_parameters())

        res = {}
        got = W.take(out / "mesh22.pt")
        res["sharded"] = bool(got["sharded"])
        res["single"] = W.verdict(W.check_step, got, base, spread, start_params)
        del base
        res["jax"] = W.verdict(_check_jax, got, float(metrics["loss"]), W.port_model(cfg, jax_end),
                               spread, start_params)
        del jax_end, start_params
        (path,) = list((out / "ckpt").iterdir())
        res["ckpt_to_one"] = W.verdict(_check_ckpt_to_one, str(path), got["params"], cfg, start)
        del got
        os.remove(path)
        res["one_to_mesh"] = W.verdict(_check_one_to_mesh, W.take(out / "loaded22.pt"),
                                       read_checkpoint(single_ckpt))
        res["dropout"] = W.take(out / "dropout22.pt")
        del start, x, y, jmodel, metrics
        W.release()
        yield res
    finally:
        torch.set_num_threads(n)
        shutil.rmtree(out, ignore_errors=True)


def _check_jax(got, want_loss, ref_model, spread, old):
    """The (2, 2) step against the JAX step's: the loss within 1e-5
    relative, every parameter's update within 1e-4 of its largest |update|,
    every BatchNorm statistic within 1e-5 of max(1, |value|); each, where
    larger, within 4x the port's own spread."""
    sp = spread["loss",]
    assert abs(got["loss"] - want_loss) <= max(1e-5 * abs(want_loss), W.SPREAD * sp), (
        got["loss"], want_loss)
    ref = dict(ref_model.named_parameters())
    for name, p in got["params"].items():
        upd, want_upd = p - old[name], (ref[name] - old[name]).detach()
        big = want_upd.abs().max().item()
        err = (upd - want_upd).abs().max().item()
        sp = spread["params", name]
        assert err <= max(1e-4 * big, W.SPREAD * sp), (name, err, big, sp)
    for name, w in W.stats(ref_model).items():
        sp = spread["stats", name]
        err = (got["stats"][name] - w).abs().max().item()
        assert err <= max(1e-5 * max(1.0, w.abs().max().item()), W.SPREAD * sp), (name, err, sp)


def _check_ckpt_to_one(path, params, cfg, start):
    """The (2, 2) checkpoint on one device: step 1, the (2, 2) weights."""
    from deepfake_tpu_torch.train.trainer import Trainer

    t = Trainer(W.port_model(cfg, start), cfg, W.Batches(None, None), logger=lambda line: None,
                device="cpu")
    t.load_ckpt(path)
    assert t.step == 1
    for name, p in t.model.named_parameters():
        assert torch.equal(p, params[name]), name


def _check_one_to_mesh(loaded, payload):
    """The single-device checkpoint on the (2, 2) mesh: its weights,
    momentum and step, gathered from the ranks' slices."""
    assert loaded["step"] == payload["step"] == 1
    for name, p in loaded["params"].items():
        assert torch.equal(p, payload["model"][name]), name
    for name, b in loaded["momentum"].items():
        assert torch.equal(b, payload["momentum"][name]), name


def test_mesh22_step_matches_single_device(run):
    """(2, 2): the loss, every gradient, the weights after one step and every
    BatchNorm running statistic against the Trainer without a group
    (W.check_step's tolerances)."""
    assert run["sharded"]
    assert run["single"] is None, run["single"]


def test_mesh22_step_matches_the_jax_step(run):
    """(2, 2) against the JAX Trainer's one-device step on the carried-across
    weights (_check_jax's tolerances)."""
    assert run["jax"] is None, run["jax"]


def test_dropout_masks_keep_the_ranks_consistent(run):
    """Dropouts on (every rate at its default, classify_drop and swin_drop
    0.1), two steps at (2, 2): every replicated parameter is the same on all
    four ranks, and every split parameter the same on the two data ranks of
    its model index (the model ranks of a data rank draw the same masks)."""
    every = run["dropout"]
    assert len(every) == 4
    n_split = 0
    for name, (split, _, _) in every[0].items():
        if split:
            n_split += 1
            for m in (0, 1):
                assert len({r[name][2] for r in every if r[name][1] == m}) == 1, name
            assert every[0][name][2] != every[1][name][2], name  # other slices
        else:
            assert len({r[name][2] for r in every}) == 1, name
    assert n_split > 0


def test_checkpoints_do_not_depend_on_the_mesh(run):
    """A checkpoint saved at (2, 2) holds whole tensors and loads on one
    device with the (2, 2) step's weights; the single-device checkpoint
    loads onto the (2, 2) mesh with its weights, momentum and step."""
    assert run["ckpt_to_one"] is None, run["ckpt_to_one"]
    assert run["one_to_mesh"] is None, run["one_to_mesh"]


def _jax_split(jmodel, inputs, kw):
    """The JAX names the JAX rules split over a model axis of 2, as the
    port's parameter names."""
    from deepfake_tpu.parallel.mesh import _path_names, _spec_for

    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *inputs, **kw))
    out = set()
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        path = _path_names(kp)
        if _spec_for(path, leaf, 2) != jax.sharding.PartitionSpec():
            leaf_name = "qkv_weight" if path[-1] == "qkv_kernel" else "weight"
            out.add(".".join(path[:-1] + (leaf_name,)))
    return out


def _stub_mesh():
    """A (1, 2) mesh's rank 0 without a group: construction only."""
    from deepfake_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh.__new__(Mesh)
    mesh.world, mesh.rank, mesh.data, mesh.model, mesh.d, mesh.m = 2, 0, 1, 2, 0, 0
    mesh.model_group = mesh.data_group = None
    mesh.sharded, mesh.batch_sharded = {}, True
    return mesh


@pytest.mark.parametrize("modality", ["fused", "video_swin", "video_swin_attention"])
def test_split_parameters_are_the_jax_rules(modality):
    """The parameters the port splits over a model axis of 2 are those the
    JAX param_shardings splits on the JAX tree of the same model, less the
    attention layers whose heads do not divide over it (head_exceptions:
    Video Swin's one-head stage here, replicated in the port), by
    construction. Each split weight keeps half its rows or columns.
    ``video_swin_attention``: Video Swin with the attention-pooling head,
    whose encoder layers' out_proj the rules row-split beside a whole
    in_proj."""
    from deepfake_tpu.models.registry import build_model as jax_build, example_inputs
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.parallel.mesh import head_exceptions, shard_model
    from tests.test_torch_swin3d import SMALL_VIDEO_SWIN

    over = W.TRAIN if modality == "fused" else dict(
        SMALL_VIDEO_SWIN, **({"model.video_pool": "Attention"} if modality.endswith("attention")
                             else {}))
    jcfg, tcfg = both_configs(over)
    if modality == "fused":
        jmodel, kw = _jax_fused(jcfg), {"deterministic": True, "train": False}
    else:
        jmodel, kw = jax_build(jcfg), {"deterministic": True}
    want = _jax_split(jmodel, example_inputs(jcfg, batch=1), kw)
    model = build_model(tcfg, "cpu", train=True)
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    exceptions = head_exceptions(model, 2)
    mesh = _stub_mesh()
    shard_model(model, mesh)
    assert set(mesh.sharded) == {n for n in want
                                 if not any(n.startswith(e + ".") for e in exceptions)}
    assert bool(exceptions) == (modality != "fused")
    assert all(any(n.startswith(e + ".") for e in exceptions) for n in want - set(mesh.sharded))
    for name, p in model.named_parameters():
        if name in mesh.sharded:
            dim = mesh.sharded[name][0]
            assert p.shape[dim] * 2 == full[name][dim], name
        else:
            assert tuple(p.shape) == full[name], name


def test_dryrun_multichip_at_four_ranks(capfd, monkeypatch):
    """The dry run at its small-host shapes: one fused step over a (2 data,
    2 model) mesh of four CPU processes, a finite loss, every rank's
    parameters consistent."""
    from deepfake_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setenv("DEEPFAKE_TPU_DRYRUN_TOY", "1")
    dryrun_multichip(4)
    line = [s for s in capfd.readouterr().out.splitlines() if s.startswith("dryrun_multichip")]
    assert len(line) == 1 and line[0].startswith("dryrun_multichip(4): mesh=(2 data, 2 model), "
                                                 "loss=") and line[0].endswith(" OK"), line
