"""The port's mesh at two CPU ranks (gloo, one spawn for the file), against
the port's own single-device run: one fused training step at (2, 1) and at
(1, 2); the InfoNCE alignment loss over the global batch at (2, 1);
batch-sharded serving (Predictor and SubmitCtl) at data 2 on a ragged batch,
and int8 serving (dynamic, and static after calibration) likewise;
the data module's loaders at data 2 (a step and evaluations, one at a batch
the data axis does not divide); the (2, 1) steps in float64 at 1e-10.
tests/torch_parallel_workers.py has the ranks' jobs and the tolerances;
tests/test_torch_parallel.py the (2, 2) mesh, the JAX step and the dry run.
Imports no JAX."""

import shutil

import numpy as np
import pytest
import torch

from tests import torch_parallel_workers as W

# the global-norm clip on (the step's gradient norm is ~346, so every
# gradient is scaled by ~0.29): at (1, 2) the norm sums the split
# gradients' squares over the model axis and counts the replicated ones once
CLIPPED = dict(W.TRAIN, **{"optim.grad_clip": 100.0})
SERVE = dict(W.SMALL_FUSED, **{
    "data.wave_seconds_buckets": (0.5, 1.0), "data.num_workers": 2, "optim.batch_size": 5})


def _synthetic_trainset(root):
    """4 train and 5 val clips whose waves last 0.2-0.8 s: the longest wave
    of a batch, and its bucket, differ between the data ranks' rows."""
    from scipy.io import wavfile

    from deepfake_tpu_torch.data.synthetic import make_synthetic_trainset

    make_synthetic_trainset(str(root), 4, 5, frames=6, size=96, seconds=0.5, seed=12)
    rng = np.random.default_rng(13)
    for split, lengths in (("trainset", (8000, 4800, 7200, 3200)),
                           ("valset", (8000, 4800, 12800, 4000, 9600))):
        for i, n in enumerate(lengths):
            wav = (rng.standard_normal(n) * 0.1 * 32767).astype(np.int16)
            wavfile.write(str(root / "phase1" / split / f"clip_{i}.wav"), 16000, wav)


def _one_device_loaders(over):
    """The ranks' ``loaders`` job on one device: the two evaluations, and the
    train loader's one yield as numpy."""
    from deepfake_tpu_torch.compiled import map_leaves
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.data.pipeline import ModelFeedLoader
    from deepfake_tpu_torch.train.trainer import Trainer

    out = {}
    for tag, o in (("eval", over), ("odd_eval", dict(over, **W.ODD_BATCH))):
        cfg = W.config(o)
        dm = DeepFakeDataModule(cfg, device="cpu").setup("fit")
        t = Trainer(W.port_model(cfg, "conditioned"), cfg, W.Batches(None, None),
                    logger=lambda line: None, device="cpu")
        out[tag] = t.eval(ModelFeedLoader(dm.val_dataloader(), cfg, False, device="cpu"))
        if tag == "eval":
            ((x, y),) = list(ModelFeedLoader(dm.train_dataloader(), cfg, True, device="cpu"))
            out["batch"] = map_leaves(lambda v: v.numpy(), x), y.numpy()
        del t
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two-rank job and, while it runs, the single-device references
    (W.reference); then each mesh step's verdict against them, and the
    ranks' serving results. The
    result files (hundreds of MB) are removed as they are read, the
    directory at the end."""
    from deepfake_tpu_torch.data.synthetic import make_synthetic_testset

    out = tmp_path_factory.mktemp("mesh2")
    root = out / "data"
    make_synthetic_testset(str(root), 5, frames=40, size=64, seconds=0.5, seed=11)
    _synthetic_trainset(out / "train")
    loader = dict(W.TRAIN, **{"data.data_root": str(out / "train"), "data.num_workers": 2,
                              "data.wave_seconds_buckets": (0.5, 1.0)})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = W.config(CLIPPED)
        x, y = W.batch()
        rng = np.random.default_rng(70)
        serve_x = (rng.standard_normal((5, 2, 96, 96, 3)).astype(np.float32),
                   rng.standard_normal((5, 56, 56, 3)).astype(np.float32),
                   (rng.standard_normal((5, 16000)).astype(np.float32),
                    np.asarray([9000, 16000, 12000, 8000, 15000], np.int64)))
        serve = dict(SERVE, **{"data.data_root": str(root)})
        eval_batch = (serve_x, np.asarray([0.0, 1.0, 1.0, 0.0, 1.0], np.float32))
        # int8 serving: frames at twice the calibration batch's scale, so the
        # static scales saturate
        int8_x = (2.0 * serve_x[0], serve_x[1], serve_x[2])
        torch.save({"overrides": CLIPPED, "x": x, "y": y, "serve": serve, "serve_x": serve_x,
                    "int8_x": int8_x, "eval": eval_batch, "csv": str(out / "mesh.csv"),
                    "loader": loader}, out / "setup.pt")
        # the single-device references while the ranks run, then their verdicts
        wait = W.spawn("job_mesh2", 2, str(out))
        start_params = dict(W.port_model(cfg, "conditioned").named_parameters())
        ref = {name: W.reference(W.config(over), "conditioned", x, y) for name, over in (
            ("plain", CLIPPED), ("align", W.ALIGN))}
        from deepfake_tpu_torch.train.trainer import Trainer

        evaluated = Trainer(W.port_model(cfg, "conditioned"), cfg, W.Batches(x, y),
                            logger=lambda line: None, device="cpu").eval([eval_batch])
        one = _one_device_loaders(loader)
        ref["loader"] = W.reference(W.config(loader), "conditioned", *one.pop("batch"))
        int8_one = W.int8_scores({"serve": serve, "serve_x": serve_x, "int8_x": int8_x})
        wait()
        res = {"align_differs": ref["align"][0]["loss"] != ref["plain"][0]["loss"]}
        for tag, name in (("mesh21", "plain"), ("mesh12", "plain"), ("remat12", "plain"),
                          ("align21", "align"), ("loader21", "loader")):
            got = W.take(out / f"{tag}.pt")
            res[tag] = W.verdict(W.check_step, got, *ref[name], start_params)
            if tag != "loader21":
                res[tag + "_sharded"] = bool(got["sharded"])
            del got
        del ref, start_params
        res["loaders"] = one
        res["serve"] = [torch.load(out / f"serve{r}.pt", weights_only=False) for r in (0, 1)]
        res["csv"] = [line.strip().split(",") for line in open(out / "mesh.csv") if line.strip()]
        res["serve_cfg"], res["serve_x"], res["eval"] = serve, serve_x, evaluated
        res["int8_one"] = int8_one
        W.release()
        yield res
    finally:
        torch.set_num_threads(n)
        shutil.rmtree(out, ignore_errors=True)


@pytest.mark.parametrize("mesh", ["mesh21", "mesh12"])
def test_mesh_step_matches_single_device(run, mesh):
    """(2, 1) and (1, 2), with the global-norm clip: the loss, every
    gradient, the weights after one step and every BatchNorm running
    statistic against the Trainer without a group (W.check_step's
    tolerances); (1, 2) splits the tensor-parallel weights of every SwinV2,
    wav2vec2 and head layer."""
    assert run[mesh] is None, run[mesh]
    assert run[mesh + "_sharded"] == (mesh == "mesh12")


def test_remat_mesh_step_matches_single_device(run):
    """(1, 2) with activation checkpointing on (``parallel.remat``, "dots"):
    every SwinV2 and wav2vec2 block runs its forward again in the backward,
    the split layers' all-reduces and gathers included, and the step equals
    one device's step without remat (W.check_step's tolerances)."""
    assert run["remat12"] is None, run["remat12"]
    assert run["remat12_sharded"]


def test_align_loss_over_the_global_batch(run):
    """With optim.use_align_loss at (2, 1) (temperature 0.1, W.ALIGN): the
    InfoNCE loss is taken over the global batch (the features gathered over
    the data axis) and its gradient comes back once (the gather's sum over
    ranks, then the gradient mean): loss, gradients, update and statistics
    as one device's."""
    assert run["align_differs"]
    assert run["align21"] is None, run["align21"]


def test_eval_over_the_data_axis_matches_one_device(run):
    """Trainer.eval at data 2 on a ragged batch of 5 (shard_eval_batch: padded
    to 6 with NaN labels, three rows a rank; the ranks' outputs gathered and
    the padding dropped): the loss, accuracy and AUC of one device's eval
    on both ranks, loss and accuracy within 1e-6 relative."""
    want = run["eval"]
    for got in run["serve"]:
        np.testing.assert_allclose([got["eval"]["loss"], got["eval"]["acc"]],
                                   [want["loss"], want["acc"]], rtol=1e-6)
        assert got["eval"]["auc"] == pytest.approx(want["auc"], rel=1e-6)


def test_batch_sharded_serving_matches_one_device(run, tmp_path):
    """At data 2: Predictor.predict on a ragged batch of 5 (padded to 6,
    three rows a rank, gathered and trimmed) and SubmitCtl over 5 clips in
    one batch of 5 give one device's scores in input order; rank 0 alone
    writes prediction.csv, and both ranks return the same result."""
    from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
    from deepfake_tpu_torch.serving import Predictor
    from deepfake_tpu_torch.train.submit import SubmitCtl

    cfg = W.config(run["serve_cfg"])
    pred = Predictor(cfg, device="cpu")
    want = pred.predict(run["serve_x"])
    csv = str(tmp_path / "one.csv")
    dm = DeepFakeDataModule(cfg, prediction_csv=csv, device="cpu").setup("test")
    want_result = SubmitCtl(pred, cfg, dm, logger=lambda line: None, prediction_csv=csv).submit()
    for got in run["serve"]:
        assert got["scores"].shape == (5,)
        np.testing.assert_allclose(got["scores"], want, rtol=0, atol=1e-5)
        assert list(got["result"]) == list(want_result)
        np.testing.assert_allclose(list(got["result"].values()), list(want_result.values()),
                                   rtol=0, atol=1e-5)
    assert [r[0] for r in run["csv"]] == list(want_result)


def test_inference_dropout_refuses_a_data_axis(run):
    """At data 2, ``model.parity_inference_dropout`` raises when the
    Predictor is built: every rank would reset one generator to one state
    and draw masks of its own rows' shape, so rank 1's rows would take rank
    0's masks and not those that one device's draw over the whole batch
    gives them."""
    for got in run["serve"]:
        assert got["inference_dropout"] is not None
        assert "parity_inference_dropout at a data axis of 2" in got["inference_dropout"]


@pytest.mark.parametrize("quant", W.INT8)
def test_batch_sharded_int8_serving_matches_one_device(run, quant):
    """At data 2, model.irv2_quant int8 and int8_static (every IRv2 conv
    int8), Predictor.predict on a ragged batch of 5 (padded by repeating its
    last row, which leaves a max unchanged): each int8 conv's per-tensor max
    is taken over both ranks' rows before it quantises (and, at calibration
    on the same ragged batch, before it is folded in). Both ranks give one
    device's fused scores within 1e-5 (the file's serving tolerance) and its
    fused and video logits within 1e-5 of their largest |logit|: the int8
    trunk is the same integer arithmetic on either side, and the rest
    differs by summation order (measured: 1.2e-7 and 2.7e-7 of it). A
    rank's own max in place of the global one moves the video logits by
    1.2e-2 of it, the fused ones by 2.0e-5 (measured in a copy without the
    all-reduce, where the scores still met 1e-5: their sigmoid near 0.5
    hides it)."""
    for modality in ("fused", "video"):
        want_scores, want_logits = run["int8_one"][modality, quant]
        assert want_scores.shape == (5,) and np.isfinite(want_logits).all()
        for got in run["serve"]:
            scores, logits = got["int8"][modality, quant]
            if modality == "fused":
                np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-5)
            np.testing.assert_allclose(logits, want_logits, rtol=0,
                                       atol=1e-5 * np.abs(want_logits).max())
    one = run["int8_one"]
    assert not np.array_equal(one["video", "int8"][1], one["video", "int8_static"][1])


def test_loaders_over_the_data_axis_match_one_device(run):
    """The data module's train and val loaders built with the (2, 1) mesh on
    a synthetic set whose waves last 0.2-0.8 s, at batch 2 x 2: one step
    from the train loader's yield (each rank decodes its slice of each
    micro-batch, waves padded to the largest bucket; the augmentation draws
    for the whole batch) against one device's step on its own loader's
    yield (W.check_step's tolerances), and the evaluation over the val
    loader (a ragged last batch padded; each batch's longest wave taken
    over both ranks) against one device's: loss and accuracy within 1e-6
    relative, and the AUC."""
    assert run["loader21"] is None, run["loader21"]
    want = run["loaders"]["eval"]
    for got in run["serve"]:
        got = got["loaders"]["eval"]
        np.testing.assert_allclose([got["loss"], got["acc"]], [want["loss"], want["acc"]],
                                   rtol=1e-6)
        assert got["auc"] == pytest.approx(want["auc"], rel=1e-6)


def test_eval_at_a_batch_the_data_axis_does_not_divide(run):
    """At batch 3 on data 2, where a training batch would be replicated on
    both ranks: the val loader pads each batch to 4, two rows a rank, and
    the model takes each batch's statistics (its longest wave) over both
    ranks: one device's loss and accuracy within 1e-6 relative, and its
    AUC."""
    want = run["loaders"]["odd_eval"]
    for got in run["serve"]:
        got = got["loaders"]["odd_eval"]
        np.testing.assert_allclose([got["loss"], got["acc"]], [want["loss"], want["acc"]],
                                   rtol=1e-6)
        assert got["auc"] == pytest.approx(want["auc"], rel=1e-6)


@pytest.mark.parametrize("rank", [0, 1], ids=["plain", "align"])
def test_float64_mesh_step_equals_one_device(run, rank):
    """The witness behind the f32 checks' conditioning and the align case's
    temperature 0.1: in float64 (W.float64), from the seeded weights with
    nothing conditioned, the (2, 1) step, plain and with the alignment loss
    at the preset's temperature 0.01, equals one device's step to 1e-10
    (W.check_float64). What the f32 checks leave to the spread is rounding."""
    losses = [r["witness"][0] for r in run["serve"]]
    assert losses[0] != losses[1]  # the alignment loss counts
    assert run["serve"][rank]["witness"][1] is None, run["serve"][rank]["witness"][1]
