"""SubmitCtl, Predictor.score_file and the inference CLI of the port against
the JAX package's on the same synthetic test set and the same weights (the
JAX tree carried across), on the CPU: ``audio`` (SwinV2 at window 16) and
``video_swin`` at the small geometries of tests/test_torch_audio.py and
tests/test_torch_swin3d.py, and ``fused`` at the tiny fused geometry. The
JAX side runs on one CPU device on its default (non-Pallas) routes; the
port's kernel routes take the kernels' plain versions on the CPU. f32."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_audio import SMALL_AUDIO_W16
from tests.test_torch_swin3d import SMALL_VIDEO_SWIN
from tests.torch_port_helpers import SMALL_FUSED, both_configs, random_variables

from deepfake_tpu_torch.data.dataset import DeepFakeDataModule
from deepfake_tpu_torch.serving import Predictor
from deepfake_tpu_torch.train.submit import SubmitCtl, pad_rows

N_CLIPS = 5
GEOMETRIES = {
    "audio": SMALL_AUDIO_W16,
    "video_swin": dict(SMALL_VIDEO_SWIN, **{"model.swin3d_drop_path": 0.0}),
    "fused": SMALL_FUSED,
}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """5 clips of 40 frames at 64^2 with 0.5 s PCM sidecars."""
    from deepfake_tpu_torch.data.synthetic import make_synthetic_testset

    root = tmp_path_factory.mktemp("submit")
    make_synthetic_testset(str(root), N_CLIPS, frames=40, size=64, seconds=0.5, seed=11)
    return root


def _configs(modality, root):
    over = dict(GEOMETRIES[modality], **{
        "data.data_root": str(root), "data.wave_seconds_buckets": (0.5, 1.0),
        "data.num_workers": 2, "optim.batch_size": 2, "data.chunk_frames": 16,
        "data.chunk_stride": 8, "log.log_step": 1})
    jcfg, tcfg = both_configs(over)
    jcfg.data.use_native_ingest = False
    jcfg.model.swin3d_pallas_attn = False
    return jcfg, tcfg


def _variables(jcfg, seed):
    from deepfake_tpu.models.registry import build_model, example_inputs

    model = build_model(jcfg)
    return model, random_variables(model, *example_inputs(jcfg, batch=1), deterministic=True,
                                   seed=seed)


def _jax_ctl(jcfg, model, variables, csv, logs, names=None):
    from deepfake_tpu.data.dataset import DeepFakeDataModule as JDM
    from deepfake_tpu.parallel.mesh import make_mesh
    from deepfake_tpu.train.submit import SubmitCtl as JCtl

    dm = JDM(jcfg, prediction_csv=csv).setup("test")
    if names is not None:
        dm.testset.names = dm.testset.names[:names]
    return JCtl(model, jcfg, dm, logger=logs.append, variables=variables, prediction_csv=csv,
                mesh=make_mesh(data=1, model=1, devices=jax.devices()[:1]))


def _port_ctl(tcfg, pred, csv, logs, names=None):
    dm = DeepFakeDataModule(tcfg, prediction_csv=csv, device="cpu").setup("test")
    if names is not None:
        dm.testset.names = dm.testset.names[:names]
    return SubmitCtl(pred, tcfg, dm, logger=logs.append, prediction_csv=csv)


def _rows(csv):
    return [line.strip().split(",") for line in open(csv) if line.strip()]


@pytest.mark.parametrize("modality", ["audio", "video_swin", "fused"])
def test_submit_matches_jax(data_root, tmp_path, modality):
    """prediction.csv from the port's SubmitCtl against the JAX SubmitCtl's:
    the same names in the same order, scores within 1e-4, the same returned
    dict and the same progress lines. Batches of 2 over the 5 clips (2, 2
    and a ragged 1, which the port pads to 2; fused over 4 clips)."""
    jcfg, tcfg = _configs(modality, data_root)
    model, variables = _variables(jcfg, seed=40)
    names = 4 if modality == "fused" else None
    jlogs, tlogs = [], []
    jcsv, tcsv = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    want = _jax_ctl(jcfg, model, variables, jcsv, jlogs, names).submit()
    got = _port_ctl(tcfg, Predictor(tcfg, variables, device="cpu"), tcsv, tlogs, names).submit()
    jrows, trows = _rows(jcsv), _rows(tcsv)
    assert [r[0] for r in trows] == [r[0] for r in jrows] == list(want) == list(got)
    assert len(trows) == (names or N_CLIPS)
    np.testing.assert_allclose([float(r[1]) for r in trows], [float(r[1]) for r in jrows],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(list(got.values()), list(want.values()), atol=1e-4, rtol=0)
    assert [float(r[1]) for r in trows] == [float(np.float32(v)) for v in got.values()]
    strip = lambda logs: [s for s in logs if "Rate%" in s or "Done" in s]
    assert strip(tlogs) == strip(jlogs) and len(strip(tlogs)) == len(trows) // 2 + (
        len(trows) % 2) + 1


def test_submit_resume_writes_each_file_once(data_root, tmp_path, monkeypatch):
    """A run stopped after its first batch, then a second run: prediction.csv
    holds each of the 5 names once, with the scores of an uninterrupted run;
    the second run's prediction_full.csv holds its own 3 rows (the JAX
    package's behaviour after a resume)."""
    _, tcfg = _configs("video_swin", data_root)
    pred = Predictor(tcfg, device="cpu")
    whole = str(tmp_path / "whole.csv")
    _port_ctl(tcfg, pred, whole, []).submit()
    csv = str(tmp_path / "prediction.csv")
    calls = []
    real = pred.predict_raw

    def stop_after_one(feats):
        if calls:
            raise KeyboardInterrupt
        calls.append(1)
        return real(feats)

    monkeypatch.setattr(pred, "predict_raw", stop_after_one)
    with pytest.raises(KeyboardInterrupt):
        _port_ctl(tcfg, pred, csv, []).submit()
    assert [r[0] for r in _rows(csv)] == ["clip_0.mp4", "clip_1.mp4"]
    monkeypatch.setattr(pred, "predict_raw", real)
    ctl = _port_ctl(tcfg, pred, csv, [])
    assert ctl.data.testset.names == ["clip_2.mp4", "clip_3.mp4", "clip_4.mp4"]
    result = ctl.submit()
    assert _rows(csv) == _rows(whole)
    full = str(tmp_path / "prediction_full.csv")
    ctl.write_full(result, full)
    lines = open(full).read().splitlines()
    assert lines[0] == "video_name,y_pred" and [l.split(",")[0] for l in lines[1:]] == list(result)
    assert len(lines) == 4


@pytest.mark.parametrize("modality,rows", [("fused", 1), ("fused", 3), ("paudio", 3)])
def test_padded_ragged_batch_gives_the_unpadded_scores(modality, rows):
    """A ragged batch padded to 4 rows by repeating its last row gives its
    real rows the scores of the unpadded batch within 1e-6 (the longest
    valid wave length, which batch_longest normalisation and wav2vec2's
    frame mask read, does not change), waves of different lengths."""
    from tests.test_torch_audio import _pcm

    _, tcfg = both_configs(dict(SMALL_FUSED, **{"data.modality": modality}))
    pred = Predictor(tcfg, device="cpu")
    wave, lengths = _pcm(rows, 16000, 70 + rows)
    lengths[-1] = 11000  # the longest row is not the repeated one
    lengths[0] = 16000 if rows > 1 else lengths[0]
    wave[np.arange(16000)[None] >= lengths[:, None]] = 0.0
    feats = {"paudio_wave": wave, "paudio_len": lengths}
    if modality == "fused":
        feats.update(video=np.random.default_rng(72).integers(0, 256, (rows, 2, 96, 96, 3),
                                                              np.uint8),
                     audio_wave=wave, audio_len=lengths)
    padded = pad_rows(feats, 4)
    assert all(v.shape[0] == 4 for v in padded.values())
    np.testing.assert_allclose(pred.predict_raw(padded)[:rows], pred.predict_raw(feats),
                               atol=1e-6, rtol=0)
    tpad = pad_rows({k: torch.from_numpy(np.asarray(v)) for k, v in feats.items()}, 4)
    for k in feats:
        np.testing.assert_array_equal(tpad[k].numpy(), padded[k])


def test_long_video_scoring_matches_jax(data_root, tmp_path):
    """video_swin: score_long_video on one 40-frame clip (windows of 16 every
    8: 4 windows, one batch padded to 8) with mean, max and top3, and
    submit_chunked over 2 clips, against the JAX SubmitCtl: within 1e-4;
    the port's mean equals the mean of predict_raw over the same windows."""
    from deepfake_tpu_torch.data.chunking import chunk_frames
    from deepfake_tpu_torch.data.video_decode import sequential_frames

    jcfg, tcfg = _configs("video_swin", data_root)
    model, variables = _variables(jcfg, seed=41)
    pred = Predictor(tcfg, variables, device="cpu")
    jctl = _jax_ctl(jcfg, model, variables, str(tmp_path / "j.csv"), [], names=2)
    tctl = _port_ctl(tcfg, pred, str(tmp_path / "t.csv"), [], names=2)
    path = str(data_root / "phase2" / "testset1seen" / "clip_3.mp4")
    for agg in ("mean", "max", "top3"):
        np.testing.assert_allclose(tctl.score_long_video(path, agg), jctl.score_long_video(path, agg),
                                   atol=1e-4, rtol=0)
    windows = chunk_frames(sequential_frames(path, 56), 16, 8)
    assert windows.shape[0] == 4
    assert tctl.score_long_video(path) == float(np.float32(pred.predict_raw(
        {"video": windows}).mean()))
    from deepfake_tpu_torch.data.video_decode import extract_frames

    assert pred.score_file(path) == float(pred.predict_raw(
        {"video": extract_frames(path, 16, 56)[None]})[0])
    want, got = jctl.submit_chunked(), tctl.submit_chunked()
    assert list(got) == list(want) == ["clip_0.mp4", "clip_1.mp4"]
    np.testing.assert_allclose(list(got.values()), list(want.values()), atol=1e-4, rtol=0)
    assert [r[0] for r in _rows(str(tmp_path / "t.csv"))] == list(got)
    with pytest.raises(ValueError, match="needs audio"):
        _port_ctl(both_configs(dict(SMALL_FUSED, **{"data.data_root": str(data_root)}))[1],
                  None, str(tmp_path / "f.csv"), []).score_frames(windows[0])


@pytest.mark.parametrize("modality", ["audio", "paudio"])
def test_score_file_matches_jax(data_root, modality):
    """Predictor.score_file (PCM from the sidecar, predict_raw at batch 1)
    against the JAX Predictor.score_file: within 1e-4. (The JAX one raises
    for video_swin, whose model returns a tuple; the port's video_swin
    score_file is held to predict_raw in test_long_video_scoring_matches_jax.)"""
    from deepfake_tpu.serving import Predictor as JPredictor

    jcfg, tcfg = _configs(modality, data_root) if modality == "audio" else both_configs(dict(
        SMALL_FUSED, **{"data.modality": "paudio", "data.wave_seconds_buckets": (0.5, 1.0)}))
    _, variables = _variables(jcfg, seed=42)
    path = str(data_root / "phase2" / "testset1seen" / "clip_2.mp4")
    want = JPredictor(jcfg, variables).score_file(path)
    got = Predictor(tcfg, variables, device="cpu").score_file(path)
    assert isinstance(got, float) and np.isfinite(got)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _audio_checkpoint(tcfg, variables, path):
    """A training checkpoint (``save_checkpoint`` of a Trainer that took no
    step) of the port's audio model holding the JAX ``variables``."""
    from deepfake_tpu_torch.io.checkpoint import save_checkpoint
    from deepfake_tpu_torch.io.jax_weights import load_jax_variables
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.trainer import Trainer

    class NoBatches:
        def train_loader(self):
            return []

    model = load_jax_variables(build_model(tcfg, "cpu", train=True), variables)
    trainer = Trainer(model, tcfg, NoBatches(), logger=lambda s: None, device="cpu")
    return save_checkpoint(str(path), trainer)


def test_checkpoint_loading_is_not_ported(data_root, tmp_path):
    """What is not ported raises: the reference .pth import (it waits for
    reference files) and int8 calibration (ROADMAP A7). The port's own
    checkpoints load: ``SubmitCtl.load_checkpoint`` swaps the random-weight
    Predictor for one serving the checkpoint's weights, whose submission
    equals, to the bit, that of a Predictor built on the same weights."""
    jcfg, tcfg = _configs("audio", data_root)
    _, variables = _variables(jcfg, seed=46)
    path = _audio_checkpoint(tcfg, variables, tmp_path / "ckpt")
    lines = []
    ctl = _port_ctl(tcfg, Predictor(tcfg, device="cpu"), str(tmp_path / "t.csv"), lines)
    with pytest.raises(NotImplementedError, match="reference files"):
        ctl.load_reference_pth("x.pth")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ctl.calibrate([])
    old = ctl.predictor
    ctl.load_checkpoint(path)
    assert ctl.predictor is not old and ctl.predictor.device.type == "cpu"
    assert f"Load Finetuned Model From:{path}" in lines
    got = ctl.submit()
    want = _port_ctl(tcfg, Predictor(tcfg, variables, device="cpu"), str(tmp_path / "w.csv"),
                     []).submit()
    assert list(got) == list(want) and list(got.values()) == list(want.values())
    assert _rows(tmp_path / "t.csv") == _rows(tmp_path / "w.csv")


CLI_SET = ["--set", "data.num_frames=16", "--set", "data.frame_size=56",
           "--set", "model.swin3d_embed_dim=32", "--set", "model.swin3d_depths=[2, 2]",
           "--set", "model.swin3d_heads=[1, 2]", "--set", "model.num_hiddens=16",
           "--set", "parallel.compute_dtype=float32",
           "--set", "data.wave_seconds_buckets=[0.5, 1.0]"]


def test_cli_on_the_cpu_writes_both_csvs(data_root, tmp_path):
    """``python -m deepfake_tpu_torch.test -cuda False`` in a subprocess:
    prediction.csv and prediction_full.csv with the 5 clips, in order, and
    the scores of a SubmitCtl run in this process on the same config."""
    argv = ["--preset", "video_swin", "--data_root", str(data_root), "-b", "2", "-cuda",
            "False", *CLI_SET]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    res = subprocess.run([sys.executable, "-m", "deepfake_tpu_torch.test", *argv],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rows = _rows(tmp_path / "prediction.csv")
    full = _rows(tmp_path / "prediction_full.csv")
    assert [r[0] for r in rows] == [f"clip_{i}.mp4" for i in range(N_CLIPS)]
    assert full[0] == ["video_name", "y_pred"] and full[1:] == rows
    assert "Test Score Prediction Done" in res.stdout

    from deepfake_tpu_torch.config import get_config

    cfg = get_config(argv)
    csv = str(tmp_path / "here.csv")
    _port_ctl(cfg, Predictor(cfg, device="cpu"), csv, []).submit()
    assert _rows(csv) == rows


def test_cli_needs_a_card_unless_asked_for_the_cpu(data_root, tmp_path, monkeypatch):
    """Without ``-cuda False`` on a machine with no card the CLI raises, and
    --Resume with a reference .pth raises (it waits for reference files);
    neither writes a CSV. ``-cuda False --Resume --audio_ckpt_path`` with a
    training checkpoint scores with the checkpoint's weights: the CSV of a
    SubmitCtl over a Predictor built on those weights, to the bit."""
    import dataclasses
    import json

    from deepfake_tpu_torch import test as cli
    from deepfake_tpu_torch.config import get_config

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--preset", "video_swin", "--data_root", str(data_root), *CLI_SET]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    with pytest.raises(NotImplementedError, match="reference files"):
        cli.main(["--preset", "fused", "--Resume", "--fused_ckpt_path", "fused.pth",
                  "-cuda", "False"])
    assert not os.path.exists(tmp_path / "prediction.csv")

    jcfg, tcfg = _configs("audio", data_root)
    _, variables = _variables(jcfg, seed=47)
    path = _audio_checkpoint(tcfg, variables, tmp_path / "ckpt")
    argv = ["-cuda", "False", "--Resume", "--audio_ckpt_path", path]
    for group in (GEOMETRIES["audio"], {"data.data_root": str(data_root),
                                        "data.wave_seconds_buckets": (0.5, 1.0),
                                        "data.num_workers": 2, "optim.batch_size": 2,
                                        "data.chunk_frames": 16, "data.chunk_stride": 8}):
        for k, v in group.items():
            argv += ["--set", f"{k}={json.dumps(list(v) if isinstance(v, tuple) else v)}"]
    cfg = get_config(argv)
    as_json = lambda c: json.loads(json.dumps(dataclasses.asdict(c)))  # lists for tuples
    assert cfg.model.resume and cfg.model.audio_ckpt_path == path
    assert as_json(cfg.data) == as_json(tcfg.data)
    assert as_json(dataclasses.replace(cfg.model, resume=False, audio_ckpt_path=None)) == \
        as_json(tcfg.model)
    got = cli.main(argv)
    want = _port_ctl(tcfg, Predictor(tcfg, variables, device="cpu"), str(tmp_path / "w.csv"),
                     []).submit()
    assert list(got) == list(want) and list(got.values()) == list(want.values())
    assert _rows(tmp_path / "prediction.csv") == _rows(tmp_path / "w.csv")


def test_prefetcher_and_feed_loader_on_the_cpu(data_root):
    """On the CPU the prefetcher passes the loader's batches through, and
    ModelFeedLoader yields the FeatureAssembler's inputs of each batch."""
    from deepfake_tpu_torch.data.pipeline import (
        DevicePrefetcher, FeatureAssembler, ModelFeedLoader,
    )

    _, tcfg = _configs("video_swin", data_root)
    dm = DeepFakeDataModule(tcfg, "none.csv", device="cpu").setup("test")
    batches = list(dm.test_dataloader())
    got = list(DevicePrefetcher(dm.test_dataloader(), "cpu"))
    assert len(got) == len(batches) == 3
    for (a, la, na), (b, lb, nb) in zip(got, batches):
        assert na == nb
        np.testing.assert_array_equal(a["video"], b["video"])
    fed = list(ModelFeedLoader(dm.test_dataloader(), tcfg, train=False, device="cpu"))
    assembler = FeatureAssembler(tcfg, device="cpu")
    for (inputs, labels), (feats, lab, _n) in zip(fed, batches):
        want, _ = assembler(feats, lab)
        assert torch.equal(inputs, want) and labels.shape == (len(_n),)
