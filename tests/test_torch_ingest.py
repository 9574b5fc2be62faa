"""The port's data modules against the JAX package's on the same files, on
the CPU: video decode (seek and sequential sampling, and every frame for
long videos), PCM from sidecars, bucket padding, long-video chunking, the
label and prediction CSVs, the dataset's features for every modality (the
mel-JPEG path included), collate, the mel JPEGs themselves and the CLI's
config. Clips are small (6 to 24 frames of 64^2, 0.5 s of PCM), written by
the JAX package's synthetic test-set generator from a seed."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's modules run on the CPU)

from deepfake_tpu.data import audio_io as jio
from deepfake_tpu.data import chunking as jchunk
from deepfake_tpu.data import dataset as jds
from deepfake_tpu.data import video_decode as jvd
from deepfake_tpu_torch.data import audio_io as tio
from deepfake_tpu_torch.data import chunking as tchunk
from deepfake_tpu_torch.data import dataset as tds
from deepfake_tpu_torch.data import video_decode as tvd

from tests.torch_port_helpers import both_configs

N_CLIPS = 5


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A test split of N_CLIPS clips (24 frames of 64^2 and 0.5 s sidecars)
    and a train and a val split of copies of them, with labels."""
    from deepfake_tpu.data.synthetic import make_synthetic_testset

    root = tmp_path_factory.mktemp("ingest")
    names = make_synthetic_testset(str(root), N_CLIPS, frames=24, size=64, seconds=0.5, seed=3)
    test_dir = root / "phase2" / "testset1seen"
    for split, label_file, n in (("trainset", "train_label.txt", 4), ("valset", "val_label.txt", 2)):
        d = root / "phase1" / split
        d.mkdir(parents=True)
        with open(root / label_file, "w") as f:
            f.write("video_name,target\n")
            for i, name in enumerate(names[:n]):
                for ext in (".mp4", ".wav"):
                    shutil.copy(test_dir / (name[:-4] + ext), d / (name[:-4] + ext))
                f.write(f"{name},{i % 2}\n")
    return root


def _clip(root, i=0):
    return str(root / "phase2" / "testset1seen" / f"clip_{i}.mp4")


def _cfgs(root, modality, **over):
    base = {"data.data_root": str(root), "data.modality": modality, "data.num_frames": 4,
            "data.frame_size": 48, "data.audio_size": 56, "data.wave_seconds_buckets": (0.5, 1.0),
            "optim.batch_size": 2, "optim.accum_step": 1}
    base.update(over)
    return both_configs(base)


def test_synthetic_testset_matches_jax(tmp_path, data_root):
    """The port's generator writes the same names, CSV and PCM as the JAX
    one from the same seed, and clips that decode to the same frames."""
    from deepfake_tpu_torch.data.synthetic import make_synthetic_testset

    names = make_synthetic_testset(str(tmp_path), N_CLIPS, frames=24, size=64, seconds=0.5,
                                   seed=3)
    assert names == [f"clip_{i}.mp4" for i in range(N_CLIPS)]
    for rel in ("phase2/prediction.txt.csv", "phase2/testset1seen/clip_1.wav"):
        assert (tmp_path / rel).read_bytes() == (data_root / rel).read_bytes()
    np.testing.assert_array_equal(tvd.sequential_frames(str(tmp_path / "phase2/testset1seen/clip_1.mp4"), 64),
                                  tvd.sequential_frames(_clip(data_root, 1), 64))


@pytest.mark.parametrize("num_frames,size", [(4, 48), (8, 32), (32, 40)],
                         ids=["4f", "8f", "32f_short_clip"])
def test_extract_frames_matches_jax(data_root, num_frames, size):
    """``extract_frames`` by seek gives the JAX package's uint8 bits (32
    frames of a 24-frame clip: the last one repeated); ``sequential`` keeps
    the same frames by one pass over the stream, as the JAX package's
    native df_decode_clip_seq does (held to it where that library is
    built)."""
    from deepfake_tpu import native

    path = _clip(data_root, 2)
    want = jvd.extract_frames(path, num_frames, size, method="seek")
    got = tvd.extract_frames(path, num_frames, size, method="seek")
    assert got.dtype == np.uint8 and got.shape == (num_frames, size, size, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvd.extract_frames(path, num_frames, size, "sequential"), want)
    if native.available():
        np.testing.assert_array_equal(tvd.extract_frames(path, num_frames, size, "sequential"),
                                      native.decode_clip(path, num_frames, size, "sequential"))


def test_unreadable_file_gives_zeros_as_jax(tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    for method in ("seek", "sequential"):
        got = tvd.extract_frames(str(bad), 3, 16, method)
        assert got.shape == (3, 16, 16, 3) and not got.any()
    assert not jvd.extract_frames(str(bad), 3, 16).any()
    assert tvd.sequential_frames(str(bad), 16).shape == (0, 16, 16, 3)
    with pytest.raises(ValueError, match="seek"):
        tvd.extract_frames(str(bad), 3, 16, "random")


@pytest.mark.parametrize("max_frames", [None, 10])
def test_sequential_frames_matches_jax(data_root, max_frames):
    """Every frame to the end of the stream (24), or the first 10."""
    path = _clip(data_root, 3)
    want = jvd.sequential_frames(path, 40, max_frames)
    got = tvd.sequential_frames(path, 40, max_frames)
    assert got.shape == (max_frames or 24, 40, 40, 3)
    np.testing.assert_array_equal(got, want)


def test_extract_wav_read_wav_and_buckets_match_jax(data_root, tmp_path):
    """PCM from the .wav sidecar, from a .npy sidecar, a resampled read and
    the bucket padding (short, exact and truncated) give JAX's float32
    bits; a clip with no sidecar and no ffmpeg raises in both."""
    path = _clip(data_root, 0)
    np.testing.assert_array_equal(tio.extract_wav(path), jio.extract_wav(path))
    wav = path[:-4] + ".wav"
    np.testing.assert_array_equal(tio.read_wav(wav, 22050), jio.read_wav(wav, 22050))
    npy_clip = tmp_path / "n.mp4"
    npy_clip.write_bytes(b"")
    np.save(tmp_path / "n.npy", np.linspace(-1, 1, 100, dtype=np.float64))
    np.testing.assert_array_equal(tio.extract_wav(str(npy_clip)), jio.extract_wav(str(npy_clip)))
    assert tio.has_sidecar(path) and tio.has_sidecar(str(npy_clip))
    y = tio.extract_wav(path)
    for buckets in ([4000, 8000], [8000, 16000], [2000]):
        with pytest.warns(UserWarning) if max(buckets) < len(y) else _nothing():
            got = tio.pad_to_bucket(y, buckets)
        np.testing.assert_array_equal(got, jio.pad_to_bucket(y, buckets))
    lone = tmp_path / "lone.mp4"
    lone.write_bytes(b"")
    if not tio.has_ffmpeg():
        with pytest.raises(RuntimeError, match="sidecar"):
            tio.extract_wav(str(lone))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture(autouse=True)
def _fresh_truncation_warning(monkeypatch):
    monkeypatch.setattr(tio, "_warned_truncate", False)


@pytest.mark.parametrize("total,chunk,stride", [(0, 4, 2), (3, 4, 2), (24, 8, 4), (23, 8, 5),
                                                (96, 32, 16)])
def test_chunking_matches_jax(total, chunk, stride):
    assert tchunk.sliding_windows(total, chunk, stride) == jchunk.sliding_windows(total, chunk,
                                                                                  stride)
    frames = np.random.default_rng(total).integers(0, 256, (total, 4, 4, 3), np.uint8)
    if total:
        np.testing.assert_array_equal(tchunk.chunk_frames(frames, chunk, stride),
                                      jchunk.chunk_frames(frames, chunk, stride))
    scores = np.random.default_rng(total + 1).uniform(size=total % 7).tolist()
    for agg in ("mean", "max", "top3"):
        np.testing.assert_equal(tchunk.aggregate_window_scores(scores, agg),
                                jchunk.aggregate_window_scores(scores, agg))


def test_reshard_directory_matches_jax(tmp_path):
    for pkg, d in ((tchunk, tmp_path / "t"), (jchunk, tmp_path / "j")):
        d.mkdir()
        for i in range(7):
            (d / f"f{i}.mp4").write_text(str(i))
        assert [os.path.basename(s) for s in pkg.reshard_directory(str(d), 3, dry_run=True)] == [
            "sub_dir1", "sub_dir2", "sub_dir3"]
        pkg.reshard_directory(str(d), 3)
    tree = lambda d, pkg: [os.path.relpath(p, d) for p in pkg.iter_sharded_files(str(d))]
    assert tree(tmp_path / "t", tchunk) == tree(tmp_path / "j", jchunk)
    assert len(tree(tmp_path / "t", tchunk)) == 7


@pytest.mark.parametrize("text", ["video_name,target\na.mp4,1\nb.mp4,0\nc.mp4,\n",
                                  "video_name,y_pred\na.mp4,0.5\n"], ids=["labels", "names"])
def test_read_label_csv_matches_jax(tmp_path, text):
    p = tmp_path / "labels.csv"
    p.write_text(text)
    got, want = tds.read_label_csv(str(p)), jds.read_label_csv(str(p))
    assert list(got) == list(want)
    np.testing.assert_array_equal(list(got.values()), list(want.values()))


@pytest.mark.parametrize("text", ["video_name,y_pred\na.mp4,0.1\nb.mp4,0.2\n",
                                  "a.mp4,0.1\n\nb.mp4,0.2\n", ""], ids=["header", "bare", "empty"])
def test_predicted_names_matches_jax(tmp_path, text):
    p = tmp_path / "prediction.csv"
    p.write_text(text)
    assert tds.predicted_names(str(p)) == jds.predicted_names(str(p))
    assert tds.predicted_names(str(tmp_path / "missing.csv")) == []


def _same_item(a, b):
    fa, la, na = a
    fb, lb, nb = b
    assert na == nb and set(fa) == set(fb)
    np.testing.assert_equal(la, lb)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("modality", ["video", "audio", "paudio", "fused", "video_swin"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_items_match_jax(data_root, tmp_path, modality, split):
    """DeepFakeDataset's names (the test split in prediction.txt.csv's
    order, resumed past prediction.csv's names) and every item's arrays
    equal the JAX dataset's."""
    jcfg, tcfg = _cfgs(data_root, modality)
    pred = tmp_path / "prediction.csv"
    pred.write_text("clip_1.mp4,0.25\nclip_3.mp4,0.5\n")
    j = jds.DeepFakeDataset(jcfg, split, str(pred))
    t = tds.DeepFakeDataset(tcfg, split, str(pred))
    assert t.names == j.names and t.dataset_path == j.dataset_path
    if split == "test":
        assert t.names == ["clip_0.mp4", "clip_2.mp4", "clip_4.mp4"]
        assert tds.DeepFakeDataset(tcfg, split, str(pred), resume=False).names == [
            f"clip_{i}.mp4" for i in range(N_CLIPS)]
    for i in range(len(t)):
        _same_item(t[i], j[i])


def test_missing_train_label_raises(data_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(data_root, root)
    (root / "train_label.txt").write_text("video_name,target\nclip_0.mp4,1\n")
    _, tcfg = _cfgs(root, "video")
    ds = tds.DeepFakeDataset(tcfg, "train")
    assert ds[0][1] == 1.0
    with pytest.raises(KeyError, match="train_label.txt"):
        ds[1]


@pytest.mark.parametrize("modality", ["audio", "fused"])
def test_dataset_audio_from_images_matches_jax(data_root, tmp_path, modality):
    """The mel-JPEG path: both datasets read the same JPEGs (written here
    from seeded noise; 64^2, resized to the audio side 56) to the same
    ``audio_image`` arrays; ``audio`` then has no wave, ``fused`` keeps the
    paudio wave."""
    import cv2

    root = tmp_path / "root"
    shutil.copytree(data_root, root)
    rng = np.random.default_rng(8)
    (root / "TestAudioImgs").mkdir()
    for i in range(N_CLIPS):
        cv2.imwrite(str(root / "TestAudioImgs" / f"clip_{i}.jpg"),
                    rng.integers(0, 255, (64, 64, 3), np.uint8))
    jcfg, tcfg = _cfgs(root, modality, **{"data.audio_from_images": True})
    j = jds.DeepFakeDataset(jcfg, "test", str(tmp_path / "none.csv"))
    t = tds.DeepFakeDataset(tcfg, "test", str(tmp_path / "none.csv"), device="cpu")
    for i in range(len(t)):
        _same_item(t[i], j[i])
    assert t[0][0]["audio_image"].shape == (56, 56, 3)
    assert ("audio_wave" in t[0][0]) is False and ("paudio_wave" in t[0][0]) == (modality == "fused")


def test_collate_and_loaders_match_jax(data_root, tmp_path):
    """collate pads waves to the batch's largest bucket (a 0.5 s and a
    0.75 s clip: buckets of 8000 and 16000 samples), as JAX's; the data
    modules' test loader gives the same batches (2, 2, 1) and the train
    loader batch_size x accum_step rows with the ragged last dropped."""
    jcfg, tcfg = _cfgs(data_root, "fused")
    samples = [tds.DeepFakeDataset(tcfg, "test", str(tmp_path / "x.csv"))[i] for i in range(2)]
    long = np.ones(12000, np.float32)
    samples[1][0]["paudio_wave"] = tio.pad_to_bucket(long, [8000, 16000])
    got, want = tds.collate(samples), jds.collate(samples)
    assert got[0]["paudio_wave"].shape == (2, 16000)
    _same_item((got[0], got[1], got[2]), want)
    jcfg.data.use_native_ingest = False
    jdm = jds.DeepFakeDataModule(jcfg, str(tmp_path / "x.csv")).setup()
    tdm = tds.DeepFakeDataModule(tcfg, str(tmp_path / "x.csv")).setup()
    tb, jb = list(tdm.test_dataloader()), list(jdm.test_dataloader())
    assert [len(b[2]) for b in tb] == [2, 2, 1] and len(tdm.test_dataloader()) == 3
    for a, b in zip(tb, jb):
        _same_item(a, b)
    tcfg.optim.accum_step = jcfg.optim.accum_step = 2
    ttrain, jtrain = list(tdm.train_dataloader()), list(jdm.train_dataloader())
    assert [len(b[2]) for b in ttrain] == [4] and len(tdm.train_dataloader()) == 1
    for a, b in zip(ttrain, jtrain):
        _same_item(a, b)


def test_write_mel_jpegs_matches_jax(data_root, tmp_path):
    """The mel JPEGs of the test split (0.5 s clips, audio side 224): the
    port's (its mel image on the CPU, cv2.imwrite) read back within one
    uint8 level of the JAX package's on >= 99.9% of the pixels; the lazy
    pass writes nothing when every JPEG exists and everything with
    force_generate."""
    import cv2

    from deepfake_tpu.data.audio_images import write_mel_jpegs as jwrite
    from deepfake_tpu_torch.data.audio_images import ensure_audio_images, write_mel_jpegs

    ds_path = str(data_root / "phase2" / "testset1seen")
    names = [f"clip_{i}.mp4" for i in range(N_CLIPS)]
    log = lambda s: None
    assert jwrite(str(tmp_path / "j"), "test", ds_path, names, 16000, log) == N_CLIPS
    assert write_mel_jpegs(str(tmp_path / "t"), "test", ds_path, names, 16000, log,
                           device="cpu") == N_CLIPS
    for n in names:
        a = cv2.imread(str(tmp_path / "t" / "TestAudioImgs" / (n[:-4] + ".jpg")), 0)
        b = cv2.imread(str(tmp_path / "j" / "TestAudioImgs" / (n[:-4] + ".jpg")), 0)
        assert a.shape == b.shape == (224, 224)
        assert np.mean(np.abs(a.astype(int) - b) <= 1) >= 0.999, n
    _, tcfg = _cfgs(tmp_path / "t", "audio")
    assert ensure_audio_images(tcfg, "test", ds_path, names, device="cpu") == 0
    tcfg.data.force_generate = True
    assert ensure_audio_images(tcfg, "test", ds_path, names[:2], device="cpu") == 2


REFERENCE_FLAGS = [
    "--preset", "fused", "--data_root", "/data/multi-ffdv", "--num_frames", "16",
    "-nu", "10", "--classify_drop", "0.2", "--num_hiddens", "256", "--video_pool", "mean",
    "--fused_ckpt_path", "ckpt/fused", "--audio_ckpt_path", "ckpt/audio", "--Resume",
    "-cuda", "True", "--random_seed", "7", "-b", "16", "--accum_step", "2",
    "--l2_decacy", "0.01", "-e", "3", "-lr", "3e-4", "--log_step", "5",
    "--log_dir", "log.txt", "--force_generate",
]


@pytest.mark.parametrize("argv", [
    REFERENCE_FLAGS,
    ["--preset", "video_swin", "--set", "data.frame_size=96", "--set", "optim.learning_rate=1",
     "--set", "data.wave_seconds_buckets=[4, 8, 16, 32]", "--set", "data.decode_method=sequential"],
    ["--preset", "audio", "--modality", "paudio", "--set", "model.swin2d_heads=[2, 4]"],
    ["--modality", "video"],
    ["--preset", "fused", "--swin_drop", "0.3", "--soft", "0.05", "--bn_momentum", "0.2",
     "--align_loss_rate", "0.5", "--skip_learning", "--val_model",
     "--set", "optim.use_align_loss=true"],
], ids=["reference_flags", "video_swin_set", "audio_modality", "defaults", "training_flags"])
def test_get_config_matches_jax(argv):
    """Every field both config trees have takes the same value from the same
    argv (flags, presets and ``--set``; the defaults with the modality named,
    since the port's default is the fused config of record and the JAX
    package's ``audio``)."""
    import dataclasses

    from deepfake_tpu.config import get_config as jget
    from deepfake_tpu_torch.config import get_config as tget

    j, t = jget(argv), tget(argv)
    shared = 0
    for sec in ("data", "mel", "model", "optim", "parallel", "log"):
        js, ts = getattr(j, sec), getattr(t, sec)
        for f in dataclasses.fields(ts):
            if hasattr(js, f.name):
                assert getattr(ts, f.name) == getattr(js, f.name), f"{sec}.{f.name}"
                shared += 1
    assert t.random_seed == j.random_seed and shared > 40
    assert t.parallel.use_cuda is True


def test_get_config_cuda_flag_and_refusals():
    from deepfake_tpu_torch.config import get_config

    assert get_config(["-cuda", "False"]).parallel.use_cuda is False
    assert get_config(["--use_cuda", "no"]).parallel.use_cuda is False
    assert '"data_root"' in get_config([]).to_json()
    train = get_config(["--swin_drop", "0.2", "--val_model", "--skip_learning"])
    assert train.model.swin_drop == 0.2 and train.optim.val_model and train.optim.skip_learning
    # --model_save sets the checkpoint cadence; the flags that read the
    # reference's checkpoints stay refused until such files are in the repository
    assert get_config(["--model_save", "7"]).log.model_save == 7
    assert get_config([]).log.model_save == 5
    for argv in (["--wav2vec2_dir", "w2v"], ["--video_pretrained_dir", "irv2"],
                 ["--audio_pretrained_dir", "swinv2"]):
        with pytest.raises(SystemExit):
            get_config(argv)
    with pytest.raises(AttributeError):
        get_config(["--set", "model.no_such_field=1"])
