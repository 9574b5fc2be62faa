"""Typed configuration tree and CLI: the port's own copy of the fields that
fused, ``audio`` and ``video_swin`` serving (raw-input feature assembly and
the ingest of video files included) and the training of every modality
read (deepfake_tpu/config.py:18-256). Field names and defaults match the JAX
package, so one set of dotted overrides configures both; ``get_config(argv)``
takes the JAX package's flags (deepfake_tpu/config.py:284-380). Every JAX
field is taken: the kernel switches under their JAX names as aliases
(``ALIASES``), and the fields whose meaning is the TPU's or waits for a
module not ported yet (``NOT_ON_THE_CARD``) at the values that say what the
port does, raising, with the reason, at any other.

The three kernel switches are on by default and renamed without "pallas":
``model.irv2_fused_blocks`` (deepfake_tpu: ``irv2_pallas_blocks``),
``model.swin2d_attn_kernel`` (``swin2d_pallas_attn``) and
``model.swin3d_attn_kernel`` (``swin3d_pallas_attn``). Off selects the plain
PyTorch path on purpose; it is never a fallback. ``swin2d_attn_kernel``
routes SwinV2's window attention through K2 for windows of N <= 64 tokens
and through K6 for every larger window, which together take every N that
``swin2d_pallas_attn``'s Pallas routes take. Like ``swin3d_pallas_attn``, which routes a Video Swin block
through all three of its Pallas kernels (attention, QKV-fused attention,
MLP tail), ``swin3d_attn_kernel`` routes it through K3 and K4 when serving,
and through K5 (forward and backward) in training.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass
class DataConfig:
    data_root: str = "/data/deepfake/full_data"
    modality: str = "fused"  # video | audio | paudio | video_swin | fused
    num_frames: int = 32
    frame_size: int = 224
    audio_size: int = 224  # mel-spectrogram image side
    num_workers: int = 4  # host decode threads of a loader
    # seek: num_frames evenly spaced seeks (the reference's sampling);
    # sequential: one pass over the stream keeping the same frames
    decode_method: str = "seek"
    force_generate: bool = False  # rewrite the mel JPEGs that already exist
    prefetch_depth: int = 4  # batches the loader's thread decodes ahead
    wave_seconds_buckets: Tuple[float, ...] = (4.0, 8.0, 16.0)
    wave_sample_rate: int = 16000
    # waveform normalisation of the paudio input: "batch_longest" (the
    # reference processor's statistics over the batch-longest length), "hf"
    # (over the full bucket row) or "masked" (over the valid prefix only)
    wave_norm: str = "batch_longest"
    # read the reference's {train,Val,Test}AudioImgs mel JPEGs instead of
    # computing the mel image from PCM on the device
    audio_from_images: bool = False
    # long videos: sliding windows of chunk_frames frames, stride chunk_stride
    chunk_frames: int = 32
    chunk_stride: int = 16


@dataclass
class MelConfig:
    """The device log-mel image (deepfake_tpu/config.py:55-67). As in the
    JAX front end, FeatureAssembler reads the rate, n_fft, hop and n_mels;
    fmin, fmax and top_db are carried so that one override set configures
    both packages (the mel image keeps librosa's 0, sr / 2 and 80 dB)."""

    sample_rate: int = 22050  # the PCM is resampled to this rate first
    n_fft: int = 2048
    hop_length: int = 512
    n_mels: int = 128
    fmin: float = 0.0
    fmax: Optional[float] = None  # sr / 2
    top_db: float = 80.0
    target_size: int = 224  # carried as the JAX package carries it (data.audio_size sets the side)


@dataclass
class ModelConfig:
    num_classes: int = 1
    classify_drop: float = 0.1  # classifier MLP dropout, in training
    swin_drop: float = 0.1  # backbone dropout (IRv2, NeXtVLAD, the paudio feature), in training
    bn_momentum: float = 0.1  # IRv2 and NeXtVLAD BatchNorm, PyTorch semantics
    soft: float = 0.01  # InfoNCE temperature of the fused alignment loss
    num_hiddens: int = 128  # Video Swin classifier hidden width
    video_pool: str = "mean"  # Video Swin pooling: "mean" or "Attention"
    # SwinV2-B audio branch
    swin2d_embed_dim: int = 128
    swin2d_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin2d_heads: Tuple[int, ...] = (4, 8, 16, 32)
    swin2d_window: int = 7
    swin2d_pretrained_windows: Tuple[int, ...] = (16, 16, 16, 16)
    # cosine window attention through the CUDA kernels: K2
    # (csrc/window_attn.cu) for N <= 64, K6 (csrc/window_attn_multihead.cu)
    # for N > 64
    swin2d_attn_kernel: bool = True
    # Video Swin 3D (the video_swin modality)
    swin3d_embed_dim: int = 96
    swin3d_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin3d_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin3d_patch: Tuple[int, ...] = (2, 4, 4)
    swin3d_window: Tuple[int, ...] = (8, 7, 7)
    swin3d_drop_path: float = 0.1  # DropPath rate of the last block, in training
    # every block through the CUDA kernels: serving K3 (csrc/window_attn3d.cu,
    # the window attention) and K4 (csrc/ln_linear.cu, LayerNorm + the linear
    # layers); training K5 (csrc/window_attn3d_train.cu, the window attention
    # and its backward); K3 and K5 take any window (N = 392 at (8,7,7), 784
    # at Video Swin-B's (16,7,7)) and head dims 1 to 128
    swin3d_attn_kernel: bool = True
    # wav2vec2-base topology
    wav_layers: int = 12
    wav_hidden: int = 768
    wav_heads: int = 12
    wav_intermediate: int = 3072
    wav_conv_dim: int = 512
    # IRv2 residual blocks A/B/C through the CUDA kernel (csrc/inception_block.cu)
    irv2_fused_blocks: bool = True
    # int8 IRv2 trunk at serving ("none" | "int8" | "int8_static"; any other
    # value raises; deepfake_tpu/config.py:124-130): each ConvBnRelu's
    # BatchNorm folded into its weight, weights quantised per output channel,
    # activations per tensor (int8: each batch's max; int8_static: the scale
    # SubmitCtl.calibrate / Predictor.calibrate recorded, the dynamic one
    # before any), the conv int8 x int8 -> int32 on the tensor cores (K7,
    # K8: csrc/int8_conv.cu). With irv2_fused_blocks on, the blocks run K1
    # in the compute type and the 24 convs outside them int8 (stem,
    # reductions, the 1536 conv); off, all 244 convs, the blocks' residual
    # 1x1s included. Training ignores it.
    irv2_quant: str = "none"
    # the reference's ungated F.dropout (deepfake_tpu/config.py:131-135): the
    # IRv2 pool's, NeXtVLAD's and the paudio head's dropouts stay active at
    # serving, their masks drawn from the Predictor's generator, reset to
    # one state before every request (one request, one mask)
    parity_inference_dropout: bool = False
    # checkpoints of each modality: --Resume loads the modality's one
    # (io/checkpoint.py); a reference .pth or .safetensors path raises
    audio_ckpt_path: Optional[str] = None
    video_ckpt_path: Optional[str] = None
    paudio_ckpt_path: Optional[str] = None
    fused_ckpt_path: Optional[str] = None
    resume: bool = False


@dataclass
class OptimConfig:
    """SGD with momentum and coupled weight decay, cosine schedule
    (deepfake_tpu/config.py:138-153)."""

    learning_rate: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 0.05
    batch_size: int = 8  # the micro-batch
    accum_step: int = 4  # micro-batches per optimizer step
    epochs: int = 50
    schedule: str = "cosine"  # "cosine", or any other value for a constant rate
    grad_clip: Optional[float] = None  # global-norm clip
    # the fused model's InfoNCE alignment loss, loss + align_loss_rate * align
    # (the reference computes it and leaves it off)
    align_loss_rate: float = 0.4
    use_align_loss: bool = False
    skip_learning: bool = False  # the training CLI builds everything and trains nothing
    val_model: bool = False  # the training CLI evaluates on the val split only


@dataclass
class ParallelConfig:
    # bfloat16 serves and trains; float32 is for parity runs
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"  # the training masters
    # the reference's -cuda flag (the JAX package accepts and ignores it):
    # False runs the CLIs on the CPU; True on the card, or they raise
    use_cuda: bool = True
    # the mesh of a multi-device run (parallel/mesh.py; deepfake_tpu/config.py:
    # 161-186): data x model ranks, -1 on the data axis takes every rank the
    # model axis leaves; multihost joins the group torchrun's environment
    # names even at one rank
    data_axis: int = -1
    model_axis: int = 1
    multihost: bool = False
    # activation checkpointing (deepfake_tpu/config.py:178-182): each
    # SwinV2, Video Swin and wav2vec2 block's forward runs again in the
    # backward (models/layers.py::remat_block). remat_policy: "" or
    # "nothing" recompute everything, "dots" keeps the products without
    # batch dims (mm, addmm), "dots_all" every product; "dots,dots,off,off"
    # takes one entry a stage (stage_policy)
    remat: bool = False
    remat_policy: str = ""
    # serving: every window-attention bias ([H, N, N], a function of the
    # weights) computed once when the Predictor is built
    # (registry.precompute_bias_cache; deepfake_tpu/config.py:200-206); off,
    # each forward computes it
    infer_bias_cache: bool = True


@dataclass
class LogConfig:
    """The training loop's logging, checkpoints and observability
    (deepfake_tpu/config.py:197-207)."""

    log_step: int = 10  # a log line every log_step steps (optimizer steps, batches)
    log_dir: Optional[str] = None  # the log file; None: standard output only
    model_save: int = 5  # a checkpoint after each step t with (t + 1) % model_save == 0
    ckpt_dir: str = "./checkpoints"
    curve_dir: str = "./checkpoints"  # the loss curves' PNGs
    profile_dir: Optional[str] = None  # a torch.profiler trace of the training loop
    hbm_track_step: int = 500  # live-tensor census cadence (./hbm_track/)
    step_deadline_s: float = 600.0  # the watchdog logs a step that runs longer


# Video Swin 3D as the reference's shell script runs it: 32 frames, batch 8 x
# accum 4, mean pooling, num_hiddens 256 (deepfake_tpu/config.py:246-255)
_VIDEO_SWIN = {
    "data.modality": "video_swin",
    "data.num_frames": 32,
    "optim.batch_size": 8,
    "optim.accum_step": 4,
    "optim.learning_rate": 1e-4,
    "optim.epochs": 4,
    "model.video_pool": "mean",
    "model.num_hiddens": 256,
}

# Named override sets (deepfake_tpu/config.py PRESETS)
PRESETS = {
    "video": {"data.modality": "video", "optim.batch_size": 8, "optim.accum_step": 4},
    # SwinV2-B on the mel image (deepfake_tpu/config.py:231)
    "audio": {"data.modality": "audio", "optim.batch_size": 48, "optim.epochs": 12},
    "paudio": {"data.modality": "paudio", "optim.batch_size": 8},
    # the reference's fused configs (train_model.sh:14-38, test_model.sh)
    "fused": {
        "data.modality": "fused",
        "optim.batch_size": 8,
        "optim.accum_step": 4,
        "optim.learning_rate": 1e-4,
        "optim.epochs": 4,
    },
    "video_swin": _VIDEO_SWIN,
    # Video Swin-L (Liu et al. 2022, configs/recognition/swin/
    # swin_large_patch244_window877_kinetics400_22k.py): embed 192, depths
    # 2/2/18/2, heads 6/12/24/48 (head dim 32), window (8,7,7), on the
    # video_swin preset's clips and recipe; stage 3 runs at C = 1536
    "swin_large_patch244_window877": {
        **_VIDEO_SWIN,
        "model.swin3d_embed_dim": 192,
        "model.swin3d_depths": (2, 2, 18, 2),
        "model.swin3d_heads": (6, 12, 24, 48),
        "model.swin3d_window": (8, 7, 7),
    },
}


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    log: LogConfig = field(default_factory=LogConfig)
    random_seed: int = 42

    def set(self, key: str, value: Any) -> "Config":
        """Set one dotted field (``"model.wav_layers"``, or a JAX name of
        ``ALIASES``) in place; a ``NOT_ON_THE_CARD`` field takes its
        accepted values and raises at any other."""
        key = ALIASES.get(key, key)
        if key in NOT_ON_THE_CARD:
            accepted, why = NOT_ON_THE_CARD[key]
            if value not in accepted:
                raise ValueError(f"{key}={value!r}: {why}")
            return self  # what the port does already
        parts = key.split(".")
        obj = self
        for p in parts[:-1]:
            obj = getattr(obj, p)
        if not hasattr(obj, parts[-1]):
            raise AttributeError(f"unknown config field {key!r}")
        setattr(obj, parts[-1], value)
        return self

    @classmethod
    def preset(cls, name: str) -> "Config":
        """A default Config with the named PRESETS entry applied."""
        cfg = cls()
        for k, v in PRESETS[name].items():
            cfg.set(k, v)
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4, default=str)


def _str2bool(v) -> bool:
    """``-cuda False``: argparse's ``type=bool`` would read any non-empty
    string as True."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y"):
        return True
    if s in ("0", "false", "f", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


# the JAX names of the kernel switches (deepfake_tpu/config.py:103, :110, :122)
ALIASES = {
    "model.irv2_pallas_blocks": "model.irv2_fused_blocks",
    "model.swin2d_pallas_attn": "model.swin2d_attn_kernel",
    "model.swin3d_pallas_attn": "model.swin3d_attn_kernel",
}

_A3 = ("importing reference checkpoints waits for reference files in the repository "
       "(ROADMAP A3)")
# JAX fields the port has no field for: {field: (the values that say what
# the port does, taken as they are; why any other raises)}
NOT_ON_THE_CARD = {
    "data.use_native_ingest": (
        (False,), "the native C++ ingest waits for ROADMAP A1; the port decodes with its "
                  "Python loader (data/dataset.py)"),
    "parallel.axis_names": (
        (("data", "model"),), "TPU-only: the names of the JAX device mesh's axes; the port's "
                              "mesh (parallel/mesh.py) has a data and a model axis"),
    "parallel.prng_impl": (
        ("auto",), "TPU-only: the JAX PRNG implementation (rbg on the TPU); the port draws "
                   "every stream from torch generators seeded by random_seed"),
    # where the JAX package casts the serving weights, once or in each forward:
    # a TPU layout trade (deepfake_tpu/config.py:190-196) with the same
    # numbers; the Predictor casts them once either way
    "parallel.infer_cast_params": ((False, True), "TPU-only"),
    "model.video_pretrained_dir": ((None,), _A3),
    "model.audio_pretrained_dir": ((None,), _A3),
    "model.wav2vec2_dir": ((None,), _A3),
}


def _apply(cfg: Config, key: str, value: Any) -> None:
    """Set a dotted field, converted to the type of its current value (as
    the JAX package's ``_apply_dotted``: ``--set optim.learning_rate=1`` is
    1.0); a ``NOT_ON_THE_CARD`` field's value to its accepted values' type."""
    key = ALIASES.get(key, key)
    if key in NOT_ON_THE_CARD:
        cur = NOT_ON_THE_CARD[key][0][0]
        if isinstance(cur, bool):
            value = _str2bool(value) if isinstance(value, (bool, str)) else value
        elif isinstance(cur, tuple) and isinstance(value, list):
            value = tuple(value)
        cfg.set(key, value)
        return
    obj = cfg
    for p in key.split(".")[:-1]:
        obj = getattr(obj, p)
    cur = getattr(obj, key.split(".")[-1], None)
    if isinstance(cur, bool) and isinstance(value, str):
        value = _str2bool(value)
    elif cur is not None and not isinstance(cur, (tuple, list)) and value is not None:
        value = type(cur)(value)
    cfg.set(key, value)


# flag -> dotted field, for the flags that take a value
_DIRECT = {
    "data_root": "data.data_root", "modality": "data.modality",
    "num_frames": "data.num_frames", "num_workers": "data.num_workers",
    "classify_drop": "model.classify_drop", "num_hiddens": "model.num_hiddens",
    "swin_drop": "model.swin_drop", "soft": "model.soft", "bn_momentum": "model.bn_momentum",
    "align_loss_rate": "optim.align_loss_rate",
    "video_pool": "model.video_pool", "audio_ckpt_path": "model.audio_ckpt_path",
    "video_ckpt_path": "model.video_ckpt_path", "paudio_ckpt_path": "model.paudio_ckpt_path",
    "fused_ckpt_path": "model.fused_ckpt_path", "use_cuda": "parallel.use_cuda",
    "random_seed": "random_seed", "batch_size": "optim.batch_size",
    "accum_step": "optim.accum_step", "l2_decacy": "optim.weight_decay",
    "epochs": "optim.epochs", "learning_rate": "optim.learning_rate",
    "log_step": "log.log_step", "log_dir": "log.log_dir", "model_save": "log.model_save",
}
# flags of the JAX package that read the reference's checkpoints (pretrained
# backbones, wav2vec2): parsed, and refused when given, since importing
# reference checkpoints waits for such files in the repository
_NOT_PORTED = ("wav2vec2_dir", "video_pretrained_dir", "audio_pretrained_dir")


def get_config(argv: Optional[list] = None) -> Config:
    """The CLI's flags (the JAX package's surface, the reference's
    config.py:3-45) into a Config: ``--preset`` first, then each flag, then
    every ``--set a.b=v`` (the value read as JSON where it parses)."""
    p = argparse.ArgumentParser(description="deepfake_tpu_torch")
    p.add_argument("--preset", type=str, default=None, choices=list(PRESETS))
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--modality", type=str, default=None)
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--force_generate", action="store_true")
    p.add_argument("-nu", "--num_workers", type=int, default=None)
    p.add_argument("--classify_drop", type=float, default=None)
    p.add_argument("--swin_drop", type=float, default=None)
    p.add_argument("--soft", type=float, default=None)
    p.add_argument("--num_hiddens", type=int, default=None)
    p.add_argument("--video_pool", type=str, default=None)
    p.add_argument("--audio_ckpt_path", type=str, default=None)
    p.add_argument("--video_ckpt_path", type=str, default=None)
    p.add_argument("--paudio_ckpt_path", type=str, default=None)
    p.add_argument("--fused_ckpt_path", type=str, default=None)
    p.add_argument("--wav2vec2_dir", type=str, default=None)
    p.add_argument("--video_pretrained_dir", type=str, default=None)
    p.add_argument("--audio_pretrained_dir", type=str, default=None)
    p.add_argument("--bn_momentum", type=float, default=None)
    p.add_argument("--Resume", action="store_true")
    p.add_argument("-cuda", "--use_cuda", type=_str2bool, default=None)
    p.add_argument("--random_seed", type=int, default=None)
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("--accum_step", type=int, default=None)
    p.add_argument("--align_loss_rate", type=float, default=None)
    p.add_argument("--l2_decacy", type=float, default=None)  # the reference's spelling
    p.add_argument("-e", "--epochs", type=int, default=None)
    p.add_argument("-lr", "--learning_rate", type=float, default=None)
    p.add_argument("--model_save", type=int, default=None)
    p.add_argument("--skip_learning", action="store_true")
    p.add_argument("--val_model", action="store_true")
    p.add_argument("--log_step", type=int, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--set", action="append", default=[], metavar="a.b=v")
    args = p.parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name) not in (None, False):
            p.error(f"--{name}: {_A3}")

    cfg = Config.preset(args.preset) if args.preset else Config()
    for name, dotted in _DIRECT.items():
        v = getattr(args, name)
        if v is not None:
            _apply(cfg, dotted, v)
    if args.force_generate:
        cfg.data.force_generate = True
    if args.Resume:
        cfg.model.resume = True
    if args.skip_learning:
        cfg.optim.skip_learning = True
    if args.val_model:
        cfg.optim.val_model = True
    for kv in args.set:
        k, _, v = kv.partition("=")
        try:
            parsed = json.loads(v)
        except ValueError:
            parsed = v
        _apply(cfg, k, parsed)
    return cfg
