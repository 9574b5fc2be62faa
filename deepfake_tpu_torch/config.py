"""Typed configuration tree: the port's own copy of the fields that fused
and ``video_swin`` serving and ``video_swin`` training read
(deepfake_tpu/config.py:18-256). Field names and defaults match the JAX
package, so one set of dotted overrides configures both.

The three kernel switches are on by default and renamed without "pallas":
``model.irv2_fused_blocks`` (deepfake_tpu: ``irv2_pallas_blocks``),
``model.swin2d_attn_kernel`` (``swin2d_pallas_attn``) and
``model.swin3d_attn_kernel`` (``swin3d_pallas_attn``). Off selects the plain
PyTorch path on purpose; it is never a fallback. Like ``swin3d_pallas_attn``,
which routes a Video Swin block through all three of its Pallas kernels
(attention, QKV-fused attention, MLP tail), ``swin3d_attn_kernel`` routes it
through K3 and K4 when serving, and through K5 (forward and backward) in
training.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass
class DataConfig:
    modality: str = "fused"  # video | audio | paudio | video_swin | fused
    num_frames: int = 32
    frame_size: int = 224
    audio_size: int = 224  # mel-spectrogram image side
    wave_seconds_buckets: Tuple[float, ...] = (4.0, 8.0, 16.0)
    wave_sample_rate: int = 16000


@dataclass
class ModelConfig:
    num_classes: int = 1
    classify_drop: float = 0.1  # classifier MLP dropout, in training
    num_hiddens: int = 128  # Video Swin classifier hidden width
    video_pool: str = "mean"  # Video Swin pooling ("Attention" is not ported)
    # SwinV2-B audio branch
    swin2d_embed_dim: int = 128
    swin2d_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin2d_heads: Tuple[int, ...] = (4, 8, 16, 32)
    swin2d_window: int = 7
    swin2d_pretrained_windows: Tuple[int, ...] = (16, 16, 16, 16)
    # cosine window attention through the CUDA kernel (csrc/window_attn.cu)
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
    # and its backward)
    swin3d_attn_kernel: bool = True
    # wav2vec2-base topology
    wav_layers: int = 12
    wav_hidden: int = 768
    wav_heads: int = 12
    wav_intermediate: int = 3072
    wav_conv_dim: int = 512
    # IRv2 residual blocks A/B/C through the CUDA kernel (csrc/inception_block.cu)
    irv2_fused_blocks: bool = True


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


@dataclass
class ParallelConfig:
    # bfloat16 serves and trains; float32 is for parity runs
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"  # the training masters


@dataclass
class LogConfig:
    log_step: int = 10  # a train log line every log_step optimizer steps


# Named override sets (deepfake_tpu/config.py PRESETS)
PRESETS = {
    # Video Swin 3D as the reference's shell script runs it: 32 frames, batch
    # 8 x accum 4, mean pooling, num_hiddens 256 (deepfake_tpu/config.py:246-255)
    "video_swin": {
        "data.modality": "video_swin",
        "data.num_frames": 32,
        "optim.batch_size": 8,
        "optim.accum_step": 4,
        "optim.learning_rate": 1e-4,
        "optim.epochs": 4,
        "model.video_pool": "mean",
        "model.num_hiddens": 256,
    },
}


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    log: LogConfig = field(default_factory=LogConfig)
    random_seed: int = 42

    def set(self, key: str, value: Any) -> "Config":
        """Set one dotted field (``"model.wav_layers"``) in place."""
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
