"""Typed configuration tree: the port's own copy of the fields that fused
serving reads (deepfake_tpu/config.py:18-256). Field names and defaults
match the JAX package, so one set of dotted overrides configures both.

The two kernel switches are on by default and renamed without "pallas":
``model.irv2_fused_blocks`` (deepfake_tpu: ``irv2_pallas_blocks``) and
``model.swin2d_attn_kernel`` (``swin2d_pallas_attn``). Off selects the plain
PyTorch path on purpose; it is never a fallback.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass
class DataConfig:
    modality: str = "fused"  # video | audio | paudio | fused
    num_frames: int = 32
    frame_size: int = 224
    audio_size: int = 224  # mel-spectrogram image side
    wave_seconds_buckets: Tuple[float, ...] = (4.0, 8.0, 16.0)
    wave_sample_rate: int = 16000


@dataclass
class ModelConfig:
    num_classes: int = 1
    # SwinV2-B audio branch
    swin2d_embed_dim: int = 128
    swin2d_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin2d_heads: Tuple[int, ...] = (4, 8, 16, 32)
    swin2d_window: int = 7
    swin2d_pretrained_windows: Tuple[int, ...] = (16, 16, 16, 16)
    # cosine window attention through the CUDA kernel (csrc/window_attn.cu)
    swin2d_attn_kernel: bool = True
    # wav2vec2-base topology
    wav_layers: int = 12
    wav_hidden: int = 768
    wav_heads: int = 12
    wav_intermediate: int = 3072
    wav_conv_dim: int = 512
    # IRv2 residual blocks A/B/C through the CUDA kernel (csrc/inception_block.cu)
    irv2_fused_blocks: bool = True


@dataclass
class ParallelConfig:
    # bfloat16 serves; float32 is for parity runs
    compute_dtype: str = "bfloat16"


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
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
