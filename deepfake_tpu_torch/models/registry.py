"""Per-modality model construction (deepfake_tpu/models/registry.py).

``build_model(cfg, device=None)`` returns the modality's module in f32 on
``device`` (the card unless the caller asks for the CPU), with seeded
random weights, in eval mode; ``build_model(cfg, device, train=True)`` the
``video_swin`` model in train mode, its parameters in
``parallel.param_dtype``, its drop rates from the config and its dropout
masks drawn from the seed's dropout stream. ``example_inputs`` gives zero
inputs of the canonical shapes; ``precompute_bias_cache`` and
``pack_block_weights`` fill the inference caches once the weights are final.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.models.layers import init_weights, set_dropout_generator
from deepfake_tpu_torch.utils.seeding import make_generators


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device. Raises when no GPU is
    present and the caller did not ask for the CPU: nothing carries on
    quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.parallel.compute_dtype]


def wav_config(cfg: Config):
    from deepfake_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    m = cfg.model
    return Wav2Vec2Config(
        conv_dim=(m.wav_conv_dim,) * 7, hidden_size=m.wav_hidden,
        num_hidden_layers=m.wav_layers, num_attention_heads=m.wav_heads,
        intermediate_size=m.wav_intermediate)


def _swin(cfg: Config, use_feat: bool):
    from deepfake_tpu_torch.models.swin2d import SwinTransformerV2

    m = cfg.model
    return SwinTransformerV2(
        img_size=cfg.data.audio_size, num_classes=m.num_classes, embed_dim=m.swin2d_embed_dim,
        depths=tuple(m.swin2d_depths), num_heads=tuple(m.swin2d_heads),
        window_size=m.swin2d_window, pretrained_window_sizes=tuple(m.swin2d_pretrained_windows),
        use_feat=use_feat, attn_kernel=m.swin2d_attn_kernel)


def _video(cfg: Config, use_feat: bool):
    from deepfake_tpu_torch.models.nextvlad import InceptionVideoClassifier

    return InceptionVideoClassifier(
        num_frames=cfg.data.num_frames, num_classes=cfg.model.num_classes, use_feat=use_feat,
        fused_blocks=cfg.model.irv2_fused_blocks)


def _paudio(cfg: Config, use_feat: bool):
    from deepfake_tpu_torch.models.audio2d import Audio2D

    return Audio2D(num_classes=cfg.model.num_classes, use_feat=use_feat,
                   wav_config=wav_config(cfg))


def _video_swin(cfg: Config):
    from deepfake_tpu_torch.models.swin3d import VideoClassifier

    m, s = cfg.model, cfg.data.frame_size
    return VideoClassifier(
        input_size=(cfg.data.num_frames, s, s), num_classes=m.num_classes,
        embed_dim=m.swin3d_embed_dim, depths=tuple(m.swin3d_depths),
        num_heads=tuple(m.swin3d_heads), patch_size=tuple(m.swin3d_patch),
        window_size=tuple(m.swin3d_window), num_hiddens=m.num_hiddens, pool=m.video_pool,
        kernels=m.swin3d_attn_kernel, drop_path_rate=m.swin3d_drop_path,
        classify_drop=m.classify_drop)


def build_model(cfg: Config, device=None, train: bool = False) -> nn.Module:
    """The configured modality's model on ``device`` with random weights
    drawn from ``cfg.random_seed``: f32 in eval mode, or with ``train``
    (video_swin only: fused training is not ported) in train mode with
    ``parallel.param_dtype`` parameters and seeded dropout."""
    dev = resolve_device(device)
    modality = cfg.data.modality
    if train and modality != "video_swin":
        raise NotImplementedError(f"training is ported for video_swin only, not {modality}")
    if modality == "video":
        model = _video(cfg, False)
    elif modality == "audio":
        model = _swin(cfg, False)
    elif modality == "paudio":
        model = _paudio(cfg, False)
    elif modality == "video_swin":
        model = _video_swin(cfg)
    elif modality == "fused":
        from deepfake_tpu_torch.models.fusion import FusionModel

        m = cfg.model
        model = FusionModel(
            _video(cfg, True), _swin(cfg, True), _paudio(cfg, True),
            dims=(1024, m.swin2d_embed_dim * 2 ** (len(m.swin2d_depths) - 1), m.wav_hidden),
            out_dim=m.num_classes)
    else:
        raise ValueError(f"unknown modality: {modality}")
    model = model.to(dev).eval()
    gens = make_generators(cfg.random_seed, dev)
    init_weights(model, gens.init)
    if train:
        set_dropout_generator(model, gens.dropout)
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(_DTYPES[cfg.parallel.param_dtype])
        model.train()
    return model


def example_inputs(cfg: Config, batch: int = 1, device=None) -> Tuple:
    """Zero inputs with the canonical shapes per modality, JAX layouts."""
    dev = resolve_device(device)
    t, s, a = cfg.data.num_frames, cfg.data.frame_size, cfg.data.audio_size
    wave = int(cfg.data.wave_seconds_buckets[0] * cfg.data.wave_sample_rate)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    modality = cfg.data.modality
    if modality == "paudio":
        return (z(batch, wave),)
    if modality == "audio":
        return (z(batch, a, a, 3),)
    if modality in ("video", "video_swin"):
        return (z(batch, t, s, s, 3),)
    if modality == "fused":
        return ((z(batch, t, s, s, 3), z(batch, a, a, 3), z(batch, wave)),)
    raise ValueError(modality)


def precompute_bias_cache(model: nn.Module) -> nn.Module:
    """Compute every window-attention bias ([H, N, N] f32, a function of the
    weights only) once; inference forwards then skip the CPB-MLP (2D) or
    the table gather (3D) (registry.py:128-159). Call after the weights are
    final."""
    from deepfake_tpu_torch.models.swin2d import WindowAttention
    from deepfake_tpu_torch.models.swin3d import WindowAttention3D

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (WindowAttention, WindowAttention3D)):
                mod.precompute_bias()
    return model


def pack_block_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Fold BN and lay out every IRv2 residual block's weights for kernel K1
    in ``dtype``, once. Call after the weights are final."""
    from deepfake_tpu_torch.models.inception_resnet_v2 import _ResidualBlock

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _ResidualBlock) and mod.fused:
                mod.packed = mod.pack_weights(dtype)
    return model


def drop_inference_caches(model: nn.Module) -> nn.Module:
    """Forget the caches above (after new weights are loaded)."""
    for mod in model.modules():
        if hasattr(mod, "bias_cache"):
            mod.bias_cache = None
        if hasattr(mod, "packed"):
            mod.packed = None
    return model
