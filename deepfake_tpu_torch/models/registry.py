"""Per-modality model construction (deepfake_tpu/models/registry.py).

``build_model(cfg, device=None)`` returns the modality's module in f32 on
``device`` (the card unless the caller asks for the CPU), with seeded
random weights, in eval mode; ``build_model(cfg, device, train=True)`` the
same model in train mode, its parameters in ``parallel.param_dtype``, its
drop rates and BatchNorm momenta from the config (the rates the JAX package
hard-codes as it does: SwinV2's DropPath 0.1, wav2vec2's dropouts, LayerDrop
and SpecAugment) and every mask drawn from the seed's dropout stream.
``example_inputs`` gives zero inputs of the canonical shapes; ``precompute_bias_cache``,
``pack_block_weights`` and ``pack_int8_weights`` fill the inference caches once the
weights are final. ``model.parity_inference_dropout`` keeps the reference's ungated
dropouts active in a serving model (``inference_dropout``). ``model.irv2_quant``
(``irv2_quant``) sets the IRv2 trunk's int8 mode
of the ``video`` and ``fused`` models at serving; a training model is built without it
(its BatchNorm takes batch statistics); the Trainer gives it the mode
(``set_irv2_quant``) and evaluates in int8 on weights packed before each
evaluation pass, as the JAX package builds one model for both.
``calibrate_act_scales`` records int8_static's activation scales.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.models.layers import Dropout, init_weights, set_dropout_generator
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
        intermediate_size=m.wav_intermediate, remat=cfg.parallel.remat,
        remat_policy=cfg.parallel.remat_policy)


def _swin(cfg: Config, use_feat: bool):
    from deepfake_tpu_torch.models.swin2d import SwinTransformerV2

    m = cfg.model
    return SwinTransformerV2(
        img_size=cfg.data.audio_size, num_classes=m.num_classes, embed_dim=m.swin2d_embed_dim,
        depths=tuple(m.swin2d_depths), num_heads=tuple(m.swin2d_heads),
        window_size=m.swin2d_window, pretrained_window_sizes=tuple(m.swin2d_pretrained_windows),
        use_feat=use_feat, attn_kernel=m.swin2d_attn_kernel, remat=cfg.parallel.remat,
        remat_policy=cfg.parallel.remat_policy)


IRV2_QUANT = ("none", "int8", "int8_static")


def irv2_quant(cfg: Config) -> Optional[str]:
    """``model.irv2_quant`` as the modules take it (None for "none"); any
    value but none, int8 and int8_static raises (the JAX package would run
    the float path)."""
    q = cfg.model.irv2_quant
    if q not in IRV2_QUANT:
        raise ValueError(f"model.irv2_quant={q!r}: expected one of {IRV2_QUANT}")
    return None if q == "none" else q


def _video(cfg: Config, use_feat: bool, train: bool = False):
    from deepfake_tpu_torch.models.nextvlad import InceptionVideoClassifier

    m = cfg.model
    return InceptionVideoClassifier(
        num_frames=cfg.data.num_frames, num_classes=m.num_classes, use_feat=use_feat,
        fused_blocks=m.irv2_fused_blocks, drop_rate=m.swin_drop,
        classify_drop=m.classify_drop, bn_momentum=m.bn_momentum,
        quant=None if train else irv2_quant(cfg))


def _paudio(cfg: Config, use_feat: bool):
    from deepfake_tpu_torch.models.audio2d import Audio2D

    m = cfg.model
    return Audio2D(num_classes=m.num_classes, use_feat=use_feat, wav_config=wav_config(cfg),
                   model_drop=m.swin_drop, classify_drop=m.classify_drop)


def _video_swin(cfg: Config):
    from deepfake_tpu_torch.models.swin3d import VideoClassifier

    m, s = cfg.model, cfg.data.frame_size
    return VideoClassifier(
        input_size=(cfg.data.num_frames, s, s), num_classes=m.num_classes,
        embed_dim=m.swin3d_embed_dim, depths=tuple(m.swin3d_depths),
        num_heads=tuple(m.swin3d_heads), patch_size=tuple(m.swin3d_patch),
        window_size=tuple(m.swin3d_window), num_hiddens=m.num_hiddens, pool=m.video_pool,
        kernels=m.swin3d_attn_kernel, drop_path_rate=m.swin3d_drop_path,
        classify_drop=m.classify_drop, remat=cfg.parallel.remat,
        remat_policy=cfg.parallel.remat_policy)


def build_model(cfg: Config, device=None, train: bool = False) -> nn.Module:
    """The configured modality's model on ``device`` with random weights
    drawn from ``cfg.random_seed``: f32 in eval mode, or with ``train`` in
    train mode with ``parallel.param_dtype`` parameters and seeded dropout."""
    dev = resolve_device(device)
    irv2_quant(cfg)
    modality = cfg.data.modality
    if modality == "video":
        model = _video(cfg, False, train)
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
            _video(cfg, True, train), _swin(cfg, True), _paudio(cfg, True),
            dims=(1024, m.swin2d_embed_dim * 2 ** (len(m.swin2d_depths) - 1), m.wav_hidden),
            out_dim=m.num_classes, soft=m.soft, classify_drop=m.classify_drop)
    else:
        raise ValueError(f"unknown modality: {modality}")
    model = model.to(dev).eval()
    gens = make_generators(cfg.random_seed, dev)
    init_weights(model, gens.init)
    if cfg.model.parity_inference_dropout and not train:
        inference_dropout(model)
    if train:
        set_dropout_generator(model, gens.dropout)
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(_DTYPES[cfg.parallel.param_dtype])
        model.train()
    return model


def inference_dropout(model: nn.Module) -> nn.Module:
    """``model.parity_inference_dropout``: the dropouts that the reference
    applies ungated (F.dropout without ``training=``) stay active in eval
    mode, the three sites the JAX package gates on the flag: the IRv2
    pool's (inception_resnet_v2.py:400), NeXtVLAD's (nextvlad.py:136) and
    the paudio head's two (audio2d.py:40). Their masks come from the
    generator that ``set_dropout_generator`` gives (the Predictor's). A
    training model is built without it: the Trainer's evaluation runs
    without dropout."""
    from deepfake_tpu_torch.models.audio2d import Audio2D
    from deepfake_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2
    from deepfake_tpu_torch.models.nextvlad import InceptionVideoClassifier

    for mod in model.modules():
        sites = (("drop",) if isinstance(mod, InceptionResNetV2) else
                 ("vlad_drop",) if isinstance(mod, InceptionVideoClassifier) else
                 ("model_drop",) + (() if mod.use_feat else ("classify_drop",))
                 if isinstance(mod, Audio2D) else ())
        for name in sites:
            site = getattr(mod, name, None)
            if not isinstance(site, Dropout):
                raise AttributeError(f"{type(mod).__name__}.{name}: the inference-time "
                                     "dropout site is not a Dropout")
            site.at_inference = True
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


def pack_int8_weights(model: nn.Module) -> nn.Module:
    """Fold BN into every int8 conv's weights and quantise them per output
    channel from the f32 weights (the JAX package folds the cast
    parameters on every forward: the same numbers in f32). Call after the
    weights are final, or again after they change (the Trainer, before each
    evaluation pass): weights packed before are overwritten in place, so
    that a captured graph reads the new ones. Nothing to do without
    ``irv2_quant``."""
    from deepfake_tpu_torch.models.layers import Int8Owner

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Int8Owner) and mod.quant is not None:
                new, old = mod.pack_int8(), mod.int8_packed
                if old is None or old.wq.shape != new.wq.shape or old.wq.device != new.wq.device:
                    mod.int8_packed = new
                    continue
                for name in ("wq", "ws", "shift"):
                    getattr(old, name).copy_(getattr(new, name))
    return model


def set_irv2_quant(model: nn.Module, quant: Optional[str]) -> nn.Module:
    """The int8 mode (``irv2_quant``'s value) on every IRv2 trunk of
    ``model`` and its int8 convs; a module in train mode takes the float
    path whatever its mode."""
    from deepfake_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2
    from deepfake_tpu_torch.models.layers import Int8Owner

    for mod in model.modules():
        if isinstance(mod, (InceptionResNetV2, Int8Owner)):
            mod.quant = quant
    return model


def drop_inference_caches(model: nn.Module) -> nn.Module:
    """Forget the caches above (after new weights are loaded)."""
    for mod in model.modules():
        if hasattr(mod, "bias_cache"):
            mod.bias_cache = None
        if hasattr(mod, "packed"):
            mod.packed = None
        if hasattr(mod, "int8_packed"):
            mod.int8_packed = None
    return model


def reset_calibration(model: nn.Module) -> nn.Module:
    """Forget every int8_static activation scale (weights loaded since they
    were recorded): static mode runs the dynamic computation until
    ``calibrate_act_scales``."""
    from deepfake_tpu_torch.models.layers import Int8Owner

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Int8Owner):
                mod.reset_act_scales()
    return model


def calibrate_act_scales(model: nn.Module, run: Callable, batches: Iterable) -> int:
    """Record int8_static's activation scales (registry.py:162-199): every
    scale zeroed, then ``run(batch)`` (one eager eval forward of ``model``)
    for each batch, each int8_static conv folding the batch's max |input|
    into its scalar (the running max over the batches). Convs that ran none
    stay uncalibrated, and a model in another mode records nothing, as in
    JAX. Returns the number of scalars calibrated."""
    from deepfake_tpu_torch.models.layers import Int8Owner

    owners = [m for m in model.modules() if isinstance(m, Int8Owner)]
    reset_calibration(model)
    for m in owners:
        m.calibrating = True
    try:
        with torch.inference_mode():
            for batch in batches:
                run(batch)
    finally:
        for m in owners:
            m.calibrating = False
    return sum(len(m.calibrated) for m in owners)
