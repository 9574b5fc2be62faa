"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py): one
dotted override set configures both packages, and both take the same random
numpy weights."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

SMALL_FUSED = {
    "data.modality": "fused",
    "data.num_frames": 2,
    "data.frame_size": 96,
    "data.audio_size": 56,
    "model.swin2d_embed_dim": 16,
    "model.swin2d_depths": (2, 2),
    "model.swin2d_heads": (2, 4),
    "model.wav_layers": 2,
    "model.wav_hidden": 64,
    "model.wav_heads": 4,
    "model.wav_intermediate": 128,
    "model.wav_conv_dim": 64,
    "parallel.compute_dtype": "float32",
}


def both_configs(overrides):
    """(JAX Config, port Config) with the same overrides."""
    from deepfake_tpu.config import Config as JaxConfig
    from deepfake_tpu_torch.config import Config

    jcfg, tcfg = JaxConfig(), Config()
    for k, v in overrides.items():
        obj = jcfg
        parts = k.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], v)
        tcfg.set(k, v)
    return jcfg, tcfg


def random_variables(model, *inputs, seed: int = 0, **kw):
    """Random numpy variables with the tree ``model.init`` would give (only
    its shapes are traced, nothing is computed): kernels lecun-normal,
    biases and BN means ~0.1, norm scales around 1, BN running var in
    [0.5, 1.5], so that folded BatchNorm, biases and norm scales all matter."""
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: model.init(rngs, *inputs, **kw))
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        n = rng.standard_normal(shape).astype(np.float32)
        if name in ("kernel", "qkv_kernel"):
            return n / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.2 * n
        if name == "logit_scale":
            return np.float32(np.log(10.0)) + 0.3 * n
        if name in ("cluster_weights2", "masked_spec_embed"):
            return rng.uniform(0.0, 1.0, shape).astype(np.float32)
        return 0.1 * n  # bias, q_bias, v_bias, mean

    return walk(shapes)


@pytest.fixture(autouse=True, scope="module")
def torch_on_one_thread():
    """torch on one thread for a test module that imports this fixture: the
    suite's workers share the machine's cores, and a worker's torch threads
    spend their time in OpenMP barriers waiting for cores the other workers
    hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
