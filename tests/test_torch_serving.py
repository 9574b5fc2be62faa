"""The port's slice as a whole: fused serving through
``deepfake_tpu_torch.serving.Predictor`` against the JAX fused model, plus
the port's rules (import isolation, device policy, strict weight loading)."""

import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import SMALL_FUSED, both_configs, random_variables


@pytest.fixture(scope="module")
def fused_case():
    """Small fused geometry (2 frames of 96x96, 56x56 mel, a 2-layer 64-wide
    wav2vec2), randomised JAX weights, and batch-2 inputs."""
    from deepfake_tpu.models.registry import build_model

    jcfg, tcfg = both_configs(SMALL_FUSED)
    model = build_model(jcfg)
    rng = np.random.default_rng(11)
    inputs = (rng.standard_normal((2, 2, 96, 96, 3)).astype(np.float32) * 0.5,
              rng.standard_normal((2, 56, 56, 3)).astype(np.float32),
              rng.standard_normal((2, 4000)).astype(np.float32))
    variables = random_variables(model, tuple(jnp.asarray(a) for a in inputs),
                                 deterministic=True, seed=12)
    apply = jax.jit(lambda v, x: model.apply(v, x, deterministic=True))
    return apply, variables, tcfg, inputs


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel_routes", "plain_routes"])
def test_fused_predictor_matches_jax(fused_case, kernels):
    """Port Predictor (device='cpu', f32) == JAX fused model.apply on its
    default XLA path: each score within 1e-4 (repo target 1e-3, PARITY.md)."""
    from deepfake_tpu_torch.serving import Predictor

    apply, variables, tcfg, inputs = fused_case
    want = np.asarray(apply(variables, tuple(jnp.asarray(a) for a in inputs)))
    cfg = copy.deepcopy(tcfg)
    cfg.model.irv2_fused_blocks = kernels
    cfg.model.swin2d_attn_kernel = kernels
    got = Predictor(cfg, variables, device="cpu").predict(inputs)
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fused_predictor_wave_lengths_matches_jax(fused_case):
    """The (wave, lengths) input form of the paudio branch, batch-longest
    masking included: scores within 1e-4."""
    from deepfake_tpu_torch.serving import Predictor

    apply, variables, tcfg, (video, audio, wave) = fused_case
    lengths = np.asarray([3000, 3700], np.int32)
    want = np.asarray(apply(variables, (jnp.asarray(video), jnp.asarray(audio),
                                        (jnp.asarray(wave), jnp.asarray(lengths)))))
    got = Predictor(tcfg, variables, device="cpu").predict((video, audio, (wave, lengths)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fused_predictor_bf16_serves(fused_case):
    """The serving default, bf16, on the same weights: K1's packed weights
    pass the wrapper's checks after the parameters are cast, and each score
    is within 2e-2 of the JAX f32 score (bf16 keeps ~3 significant digits
    through ~100 layers of random weights)."""
    from deepfake_tpu_torch.serving import Predictor

    apply, variables, tcfg, inputs = fused_case
    want = np.asarray(apply(variables, tuple(jnp.asarray(a) for a in inputs)))
    cfg = copy.deepcopy(tcfg)
    cfg.parallel.compute_dtype = "bfloat16"
    pred = Predictor(cfg, variables, device="cpu")
    assert next(pred.model.parameters()).dtype == torch.bfloat16
    assert all(b.dtype != torch.bfloat16 for b in pred.model.buffers())
    got = pred.predict(inputs)
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("modality", ["video", "audio", "paudio"])
def test_single_modality_predictor_matches_jax(modality):
    """build_model's other modalities (the fused model's branches with their
    own heads) through Predictor, kernels on, on inputs of example_inputs'
    shapes, against the JAX model on its default XLA path: scores within
    1e-4."""
    from deepfake_tpu.models.registry import build_model
    from deepfake_tpu_torch.models.registry import example_inputs
    from deepfake_tpu_torch.serving import Predictor

    jcfg, tcfg = both_configs(dict(SMALL_FUSED, **{"data.modality": modality}))
    model = build_model(jcfg)
    (zeros,) = example_inputs(tcfg, batch=2, device="cpu")
    x = np.random.default_rng(13).standard_normal(zeros.shape).astype(np.float32) * 0.5
    variables = random_variables(model, jnp.asarray(x), deterministic=True, seed=14)
    apply = jax.jit(lambda v, a: model.apply(v, a, deterministic=True))
    want = np.asarray(apply(variables, jnp.asarray(x)))
    got = Predictor(tcfg, variables, device="cpu").predict(x)
    assert got.shape == (2,)
    np.testing.assert_allclose(got, np.atleast_1d(want), atol=1e-4, rtol=0)


def test_port_imports_no_jax_and_no_jax_package():
    """Importing every module of deepfake_tpu_torch (the Swin3D model, the
    K3, K4, K5 and K6 wrappers, the training modules, the feature
    assembly, the data modules, SubmitCtl and the CLIs among them, the
    training CLI ``train/__main__.py`` imported without running, the
    checkpoints and the loop's observability) loads no jax* module and
    nothing of deepfake_tpu, nor cv2 (imported only inside the functions
    that decode or encode) nor matplotlib (only inside ``Drawer.draw``)."""
    code = (
        "import importlib, pkgutil, sys, deepfake_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "             or m == 'deepfake_tpu' or m.startswith('deepfake_tpu.'))\n"
        "need = {'deepfake_tpu_torch.models.swin3d', 'deepfake_tpu_torch.ops.window_attn3d_kernel',\n"
        "        'deepfake_tpu_torch.ops.ln_linear_kernel', 'deepfake_tpu_torch.ops.window_attn3d_train',\n"
        "        'deepfake_tpu_torch.train.trainer', 'deepfake_tpu_torch.train.schedule',\n"
        "        'deepfake_tpu_torch.train.losses', 'deepfake_tpu_torch.utils.seeding',\n"
        "        'deepfake_tpu_torch.utils.metrics', 'deepfake_tpu_torch.utils.logging',\n"
        "        'deepfake_tpu_torch.ops.window_attn_multihead', 'deepfake_tpu_torch.ops.mel',\n"
        "        'deepfake_tpu_torch.ops.resample', 'deepfake_tpu_torch.ops.image',\n"
        "        'deepfake_tpu_torch.data.pipeline', 'deepfake_tpu_torch.data.dataset',\n"
        "        'deepfake_tpu_torch.data.audio_io', 'deepfake_tpu_torch.data.video_decode',\n"
        "        'deepfake_tpu_torch.data.chunking', 'deepfake_tpu_torch.data.synthetic',\n"
        "        'deepfake_tpu_torch.data.audio_images', 'deepfake_tpu_torch.train.submit',\n"
        "        'deepfake_tpu_torch.test', 'deepfake_tpu_torch.audio_preprocess',\n"
        "        'deepfake_tpu_torch.train.__main__', 'deepfake_tpu_torch.models.fusion',\n"
        "        'deepfake_tpu_torch.io.checkpoint', 'deepfake_tpu_torch.utils.profiling',\n"
        "        'deepfake_tpu_torch.utils.watchdog', 'deepfake_tpu_torch.utils.init'}\n"
        "bad += sorted(need - set(sys.modules))\n"
        "bad += [m for m in ('cv2', 'matplotlib') if m in sys.modules]  # imported where used\n"
        "print(len([m for m in sys.modules if m.startswith('deepfake_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 10  # the package's modules did import


def test_predictor_without_cuda_raises_unless_cpu_asked(monkeypatch):
    from deepfake_tpu_torch.models.registry import resolve_device
    from deepfake_tpu_torch.serving import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = both_configs(SMALL_FUSED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _nextvlad_pair():
    from deepfake_tpu.models.nextvlad import NeXtVLAD as J
    from deepfake_tpu_torch.models.nextvlad import NeXtVLAD as T

    kw = dict(dim=16, num_clusters=4, lamb=2, groups=2, max_frames=3)
    variables = random_variables(J(**kw), jnp.zeros((1, 3, 16)))
    return T(**kw), variables


def test_load_jax_variables_is_strict():
    from deepfake_tpu_torch.io.jax_weights import load_jax_variables

    tm, variables = _nextvlad_pair()
    load_jax_variables(tm, variables)  # the full tree loads

    missing = {k: dict(v) for k, v in variables.items()}
    del missing["params"]["fc_g"]
    with pytest.raises(KeyError, match="not set by the JAX variables.*fc_g"):
        load_jax_variables(_nextvlad_pair()[0], missing)

    extra = {k: dict(v) for k, v in variables.items()}
    extra["params"]["fc_extra"] = {"kernel": np.zeros((16, 2), np.float32)}
    with pytest.raises(KeyError, match="params/fc_extra/kernel"):
        load_jax_variables(_nextvlad_pair()[0], extra)

    shape = {k: dict(v) for k, v in variables.items()}
    shape["params"]["cluster_weights2"] = np.zeros((1, 2, 2), np.float32)
    with pytest.raises(ValueError, match="params/cluster_weights2"):
        load_jax_variables(_nextvlad_pair()[0], shape)

    with pytest.raises(ValueError, match="collections"):
        load_jax_variables(_nextvlad_pair()[0], dict(variables, bias_cache={}))
