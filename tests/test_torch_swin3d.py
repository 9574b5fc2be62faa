"""The port's Video Swin 3D (deepfake_tpu_torch/models/swin3d.py) and
``video_swin`` serving against the JAX package's swin3d.py, weights carried
across with load_jax_variables. All f32 on the CPU.

The JAX side runs one of three routes: its default Pallas routes (interpret
mode), where ``pallas_window_attention_nhc_qkv`` computes LayerNorm, qkv,
attention and proj and ``fused_mlp_tail`` the MLP half (its minimum token
count set to 0, so that the small test shapes take it); its ``nhc`` route,
where ``pallas_window_attention_nhc`` computes the attention alone; or its
einsum route (``use_pallas=False``). The port runs the plain versions of K3
and K4 (its kernel route, the same for the first two) or its own plain
route.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_tpu_torch.io.jax_weights import load_jax_variables
from deepfake_tpu_torch.models.registry import precompute_bias_cache

from tests.torch_port_helpers import both_configs, random_variables, torch_on_one_thread  # noqa: F401 (autouse)

SMALL_VIDEO_SWIN = {
    # stage 0: 8 x 14 x 14 tokens, four (8,7,7) windows of N = 392 per clip
    "data.modality": "video_swin",
    "data.num_frames": 16,
    "data.frame_size": 56,
    "model.swin3d_embed_dim": 32,
    "model.swin3d_depths": (2, 2),
    "model.swin3d_heads": (1, 2),
    "model.swin3d_window": (8, 7, 7),
    "model.num_hiddens": 16,
    "parallel.compute_dtype": "float32",
}


def jax_routes(monkeypatch, routes: str):
    """Pallas in interpret mode, and for ``"nhc"`` QKV fusion and the MLP
    tail off, so WindowAttention3D takes the ``nhc`` route
    (swin3d.py:531-547); for ``"fused"`` the default routes, with the MLP
    tail's minimum token count at 0."""
    monkeypatch.setenv("DEEPFAKE_TPU_PALLAS_INTERPRET", "1")
    if routes == "nhc":
        monkeypatch.setenv("DEEPFAKE_TPU_NO_QKV_FUSE", "1")
        monkeypatch.setenv("DEEPFAKE_TPU_NO_MLP_TAIL", "1")
    else:
        monkeypatch.setenv("DEEPFAKE_TPU_MLP_TAIL_MINL", "0")


def count_calls(monkeypatch, calls, module, names):
    """Count in ``calls`` the calls of ``module.<name>`` for each name (the
    JAX model imports them from the module at call time)."""
    calls.update(dict.fromkeys(names, 0))
    for name in names:
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, spy)


@pytest.fixture
def nhc_route(monkeypatch):
    jax_routes(monkeypatch, "nhc")


@pytest.fixture
def fused_routes(monkeypatch):
    """The JAX default routes, with a count of the calls of the QKV-fused
    attention and MLP-tail kernels."""
    from deepfake_tpu.ops import pallas_mlp, pallas_window_attn

    jax_routes(monkeypatch, "fused")
    calls = {}
    count_calls(monkeypatch, calls, pallas_window_attn, ["pallas_window_attention_nhc_qkv"])
    count_calls(monkeypatch, calls, pallas_mlp, ["fused_mlp_tail"])
    return calls


@pytest.mark.parametrize("shape,shift", [
    ((2, 8, 14, 14, 64), (0, 0, 0)),
    ((2, 8, 14, 14, 64), (4, 3, 3)),
    ((1, 8, 10, 10, 64), (4, 3, 3)),  # H, W padded to 14 before the roll
], ids=["unshifted", "shifted", "padded_shifted"])
def test_swin_block3d_matches_jax_nhc(nhc_route, shape, shift):
    """SwinBlock3D, attention through K3's plain token-major version, against
    the JAX block on its nhc route: max abs error <= 2e-5."""
    from deepfake_tpu.models.swin3d import SwinBlock3D as J
    from deepfake_tpu_torch.models.swin3d import SwinBlock3D as T

    x = np.random.default_rng(20).standard_normal(shape).astype(np.float32)
    jblock = J(dim=64, num_heads=2, window_size=(8, 7, 7), shift_size=shift, use_pallas=True)
    variables = random_variables(jblock, jnp.asarray(x), seed=21, deterministic=True)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), deterministic=True))
    tblock = T(64, shape[1:4], 2, (8, 7, 7), shift, kernels=True)
    load_jax_variables(tblock, variables)
    precompute_bias_cache(tblock)
    with torch.inference_mode():
        got = tblock(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape,shift", [
    ((2, 8, 14, 14, 64), (0, 0, 0)),
    ((2, 8, 14, 14, 64), (4, 3, 3)),
    ((1, 8, 10, 10, 64), (4, 3, 3)),  # padded: the JAX kernel and K4 take a normed input
], ids=["unshifted", "shifted", "padded_shifted"])
def test_swin_block3d_matches_jax_fused_routes(fused_routes, shape, shift):
    """SwinBlock3D on its kernel route (K4's and K3's plain versions) against
    the JAX block on its default routes, where the QKV-fused attention
    kernel and the MLP-tail kernel each run once: max abs error <= 2e-5."""
    from deepfake_tpu.models.swin3d import SwinBlock3D as J
    from deepfake_tpu_torch.models.swin3d import SwinBlock3D as T

    x = np.random.default_rng(24).standard_normal(shape).astype(np.float32)
    jblock = J(dim=64, num_heads=2, window_size=(8, 7, 7), shift_size=shift, use_pallas=True)
    variables = random_variables(jblock, jnp.asarray(x), seed=25, deterministic=True)
    fused_routes.update(dict.fromkeys(fused_routes, 0))
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), deterministic=True))
    assert fused_routes == {"pallas_window_attention_nhc_qkv": 1, "fused_mlp_tail": 1}
    tblock = T(64, shape[1:4], 2, (8, 7, 7), shift, kernels=True)
    load_jax_variables(tblock, variables)
    precompute_bias_cache(tblock)
    with torch.inference_mode():
        got = tblock(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _classifier_case(frames: int, jax_pallas: bool, window=(8, 7, 7)):
    from deepfake_tpu.models.registry import build_model

    jcfg, tcfg = both_configs(dict(SMALL_VIDEO_SWIN, **{"data.num_frames": frames,
                                                        "model.swin3d_window": window}))
    jcfg.model.swin3d_pallas_attn = jax_pallas
    model = build_model(jcfg)
    x = np.random.default_rng(22).standard_normal((2, frames, 56, 56, 3)).astype(np.float32)
    variables = random_variables(model, jnp.asarray(x), seed=23, deterministic=True)
    return model, variables, tcfg, x


@pytest.mark.parametrize("frames,routes,window", [
    (16, "nhc", (8, 7, 7)), (16, "einsum", (8, 7, 7)), (8, "nhc", (8, 7, 7)),
    (16, "fused", (8, 7, 7)), (8, "fused", (8, 7, 7)), (32, "nhc", (16, 7, 7)),
], ids=["16f_k3_vs_nhc", "16f_plain_vs_einsum", "8f_clamped_k3_vs_nhc",
        "16f_kernels_vs_fused", "8f_clamped_kernels_vs_fused", "32f_window16x7x7_k3_vs_nhc"])
def test_video_classifier_matches_jax(monkeypatch, frames, routes, window):
    """VideoClassifier at small width (embed 32, depths 2/2, heads 1/2,
    window (8,7,7), 56x56): scores and per-frame features within 1e-4 of
    the JAX model. The port's kernel route (K3's and K4's plain versions)
    faces the JAX nhc route and the JAX default (QKV-fused, MLP-tail)
    routes, the port's plain route the JAX einsum route. 8 frames give 4
    tokens in time, so the window clamps to (4,7,7) and the bias takes the
    [:N, :N] slice of the (8,7,7) index. 32 frames at window (16,7,7) is
    Video Swin-B's Something-Something v2 setting: 16 tokens in time fill
    the window (N = 784, the temporal shift clamps to 0)."""
    from deepfake_tpu_torch.models.registry import build_model as tbuild

    jax_routes(monkeypatch, routes)
    kernel = routes != "einsum"
    model, variables, tcfg, x = _classifier_case(frames, jax_pallas=kernel, window=window)
    want_p, want_f = model.apply(variables, jnp.asarray(x), deterministic=True)
    cfg = copy.deepcopy(tcfg)
    cfg.model.swin3d_attn_kernel = kernel
    tmodel = tbuild(cfg, "cpu")
    if frames == 8:
        assert tmodel.videoSwinT.layers_0_blocks_1.ws == (4, 7, 7)
    if window == (16, 7, 7):
        blk = tmodel.videoSwinT.layers_0_blocks_1
        assert blk.ws == (16, 7, 7) and blk.ss == (0, 3, 3) and blk.attn_mask.shape[1] == 784
    load_jax_variables(tmodel, variables)
    precompute_bias_cache(tmodel)
    with torch.inference_mode():
        got_p, got_f = tmodel(torch.from_numpy(x))
    assert got_f.shape == want_f.shape
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-4, rtol=0)


def test_video_swin_predictor_matches_jax(fused_routes):
    """``Predictor(device="cpu")`` for video_swin, JAX variables loaded,
    against the JAX VideoClassifier on its default routes: scores within
    1e-4, and the JAX model's tree loads strictly (no leaf left over or
    missing)."""
    from deepfake_tpu_torch.serving import Predictor

    model, variables, tcfg, x = _classifier_case(16, jax_pallas=True)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, deterministic=True)[0])(
        variables, jnp.asarray(x)))
    assert fused_routes["pallas_window_attention_nhc_qkv"] and fused_routes["fused_mlp_tail"]
    pred = Predictor(tcfg, variables, device="cpu")
    got = pred.predict(x)
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    bias = pred.model.videoSwinT.layers_0_blocks_0.attn.bias_cache
    assert bias is not None and bias.shape == (1, 392, 392)


def test_video_swin_preset_and_inputs():
    """The video_swin preset and example_inputs give the full-width shapes:
    32 frames of 224x224, num_hiddens 256, mean pooling, K3 and K4 on."""
    from deepfake_tpu_torch.config import Config
    from deepfake_tpu_torch.models.registry import example_inputs

    cfg = Config.preset("video_swin")
    assert cfg.data.modality == "video_swin" and cfg.model.num_hiddens == 256
    assert cfg.model.swin3d_attn_kernel and cfg.model.video_pool == "mean"
    (x,) = example_inputs(cfg, batch=2, device="cpu")
    assert tuple(x.shape) == (2, 32, 224, 224, 3)


def _flat_stats(tree, path=()):
    """A flax batch_stats tree as the port's running-statistic names."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat_stats(v, path + (k,)))
        else:
            out[".".join(path + ("running_mean" if k == "mean" else "running_var",))] = v
    return out


def _check_head(got, want, tmodel=None, new_stats=None):
    (got_l, got_f), (want_l, want_f) = got, want
    assert tuple(got_f.shape) == tuple(np.shape(want_f))
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(want_l), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_f.detach().numpy(), np.asarray(want_f), atol=1e-4, rtol=0)
    if new_stats is not None:
        state = tmodel.state_dict()
        stats = _flat_stats(new_stats)
        assert len(stats) == 4  # down_bn1, down_bn2: mean and var
        for k, v in stats.items():
            np.testing.assert_allclose(state[k].numpy(), np.asarray(v), atol=1e-5,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_attention_pooling_head_matches_jax(train):
    """PoolingMLP(pool="Attention") alone on a [2, 8, 7, 7, 64] map against
    the JAX head (swin3d.py:1075-1164): down convs and BatchNorms, the CLS
    token and position embedding, six post-norm encoder layers over the 9
    tokens of a clip, the projection Mlp; logits and frame tokens within
    1e-4, in eval mode and in train mode (batch statistics; the running
    statistics moved as flax moves them)."""
    from deepfake_tpu.models.swin3d import PoolingMLP as J
    from deepfake_tpu_torch.models.swin3d import PoolingMLP as T

    x = np.random.default_rng(30).standard_normal((2, 8, 7, 7, 64)).astype(np.float32)
    jhead = J(in_feature=64, num_hidden=16, pool="Attention", classify_drop=0.0)
    variables = random_variables(jhead, jnp.asarray(x), seed=31, deterministic=True)
    thead = T(64, 16, 1, "Attention", 0.0, size=(8, 7, 7))
    load_jax_variables(thead, variables)
    if train:
        want, new = jhead.apply(variables, jnp.asarray(x), deterministic=False,
                                mutable=["batch_stats"])
        thead.train()
    else:
        want, new = jhead.apply(variables, jnp.asarray(x), deterministic=True), None
    with torch.no_grad():
        got = thead(torch.from_numpy(x))
    _check_head(got, want, thead, None if new is None else new["batch_stats"])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_attention_pooling_classifier_matches_jax(train):
    """VideoClassifier at SMALL_VIDEO_SWIN with pool="Attention" (56^2
    frames give the head its 7x7 map; 16 frames, 8 tokens in time) against
    the JAX model, both on their plain routes, DropPath and dropout at 0:
    scores and the 512-d frame tokens within 1e-4, in eval mode and in train
    mode (the head's BatchNorms on batch statistics)."""
    from deepfake_tpu.models.swin3d import VideoClassifier as J
    from deepfake_tpu_torch.models.swin3d import VideoClassifier as T

    kw = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=(8, 7, 7),
              num_hiddens=16, pool="Attention", drop_path_rate=0.0, classify_drop=0.0)
    x = np.random.default_rng(32).standard_normal((2, 16, 56, 56, 3)).astype(np.float32)
    jmodel = J(**kw, use_pallas=False)
    variables = random_variables(jmodel, jnp.asarray(x), seed=33, deterministic=True)
    tmodel = T((16, 56, 56), **kw)
    load_jax_variables(tmodel, variables)
    if train:
        want, new = jmodel.apply(variables, jnp.asarray(x), deterministic=False,
                                 mutable=["batch_stats"])
        tmodel.train()
    else:
        want, new = jmodel.apply(variables, jnp.asarray(x), deterministic=True), None
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert tuple(got[1].shape) == (2, 8, 512)
    _check_head(got, want, tmodel, None if new is None else new["batch_stats"])


def test_attention_pooling_predictor_matches_jax(fused_routes):
    """``Predictor(device="cpu")`` for video_swin at --video_pool Attention
    (SMALL_VIDEO_SWIN: the backbone on K3's and K4's plain versions, the
    head in PyTorch) against the JAX VideoClassifier on its default routes:
    scores and features within 1e-4; the JAX tree, the head's included,
    loads strictly."""
    from deepfake_tpu.models.registry import build_model
    from deepfake_tpu_torch.serving import Predictor

    jcfg, tcfg = both_configs(dict(SMALL_VIDEO_SWIN, **{"model.video_pool": "Attention"}))
    model = build_model(jcfg)
    x = np.random.default_rng(34).standard_normal((2, 16, 56, 56, 3)).astype(np.float32)
    variables = random_variables(model, jnp.asarray(x), seed=35, deterministic=True)
    want_p, want_f = jax.jit(lambda v, a: model.apply(v, a, deterministic=True))(
        variables, jnp.asarray(x))
    pred = Predictor(tcfg, variables, device="cpu")
    np.testing.assert_allclose(pred.predict(x), np.asarray(want_p), atol=1e-4, rtol=0)
    feat = pred.forward(x)[1]
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_f), atol=1e-4, rtol=0)


def test_attention_pooling_takes_the_7x7_map_only():
    """The attention head collapses a 7x7 map (224^2 clips at Video Swin's
    four stages, 56^2 at two) to one token a frame: a backbone that gives
    another map, a forward on another map and an unknown pool all raise."""
    from deepfake_tpu_torch.models.swin3d import PoolingMLP, VideoClassifier

    with pytest.raises(ValueError, match="7x7"):
        VideoClassifier((16, 112, 112), embed_dim=32, depths=(2, 2), num_heads=(1, 2),
                        num_hiddens=16, pool="Attention")
    head = PoolingMLP(64, 16, 1, pool="Attention", size=(8, 7, 7))
    with pytest.raises(ValueError, match="7x7"):
        head(torch.zeros(1, 8, 14, 14, 64))
    with pytest.raises(ValueError, match="pool="):
        PoolingMLP(64, 16, 1, pool="max")
