"""The port's train-side feature assembly against the JAX package on the CPU:
the augmentation's draw-free core (flips and nearest-neighbour rotation) on
the JAX function's own draws, ``FeatureAssembler(train=True)`` for every
modality that carries frames, and ``batch_longest`` waves normalised per
accumulation micro-batch. Inputs from numpy seeds; f32."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import both_configs, torch_on_one_thread  # noqa: F401 (autouse)

from deepfake_tpu_torch.ops.image import (
    augment_clip, draw_augmentation, normalize_imagenet, rotate_nearest,
)

# a pixel whose inversely rotated source coordinate lies this close to a .5
# rounding edge may round the other way in the two packages (their sin and
# cos differ in the last f32 bit)
EDGE = 1e-4


def _near_edge(H: int, W: int, angles) -> np.ndarray:
    """[n, H, W] bool: the output pixels whose source row or column lies
    within EDGE of a rounding edge, for each angle in degrees."""
    theta = -np.asarray(angles, np.float64)[:, None, None] * np.pi / 180.0
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    y0 = (np.arange(H) - cy)[None, :, None]
    x0 = (np.arange(W) - cx)[None, None, :]
    sy = cy + y0 * np.cos(theta) - x0 * np.sin(theta)
    sx = cx + y0 * np.sin(theta) + x0 * np.cos(theta)
    edge = lambda s: np.abs(s - np.floor(s) - 0.5) < EDGE
    return edge(sy) | edge(sx)


def _equal_off_edges(got: np.ndarray, want: np.ndarray, near: np.ndarray) -> int:
    """Assert got == want at every pixel off a rounding edge and that the
    edge pixels are few (at most 1% of a frame); returns how many differ."""
    differ = np.any(got != want, axis=-1)
    assert not np.any(differ & ~near), np.argwhere(differ & ~near)[:5]
    assert near.mean() <= 1e-2, near.mean()
    return int(differ.sum())


@pytest.mark.parametrize("angle", [0.0, 90.0, -90.0, 45.0, -30.25, 12.5, 89.999, -7.0])
def test_rotate_nearest_matches_jax(angle):
    """One [H, W, C] frame at a given angle against the JAX rotate_nearest:
    equal off the rounding edges; quarter turns and 0 exactly."""
    from deepfake_tpu.ops.image import rotate_nearest as jrotate

    frame = np.random.default_rng(60).standard_normal((23, 31, 3)).astype(np.float32)
    want = np.asarray(jrotate(jnp.asarray(frame), jnp.float32(angle)))
    got = rotate_nearest(torch.from_numpy(frame), torch.tensor([angle])).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    differ = _equal_off_edges(got[None], want[None], _near_edge(23, 31, [angle]))
    if angle in (0.0, 90.0, -90.0):
        assert differ == 0


def _jax_draws(key, T: int, per_frame: bool):
    """The draws JAX's augment_clip makes from ``key`` (its own splits),
    broadcast over the clip's T frames."""
    n = T if per_frame else 1
    k_h, k_v, k_r = jax.random.split(key, 3)
    draws = (jax.random.bernoulli(k_h, 0.5, (n,)), jax.random.bernoulli(k_v, 0.5, (n,)),
             jax.random.uniform(k_r, (n,), minval=-90.0, maxval=90.0))
    return [np.broadcast_to(np.asarray(d), (T,)) for d in draws]


@pytest.mark.parametrize("per_frame", [False, True], ids=["per_clip", "per_frame"])
def test_augment_clip_matches_jax_on_its_draws(per_frame):
    """augment_clip(frames, hflip, vflip, angle) against the JAX
    augment_clip, fed the draws that function makes from its key: eight
    clips of 5 frames, equal off the rounding edges, the edge pixels that
    differ counted and bounded; the draws include both flips."""
    from deepfake_tpu.ops.image import augment_clip as jaugment

    rng = np.random.default_rng(61)
    T, H, W = 5, 20, 28
    differ, seen = 0, set()
    for i in range(8):
        clip = rng.standard_normal((T, H, W, 3)).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        want = np.asarray(jaugment(key, jnp.asarray(clip), per_frame))
        h, v, a = _jax_draws(key, T, per_frame)
        seen.update(zip(h.tolist(), v.tolist()))
        got = augment_clip(torch.from_numpy(clip), torch.from_numpy(h.copy()),
                           torch.from_numpy(v.copy()), torch.from_numpy(a.copy())).numpy()
        differ += _equal_off_edges(got, want, _near_edge(H, W, a))
    assert len(seen) == 4, seen  # every flip combination was drawn
    assert differ <= 1e-3 * 8 * T * H * W, differ


def test_draw_augmentation_per_clip_and_per_frame():
    """One draw a clip is the same for all its frames; per_frame draws
    differ between frames; angles lie in [-90, 90)."""
    gen = torch.Generator().manual_seed(3)
    h, v, a = draw_augmentation(gen, 16, 4)
    assert h.shape == v.shape == a.shape == (16, 4) and h.dtype == torch.bool
    assert torch.equal(a, a[:, :1].expand(16, 4)) and torch.equal(h, h[:, :1].expand(16, 4))
    assert (a >= -90).all() and (a < 90).all() and 0 < h.sum() < 64
    _, _, a = draw_augmentation(gen, 16, 4, per_frame=True)
    assert len(set(a.flatten().tolist())) == 64


TRAIN_FEATS = {
    "video": {"data.modality": "video"},
    "video_swin": {"data.modality": "video_swin"},
    # accum 1: the paudio wave is normalised over the whole batch, as in evaluation
    "fused": {"data.modality": "fused", "data.audio_size": 56, "optim.accum_step": 1},
}


@pytest.mark.parametrize("modality", list(TRAIN_FEATS))
def test_train_feature_assembler_augments_frames(modality):
    """FeatureAssembler(train=True) for every modality with frames: f32
    NTHWC of the clip's shape; each clip is augment_clip of the normalised
    frames on the draws of a generator seeded with random_seed + 1; two
    calls draw different augmentations; the other inputs of a fused batch
    are the evaluation assembler's."""
    from tests.test_torch_audio import _pcm
    from deepfake_tpu_torch.data.pipeline import FeatureAssembler

    _, cfg = both_configs(TRAIN_FEATS[modality])
    rng = np.random.default_rng(62)
    feats = {"video": rng.integers(0, 256, (4, 3, 16, 16, 3), dtype=np.uint8)}
    if modality == "fused":
        feats.update(zip(("audio_wave", "audio_len"), _pcm(4, 24000, 52)))
        feats.update(zip(("paudio_wave", "paudio_len"), _pcm(4, 4000, 53)))
    labels = np.asarray([0.0, 1.0, 1.0, 0.0], np.float32)
    asm = FeatureAssembler(cfg, train=True, device="cpu")
    first, tl = asm(feats, labels)
    second, _ = asm(feats, labels)
    ev, _ = FeatureAssembler(cfg, train=False, device="cpu")(feats, labels)
    np.testing.assert_array_equal(tl.numpy(), labels)
    if modality == "fused":
        for g, e in zip(first[1:], ev[1:]):
            g, e = (g[0], e[0]) if isinstance(g, tuple) else (g, e)
            torch.testing.assert_close(g, e, rtol=0, atol=0)
        first, second, ev = first[0], second[0], ev[0]
    assert first.shape == (4, 3, 16, 16, 3) and first.dtype == torch.float32
    gen = torch.Generator().manual_seed(cfg.random_seed + 1)
    x = normalize_imagenet(torch.from_numpy(feats["video"]))
    want = augment_clip(x, *draw_augmentation(gen, 4, 3))
    torch.testing.assert_close(first, want, rtol=0, atol=0)
    assert not torch.equal(first, second)
    assert not torch.equal(first, ev)


@pytest.mark.parametrize("accum,batch", [(2, 4), (3, 6), (4, 6)])
def test_batch_longest_per_micro_batch_matches_jax(accum, batch):
    """In training, batch_longest waves are normalised over each of the
    accum micro-batches (the reference's per-DataLoader-batch statistics),
    as the JAX assembler does; a batch that accum does not divide is
    normalised whole, as there. Within 1e-5; the lengths pass through."""
    from tests.test_torch_audio import _pcm
    from deepfake_tpu.data.pipeline import FeatureAssembler as J
    from deepfake_tpu_torch.data.pipeline import FeatureAssembler as T

    jcfg, tcfg = both_configs({"data.modality": "paudio", "data.wave_norm": "batch_longest",
                               "optim.accum_step": accum})
    wave, lengths = _pcm(batch, 4000, 63)
    lengths[: batch // 2] //= 3  # the micro-batches' longest lengths differ
    feats = {"paudio_wave": wave, "paudio_len": lengths}
    labels = np.zeros(batch, np.float32)
    (want, wl), _ = J(jcfg, train=True)(feats, labels)
    (got, gl), _ = T(tcfg, train=True, device="cpu")(feats, labels)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * max(1.0, np.abs(np.asarray(want)).max()))
    (whole, _), _ = T(tcfg, train=False, device="cpu")(feats, labels)
    assert (batch % accum == 0) != torch.equal(got, whole)


def test_zero_fill_with_zero_biases_gives_huge_finite_gradients_in_both_packages():
    """A clip with a zero-filled corner (what a rotation leaves in the
    normalised frame) through a Video Swin model whose biases are zero (the
    init's): the corner's tokens stay exactly zero through every block,
    each LayerNorm there sees zero variance, and the gradient explodes, in
    the JAX package as in the port (above 1e10 in both); with random
    biases it is ordinary in both (below 10). After one unclipped SGD step
    at the Trainer's rate (1e-4) the corner's tokens are equal and large,
    and the second step's gradient is finite in both packages: the
    reference's softmax holds at such logits, so the port's kernels must
    too (chip_smoke.py trains the init's weights on the card)."""
    from tests.test_torch_swin3d import SMALL_VIDEO_SWIN
    from tests.torch_port_helpers import random_variables
    from deepfake_tpu.models.registry import build_model as jbuild
    from deepfake_tpu.train.losses import bce_with_logits as jbce
    from deepfake_tpu_torch.io.jax_weights import load_jax_variables
    from deepfake_tpu_torch.models.registry import build_model
    from deepfake_tpu_torch.train.losses import bce_with_logits

    jcfg, tcfg = both_configs(dict(SMALL_VIDEO_SWIN, **{"model.swin3d_drop_path": 0.0,
                                                        "model.classify_drop": 0.0}))
    x = np.random.default_rng(64).standard_normal((2, 16, 56, 56, 3)).astype(np.float32)
    x[:, :, :28, :28] = 0.0
    y = np.asarray([0.0, 1.0], np.float32)
    jm = jbuild(jcfg)
    params = random_variables(jm, jnp.asarray(x[:1]), seed=65, deterministic=True)["params"]
    zeroed = jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if path[-1].key == "bias" else a, params)

    def grads(p):
        """max |grad| and the JAX gradient in each package, with p's weights"""
        g = jax.grad(lambda q: jbce(jm.apply({"params": q}, jnp.asarray(x),
                                             deterministic=True)[0], jnp.asarray(y)))(p)
        jmax = max(float(np.abs(np.asarray(leaf)).max()) for leaf in jax.tree_util.tree_leaves(g))
        tm = load_jax_variables(build_model(tcfg, "cpu", train=True), {"params": p})
        bce_with_logits(tm(torch.from_numpy(x), return_logits=True)[0],
                        torch.from_numpy(y)).backward()
        tmax = max(q.grad.abs().max().item() for q in tm.parameters() if q.grad is not None)
        return jmax, tmax, g

    for p, blows_up in ((zeroed, True), (params, False)):
        jmax, tmax, g = grads(p)
        if blows_up:
            assert jmax > 1e10 and tmax > 1e10, (jmax, tmax)
            stepped = jax.tree_util.tree_map(lambda a, b: a - 1e-4 * np.asarray(b), p, g)
            jmax2, tmax2, _ = grads(stepped)
            assert math.isfinite(jmax2) and math.isfinite(tmax2), (jmax2, tmax2)
        else:
            assert jmax < 10 and tmax < 10, (jmax, tmax)
