"""Activation checkpointing in the port (``parallel.remat``,
deepfake_tpu_torch/models/layers.py::remat_block), after tests/test_remat.py.

* ``stage_policy`` resolves per-stage specs as the JAX package does, and an
  unknown policy raises.
* With dropout and DropPath on, a small SwinV2 (K5's plain version), Video
  Swin (K5's plain version; the attention-pooling head, whose BatchNorms
  stay outside the checkpointed blocks) and wav2vec2 (its dropouts,
  LayerDrop and SpecAugment) give, checkpointed at "", "dots", "dots_all"
  and "dots,off", the forward value, every gradient, the dropout
  generator's state and every buffer of the run without remat, to the bit;
  the blocks' forwards run again in the backward (counted).
* The same models checkpointed against the JAX models at ``remat=True``
  (dropout off: the two packages' random streams differ), at the
  tolerances of tests/test_torch_train.py.
* Two fused Trainer steps at ``--set parallel.remat=true`` equal two
  without, to the bit.
f32 on the CPU.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_tpu_torch.io.jax_weights import load_jax_variables
from deepfake_tpu_torch.models.layers import block_remat, set_dropout_generator, stage_policy

from tests.torch_port_helpers import random_variables

POLICIES = ["", "dots", "dots_all", "dots,off"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stage_policy_resolution():
    """The cases of tests/test_remat.py:31-42, and the policy a stage's
    blocks take (None: remat off there); an unknown policy raises, as
    remat_wrap's lookup does."""
    assert stage_policy(True, "dots", 3) == (True, "dots")
    assert stage_policy(False, "dots", 0) == (False, "dots")
    spec = "dots,dots,off,"
    assert stage_policy(True, spec, 0) == (True, "dots")
    assert stage_policy(True, spec, 2) == (False, "")
    assert stage_policy(True, spec, 3) == (True, "")
    assert stage_policy(True, "dots,off", 5) == (False, "")
    assert [block_remat(True, "dots,dots,off,off", i) for i in range(4)] == [
        "dots", "dots", None, None]
    assert block_remat(False, "dots", 0) is None and block_remat(True, "", 1) == ""
    with pytest.raises(ValueError, match="remat policy 'dot'"):
        block_remat(True, "dot", 0)
    from deepfake_tpu_torch.models.swin2d import SwinTransformerV2

    with pytest.raises(ValueError, match="remat policy"):
        SwinTransformerV2(img_size=32, embed_dim=16, depths=(2,), num_heads=(2,), window_size=4,
                          remat=True, remat_policy="saveall")


# ------------------------------------------------------- the port, remat off

def _swinv2(remat=False, policy="", drop=True):
    from deepfake_tpu_torch.models.swin2d import SwinTransformerV2

    m = SwinTransformerV2(img_size=32, num_classes=1, embed_dim=16, depths=(2, 2),
                          num_heads=(2, 2), window_size=4, attn_kernel=True,
                          drop_path_rate=0.3 if drop else 0.0, remat=remat, remat_policy=policy)
    if drop:  # element masks too, beside DropPath's per-sample ones
        for name, mod in m.named_modules():
            if name.endswith(".mlp"):
                mod.drop.rate = 0.2
    x = np.random.default_rng(50).standard_normal((2, 32, 32, 3)).astype(np.float32)
    return m, (x,), dict(return_logits=True)


def _video_swin(remat=False, policy="", drop=True):
    from deepfake_tpu_torch.models.swin3d import VideoClassifier

    m = VideoClassifier((16, 56, 56), embed_dim=32, depths=(2, 2), num_heads=(1, 2),
                        num_hiddens=16, pool="Attention", kernels=True,
                        drop_path_rate=0.3 if drop else 0.0, classify_drop=0.1 if drop else 0.0,
                        remat=remat, remat_policy=policy)
    x = np.random.default_rng(51).standard_normal((2, 16, 56, 56, 3)).astype(np.float32)
    return m, (x,), dict(return_logits=True)


def _wav_config(remat=False, policy="", drop=True):
    from deepfake_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    rates = {} if drop else dict(feat_proj_dropout=0.0, hidden_dropout=0.0,
                                 attention_dropout=0.0, activation_dropout=0.0, layerdrop=0.0,
                                 apply_spec_augment=False)
    # mask_time_prob 0.3: SpecAugment masks some of the 12 frames
    return Wav2Vec2Config(conv_dim=(8,) * 7, hidden_size=32, num_hidden_layers=3,
                          num_attention_heads=2, intermediate_size=64,
                          num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                          mask_time_prob=0.3 if drop else 0.05, remat=remat,
                          remat_policy=policy, **rates)


def _wav2vec2(remat=False, policy="", drop=True):
    from deepfake_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    m = Wav2Vec2Model(_wav_config(remat, policy, drop))
    x = np.random.default_rng(52).standard_normal((2, 4000)).astype(np.float32)
    return m, (x,), {}


MODELS = {"swinv2": _swinv2, "video_swin": _video_swin, "wav2vec2": _wav2vec2}
BLOCKS = {"swinv2": "SwinBlock", "video_swin": "SwinBlock3D", "wav2vec2": "EncoderLayer"}


def _train_run(name, remat, policy):
    """One train-mode forward and backward from the seeded weights, dropout
    on: (output, gradients, generator state, buffers, block forwards). On
    one thread (the module's fixture): the table gather's backward on
    several threads adds in an order that changes from run to run, with or
    without remat."""
    from deepfake_tpu_torch.models.layers import init_weights

    torch.manual_seed(0)
    m, xs, kw = MODELS[name](remat, policy)
    init_weights(m, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    set_dropout_generator(m, gen).train()
    calls = [0]
    kind = BLOCKS[name]
    for mod in m.modules():
        if type(mod).__name__ == kind:
            mod.register_forward_pre_hook(lambda *a: calls.__setitem__(0, calls[0] + 1))
    out = m(*(torch.from_numpy(x) for x in xs), **kw)
    out = out[0] if isinstance(out, tuple) else out
    (out.float() ** 2).mean().backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}
    buffers = {n: b.clone() for n, b in m.named_buffers() if b is not None}
    return out.detach(), grads, gen.get_state(), buffers, calls[0]


@functools.lru_cache(maxsize=None)
def _baseline(name):
    return _train_run(name, False, "")


@pytest.mark.parametrize("policy", POLICIES, ids=["all", "dots", "dots_all", "dots_off"])
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_equals_no_remat_to_the_bit(name, policy):
    out0, g0, s0, b0, calls0 = _baseline(name)
    out1, g1, s1, b1, calls1 = _train_run(name, True, policy)
    assert torch.equal(out0, out1)
    assert g0.keys() == g1.keys() and len(g0) > 10
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert torch.equal(s0, s1), "the dropout generator moved by another count"
    assert b0.keys() == b1.keys()
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k
    if name == "video_swin":
        assert any(k.endswith("down_bn1.running_mean") for k in b0)
    # each checkpointed block's forward runs again in the backward: every
    # block, or stage 0's two under "dots,off" (wav2vec2 takes the spec's
    # first entry in every layer)
    again = calls0 // 2 if policy == "dots,off" and name != "wav2vec2" else calls0
    assert calls1 == calls0 + again, (calls0, calls1)


def test_remat_is_a_no_op_without_autograd(monkeypatch):
    """Under no_grad (serving) a checkpointed model runs the plain call; with
    autograd every checkpointed block goes through torch.utils.checkpoint."""
    import deepfake_tpu_torch.models.layers as L

    m, (x,), kw = _swinv2(True, "dots", drop=False)
    seen = []
    checkpoint = L.checkpoint
    monkeypatch.setattr(L, "checkpoint", lambda *a, **k: seen.append(1) or checkpoint(*a, **k))
    with torch.no_grad():
        m(torch.from_numpy(x), **kw)
    assert not seen
    m.train()
    m(torch.from_numpy(x), **kw)
    assert len(seen) == 4


# ---------------------------------------------------------------- against JAX

def _jax_loss(jmodel, x, **kw):
    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), **kw)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.mean(out.astype(jnp.float32) ** 2)

    return loss


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_matches_jax_remat(name):
    """The checkpointed port model ("dots") against the JAX model at
    remat=True, remat_policy="dots", dropout off: the loss within 1e-5
    relative, every gradient within 1e-4 of its largest |value|
    (tests/test_torch_train.py)."""
    from deepfake_tpu.models.swin2d import SwinTransformerV2
    from deepfake_tpu.models.swin3d import VideoClassifier
    from deepfake_tpu.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

    tmodel, (x,), kw = MODELS[name](True, "dots", drop=False)
    if name == "swinv2":
        jmodel = SwinTransformerV2(img_size=32, num_classes=1, embed_dim=16, depths=(2, 2),
                                   num_heads=(2, 2), window_size=4, drop_path_rate=0.0,
                                   remat=True, remat_policy="dots")
        jkw = dict(deterministic=False, return_logits=True)
    elif name == "video_swin":
        jmodel = VideoClassifier(embed_dim=32, depths=(2, 2), num_heads=(1, 2), num_hiddens=16,
                                 pool="Attention", drop_path_rate=0.0, classify_drop=0.0,
                                 remat=True, remat_policy="dots")
        jkw = dict(deterministic=False, return_logits=True)
    else:
        c = _wav_config(True, "dots", drop=False)
        jmodel = Wav2Vec2Model(Wav2Vec2Config(
            conv_dim=c.conv_dim, hidden_size=c.hidden_size, num_hidden_layers=c.num_hidden_layers,
            num_attention_heads=c.num_attention_heads, intermediate_size=c.intermediate_size,
            num_conv_pos_embeddings=c.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=c.num_conv_pos_embedding_groups,
            remat=True, remat_policy="dots"))
        jkw = dict(deterministic=True)
    variables = random_variables(jmodel, jnp.asarray(x), seed=53, deterministic=True)
    rngs = {"dropout": jax.random.PRNGKey(3)}
    if "batch_stats" in variables:
        def loss(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(x), rngs=rngs, mutable=["batch_stats"], **jkw)
            return jnp.mean(out[0] ** 2)
    else:
        loss = _jax_loss(jmodel, x, rngs=rngs, **jkw)
    want_loss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    load_jax_variables(tmodel, variables)
    if name != "wav2vec2":
        tmodel.train()
        set_dropout_generator(tmodel, torch.Generator().manual_seed(4))
    out = tmodel(torch.from_numpy(x), **kw)
    got_loss = ((out[0] if isinstance(out, tuple) else out) ** 2).mean()
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    _assert_grads_close(tmodel, grads, variables, 1e-4)


def _assert_grads_close(tmodel, grads, variables, tol: float):
    """tests/test_torch_train.py's check (max |diff| <= tol * max |JAX grad|
    for every parameter), the JAX gradients carried beside the model's
    batch statistics; a parameter that no loss reaches (wav2vec2's
    SpecAugment embedding, SpecAugment off) has no gradient here and a zero
    one in JAX. A gradient that is zero but for rounding (k_proj's bias,
    which the softmax cancels; Video Swin's last LayerNorm bias, which the
    head's batch-statistics BatchNorm cancels: below 1e-6 of the model's
    largest gradient in JAX) is held to tol of the model's largest."""
    ref = copy.deepcopy(tmodel)
    load_jax_variables(ref, dict(variables, params=jax.device_get(grads)))
    want = dict(ref.named_parameters())
    assert want.keys() == dict(tmodel.named_parameters()).keys()
    top = max(w.detach().abs().max().item() for w in want.values())
    for name, p in tmodel.named_parameters():
        w = want[name].detach()
        if p.grad is None:
            assert name == "masked_spec_embed" and not w.any(), name
            continue
        big = w.abs().max().item()
        assert big > 0, name
        err = (p.grad - w).abs().max().item()
        assert err <= tol * (big if big > 1e-6 * top else top), (name, err, big)


# -------------------------------------------------------------- the Trainer

def test_fused_trainer_steps_with_remat_equal_steps_without():
    """Two fused Trainer steps (SMALL_FUSED, micro-batch 2 x accum 2, every
    dropout on) at ``--set parallel.remat=true`` (and a per-stage policy)
    equal two without, to the bit: losses, weights, momentum, BatchNorm
    statistics (IRv2's and the head's, outside the checkpointed blocks) and
    the dropout generator."""
    from deepfake_tpu_torch.config import get_config
    from deepfake_tpu_torch.train.trainer import Trainer

    from tests.torch_parallel_workers import SMALL_FUSED, Batches, batch

    x, y = batch()
    sets = [f"{k}={v}" for k, v in SMALL_FUSED.items() if not isinstance(v, tuple)]
    sets += [f"{k}={list(v)}" for k, v in SMALL_FUSED.items() if isinstance(v, tuple)]
    sets += ["optim.batch_size=2", "optim.accum_step=2", "optim.learning_rate=0.1"]

    def run(extra):
        argv = sum((["--set", s] for s in sets + extra), [])
        cfg = get_config(argv)
        t = Trainer(None, cfg, Batches(x, y), logger=lambda line: None, device="cpu")
        losses = [float(t.train_step(x, y)["loss"]) for _ in range(2)]
        remat = [m.remat for m in t.model.modules() if getattr(m, "remat", None) is not None]
        return (losses, {k: v.clone() for k, v in t.model.state_dict().items()},
                [b.clone() for b in t.optimizer.bufs], t.dropout.get_state(), remat)

    base = run([])
    assert not base[4]
    for extra, n_remat in ((["parallel.remat=true"], 4 + 2),
                           (["parallel.remat=true", "parallel.remat_policy=dots,off"], 2 + 2)):
        got = run(extra)
        assert len(got[4]) == n_remat  # SwinV2's blocks (stage 0 alone at dots,off), wav2vec2's
        assert got[0] == base[0]
        for k in base[1]:
            assert torch.equal(got[1][k], base[1][k]), k
        assert all(torch.equal(a, b) for a, b in zip(got[2], base[2]))
        assert torch.equal(got[3], base[3])
