"""wav2vec2-base encoder (deepfake_tpu/models/wav2vec2.py:36-300).

7-layer conv feature encoder (per-channel GroupNorm after layer 0 only),
feature projection, grouped conv positional embedding (k=128, 16 groups,
trailing frame cropped), and post-norm transformer layers. Submodule names
follow the JAX parameter tree.

``forward`` takes a wave [B, T] or a ``(wave, lengths)`` pair: the pair
emulates the reference's pad-to-batch-longest (wav2vec2.py:145-160,
257-262): the GroupNorm statistics, the positional conv's boundary and the
attention keys are restricted to the frames a max(lengths)-long input would
produce. No Pallas kernel runs here; this is plain PyTorch.

Train mode (wav2vec2.py:50-57, :107-111, :161, :176-178, :195, :217,
:226-233, :272-286): dropout after the feature projection
(``feat_proj_dropout``), on the attention weights (``attention_dropout``),
after the FFN's activation (``activation_dropout``) and on the hidden
states (``hidden_dropout``); LayerDrop, one draw per layer and batch, the
layer's output or its input chosen on the device; SpecAugment time masking.
Every mask draws from the model's dropout generator (set_dropout_generator)
on the device: a train-mode forward reads nothing back to the host, so it
runs inside a CUDA graph and each replay draws anew.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

import torch.nn.functional as F

from deepfake_tpu_torch.models.layers import (
    Conv1d, Dropout, LayerNorm, Linear, block_remat, gelu_exact, remat_block,
)
from deepfake_tpu_torch.parallel.mesh import global_max


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    feat_proj_dropout: float = 0.1
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    layerdrop: float = 0.1
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    # activation checkpointing per encoder layer; a per-stage spec applies
    # its first entry to every layer (wav2vec2.py:218-223)
    remat: bool = False
    remat_policy: str = ""


def feature_extract_output_length(c: Wav2Vec2Config, input_length):
    """Encoder frames for a waveform of ``input_length`` samples."""
    t = input_length
    for k, s in zip(c.conv_kernel, c.conv_stride):
        t = (t - k) // s + 1
    return t


def _frame_mask(T: int, valid, device) -> torch.Tensor:
    return torch.arange(T, device=device) < valid


class LayerDrop(Dropout):
    """Skips a whole layer with probability ``rate`` in training: one draw
    per call (per layer and batch), the layer's output ``y`` or its input
    ``x`` selected on the device (``jnp.where(keep, y, x)``,
    wav2vec2.py:226-233), so the draw stays a device value."""

    def forward(self, x, y):
        if not self.training or self.rate == 0.0:
            return y
        if self.generator is None:
            raise RuntimeError("LayerDrop in training needs a generator (set_dropout_generator)")
        keep = torch.rand((), generator=self.generator, device=x.device) < 1.0 - self.rate
        return torch.where(keep, y, x)


class SpecAugment(Dropout):
    """Time masking in training (wav2vec2.py:272-286): span starts drawn per
    frame at ``rate`` (mask_time_prob), each dilated over ``length`` frames
    (``jnp.convolve(starts, ones(length), 'full')[:T]``), the masked frames
    replaced by ``embed``."""

    def __init__(self, rate: float, length: int):
        super().__init__(rate)
        self.length = length

    def spans(self, starts: torch.Tensor) -> torch.Tensor:
        """[B, T] 0/1 starts -> [B, T] masked frames: frame t is masked where
        a span starts at t - length + 1 .. t."""
        T, L = starts.shape[1], self.length
        ones = torch.ones(1, 1, L, dtype=starts.dtype, device=starts.device)
        return F.conv1d(starts[:, None], ones, padding=L - 1)[:, 0, :T] > 0

    def forward(self, x, embed):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("SpecAugment in training needs a generator "
                               "(set_dropout_generator)")
        B, T, _ = x.shape
        starts = (torch.rand((B, T), generator=self.generator, device=x.device)
                  < self.rate).float()
        return torch.where(self.spans(starts)[..., None], embed.to(x.dtype), x)


class ConvFeatureEncoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.c = c
        cin = 1
        for i, (dim, k, s) in enumerate(zip(c.conv_dim, c.conv_kernel, c.conv_stride)):
            self.add_module(f"conv_{i}", Conv1d(cin, dim, k, stride=s, bias=False))
            cin = dim
        self.group_norm = nn.GroupNorm(c.conv_dim[0], c.conv_dim[0], eps=c.layer_norm_eps)

    def forward(self, x, valid_samples=None):
        """x [B, T] -> [B, C, T'] (channels first)."""
        h = x[:, None]
        valid = valid_samples
        for i, (k, s) in enumerate(zip(self.c.conv_kernel, self.c.conv_stride)):
            h = getattr(self, f"conv_{i}")(h)
            if valid is not None:
                valid = (valid - k) // s + 1
            if i == 0:
                h = self._group_norm(h, valid)
            h = gelu_exact(h)
        return h

    def _group_norm(self, h, valid):
        """One group per channel: statistics over time, over the valid
        frames only when ``valid`` is given."""
        gn = self.group_norm
        hf = h.float()
        if valid is None:
            w = torch.ones(1, 1, h.shape[-1], device=h.device)
        else:
            w = _frame_mask(h.shape[-1], valid, h.device).float()[None, None]
        cnt = w.sum(-1, keepdim=True)
        mean = (hf * w).sum(-1, keepdim=True) / cnt
        var = (((hf - mean) ** 2) * w).sum(-1, keepdim=True) / cnt
        y = (hf - mean) * torch.rsqrt(var + gn.eps)
        y = y * gn.weight.float()[None, :, None] + gn.bias.float()[None, :, None]
        return y.to(h.dtype)


class FeatureProjection(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = LayerNorm(c.conv_dim[-1], eps=c.layer_norm_eps)
        self.projection = Linear(c.conv_dim[-1], c.hidden_size)
        self.drop = Dropout(c.feat_proj_dropout)

    def forward(self, x):
        return self.drop(self.projection(self.layer_norm(x)))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        k = c.num_conv_pos_embeddings
        self.crop = k % 2 == 0
        self.conv = Conv1d(c.hidden_size, c.hidden_size, k, padding=k // 2,
                           groups=c.num_conv_pos_embedding_groups)

    def forward(self, x):
        """x [B, T, C] -> [B, T, C]."""
        h = self.conv(x.transpose(1, 2))
        if self.crop:
            h = h[..., :-1]
        return gelu_exact(h.transpose(1, 2))


class SelfAttention(nn.Module):
    """Multi-head self-attention; ``local_heads``: the heads this model rank
    computes under a mesh's model axis (``parallel.mesh.shard_model`` splits
    q, k and v by heads and ``out_proj`` by rows)."""

    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        C = c.hidden_size
        self.H = self.local_heads = c.num_attention_heads
        self.q_proj = Linear(C, C)
        self.k_proj = Linear(C, C)
        self.v_proj = Linear(C, C)
        self.out_proj = Linear(C, C)
        self.drop = Dropout(c.attention_dropout)

    def forward(self, x, valid_frames=None):
        B, T, C = x.shape
        H, D = self.local_heads, C // self.H
        heads = lambda t: t.view(B, T, H, D).transpose(1, 2)
        q = heads(self.q_proj(x) * (D ** -0.5))
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        attn = (q @ k.transpose(-1, -2)).float()
        if valid_frames is not None:
            keep = _frame_mask(T, valid_frames, x.device)
            attn = attn.masked_fill(~keep[None, None, None, :], float("-inf"))
        attn = self.drop(torch.softmax(attn, dim=-1).to(x.dtype))
        out = (attn @ v).transpose(1, 2).reshape(B, T, H * D)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = Linear(c.hidden_size, c.intermediate_size)
        self.output_dense = Linear(c.intermediate_size, c.hidden_size)
        self.act_drop = Dropout(c.activation_dropout)
        self.drop = Dropout(c.hidden_dropout)

    def forward(self, x):
        h = self.act_drop(gelu_exact(self.intermediate_dense(x)))
        return self.drop(self.output_dense(h))


class EncoderLayer(nn.Module):
    """Post-norm: x = LN(x + attn(x)); x = finalLN(x + FF(x))."""

    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.attention = SelfAttention(c)
        self.layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = FeedForward(c)
        self.final_layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.drop = Dropout(c.hidden_dropout)

    def forward(self, x, valid_frames=None):
        x = self.layer_norm(x + self.drop(self.attention(x, valid_frames)))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(c)
        self.layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.drop = Dropout(c.hidden_dropout)
        self.layerdrop = LayerDrop(c.layerdrop)
        self.n_layers = c.num_hidden_layers
        for i in range(c.num_hidden_layers):
            layer = EncoderLayer(c)
            layer.remat = block_remat(c.remat, c.remat_policy, 0)
            self.add_module(f"layers_{i}", layer)

    def forward(self, x, valid_frames=None):
        pos_in = x
        if valid_frames is not None:
            # the positional conv sees zeros past the valid frames, as a
            # valid_frames-long input padded by the conv would
            pos_in = x * _frame_mask(x.shape[1], valid_frames, x.device)[None, :, None].to(x.dtype)
        x = self.drop(self.layer_norm(x + self.pos_conv_embed(pos_in)))
        for i in range(self.n_layers):
            # LayerDrop outside the checkpointed layer, as in JAX
            x = self.layerdrop(x, remat_block(getattr(self, f"layers_{i}"), x, valid_frames))
        return x


class Wav2Vec2Model(nn.Module):
    """Raw waveform [B, T] (or ``(wave, lengths)``) -> last_hidden_state
    [B, T', hidden]. ``mesh``: the data axis the batch-longest length is
    taken over (``parallel.mesh.attach``)."""

    mesh = None

    def __init__(self, c: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.config = c
        self.feature_encoder = ConvFeatureEncoder(c)
        self.feature_projection = FeatureProjection(c)
        # what SpecAugment writes into the masked frames, in training
        self.masked_spec_embed = nn.Parameter(torch.zeros(c.hidden_size))
        self.spec_augment = SpecAugment(
            c.mask_time_prob if c.apply_spec_augment else 0.0, c.mask_time_length)
        self.encoder = Encoder(c)
        self.eval()

    def init_extra(self, generator: torch.Generator) -> None:
        self.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)

    def forward(self, input_values):
        wave, valid_samples = split_wave(input_values, self.mesh)
        feats = self.feature_encoder(wave, valid_samples).transpose(1, 2)
        x = self.spec_augment(self.feature_projection(feats), self.masked_spec_embed)
        valid_frames = (None if valid_samples is None
                        else feature_extract_output_length(self.config, valid_samples))
        return self.encoder(x, valid_frames)


def split_wave(input_values, mesh=None):
    """``wave`` or ``(wave, lengths)`` -> (wave, batch-longest length or None);
    under a ``mesh`` the longest of the global batch (the rows of every data
    rank; their waves are padded at least that far)."""
    if isinstance(input_values, (tuple, list)):
        wave, lengths = input_values
        return wave, global_max(torch.as_tensor(lengths, device=wave.device).max(), mesh)
    return input_values, None
