"""Cross-modal fusion model, InfoNCE modal alignment and VAModel
(deepfake_tpu/models/fusion.py:37-167; reference: src/models/ModalFusion.py:7-99,
src/models/ModalAlignment.py:4-47).

Three branch features (video 1024-d, audio 1024-d, paudio 768-d) projected
to a 512-d common space, stacked as 3 tokens, one QKV self-attention over
them, then flatten -> Linear(1536->768, no bias) -> BatchNorm (momentum
0.08) -> MLP -> sigmoid. Reference quirk kept: the attention is scaled
*after* the softmax (fusion.py:121-141). In training the BatchNorm takes the
micro-batch's statistics, and ``classify_drop`` drops the attention weights
and the normalised feature (:128, :136); ``with_align_loss`` also returns
the InfoNCE alignment of the projected video feature with each audio
feature (:115-119), which the Trainer adds at ``optim.align_loss_rate``.
Under a mesh the loss is taken over the global batch (the three projected
features gathered over the data axis), and the head's projections may be
split over the model axis.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deepfake_tpu_torch.models.layers import BatchNorm, Dropout, Linear, Mlp
from deepfake_tpu_torch.parallel.mesh import gather_rows


def infonce_pair_loss(p_a: torch.Tensor, p_b: torch.Tensor, soft: float) -> torch.Tensor:
    """Symmetric InfoNCE over a batch of paired embeddings [B, D]
    (fusion.py:37-46; reference: ModalFusion.py:78-99), in f32."""
    p_a, p_b = p_a.float(), p_b.float()
    lse_pos = (p_a * p_b).sum(dim=-1) / soft
    ab = p_a @ p_b.t()
    loss_ab = (torch.logsumexp(ab / soft, dim=1) - lse_pos).mean()
    loss_ba = (torch.logsumexp(ab.t() / soft, dim=1) - lse_pos).mean()
    return loss_ab + loss_ba


class FusionModel(nn.Module):
    """``tp``: the head's split over a mesh's model axis (queries, keys and
    values column-parallel: the 3 x 3 energy summed over the model ranks,
    the output gathered); ``mesh``: the mesh whose data axis the alignment
    loss gathers its batch over (``parallel.mesh.shard_model``)."""

    tp = None
    mesh = None

    def __init__(self, video_extractor: nn.Module, audio_extractor: nn.Module,
                 paudio_extractor: nn.Module, dims: Sequence[int] = (1024, 1024, 768),
                 out_dim: int = 1, common_dim: int = 512, soft: float = 0.01,
                 classify_drop: float = 0.1, bn_momentum: float = 0.08):
        super().__init__()
        self.video_extractor = video_extractor
        self.audio_extractor = audio_extractor
        self.paudio_extractor = paudio_extractor
        self.out_dim = out_dim
        self.common_dim = common_dim
        self.soft = soft
        self.video_projection = Linear(dims[0], common_dim)
        self.audio_projection = Linear(dims[1], common_dim)
        self.paudio_projection = Linear(dims[2], common_dim)
        self.queries = Linear(common_dim, common_dim)
        self.keys = Linear(common_dim, common_dim)
        self.values = Linear(common_dim, common_dim)
        self.attn_drop = Dropout(classify_drop)
        self.attn_proj = Linear(3 * common_dim, 768, bias=False)
        self.norm = BatchNorm(768, axis=-1, momentum=bn_momentum)
        self.feat_drop = Dropout(classify_drop)
        # the reference's classify Mlp keeps its default drop=0 (ModalFusion.py:25)
        self.classify = Mlp(768, 256, out_dim)
        self.eval()

    def branch_features(self, feature):
        """(frames NTHWC, mel NHWC, wave or (wave, lengths)) -> the three
        branch features, before projection."""
        video, audio, paudio = feature
        return (self.video_extractor(video), self.audio_extractor(audio),
                self.paudio_extractor(paudio))

    def head(self, v_x, a_x, pa_x, return_logits: bool = False, with_align_loss: bool = False):
        v_x, a_x = self.video_projection(v_x), self.audio_projection(a_x)
        pa_x = self.paudio_projection(pa_x)
        comb = torch.stack([v_x, a_x, pa_x], dim=1)  # [B, 3, C]
        q, k, v = self.queries(comb), self.keys(comb), self.values(comb)
        energy = q @ k.transpose(1, 2)
        if self.tp is not None:  # q and k hold this rank's channels of one head
            energy = self.tp.reduce(energy)
        # reference quirk: softmax first, THEN scale
        att = self.attn_drop(
            (torch.softmax(energy.float(), dim=-1) * self.common_dim ** -0.5).to(v.dtype))
        if self.tp is not None:
            # the weights (replicated) meet this rank's channels of v: their
            # gradient sums the model ranks'; the channels are gathered after
            out = self.tp.gather(self.tp.copy(att) @ v)
        else:
            out = att @ v
        feat = self.feat_drop(self.norm(self.attn_proj(out.reshape(out.shape[0], -1))))
        logits = self.classify(feat)
        if self.out_dim == 1:
            logits = logits.squeeze(-1)
        result = logits if return_logits else torch.sigmoid(logits)
        if with_align_loss:
            # over the global batch under a mesh (the JAX loss sees all of it)
            v_g, a_g, pa_g = (gather_rows(t, self.mesh) for t in (v_x, a_x, pa_x))
            align = 0.5 * (infonce_pair_loss(v_g, a_g, self.soft)
                           + infonce_pair_loss(v_g, pa_g, self.soft))
            return result, align
        return result

    def forward(self, feature, return_logits: bool = False, with_align_loss: bool = False):
        return self.head(*self.branch_features(feature), return_logits=return_logits,
                         with_align_loss=with_align_loss)


class VAModel(nn.Module):
    """Standalone video/audio InfoNCE alignment (fusion.py:147-167;
    reference: src/models/ModalAlignment.py:4-47): both extractors read the
    same input, their features are projected to ``common_dim``, and the
    module returns infonce_pair_loss(video, audio)."""

    def __init__(self, video_extractor: nn.Module, audio_extractor: nn.Module,
                 video_dim: int = 512, audio_dim: int = 1024, common_dim: int = 512,
                 soft_param: float = 0.01):
        super().__init__()
        self.video_extractor = video_extractor
        self.audio_extractor = audio_extractor
        self.soft_param = soft_param
        self.audio_projection = Linear(audio_dim, common_dim)
        self.video_projection = Linear(video_dim, common_dim)
        self.eval()

    def forward(self, x):
        a = self.audio_projection(self.audio_extractor(x))
        v = self.video_projection(self.video_extractor(x))
        return infonce_pair_loss(v, a, self.soft_param)
