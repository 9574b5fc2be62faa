"""Cross-modal fusion model at inference (deepfake_tpu/models/fusion.py:49-144;
reference: src/models/ModalFusion.py:7-99).

Three branch features (video 1024-d, audio 1024-d, paudio 768-d) projected
to a 512-d common space, stacked as 3 tokens, one QKV self-attention over
them, then flatten -> Linear(1536->768, no bias) -> BatchNorm -> MLP ->
sigmoid. Reference quirk kept: the attention is scaled *after* the softmax
(fusion.py:121-141). InfoNCE and VAModel are training-side and not here.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deepfake_tpu_torch.models.layers import BatchNorm, Mlp


class FusionModel(nn.Module):
    def __init__(self, video_extractor: nn.Module, audio_extractor: nn.Module,
                 paudio_extractor: nn.Module, dims: Sequence[int] = (1024, 1024, 768),
                 out_dim: int = 1, common_dim: int = 512):
        super().__init__()
        self.video_extractor = video_extractor
        self.audio_extractor = audio_extractor
        self.paudio_extractor = paudio_extractor
        self.out_dim = out_dim
        self.common_dim = common_dim
        self.video_projection = nn.Linear(dims[0], common_dim)
        self.audio_projection = nn.Linear(dims[1], common_dim)
        self.paudio_projection = nn.Linear(dims[2], common_dim)
        self.queries = nn.Linear(common_dim, common_dim)
        self.keys = nn.Linear(common_dim, common_dim)
        self.values = nn.Linear(common_dim, common_dim)
        self.attn_proj = nn.Linear(3 * common_dim, 768, bias=False)
        self.norm = BatchNorm(768, axis=-1)
        self.classify = Mlp(768, 256, out_dim)

    def branch_features(self, feature):
        """(frames NTHWC, mel NHWC, wave or (wave, lengths)) -> the three
        branch features, before projection."""
        video, audio, paudio = feature
        return (self.video_extractor(video), self.audio_extractor(audio),
                self.paudio_extractor(paudio))

    def head(self, v_x, a_x, pa_x, return_logits: bool = False):
        comb = torch.stack([self.video_projection(v_x), self.audio_projection(a_x),
                            self.paudio_projection(pa_x)], dim=1)  # [B, 3, C]
        q, k, v = self.queries(comb), self.keys(comb), self.values(comb)
        # reference quirk: softmax first, THEN scale
        att = torch.softmax((q @ k.transpose(1, 2)).float(), dim=-1) * self.common_dim ** -0.5
        out = att.to(v.dtype) @ v
        feat = self.norm(self.attn_proj(out.reshape(out.shape[0], -1)))
        logits = self.classify(feat)
        if self.out_dim == 1:
            logits = logits.squeeze(-1)
        return logits if return_logits else torch.sigmoid(logits)

    def forward(self, feature, return_logits: bool = False):
        return self.head(*self.branch_features(feature), return_logits=return_logits)
