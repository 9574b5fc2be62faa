"""NeXtVLAD temporal aggregation and the video classifier
(deepfake_tpu/models/nextvlad.py:37-160; reference: src/models/IResNet.py:247-393).

Reproduced quirks, as in the JAX package:
* BatchNorm1d(max_frames) normalises per frame index: the frame axis is the
  channel axis of ``bn0`` (nextvlad.py:57-60);
* F.normalize(vlad, 1) is an L1 normalisation along the group_size axis
  (nextvlad.py:83-85);
* BatchNorm1d(1) over the flattened VLAD / hidden vectors (one scalar stat).

In training the BatchNorms take batch statistics (momentum ``bn_momentum``),
a Dropout at ``drop_rate`` follows the IRv2 pool and the VLAD (nextvlad.py:
136-137), and ``classify_drop`` the logits when the classifier is not a
feature extractor (:156-158).
"""

from __future__ import annotations

import torch
from torch import nn

from deepfake_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2
from deepfake_tpu_torch.models.layers import BatchNorm, Dropout, Linear


class NeXtVLAD(nn.Module):
    def __init__(self, dim: int = 1024, num_clusters: int = 64, lamb: int = 2,
                 groups: int = 8, max_frames: int = 300, bn_momentum: float = 0.1):
        super().__init__()
        self.G, self.K = groups, num_clusters
        self.group_size = (lamb * dim) // groups
        self.fc0 = Linear(dim, lamb * dim)
        self.fc_gk = Linear(lamb * dim, groups * num_clusters)
        self.bn0 = BatchNorm(max_frames, axis=1, momentum=bn_momentum)
        self.fc_g = Linear(lamb * dim, groups)
        self.cluster_weights2 = nn.Parameter(torch.zeros(1, self.group_size, num_clusters))
        self.bn1 = BatchNorm(1, axis=1, momentum=bn_momentum)

    def init_extra(self, generator: torch.Generator) -> None:
        self.cluster_weights2.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x):
        B, M, _ = x.shape
        G, K, gs = self.G, self.K, self.group_size
        x_dot = self.fc0(x)
        wgk = self.bn0(self.fc_gk(x_dot)).reshape(B, M * G, K)
        alpha_gk = torch.softmax(wgk.float(), dim=-1).to(x.dtype)
        alpha_g = torch.sigmoid(self.fc_g(x_dot)).reshape(B, M * G, 1)
        activation = alpha_gk * alpha_g  # [B, M*G, K]
        a = activation.sum(dim=-2, keepdim=True) * self.cluster_weights2.to(x.dtype)  # [B, gs, K]
        vlad = activation.transpose(1, 2) @ x_dot.reshape(B, M * G, gs)  # [B, K, gs]
        vlad = vlad.transpose(1, 2) - a
        vlad = vlad / torch.clamp(vlad.abs().sum(dim=1, keepdim=True), min=1e-12)
        return self.bn1(vlad.reshape(B, 1, K * gs)).reshape(B, K * gs)


class InceptionVideoClassifier(nn.Module):
    """Per-frame Inception-ResNet-v2 -> NeXtVLAD over time -> gated embedding
    -> logistic head. Input frames NTHWC [B, T, H, W, 3]; ``use_feat``
    returns the gated [B, hidden] feature for fusion."""

    def __init__(self, num_frames: int, num_classes: int = 1, num_clusters: int = 64,
                 lamb: int = 2, hidden_size: int = 1024, groups: int = 8,
                 gating_reduction: int = 8, use_feat: bool = False, fused_blocks: bool = False,
                 drop_rate: float = 0.5, classify_drop: float = 0.1, bn_momentum: float = 0.1,
                 quant=None):
        super().__init__()
        self.num_classes = num_classes
        self.use_feat = use_feat
        self.quant = quant  # the IRv2 trunk's int8 mode (nextvlad.py:120, registry.py:77)
        self.inception = InceptionResNetV2(fused_blocks, drop_rate, quant)
        self.video_nextvlad = NeXtVLAD(1536, num_clusters, lamb, groups, num_frames, bn_momentum)
        self.vlad_drop = Dropout(drop_rate)
        vlad_dim = num_clusters * (lamb * 1536) // groups
        self.fc0 = Linear(vlad_dim, hidden_size)
        self.bn0 = BatchNorm(1, axis=1, momentum=bn_momentum)
        self.fc1 = Linear(hidden_size, hidden_size // gating_reduction)
        self.bn1 = BatchNorm(1, axis=1, momentum=bn_momentum)
        self.fc2 = Linear(hidden_size // gating_reduction, hidden_size)
        if not use_feat:
            self.logistic = Linear(hidden_size, num_classes)
            self.classify_drop = Dropout(classify_drop)
        self.eval()

    def forward(self, x, return_logits: bool = False):
        B, T = x.shape[:2]
        feat = self.inception(x.reshape((B * T,) + tuple(x.shape[2:]))).reshape(B, T, -1)
        vlad = self.vlad_drop(self.video_nextvlad(feat))
        act = torch.relu(self.bn0(self.fc0(vlad)[:, None])[:, 0])
        gates = torch.sigmoid(self.fc2(self.bn1(self.fc1(act)[:, None])[:, 0]))
        feat = act * gates
        if self.use_feat:
            return feat
        logits = self.logistic(feat)
        if self.num_classes == 1:
            logits = logits.squeeze(-1)
        logits = self.classify_drop(logits)
        return logits if return_logits else torch.sigmoid(logits)
