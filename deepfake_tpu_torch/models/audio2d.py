"""Raw-waveform audio branch head, the ``paudio`` modality
(deepfake_tpu/models/audio2d.py:29-74; reference: src/models/audioTransformer.py:5-30).

Time-average-pool wav2vec2's last_hidden_state to a clip embedding, then
MLP -> LayerNorm -> GELU -> Linear -> sigmoid, or return the embedding
(``use_feat``, fusion mode). With a ``(wave, lengths)`` input the pool
averages over the batch-longest valid frames only. In training a Dropout at
``model_drop`` (the config's ``swin_drop``) follows the pool and one at
``classify_drop`` the head's GELU (audio2d.py:38-41, :63-69).
"""

from __future__ import annotations

import torch
from torch import nn

from deepfake_tpu_torch.models.layers import Dropout, LayerNorm, Linear, Mlp, gelu_exact
from deepfake_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config, Wav2Vec2Model, feature_extract_output_length, split_wave,
)


class Audio2D(nn.Module):
    def __init__(self, num_classes: int = 1, use_feat: bool = False,
                 wav_config: Wav2Vec2Config = Wav2Vec2Config(), model_drop: float = 0.1,
                 classify_drop: float = 0.1):
        super().__init__()
        self.num_classes = num_classes
        self.use_feat = use_feat
        self.wav_config = wav_config
        self.wav_model = Wav2Vec2Model(wav_config)
        self.model_drop = Dropout(model_drop)
        if not use_feat:
            C = wav_config.hidden_size
            self.mlp = Mlp(C, 512, 512)
            self.norm = LayerNorm(512)
            self.classify_drop = Dropout(classify_drop)
            self.classifier = Linear(512, num_classes)
        self.eval()

    mesh = None  # the data axis of the batch-longest length (parallel.mesh.attach)

    def forward(self, input_values, return_logits: bool = False):
        _, valid_samples = split_wave(input_values, self.mesh)
        hidden = self.wav_model(input_values)
        if valid_samples is None:
            feat = hidden.float().mean(dim=1)
        else:
            valid = feature_extract_output_length(self.wav_config, valid_samples)
            keep = (torch.arange(hidden.shape[1], device=hidden.device) < valid).float()
            feat = (hidden.float() * keep[None, :, None]).sum(dim=1) / valid.float()
        feat = self.model_drop(feat.to(hidden.dtype))
        if self.use_feat:
            return feat
        logits = self.classifier(self.classify_drop(gelu_exact(self.norm(self.mlp(feat)))))
        if self.num_classes == 1:
            logits = logits.squeeze(-1)
        return logits if return_logits else torch.sigmoid(logits)
