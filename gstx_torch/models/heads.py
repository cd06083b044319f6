"""Pretraining heads (port of the modules of ``gstx/models/heads.py``,
lines 29-90): the MLM head (transform, then the tied word-embedding
projection plus a free bias), the NSP head on the fused pooled outputs, and
the image-region classification head.  Reference BertPreTrainingHeads; its
parameters sit under ``encoder.bert_pretrained.cls``.  The losses come with
the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gstx_torch.core.config import EncoderConfig
from gstx_torch.models.layers import ACT2FN, LayerNorm, linear


class PredictionTransform(nn.Module):
    """dense + act + LayerNorm (reference BertPredictionHeadTransform)."""

    def __init__(self, size: int, activation: str = "gelu",
                 eps: float = 1e-12):
        super().__init__()
        self.activation = activation
        self.dense = nn.Linear(size, size)
        self.LayerNorm = LayerNorm(size, eps)

    def forward(self, x):
        return self.LayerNorm(ACT2FN[self.activation](linear(x, self.dense)))


class Predictions(nn.Module):
    """Reference BertLMPredictionHead: ``decoder.weight`` IS the word
    embedding table (assigned by the owner), ``bias`` is free."""

    def __init__(self, cfg: EncoderConfig, word_embeddings: nn.Embedding):
        super().__init__()
        self.transform = PredictionTransform(cfg.hidden_size, cfg.hidden_act)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.decoder.weight = word_embeddings.weight  # tied
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class ImagePredictions(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.transform = PredictionTransform(cfg.v_hidden_size, cfg.hidden_act)
        self.decoder = nn.Linear(cfg.v_hidden_size, cfg.v_target_size)


class PreTrainingHeads(nn.Module):
    def __init__(self, cfg: EncoderConfig, word_embeddings: nn.Embedding):
        super().__init__()
        self.fusion_method = cfg.fusion_method
        self.predictions = Predictions(cfg, word_embeddings)
        self.bi_seq_relationship = nn.Linear(cfg.bi_hidden_size, 2)
        self.imagePredictions = ImagePredictions(cfg)

    def seq_relationship(self, pooled_t, pooled_v):
        """The NSP logits [B, 2] from the fused pooled outputs."""
        if self.fusion_method == "sum":
            pooled = pooled_t + pooled_v
        elif self.fusion_method == "mul":
            pooled = pooled_t * pooled_v
        else:
            raise ValueError(self.fusion_method)
        return linear(pooled, self.bi_seq_relationship)

    def forward(self, sequence_t, sequence_v, pooled_t, pooled_v):
        """Returns (prediction_t [B, L, vocab] f32, prediction_v
        [B, R, v_target], seq_relationship [B, 2])."""
        p = self.predictions
        h = p.transform(sequence_t)
        # the tied projection runs in f32, as the JAX embed_attend
        prediction_t = F.linear(h.float(), p.decoder.weight.float()) \
            + p.bias.float()
        ip = self.imagePredictions
        prediction_v = linear(ip.transform(sequence_v), ip.decoder)
        return prediction_t, prediction_v, self.seq_relationship(pooled_t,
                                                                 pooled_v)
