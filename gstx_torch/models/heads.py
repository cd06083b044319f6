"""Pretraining heads (port of the modules of ``gstx/models/heads.py``,
lines 29-90): the MLM head (transform, then the tied word-embedding
projection plus a free bias), the NSP head on the fused pooled outputs, and
the image-region classification head.  Reference BertPreTrainingHeads; its
parameters sit under ``encoder.bert_pretrained.cls``.  Under training the
fused pooled output is dropped at a fixed 0.1, whatever the config
(``gstx/models/heads.py:65,83``; reference vilbert_dialog.py:1024).

The discriminative losses (``gstx/models/heads.py:93-139``, reference
``BertForMultiModalPreTraining.forward``, vilbert_dialog.py:1489-1514):
:func:`masked_lm_loss`, :func:`masked_img_loss`, :func:`soft_nsp_loss`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gstx_torch.core.config import EncoderConfig
from gstx_torch.models.layers import (ACT2FN, LayerNorm, Training, linear,
                                      site_of)

POOLED_DROPOUT = 0.1  # the heads' nn.Dropout(0.1) (gstx/models/heads.py:65)


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

    def seq_relationship(self, pooled_t, pooled_v,
                         train: Optional[Training] = None):
        """The NSP logits [B, 2] from the fused pooled outputs, dropped at
        0.1 under ``train``."""
        if self.fusion_method == "sum":
            pooled = pooled_t + pooled_v
        elif self.fusion_method == "mul":
            pooled = pooled_t * pooled_v
        else:
            raise ValueError(self.fusion_method)
        if train is not None:
            pooled = train.dropout(pooled, POOLED_DROPOUT, site_of(self))
        return linear(pooled, self.bi_seq_relationship)

    def forward(self, sequence_t, sequence_v, pooled_t, pooled_v,
                train: Optional[Training] = None):
        """Returns (prediction_t [B, L, vocab] f32, prediction_v
        [B, R, v_target], seq_relationship [B, 2])."""
        p = self.predictions
        h = p.transform(sequence_t)
        # the tied projection runs in f32, as the JAX embed_attend
        prediction_t = F.linear(h.float(), p.decoder.weight.float()) \
            + p.bias.float()
        ip = self.imagePredictions
        prediction_v = linear(ip.transform(sequence_v), ip.decoder)
        return prediction_t, prediction_v, self.seq_relationship(
            pooled_t, pooled_v, train)


# ---------------------------------------------------------------------- #
# losses
# ---------------------------------------------------------------------- #


def masked_lm_loss(prediction_t, mlm_labels, denom=None) -> torch.Tensor:
    """Cross-entropy with ignore_index=-1, the mean over the labelled
    positions in f32 (vilbert_dialog.py:1444,1504-1507); 0 when every label
    is -1, where ``F.cross_entropy`` gives NaN.  ``denom``, as the heads'
    other losses take it, replaces the count the mean divides by (a
    data-parallel rank's: the count over every rank's rows)."""
    logits = prediction_t.reshape(-1, prediction_t.shape[-1]).float()
    labels = mlm_labels.reshape(-1)
    valid = labels != -1
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    nll = torch.where(valid, nll, 0.0)
    if denom is None:
        denom = valid.sum().clamp(min=1)
    return nll.sum() / denom


def masked_img_loss(prediction_v, image_target, image_label,
                    predict_feature: bool = False,
                    denom=None) -> torch.Tensor:
    """Masked-region loss (vilbert_dialog.py:1489-1501), f32.  KL path:
    the elementwise ``KLDivLoss(log_softmax(pred), target)`` summed over
    the masked regions, over the COUNT of masked regions.  MSE path
    (``predict_feature``): over the masked ELEMENT count, the reference's
    ``expand_as`` denominator."""
    masked = image_label == 1
    mask = masked[..., None].float()
    target = image_target.float()
    if predict_feature:
        per = (prediction_v.float() - target) ** 2
        count = (mask * torch.ones_like(per)).sum().clamp(min=1.0)
    else:
        logp = F.log_softmax(prediction_v.float(), dim=-1)
        # KLDivLoss(reduction='none'): t * (log t - logp), 0 where t == 0
        pos = target > 0
        per = torch.where(pos, target * (torch.log(torch.where(
            pos, target, 1.0)) - logp), -target * logp)
        count = masked.sum().clamp(min=1)
    return (per * mask).sum() / (count if denom is None else denom)


def soft_nsp_loss(seq_relationship, labels, denom=None) -> torch.Tensor:
    """The soft next-sentence loss ``-(label * logprob).sum() / batch``
    (vilbert_dialog.py:1509-1510); ``labels`` are [B, 2] soft targets."""
    logp = F.log_softmax(seq_relationship.reshape(-1, 2).float(), dim=-1)
    return -(labels.reshape(-1, 2).float() * logp).sum() / (
        labels.shape[0] if denom is None else denom)
