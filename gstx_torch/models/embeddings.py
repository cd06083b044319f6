"""Dialog text embeddings and image-region embeddings (port of
``gstx/models/embeddings.py``).

DialogEmbeddings is reference BertEmbeddingsDialog: word + learned position
+ segment embeddings, where segment ids >= type_vocab_size index a 10-slot
extension table.  ``sep_embeddings`` is checkpoint-present but unused in
the forward pass; it is kept as a parameter so reference checkpoints load
strictly.  ImageEmbeddings is reference BertImageEmbeddings: region
features and 5-d box geometry each projected to v_hidden and summed under
LayerNorm.

Both cast to the model's compute dtype (``compute_dtype``, set by
:class:`gstx_torch.models.encdec.GSTVisualDialog`; None keeps the tables'
dtype) and, under training, drop their output at the encoder's
``hidden_dropout_prob`` (``gstx/models/embeddings.py:51,83,112``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gstx_torch.core.config import EncoderConfig
from gstx_torch.models.layers import LayerNorm, Training, linear, site_of


class DialogEmbeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.type_vocab_size = cfg.type_vocab_size
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.token_type_embeddings_extension = nn.Embedding(
            cfg.type_vocab_extension, h)
        self.sep_embeddings = nn.Embedding(cfg.sep_vocab_size, h)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps)
        self.dropout_rate = cfg.hidden_dropout_prob
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype: the compute dtype when one is set, else
        that of the (precast) embedding tables."""
        return self.compute_dtype or self.word_embeddings.weight.dtype

    def forward(self, input_ids, token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                train: Optional[Training] = None, call: int = 0):
        """``call`` tells the encoder's use (0) from the decoder's (1) apart
        for the dropout masks."""
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[-1], device=input_ids.device).expand_as(
                    input_ids)
        words = self.word_embeddings(input_ids)
        pos = self.position_embeddings(position_ids)
        # segment ids < type_vocab_size use the base table, >= use the
        # extension table shifted by type_vocab_size
        tv = self.type_vocab_size
        is_ext = token_type_ids >= tv
        base_ids = torch.where(is_ext, 0, token_type_ids)
        ext_ids = torch.where(is_ext, token_type_ids - tv, 0)
        seg = torch.where(is_ext[..., None],
                          self.token_type_embeddings_extension(ext_ids),
                          self.token_type_embeddings(base_ids))
        # each lookup is cast before the sum, so f32 tables under a bf16
        # compute dtype sum as the same tables cast once to bf16 do
        dt = self.dtype
        emb = self.LayerNorm(words.to(dt) + pos.to(dt) + seg.to(dt))
        if train is not None:
            emb = train.dropout(emb, self.dropout_rate, site_of(self, call))
        return emb


class ImageEmbeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.image_embeddings = nn.Linear(cfg.v_feature_size,
                                          cfg.v_hidden_size)
        self.image_location_embeddings = nn.Linear(cfg.v_loc_size,
                                                   cfg.v_hidden_size)
        self.LayerNorm = LayerNorm(cfg.v_hidden_size, cfg.layer_norm_eps)
        self.dropout_rate = cfg.hidden_dropout_prob
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, features, locations, train: Optional[Training] = None):
        dtype = self.compute_dtype or self.image_embeddings.weight.dtype
        img = linear(features.to(dtype), self.image_embeddings)
        loc = linear(locations.to(dtype), self.image_location_embeddings)
        emb = self.LayerNorm(img + loc)
        if train is not None:
            emb = train.dropout(emb, self.dropout_rate, site_of(self))
        return emb
