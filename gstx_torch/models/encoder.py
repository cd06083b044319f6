"""The two-stream visual-dialog encoder (port of
``gstx/models/encoder.py``): embeds text and regions, runs the interleaved
two-stream encoder and pools.  Reference BertModel; its parameters sit
under ``encoder.bert_pretrained.bert`` in the full model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gstx_torch.core.config import EncoderConfig
from gstx_torch.models.embeddings import DialogEmbeddings, ImageEmbeddings
from gstx_torch.models.layers import Training, additive_mask
from gstx_torch.models.two_stream import Pooler, TwoStreamEncoder


class GSTEncoderModel(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = DialogEmbeddings(cfg)
        self.v_embeddings = ImageEmbeddings(cfg)
        self.encoder = TwoStreamEncoder(cfg)
        self.t_pooler = Pooler(cfg.hidden_size, cfg.bi_hidden_size)
        self.v_pooler = Pooler(cfg.v_hidden_size, cfg.bi_hidden_size)

    def forward(self, input_ids, image_feat, image_loc,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                image_attention_mask: Optional[torch.Tensor] = None,
                pooled: bool = True, train: Optional[Training] = None):
        """Returns (hidden_t [B,L,768], hidden_v [B,R,1024], pooled_t,
        pooled_v); the pooled outputs are None when ``pooled`` is False (the
        decode path and the training score never read them).  ``train``:
        a training forward (:class:`gstx_torch.models.layers.Training`)."""
        dtype = self.embeddings.dtype
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if image_attention_mask is None:
            image_attention_mask = torch.ones(
                image_feat.shape[:2], dtype=input_ids.dtype,
                device=input_ids.device)
        t_mask = additive_mask(attention_mask, dtype)
        v_mask = additive_mask(image_attention_mask, dtype)
        t_emb = self.embeddings(input_ids, token_type_ids=token_type_ids,
                                train=train)
        v_emb = self.v_embeddings(image_feat, image_loc, train)
        hidden_t, hidden_v = self.encoder(t_emb, v_emb, t_mask, v_mask,
                                          train)
        if not pooled:
            return hidden_t, hidden_v, None, None
        return (hidden_t, hidden_v, self.t_pooler(hidden_t),
                self.v_pooler(hidden_v))
