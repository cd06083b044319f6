"""Two-stream ViLBERT encoder with co-attention connection layers (port of
``gstx/models/two_stream.py``).

  * text stream: BERT layers (``layer``), visual stream: BERT layers over
    the region tokens (``v_layer``);
  * co-attention connection layers (``c_layer``): one bi-directional
    cross-attention block, then a projection + residual LayerNorm per stream
    (BertBiOutput) and a per-stream FFN;
  * the interleaving schedule of (v_biattention_id, t_biattention_id), as
    reference ``BertEncoder.forward``.  With the production schedule the
    order is t0..t5, c0, v0, t6, c1, v1, t7, ..., c5, v5, t11.

Under training (``gstx/models/two_stream.py:79-91,139-171,236-265``): the
co-attention probabilities and the BiOutput and FFN outputs are dropped at
the JAX package's rates, each layer runs under the remat policy
(``layers.layer_call``), and the frozen prefixes ``fixed_t_layer`` /
``fixed_v_layer`` run under ``torch.no_grad`` (the reference's no_grad;
the JAX package's stop_gradient), so their parameters get no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gstx_torch.core.config import EncoderConfig
from gstx_torch.models.layers import (
    Intermediate,
    DenseLN,
    LayerNorm,
    Training,
    TransformerLayer,
    attention_region,
    dense_ln,
    feed_forward,
    layer_call,
    linear,
    merge_heads,
    site_of,
    split_heads,
)


class BiAttention(nn.Module):
    """Reference BertBiAttention.  Stream 1 = visual [B, R, v_hidden],
    stream 2 = text [B, L, hidden]; text queries attend visual K/V and
    visual queries attend text K/V, both at bi_hidden width."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.num_heads = cfg.bi_num_attention_heads
        bi = cfg.bi_hidden_size
        for name in ("query1", "key1", "value1"):
            setattr(self, name, nn.Linear(cfg.v_hidden_size, bi))
        for name in ("query2", "key2", "value2"):
            setattr(self, name, nn.Linear(cfg.hidden_size, bi))
        self.v_attn_dropout = cfg.v_attention_probs_dropout_prob
        self.t_attn_dropout = cfg.attention_probs_dropout_prob

    def forward(self, v_input, v_mask, t_input, t_mask,
                train: Optional[Training] = None):
        h = self.num_heads
        q1, k1, v1 = (split_heads(linear(v_input, getattr(self, n)), h)
                      for n in ("query1", "key1", "value1"))
        q2, k2, v2 = (split_heads(linear(t_input, getattr(self, n)), h)
                      for n in ("query2", "key2", "value2"))
        # text queries over visual K/V drop at the visual rate, visual
        # queries over text K/V at the text rate (two_stream.py:79-91)
        ctx_for_text = attention_region(train, q2, k1, v1, v_mask,
                                        self.v_attn_dropout,
                                        site_of(self, 0))
        ctx_for_visual = attention_region(train, q1, k2, v2, t_mask,
                                          self.t_attn_dropout,
                                          site_of(self, 1))
        return merge_heads(ctx_for_visual), merge_heads(ctx_for_text)


class BiOutput(nn.Module):
    """Reference BertBiOutput.  ``q_dense1``/``q_dense2`` exist in the
    reference model but are never called in its forward pass; the port owns
    the names so reference checkpoints load strictly."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        bi, eps = cfg.bi_hidden_size, cfg.layer_norm_eps
        self.dense1 = nn.Linear(bi, cfg.v_hidden_size)
        self.LayerNorm1 = LayerNorm(cfg.v_hidden_size, eps)
        self.q_dense1 = nn.Linear(bi, cfg.v_hidden_size)
        self.dense2 = nn.Linear(bi, cfg.hidden_size)
        self.LayerNorm2 = LayerNorm(cfg.hidden_size, eps)
        self.q_dense2 = nn.Linear(bi, cfg.hidden_size)
        self.v_dropout = cfg.v_hidden_dropout_prob
        self.t_dropout = cfg.hidden_dropout_prob

    def forward(self, ctx_for_visual, v_input, ctx_for_text, t_input,
                train: Optional[Training] = None):
        v_state = dense_ln(ctx_for_visual, self.dense1, self.LayerNorm1,
                           v_input, train, self.v_dropout, site_of(self, 0))
        t_state = dense_ln(ctx_for_text, self.dense2, self.LayerNorm2,
                           t_input, train, self.t_dropout, site_of(self, 1))
        return v_state, t_state


class CoAttentionLayer(nn.Module):
    """Reference BertConnectionLayer: bi-attention, BertBiOutput, then a
    per-stream FFN.  The visual residual receives the visual-query-over-text
    context, the text residual the text-query-over-visual context."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.v_act, self.t_act = cfg.v_hidden_act, cfg.hidden_act
        self.biattention = BiAttention(cfg)
        self.biOutput = BiOutput(cfg)
        self.v_intermediate = Intermediate(cfg.v_hidden_size,
                                           cfg.v_intermediate_size)
        self.v_output = DenseLN(cfg.v_intermediate_size, cfg.v_hidden_size,
                                eps)
        self.t_intermediate = Intermediate(cfg.hidden_size,
                                           cfg.intermediate_size)
        self.t_output = DenseLN(cfg.intermediate_size, cfg.hidden_size, eps)
        self.v_dropout = cfg.v_hidden_dropout_prob
        self.t_dropout = cfg.hidden_dropout_prob

    def forward(self, v_input, v_mask, t_input, t_mask,
                train: Optional[Training] = None):
        ctx_v, ctx_t = self.biattention(v_input, v_mask, t_input, t_mask,
                                        train)
        v_state, t_state = self.biOutput(ctx_v, v_input, ctx_t, t_input,
                                         train)
        v_state = feed_forward(v_state, self.v_intermediate.dense,
                               self.v_output.dense, self.v_output.LayerNorm,
                               self.v_act, train, self.v_dropout,
                               site_of(self.v_output))
        t_state = feed_forward(t_state, self.t_intermediate.dense,
                               self.t_output.dense, self.t_output.LayerNorm,
                               self.t_act, train, self.t_dropout,
                               site_of(self.t_output))
        return v_state, t_state


class TwoStreamEncoder(nn.Module):
    """Interleaved text / visual / co-attention stack (reference
    ``BertEncoder``).  The frozen prefixes of fixed_t/v_layer only matter
    for gradients: they run under ``torch.no_grad``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        self.layer = nn.ModuleList(
            TransformerLayer(cfg.hidden_size, cfg.num_attention_heads,
                             cfg.head_dim, cfg.intermediate_size,
                             cfg.hidden_act, eps,
                             cfg.attention_probs_dropout_prob,
                             cfg.hidden_dropout_prob)
            for _ in range(cfg.num_hidden_layers))
        self.v_layer = nn.ModuleList(
            TransformerLayer(cfg.v_hidden_size, cfg.v_num_attention_heads,
                             cfg.v_head_dim, cfg.v_intermediate_size,
                             cfg.v_hidden_act, eps,
                             cfg.v_attention_probs_dropout_prob,
                             cfg.v_hidden_dropout_prob)
            for _ in range(cfg.v_num_hidden_layers))
        self.c_layer = nn.ModuleList(
            CoAttentionLayer(cfg) for _ in range(len(cfg.v_biattention_id)))

    def forward(self, t_emb, v_emb, t_mask: Optional[torch.Tensor],
                v_mask: Optional[torch.Tensor],
                train: Optional[Training] = None):
        cfg = self.cfg

        def stream(layer, x, m, frozen=False):
            if frozen:
                with torch.no_grad():
                    return layer_call(train, layer, x, m, train)
            return layer_call(train, layer, x, m, train)

        # the frozen-prefix loops as gstx/models/two_stream.py:250-265
        v_start = t_start = 0
        for count, (v_end, t_end) in enumerate(
                zip(cfg.v_biattention_id, cfg.t_biattention_id)):
            for idx in range(v_start, min(cfg.fixed_v_layer, v_end)):
                v_emb = stream(self.v_layer[idx], v_emb, v_mask, True)
                v_start = cfg.fixed_v_layer
            for idx in range(v_start, v_end):
                v_emb = stream(self.v_layer[idx], v_emb, v_mask)
            for idx in range(t_start, min(cfg.fixed_t_layer, t_end)):
                t_emb = stream(self.layer[idx], t_emb, t_mask, True)
                t_start = cfg.fixed_t_layer
            for idx in range(t_start, t_end):
                t_emb = stream(self.layer[idx], t_emb, t_mask)
            if cfg.with_coattention:
                v_emb, t_emb = layer_call(train, self.c_layer[count], v_emb,
                                          v_mask, t_emb, t_mask, train)
            v_start, t_start = v_end, t_end
        for idx in range(v_start, cfg.v_num_hidden_layers):
            v_emb = stream(self.v_layer[idx], v_emb, v_mask)
        for idx in range(t_start, cfg.num_hidden_layers):
            t_emb = stream(self.layer[idx], t_emb, t_mask)
        return t_emb, v_emb


class Pooler(nn.Module):
    """CLS pooler to bi_hidden with ReLU (reference BertTextPooler /
    BertImagePooler)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)

    def forward(self, hidden):
        return F.relu(linear(hidden[:, 0], self.dense))
