"""Causal BERT decoder with cross-attention and a KV cache (port of
``gstx/models/decoder.py``, lines 43-358).

  * teacher-forced path: full-sequence causal self-attention and
    cross-attention over the fused memory;
  * decode path: the memory's cross-attention K/V are computed once per
    utterance (:meth:`GSTDecoderModel.precompute_memory`) and self-attention
    K/V accumulate in a fixed-shape cache, so each step is O(1) matmuls;
  * int8 memory: :func:`quantize_memory_kv` turns each layer's (k, v) into
    (k_int8, v_int8, k_scale, v_scale), which every path accepts in place of
    (k, v).  A one-token decode step then reads it through the
    ``quant_decode_attention`` kernel when its switch is on
    (``gstx_torch/kernels/decode_attn.py``); other query lengths, and the
    switch off, run the scale-folded unfused ops.

The layers are reference HF BertLayer with crossattention; their parameters
sit under ``decoder.decoder.bert.encoder.layer`` in the full model.  The
decoder's FFN and projections are plain ops, as in the JAX package (no
fused kernel runs here).

Under training (``gstx/models/decoder.py:112-155,191-195``) the self- and
cross-attention probabilities are dropped at ``attention_probs_dropout_prob``
and each projection and FFN output at ``hidden_dropout_prob``; each layer
runs under the remat policy, keeping only its inputs under ``small`` (the
JAX decoder tags nothing).  The int8 memory has no attention-dropout
branch, so a training forward over it raises, as ``decoder.py:137-145``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gstx_torch.core.config import DecoderConfig
from gstx_torch.kernels import decode_attn as kdecode
from gstx_torch.models import tensor_parallel as tpar
from gstx_torch.models.layers import (
    MASK_VALUE,
    DenseLN,
    Intermediate,
    Projections,
    Training,
    attend,
    causal_additive_mask,
    layer_call,
    linear,
    merge_heads,
    site_of,
    split_heads,
)

Cache = Dict[str, torch.Tensor]


def quantize_memory_kv(memory_kv, memory_add_mask, dtype=torch.bfloat16):
    """Symmetric per-(batch, head, channel) int8 quantization of the
    precomputed cross-attention K/V (``gstx/models/decoder.py:43-79``).

    Valid memory slots are those whose additive mask is above -5000.  The
    scale is ``max(absmax / 127, 1e-8)`` over the valid slots, so it does
    not depend on the bucket width, and is stored in ``dtype``; values are
    ``round(t / scale)`` (half to even, as ``jnp.round``) with padding slots
    zeroed.  Returns per-layer 4-tuples (k_int8, v_int8, k_scale, v_scale),
    the int8 tensors contiguous [B, H, M, dh] for the decode kernel."""
    valid = (memory_add_mask[:, 0, 0, :] > -5000.0)[:, None, :, None]

    def q(t):
        a = torch.where(valid, t.abs(), 0).float()
        scale = torch.clamp(a.amax(dim=2, keepdim=True) / 127.0, min=1e-8)
        inv = 1.0 / scale
        ti = torch.round(t.float() * inv).to(torch.int8)
        return (torch.where(valid, ti, 0).contiguous(), scale.to(dtype))

    out = []
    for k, v in memory_kv:
        kq, ks = q(k)
        vq, vs = q(v)
        out.append((kq, vq, ks, vs))
    return out


def dequantize_kv(mem):
    """(k, v) passthrough; (k_int8, v_int8, k_scale, v_scale) -> scaled."""
    if len(mem) == 2:
        return mem
    kq, vq, ks, vs = mem
    return kq.to(ks.dtype) * ks, vq.to(vs.dtype) * vs


class _Attention(nn.Module):
    """Parameters of one HF BertAttention (``self.{query,key,value}``,
    ``output.{dense,LayerNorm}``); the decoder layer runs them unfused."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.self = Projections(d, d)
        self.output = DenseLN(d, d, eps)


def _project_ln(ctx, out: DenseLN, residual, train=None, rate=0.0, site=0):
    h = linear(ctx, out.dense)
    if train is not None:
        h = train.dropout(h, rate, site)
    return out.LayerNorm(h + residual)


class DecoderLayer(nn.Module):
    """Causal self-attention + cross-attention + FFN, post-LN residuals."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_heads = cfg.num_attention_heads
        self.head_range = None  # (first, all) under tensor parallelism
        self.attention = _Attention(d, eps)
        self.crossattention = _Attention(d, eps)
        self.intermediate = Intermediate(d, cfg.intermediate_size)
        self.output = DenseLN(cfg.intermediate_size, d, eps)
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.attn_dropout = cfg.attention_probs_dropout_prob

    def memory_kv(self, memory) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V of a fixed encoder memory."""
        s = self.crossattention.self
        h = self.num_heads
        return (split_heads(linear(memory, s.key), h),
                split_heads(linear(memory, s.value), h))

    def _self_block(self, x, q, k, v, mask, train=None):
        ctx = attend(q, k, v, mask, train, self.attn_dropout,
                     site_of(self, 0), self.head_range)
        return _project_ln(merge_heads(ctx), self.attention.output, x,
                           train, self.hidden_dropout, site_of(self, 1))

    def _cross_block(self, x, mem, mem_mask, train=None):
        """Cross-attention over the static memory: ``mem`` is a layer's
        (k, v) or its int8 4-tuple from :func:`quantize_memory_kv`."""
        q = split_heads(linear(x, self.crossattention.self.query),
                        self.num_heads)
        if len(mem) == 4:
            if train is not None:
                # the int8 path has no attention-dropout branch
                raise ValueError(
                    "quantized cross-attention memory supports only "
                    "deterministic=True (no attention-dropout path); "
                    "pass unquantized (k, v) memory for training")
            ctx = self._quant_cross_attend(q, mem, mem_mask)
        else:
            mem_k, mem_v = mem
            ctx = attend(q, mem_k, mem_v, mem_mask, train, self.attn_dropout,
                         site_of(self, 2), self.head_range)
        return _project_ln(merge_heads(ctx), self.crossattention.output, x,
                           train, self.hidden_dropout, site_of(self, 3))

    @staticmethod
    def _quant_cross_attend(q, mem, mem_mask):
        """Scale-folded int8 cross-attention (``decoder.py:158-189``): the
        K scale and 1/sqrt(dh) fold into q (rounded to the activation dtype)
        before the scores, the V scale into the context after PV, so no
        dequantized copy of the memory is made.  A one-token query goes
        through the decode kernel when its switch is on."""
        kq, vq, ks, vs = mem
        dt = q.dtype
        q = (q.float() * ks.float() * (1.0 / float(q.shape[-1]) ** 0.5)
             ).to(dt)
        ctx = kdecode.maybe_quant_decode_attention(q, kq, vq, mem_mask)
        if ctx is None:
            scores = torch.matmul(q.float(), kq.float().transpose(-1, -2))
            if mem_mask is not None:
                scores = scores + mem_mask.float()
            probs = torch.softmax(scores, dim=-1).to(dt)
            ctx = torch.matmul(probs.float(), vq.float())
        return (ctx * vs.float()).to(dt)

    def _ffn_block(self, x, train=None):
        h = F.gelu(linear(x, self.intermediate.dense))  # exact erf
        h = linear(h, self.output.dense)
        if train is not None:
            h = train.dropout(h, self.hidden_dropout, site_of(self, 4))
        return self.output.LayerNorm(h + x)

    def forward(self, x, self_mask, memory, mem_mask,
                train: Optional[Training] = None):
        return self.forward_with_memory_kv(x, self_mask,
                                           self.memory_kv(memory), mem_mask,
                                           train)

    def forward_with_memory_kv(self, x, self_mask, mem, mem_mask,
                               train: Optional[Training] = None):
        """Full-sequence forward with precomputed cross-attention K/V."""
        q, k, v = (split_heads(t, self.num_heads)
                   for t in self.attention.self(x))
        x = self._self_block(x, q, k, v, self_mask, train)
        x = self._cross_block(x, mem, mem_mask, train)
        return self._ffn_block(x, train)

    def step(self, x, pos: int, cache: Cache, mem, mem_mask):
        """One KV-cached decode step for x [B, 1, D] at position ``pos``.
        JAX returns a new cache (``dynamic_update_slice``); here the cache
        is written in place, which saves a copy of it per step."""
        q, k, v = (split_heads(t, self.num_heads)
                   for t in self.attention.self(x))
        cache["k"][:, :, pos] = k[:, :, 0]
        cache["v"][:, :, pos] = v[:, :, 0]
        # valid cache slots are [0, pos]; mask the rest
        slot = torch.arange(cache["k"].shape[2], device=x.device)
        smask = torch.where(slot <= pos, 0.0, MASK_VALUE).to(x.dtype)
        x = self._self_block(x, q, cache["k"], cache["v"], smask)
        x = self._cross_block(x, mem, mem_mask)
        return self._ffn_block(x)


class _DecoderStack(nn.Module):
    """Holds the layer list under the reference name ``encoder.layer``."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.layer = nn.ModuleList(DecoderLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class LMHead(nn.Module):
    """Reference BertGenerationOnlyLMHead: ``decoder`` projection whose bias
    is also registered as ``bias`` (one tensor, two names)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.bias = self.decoder.bias


class GSTDecoderModel(nn.Module):
    """Decoder stack (``bert``) + LM head.  The input embeddings are the
    encoder's DialogEmbeddings module, passed in and registered as
    ``bert.embeddings`` (tied, as the reference's module swap makes them).
    The LM projection is independent of the embedding table: trained
    reference checkpoints diverge there."""

    def __init__(self, cfg: DecoderConfig, embeddings: nn.Module):
        super().__init__()
        self.config = cfg
        self.bert = nn.Module()
        self.bert.embeddings = embeddings
        self.bert.encoder = _DecoderStack(cfg)
        self.lm_head = LMHead(cfg)
        # the group the LM head's vocab rows are sharded over, if any
        # (gstx_torch.models.tensor_parallel.shard_model_)
        self.vocab_tp = None

    @property
    def layers(self):
        return self.bert.encoder.layer

    @property
    def local_heads(self) -> int:
        """The attention heads this rank computes (all of them in one
        process), the head count of its KV caches."""
        return self.layers[0].num_heads

    def lm_logits(self, hidden):
        """hidden @ lm_weight^T + bias as float32 logits.  JAX keeps them f32
        through ``preferred_element_type`` (``decoder.py:285-295``); a bf16
        matmul would round them to bf16 and create ties that change top-k
        sampling, so the operands are upcast.  (bf16 operands are exact in
        f32, so the products equal the JAX bf16 path's.)  The weight is
        rounded to the activation dtype first, as JAX's bf16 path casts
        its f32 parameter.  Under a sharded vocab (``vocab_tp``) they are
        this rank's slice of the vocab."""
        w = self.lm_head.decoder.weight.to(hidden.dtype)
        h = tpar.copy_to_model(hidden.float(), self.vocab_tp)
        return F.linear(h, w.float()) + self.lm_head.bias.float()

    def forward(self, x, attention_mask: Optional[torch.Tensor], memory,
                memory_mask: Optional[torch.Tensor],
                train: Optional[Training] = None):
        if attention_mask is None:
            attention_mask = torch.ones(x.shape[:2], dtype=torch.long,
                                        device=x.device)
        self_mask = causal_additive_mask(attention_mask, x.dtype)
        for layer in self.layers:
            x = layer_call(train, layer, x, self_mask, memory, memory_mask,
                           train, tagged=False)
        return x

    def forward_cached(self, x, attention_mask: Optional[torch.Tensor],
                       memory_kv, memory_mask: Optional[torch.Tensor]):
        if attention_mask is None:
            attention_mask = torch.ones(x.shape[:2], dtype=torch.long,
                                        device=x.device)
        self_mask = causal_additive_mask(attention_mask, x.dtype)
        for layer, mem in zip(self.layers, memory_kv):
            x = layer.forward_with_memory_kv(x, self_mask, mem, memory_mask)
        return x

    def precompute_memory(self, memory):
        """Per-layer cross K/V for a fixed memory, once per utterance (a
        list of (k, v); :func:`quantize_memory_kv` makes the int8 form)."""
        return [layer.memory_kv(memory) for layer in self.layers]

    def step(self, x, pos: int, caches: List[Cache], memory_kv,
             memory_mask: Optional[torch.Tensor]):
        for layer, cache, mem in zip(self.layers, caches, memory_kv):
            x = layer.step(x, pos, cache, mem, memory_mask)
        return x
