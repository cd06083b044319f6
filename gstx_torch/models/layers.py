"""Shared transformer building blocks (port of ``gstx/models/layers.py``).

Semantics mirror the reference BERT blocks: post-LayerNorm residual layers,
exact-erf GELU, LayerNorm with eps inside the rsqrt and f32 statistics,
additive -10000 attention masks.  Modules carry the reference PyTorch
parameter names (``attention.self.query``, ``output.LayerNorm``, ...), so a
reference state dict loads strictly.

dtype policy, as in the JAX package: the activation dtype is the dtype of
the tensors flowing through (bf16 in the engine, f32 in the tests).  A
projection casts its weights to it and returns it (``PDense``,
``layers.py:125-132``).  Attention scores accumulate in f32.  At the
fused sites (attention-output projection + LayerNorm, and the encoder FFN)
a bf16 activation at widths the CUDA kernels of ``gstx_torch/kernels/ffn.py``
take (``widths_taken``: multiples of 128, the output at most 1024 wide)
goes through them while their switch is on (``kffn.enable``, on by
default; the gate of ``maybe_fused_*``, ``gstx/kernels/ffn.py:395-427``);
anything else runs the unfused ops.
:func:`attend` goes through the attention kernel of
``gstx_torch/kernels/attention.py`` when its switch is on (off by default,
as in the reference).

This serving slice has no dropout: every block computes the deterministic
forward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gstx_torch.kernels import attention as kattn
from gstx_torch.kernels import ffn as kffn

MASK_VALUE = -10000.0  # reference vilbert_dialog.py:1364


# F.gelu's default is the exact (erf) GELU of the reference
ACT2FN = {"gelu": F.gelu, "relu": F.relu, "swish": F.silu}


def linear(x, layer: nn.Linear):
    """``layer(x)`` computed in x's dtype (weights cast at use, as PDense)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and parameters, eps inside the rsqrt;
    returns the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def additive_mask(binary_mask, dtype=torch.float32):
    """[B, L] {0,1} -> [B, 1, 1, L] additive mask, -10000 at masked slots."""
    m = binary_mask[:, None, None, :].float()
    return ((1.0 - m) * MASK_VALUE).to(dtype)


def causal_additive_mask(binary_mask, dtype=torch.float32):
    """[B, L] padding mask -> [B, 1, L, L] causal + padding additive mask."""
    _, l = binary_mask.shape
    seq = torch.arange(l, device=binary_mask.device)
    causal = (seq[None, :] <= seq[:, None]).float()
    m = causal[None] * binary_mask[:, None, :].float()
    return ((1.0 - m) * MASK_VALUE)[:, None].to(dtype)


def split_heads(x, num_heads: int):
    """[B, L, H*Dh] -> [B, H, L, Dh]."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x):
    """[B, H, L, Dh] -> [B, L, H*Dh]."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def attend(q, k, v, mask: Optional[torch.Tensor]):
    """Scaled dot-product attention over [B, H, L, Dh] tensors.

    The kernel gate first (``layers.py:210-216``): with the attention switch
    on (:func:`gstx_torch.kernels.attention.enable`), a query of 8 or more
    rows whose mask carries its batch goes through ``fused_attention``
    (f32 probabilities), returned in the activation dtype.  Otherwise the
    unfused ops below, which ``attention_batch_plain`` reproduces.

    The scores must be f32, as JAX's ``preferred_element_type=f32`` keeps
    them: a bf16 ``matmul`` would round them to bf16, so the operands are
    upcast.  The softmax runs in f32; the probabilities are cast to the
    activation dtype for the PV product, whose result has that dtype.
    ``mask`` is additive, broadcastable to [B, H, Lq, Lk]."""
    fused = kattn.maybe_fused_attention(q, k, v, mask)
    if fused is not None:
        return fused.to(q.dtype)
    scale = kattn.softmax_scale(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _fusable(x, d, inner) -> bool:
    """The layer-level gate of ``maybe_fused_*``: the kernels' switch
    (``kffn.enable``, set from ``-use_pallas``) first, then bf16
    activations at widths the kernels take (``widths_taken``, the predicate
    their wrappers raise by); elsewhere the caller runs the unfused ops, as
    the reference does where its gate returns None.  This slice is
    deterministic, so the dropout condition always holds."""
    return kffn.is_enabled() and x.dtype == torch.bfloat16 \
        and kffn.widths_taken(d, inner)


def dense_ln(x, dense: nn.Linear, ln: LayerNorm, residual):
    """``ln(dense(x) + residual)``, through the fused kernel when eligible."""
    if _fusable(x, *dense.weight.shape):
        dt = x.dtype
        return kffn.fused_dense_ln(
            x.contiguous(), dense.weight.to(dt), dense.bias.float(),
            residual.to(dt).contiguous(), ln.weight.float(), ln.bias.float(),
            eps=ln.eps)
    return ln(linear(x, dense) + residual)


def feed_forward(x, intermediate: nn.Linear, output: nn.Linear,
                 ln: LayerNorm, activation: str = "gelu"):
    """BertIntermediate + BertOutput: ``ln(output(act(intermediate(x))) +
    x)``, through the fused kernel when eligible."""
    if activation == "gelu" and _fusable(x, *output.weight.shape):
        dt = x.dtype
        return kffn.fused_ffn(
            x.contiguous(), intermediate.weight.to(dt),
            intermediate.bias.float(), output.weight.to(dt),
            output.bias.float(), ln.weight.float(), ln.bias.float(),
            eps=ln.eps)
    h = ACT2FN[activation](linear(x, intermediate))
    return ln(linear(h, output) + x)


class Projections(nn.Module):
    """Named projections of one input (reference BertSelfAttention holds
    query/key/value; the decoder's cross-attention the same names)."""

    def __init__(self, d_in: int, d_out: int,
                 names=("query", "key", "value")):
        super().__init__()
        self.names = tuple(names)
        for name in self.names:
            setattr(self, name, nn.Linear(d_in, d_out))

    def forward(self, x):
        return tuple(linear(x, getattr(self, n)) for n in self.names)


class DenseLN(nn.Module):
    """Reference BertSelfOutput / BertOutput: ``dense`` + ``LayerNorm``."""

    def __init__(self, d_in: int, d_out: int, eps: float = 1e-12):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = LayerNorm(d_out, eps)

    def forward(self, x, residual):
        return dense_ln(x, self.dense, self.LayerNorm, residual)


class Intermediate(nn.Module):
    """Reference BertIntermediate's parameters (its ``dense``)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class SelfAttention(nn.Module):
    """Reference BertAttention: ``LayerNorm(dense(attn(x)) + x)``."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 eps: float = 1e-12):
        super().__init__()
        self.num_heads = num_heads
        inner = num_heads * head_dim
        self.self = Projections(d_model, inner)
        self.output = DenseLN(inner, d_model, eps)

    def forward(self, x, mask):
        q, k, v = (split_heads(t, self.num_heads) for t in self.self(x))
        ctx = merge_heads(attend(q, k, v, mask))
        return self.output(ctx, x)


class TransformerLayer(nn.Module):
    """One post-LN BERT layer (text or visual stream), reference BertLayer."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 intermediate_size: int, activation: str = "gelu",
                 eps: float = 1e-12):
        super().__init__()
        self.activation = activation
        self.attention = SelfAttention(d_model, num_heads, head_dim, eps)
        self.intermediate = Intermediate(d_model, intermediate_size)
        self.output = DenseLN(intermediate_size, d_model, eps)

    def forward(self, x, mask):
        x = self.attention(x, mask)
        return feed_forward(x, self.intermediate.dense, self.output.dense,
                            self.output.LayerNorm, self.activation)


def init_weights_(module: nn.Module, generator: torch.Generator,
                  embedding_std: float = 0.02):
    """Seeded random init: ``nn.Linear`` weights N(0, 1/fan_in) (lecun
    normal, the Flax ``Dense`` default), biases zero; embeddings
    N(0, embedding_std); LayerNorm ones and zeros.  Embeddings come last,
    so a projection tied to an embedding table gets the table's init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in module.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, embedding_std, generator=generator)
