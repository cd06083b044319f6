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

Training (``gstx/models/layers.py:46-91,193-351``): a forward given a
:class:`Training` applies dropout at the JAX package's sites and rates, and
recomputes under its remat policy (:func:`layer_call`, :func:`region`).
The fused kernels' gate declines a site whose dropout is active, as
``maybe_fused_*`` do; with every rate 0 the kernels run under autograd
(``kffn.FusedFFN`` / ``kffn.FusedDenseLN``).  Without a :class:`Training`
(``train=None``) every block computes the deterministic forward.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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


# ---------------------------------------------------------------------- #
# training: dropout and recomputation
# ---------------------------------------------------------------------- #

REMAT_POLICIES = ("full", "dots", "small")
_MASK64 = (1 << 64) - 1


def _mix(seed: int, site: int) -> int:
    """A 63-bit generator seed from (seed, site): splitmix64's finalizer
    over their combination, so neighbouring sites draw unrelated masks."""
    z = (seed * 0x9E3779B97F4A7C15 + (site + 1) * 0xBF58476D1CE4E5B9) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def number_dropout_sites(root: nn.Module):
    """Give every module under ``root`` its ``dropout_site``: its index in
    ``root.modules()``.  A dropout mask's seed derives from the forward's
    seed and (module, call site), never from how many masks were drawn
    before it, so a recomputed region draws the masks of its first run."""
    for i, m in enumerate(root.modules()):
        m.dropout_site = i


def site_of(module: nn.Module, k: int = 0) -> int:
    """Call site ``k`` (< 16) of ``module``'s forward."""
    return module.dropout_site * 16 + k


@dataclass(frozen=True)
class Training:
    """What a training forward threads through the blocks (the JAX
    package's ``deterministic=False`` with its dropout rng and
    ``remat_policy``).

    ``seed`` seeds every dropout mask: a site's mask comes from a generator
    on the tensor's device seeded with ``_mix(seed, site)``, re-seeded at
    each draw.  ``torch.utils.checkpoint`` restores only the global RNG
    states, so a mask drawn from a shared stream would differ in the
    recompute; a mask that is a function of (seed, site) does not.

    ``remat``: None (keep every activation), or the policy of
    ``gstx/models/layers.py::checkpoint_policy``:

      * ``full``: each layer keeps its inputs and recomputes everything;
      * ``dots``: each layer keeps the outputs of its weight products
        (``aten.mm`` / ``aten.addmm``, the dots without batch dimensions)
        and recomputes the rest, the batched attention products included;
      * ``small``: each encoder layer keeps the QKV projections, the
        attention contexts and the block outputs (the JAX package's
        ``gstx_proj`` / ``gstx_ctx`` / ``gstx_block`` names) and
        recomputes the scores, the probabilities, the projections behind a
        LayerNorm and the FFN hidden.  A fused site keeps only its inputs
        by design (its backward recomputes from them), so it needs no
        region and its kernel does not run again.  The decoder's layers
        carry no tag in the JAX package, so under ``small`` they keep only
        their inputs, as under ``full``.
    """

    seed: int
    remat: Optional[str] = None
    _gens: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.remat not in (None,) + REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {self.remat!r} (use "
                             "'full', 'dots' or 'small')")

    def keep_mask(self, shape, device, keep: float, site: int):
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        gen.manual_seed(_mix(self.seed, site))
        return torch.rand(shape, generator=gen, device=device) < keep

    def dropout(self, x, rate: float, site: int):
        """Flax ``nn.Dropout``: kept values scaled by 1/keep in x's dtype,
        dropped ones 0."""
        if rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = self.keep_mask(x.shape, x.device, keep, site)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def dropping(train: Optional[Training], rate: float) -> bool:
    """Whether a site's dropout is active (``not deterministic and
    dropout_rate > 0``, the kernels' gate condition)."""
    return train is not None and rate > 0.0


def _dots_policy(ctx, func, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if func in _WEIGHT_PRODUCTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_WEIGHT_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _checkpoint(fn, *args, context_fn=None):
    kw = {} if context_fn is None else {"context_fn": context_fn}
    # the masks are functions of (seed, site): no global RNG to restore
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _recomputing(train: Optional[Training]) -> bool:
    return train is not None and train.remat is not None \
        and torch.is_grad_enabled()


def layer_call(train: Optional[Training], fn, *args, tagged: bool = True):
    """One layer's forward ``fn(*args)`` under ``train``'s remat policy
    (the JAX package's per-layer ``nn.remat``): ``full`` and ``dots``
    checkpoint the whole layer; ``small`` leaves a tagged (encoder) layer
    to its :func:`region`s and checkpoints an untagged (decoder) layer
    whole."""
    if not _recomputing(train) or (train.remat == "small" and tagged):
        return fn(*args)
    if train.remat == "dots":
        return _checkpoint(fn, *args, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return _checkpoint(fn, *args)


def region(train: Optional[Training], fn, *args):
    """A piece of an encoder layer between tagged values: under ``small``
    it keeps only its inputs and recomputes the rest; otherwise it runs as
    it is."""
    if _recomputing(train) and train.remat == "small":
        return _checkpoint(fn, *args)
    return fn(*args)


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


def attend(q, k, v, mask: Optional[torch.Tensor],
           train: Optional[Training] = None, rate: float = 0.0,
           site: int = 0):
    """Scaled dot-product attention over [B, H, L, Dh] tensors.

    The kernel gate first (``layers.py:210-216``): with the attention switch
    on (:func:`gstx_torch.kernels.attention.enable`) and no active dropout,
    a query of 8 or more rows whose mask carries its batch goes through
    ``fused_attention`` (f32 probabilities), returned in the activation
    dtype.  Otherwise the unfused ops below, which ``attention_batch_plain``
    reproduces.

    The scores must be f32, as JAX's ``preferred_element_type=f32`` keeps
    them: a bf16 ``matmul`` would round them to bf16, so the operands are
    upcast.  The softmax runs in f32; under ``train`` with ``rate`` > 0 the
    f32 probabilities are dropped at ``site`` and scaled by 1/keep
    (``layers.py:255-257``); they are cast to the activation dtype for the
    PV product, whose result has that dtype.  ``mask`` is additive,
    broadcastable to [B, H, Lq, Lk]."""
    if not dropping(train, rate):
        fused = kattn.maybe_fused_attention(q, k, v, mask)
        if fused is not None:
            return fused.to(q.dtype)
    scale = kattn.softmax_scale(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    if dropping(train, rate):
        keep = 1.0 - rate
        probs = probs * train.keep_mask(probs.shape, probs.device, keep,
                                        site) / keep
    # rebinding frees the f32 probabilities before the product
    probs = probs.to(q.dtype)
    return torch.matmul(probs, v)


def attention_region(train: Optional[Training], q, k, v, mask,
                     rate: float = 0.0, site: int = 0):
    """:func:`attend` as a :func:`region`: under ``small`` the context is
    kept and the scores and probabilities are recomputed."""
    return region(train, lambda q_, k_, v_, m_: attend(
        q_, k_, v_, m_, train, rate, site), q, k, v, mask)


def _fusable(x, d, inner, train: Optional[Training] = None,
             rate: float = 0.0) -> bool:
    """The layer-level gate of ``maybe_fused_*``: the kernels' switch
    (``kffn.enable``, set from ``-use_pallas``) first, then no active
    dropout at the site (``not deterministic and dropout_rate > 0``
    declines, ``gstx/kernels/ffn.py:401,419``), then bf16 activations at
    widths the kernels take (``widths_taken``, the predicate their
    wrappers raise by); elsewhere the caller runs the unfused ops, as the
    reference does where its gate returns None."""
    return kffn.is_enabled() and not dropping(train, rate) \
        and x.dtype == torch.bfloat16 and kffn.widths_taken(d, inner)


def dense_ln(x, dense: nn.Linear, ln: LayerNorm, residual,
             train: Optional[Training] = None, rate: float = 0.0,
             site: int = 0):
    """``ln(dropout(dense(x)) + residual)``, through the fused kernel when
    eligible.  The kernel's bias is rounded to the activation dtype, as the
    unfused projection's is, so an f32 parameter under a bf16 compute dtype
    gives what the same parameter cast once to bf16 gives."""
    if _fusable(x, *dense.weight.shape, train, rate):
        dt = x.dtype
        return kffn.fused_dense_ln(
            x.contiguous(), dense.weight.to(dt), dense.bias.to(dt).float(),
            residual.to(dt).contiguous(), ln.weight.float(), ln.bias.float(),
            eps=ln.eps)

    def block(x_, r_):
        h = linear(x_, dense)
        if train is not None:
            h = train.dropout(h, rate, site)
        return ln(h + r_)
    return region(train, block, x, residual)


def feed_forward(x, intermediate: nn.Linear, output: nn.Linear,
                 ln: LayerNorm, activation: str = "gelu",
                 train: Optional[Training] = None, rate: float = 0.0,
                 site: int = 0):
    """BertIntermediate + BertOutput: ``ln(dropout(output(act(
    intermediate(x)))) + x)``, through the fused kernel when eligible (its
    biases rounded as :func:`dense_ln`'s)."""
    if activation == "gelu" and _fusable(x, *output.weight.shape, train,
                                         rate):
        dt = x.dtype
        return kffn.fused_ffn(
            x.contiguous(), intermediate.weight.to(dt),
            intermediate.bias.to(dt).float(), output.weight.to(dt),
            output.bias.to(dt).float(), ln.weight.float(), ln.bias.float(),
            eps=ln.eps)

    def block(x_):
        h = linear(ACT2FN[activation](linear(x_, intermediate)), output)
        if train is not None:
            h = train.dropout(h, rate, site)
        return ln(h + x_)
    return region(train, block, x)


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

    def forward(self, x, residual, train: Optional[Training] = None,
                rate: float = 0.0):
        return dense_ln(x, self.dense, self.LayerNorm, residual, train, rate,
                        site_of(self))


class Intermediate(nn.Module):
    """Reference BertIntermediate's parameters (its ``dense``)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class SelfAttention(nn.Module):
    """Reference BertAttention: ``LayerNorm(dropout(dense(attn(x))) + x)``,
    the attention probabilities dropped at ``attn_dropout`` and the
    projection at ``hidden_dropout`` under training."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 eps: float = 1e-12, attn_dropout: float = 0.0,
                 hidden_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_dropout, self.hidden_dropout = attn_dropout, hidden_dropout
        inner = num_heads * head_dim
        self.self = Projections(d_model, inner)
        self.output = DenseLN(inner, d_model, eps)

    def forward(self, x, mask, train: Optional[Training] = None):
        q, k, v = (split_heads(t, self.num_heads) for t in self.self(x))
        ctx = attention_region(train, q, k, v, mask, self.attn_dropout,
                               site_of(self))
        return self.output(merge_heads(ctx), x, train, self.hidden_dropout)


class TransformerLayer(nn.Module):
    """One post-LN BERT layer (text or visual stream), reference BertLayer;
    ``attn_dropout`` / ``hidden_dropout`` are its training rates."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 intermediate_size: int, activation: str = "gelu",
                 eps: float = 1e-12, attn_dropout: float = 0.0,
                 hidden_dropout: float = 0.0):
        super().__init__()
        self.activation = activation
        self.hidden_dropout = hidden_dropout
        self.attention = SelfAttention(d_model, num_heads, head_dim, eps,
                                       attn_dropout, hidden_dropout)
        self.intermediate = Intermediate(d_model, intermediate_size)
        self.output = DenseLN(intermediate_size, d_model, eps)

    def forward(self, x, mask, train: Optional[Training] = None):
        x = self.attention(x, mask, train)
        return feed_forward(x, self.intermediate.dense, self.output.dense,
                            self.output.LayerNorm, self.activation, train,
                            self.hidden_dropout, site_of(self.output))


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
