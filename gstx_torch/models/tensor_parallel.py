"""Megatron-style tensor parallelism over a model group (the port of what
``gstx/core/mesh.py:179-311`` and ``gstx/models/encdec.py:38-66`` let
GSPMD do for the JAX package).

The JAX package places every weight on a ``model`` mesh axis and lets XLA
insert the collectives.  Here each rank of a
:class:`gstx_torch.core.mesh.ModelGroup` holds its slice of every sharded
parameter and the collectives are explicit, Megatron's conjugate pair:

  * :func:`copy_to_model`: identity forward, all-reduce backward, in front
    of every column-parallel product (its input is replicated, its
    gradient a partial sum over the ranks' slices);
  * :func:`reduce_from_model`: all-reduce forward, identity backward,
    after every row-parallel product (its output a partial sum), before
    the bias.

The modules keep the ``weight`` / ``bias`` names, so a sharded module's
``state_dict()`` is its slice of the reference names
(:func:`gstx_torch.core.mesh.shard_state_dict`).  :func:`shard_model_`
turns a built :class:`gstx_torch.models.encdec.GSTVisualDialog` into
rank ``m``'s shard in place.  The group is an argument of every module
(None: one process); nothing here is module-global.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gstx_torch.core import mesh
from gstx_torch.core.mesh import ModelGroup


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce(grad), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelGroup]):
    """Identity forward, the gradient all-reduced over ``tp`` backward."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelGroup]):
    """``x`` summed over ``tp`` forward, the gradient passed through
    backward."""
    return x if tp is None else _ReduceFromModel.apply(x, tp)


def sharded(module: nn.Module) -> bool:
    """Whether ``module`` holds a slice of a sharded parameter."""
    return getattr(module, "tp", None) is not None


class ColumnParallelLinear(nn.Linear):
    """Rows ``[start, start + out)`` of an ``nn.Linear``'s output features
    (its weight and bias sliced on dim 0).  The input is replicated; the
    output is this rank's slice of the features, computed in the input's
    dtype as :func:`gstx_torch.models.layers.linear`."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 tp: ModelGroup, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=dtype)
        self.tp = tp

    def forward(self, x):
        x = copy_to_model(x, self.tp)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def _partial_product(x, w):
    """``x @ w.T`` accumulated and returned in f32 (a bf16 input is exact
    in f32, so the CPU's upcast computes what the card's bf16 product with
    f32 output does)."""
    if x.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                       out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


class RowParallelLinear(nn.Linear):
    """This rank's slice of an ``nn.Linear``'s input features (its weight
    sliced on dim 1, the bias whole).  The input is this rank's slice of
    the features; the partial products, in f32, are all-reduced over the
    group, then the bias is added and the sum rounded once to the input's
    dtype, as one process's product rounds its f32 accumulator once: the
    output is replicated, and a bf16 model over the group rounds as one
    process does."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 tp: ModelGroup, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=dtype)
        self.tp = tp

    def forward(self, x):
        y = reduce_from_model(_partial_product(x, self.weight.to(x.dtype)),
                              self.tp)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).float()
        return y.to(x.dtype)


class VocabParallelEmbedding(nn.Embedding):
    """Rows ``[start, start + num_embeddings)`` of a word table: each rank
    looks up the ids it holds (zeros elsewhere) and the lookups are summed
    over the group, which gives every rank the full table's rows, exactly
    (one non-zero term per id)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, start: int,
                 tp: ModelGroup, device=None, dtype=None):
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)
        self.start = start
        self.tp = tp

    def forward(self, ids):
        local = ids - self.start
        inside = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(torch.where(inside, local, 0), self.weight)
        rows = torch.where(inside[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        return reduce_from_model(rows, self.tp)


# ---------------------------------------------------------------------- #
# the vocab-parallel logits
# ---------------------------------------------------------------------- #


def gather_vocab(logits: torch.Tensor, tp: Optional[ModelGroup]):
    """The full ``[..., V]`` logits from every rank's ``[..., V / mp]``
    slice (all-gathered in rank order; no gradient), for sampling and for
    whoever reads whole rows."""
    if tp is None:
        return logits
    return tp.all_gather(logits.detach(), -1)


def token_log_probs(logits: torch.Tensor, targets: torch.Tensor,
                    tp: Optional[ModelGroup] = None) -> torch.Tensor:
    """``log_softmax(logits)[targets]`` in f32, ``targets`` any ids in
    ``[0, V)``.  With ``tp`` the logits are this rank's vocab slice and the
    softmax is taken over the group, Megatron's vocab-parallel cross
    entropy (the port's form of ``_shard_logits``,
    ``gstx/models/encdec.py:50-66``): the group max (no gradient), the
    group sum of the exponentials and the target's logit, each reduced
    over the group; differentiable, equal to the full log-softmax."""
    logits = logits.float()
    if tp is None:
        return F.log_softmax(logits, dim=-1).gather(
            -1, targets[..., None])[..., 0]
    vl = logits.shape[-1]
    top = tp.all_reduce(logits.detach().amax(-1, keepdim=True),
                        dist.ReduceOp.MAX)
    shifted = logits - top
    sum_exp = reduce_from_model(shifted.exp().sum(-1), tp)
    local = targets - tp.rank * vl
    inside = (local >= 0) & (local < vl)
    target = shifted.gather(-1, torch.where(inside, local, 0)[..., None])
    target = reduce_from_model(torch.where(inside, target[..., 0], 0.0), tp)
    return target - torch.log(sum_exp)


# ---------------------------------------------------------------------- #
# sharding a built model
# ---------------------------------------------------------------------- #


def _slice(t: torch.Tensor, dim: int, tp: ModelGroup) -> torch.Tensor:
    per = t.shape[dim] // tp.size
    return t.detach().narrow(dim, tp.rank * per, per).clone()


def _parallel_linear(full: nn.Linear, kind: str, tp: ModelGroup):
    w = full.weight
    if kind == mesh.ROW:
        out = RowParallelLinear(w.shape[1] // tp.size, w.shape[0],
                                full.bias is not None, tp, device=w.device,
                                dtype=w.dtype)
        with torch.no_grad():
            out.weight.copy_(_slice(w, 1, tp))
            if full.bias is not None:
                out.bias.copy_(full.bias)
        return out
    out = ColumnParallelLinear(w.shape[1], w.shape[0] // tp.size,
                               full.bias is not None, tp, device=w.device,
                               dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(_slice(w, 0, tp))
        if full.bias is not None:
            out.bias.copy_(_slice(full.bias, 0, tp))
    return out


def shard_model_(model: nn.Module, tp: ModelGroup) -> Optional[ModelGroup]:
    """Turn the built (full) ``model`` into rank ``tp.rank``'s shard, in
    place: every ``nn.Linear`` of a sharded class
    (:func:`gstx_torch.core.mesh.param_partition`) becomes a
    :class:`ColumnParallelLinear` or :class:`RowParallelLinear` holding its
    slice, every attention computes its ``H / mp`` heads (``num_heads``,
    and ``head_range`` = (first head, all heads) for the dropout masks),
    and the vocab tensors shard when the vocab divides by ``mp``: the
    word table becomes a :class:`VocabParallelEmbedding` (the tied MLM
    projection follows it) and the LM head keeps its rows of the vocab.
    Returns the group the vocab is sharded over, or None when the vocab
    stays whole (one message per tensor tail, as
    :func:`gstx_torch.core.mesh.shard_dim` prints), and the losses then
    take the plain path."""
    names = {id(m): n for n, m in model.named_modules()}
    vocab = model.bert.embeddings.word_embeddings
    vocab_tp = tp if vocab.weight.shape[0] % tp.size == 0 else None
    if vocab_tp is None:
        # one message per tensor tail, as shard_state_dict gives
        warned = set()
        for name, p in model.state_dict(keep_vars=True).items():
            if mesh.param_partition(name) == mesh.VOCAB:
                mesh.shard_dim(name, p.shape, tp.size, warned)
    tied = {id(vocab.weight)}
    for parent in list(model.modules()):
        for child_name, child in list(parent.named_children()):
            if not isinstance(child, nn.Linear) or \
                    isinstance(child, (ColumnParallelLinear,
                                       RowParallelLinear)):
                continue
            path = f"{names[id(parent)]}.{child_name}".lstrip(".")
            kind = mesh.param_partition(path + ".weight")
            if kind is None or id(child.weight) in tied:
                continue
            if kind == mesh.VOCAB:
                if vocab_tp is None:
                    continue
                kind = mesh.COLUMN  # the LM head's rows of the vocab
            setattr(parent, child_name, _parallel_linear(child, kind, tp))
    for m in model.modules():
        if getattr(m, "num_heads", None) is not None and \
                hasattr(m, "head_range"):
            total = m.num_heads
            m.num_heads = total // tp.size
            m.head_range = (tp.rank * m.num_heads, total)
    if vocab_tp is None:
        return None
    emb = model.bert.embeddings
    w = vocab.weight
    table = VocabParallelEmbedding(w.shape[0] // tp.size, w.shape[1],
                                   tp.rank * (w.shape[0] // tp.size), tp,
                                   device=w.device, dtype=w.dtype)
    with torch.no_grad():
        table.weight.copy_(_slice(w, 0, tp))
    emb.word_embeddings = table
    heads = model.encoder.bert_pretrained.cls
    heads.predictions.decoder.weight = table.weight  # tied
    with torch.no_grad():
        bias = heads.predictions.bias
        heads.predictions.bias = nn.Parameter(_slice(bias, 0, tp))
    heads.vocab_tp = vocab_tp
    if getattr(model, "use_decoder", False):
        lm = model.dec.lm_head
        lm.bias = lm.decoder.bias  # one tensor, two names
        model.dec.vocab_tp = vocab_tp
    return vocab_tp
