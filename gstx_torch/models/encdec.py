"""Top-level GST visual-dialog model: two-stream encoder + V+L fusion +
cross-attention decoder (port of ``gstx/models/encdec.py``, lines 33-254).

Parameter layout is the reference EncoderDecoderModel's:
``encoder.bert_pretrained.{bert,cls}``, ``vlfusion.{fc_l,fc_v}`` and
``decoder.decoder.{bert,lm_head}``.  Tying: encoder word embeddings ==
decoder input embeddings (one module) == MLM-head projection; the decoder LM
head has its own projection weight.  With ``use_decoder=False`` the model is
the discriminative encoder alone (``encoder.bert_pretrained.*``, the
reference's enc-only checkpoints), as ``gstx/models/encdec.py:36,75``.

Compute dtype: ``GSTVisualDialog(dtype=torch.bfloat16)`` computes in bf16
over the parameters' own dtype (f32 when built), as the JAX package trains
``GSTVisualDialog(dtype=bf16)`` with f32 parameters; ``dtype=None`` (the
default) computes in the dtype of the embedding tables, so a model cast
with :func:`precast_` computes in bf16.  Both give the same forward, bit
for bit.  Training: :meth:`GSTVisualDialog.score` with ``train``
(:class:`gstx_torch.models.layers.Training`) and
:func:`teacher_forced_loss`.

Tensor parallelism: ``GSTVisualDialog(..., tp=group)`` builds the full
model and keeps rank ``group.rank``'s shard of it
(:func:`gstx_torch.models.tensor_parallel.shard_model_`);
``load_state_dict`` takes a full state dict and slices it, and
``state_dict()`` gives the rank's slices under the reference names.  The
teacher-forced logits are then the rank's slice of the vocab (when the
vocab divides by the degree: ``vocab_tp``), which the losses below take
with ``tp=model.vocab_tp``; :meth:`GSTVisualDialog.decode_step` returns
the full logits, gathered.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from gstx_torch.core import mesh, profiling
from gstx_torch.core.config import DecoderConfig, EncoderConfig
from gstx_torch.core.device import resolve_device
from gstx_torch.models import tensor_parallel as tpar
from gstx_torch.models.decoder import GSTDecoderModel
from gstx_torch.models.encoder import GSTEncoderModel
from gstx_torch.models.heads import PreTrainingHeads
from gstx_torch.models.layers import (LayerNorm, Training, additive_mask,
                                      init_weights_, linear,
                                      number_dropout_sites, site_of)

FUSION_DROPOUT = 0.1  # VLFusion's nn.Dropout(0.1) (gstx/models/encdec.py:85)


class _BertPretrained(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.bert = GSTEncoderModel(cfg)
        self.cls = PreTrainingHeads(cfg, self.bert.embeddings.word_embeddings)


class GSTVisualDialog(nn.Module):
    """``GSTVisualDialog(enc_cfg, dec_cfg, device="cuda", seed=0)`` builds
    the model on ``device`` with weights from a seeded ``torch.Generator``
    (see :func:`gstx_torch.models.layers.init_weights_`); load trained
    weights with ``load_state_dict`` afterwards.  ``use_decoder=False``
    builds the encoder and its heads only (no ``vlfusion.*`` or
    ``decoder.*``).  ``dtype``: the compute dtype (see the module's
    docstring).  ``tp``: a :class:`gstx_torch.core.mesh.ModelGroup` of
    more than one rank, whose rank's shard of the seeded model this one
    keeps (the seeded weights are those of one process)."""

    def __init__(self, enc_config: EncoderConfig, dec_config: DecoderConfig,
                 device="cuda", seed: int = 0, use_decoder: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 tp: Optional[mesh.ModelGroup] = None):
        super().__init__()
        self.enc_config, self.dec_config = enc_config, dec_config
        self.use_decoder = use_decoder
        dev = resolve_device(device)
        with dev:
            self.encoder = nn.Module()
            self.encoder.bert_pretrained = _BertPretrained(enc_config)
            if use_decoder:
                self.vlfusion = nn.Module()
                self.vlfusion.fc_l = nn.Linear(enc_config.hidden_size,
                                               enc_config.hidden_size)
                self.vlfusion.fc_v = nn.Linear(enc_config.v_hidden_size,
                                               enc_config.hidden_size)
                self.decoder = nn.Module()
                self.decoder.decoder = GSTDecoderModel(dec_config,
                                                       self.bert.embeddings)
        gen = torch.Generator(device=dev).manual_seed(seed)
        init_weights_(self, gen, enc_config.initializer_range)
        if use_decoder:
            # the decoder's LM projection is a table, initialised as one
            with torch.no_grad():
                self.dec.lm_head.decoder.weight.normal_(
                    0.0, dec_config.initializer_range, generator=gen)
        self.bert.embeddings.compute_dtype = dtype
        self.bert.v_embeddings.compute_dtype = dtype
        number_dropout_sites(self)
        self.tp = tp if tp is not None and tp.size > 1 else None
        # the group the vocab is sharded over: None in one process and
        # when the vocab does not divide by the degree
        self.vocab_tp = None
        if self.tp is not None:
            self._full_shapes = {k: v.shape
                                 for k, v in self.state_dict().items()}
            self.vocab_tp = tpar.shard_model_(self, self.tp)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict``; under tensor parallelism a full
        tensor is sliced to the rank's shard first (a tensor already of
        the shard's shape loads as it is)."""
        if self.tp is not None:
            own = self.state_dict()
            warned = set()
            state_dict = {
                k: v if k not in own or v.shape == own[k].shape
                else mesh.shard_tensor(k, v, self.tp.size, self.tp.rank,
                                       warned)
                for k, v in state_dict.items()}
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def full_state_dict(self):
        """The full tensors on the host: the state dict itself in one
        process; under tensor parallelism every rank's shards gathered
        (a collective of the model group)."""
        if self.tp is None:
            return {k: v.detach().cpu() for k, v in self.state_dict().items()}
        return mesh.gather_state_dict(self.state_dict(), self.tp,
                                      self._full_shapes)

    def full_logits(self, logits):
        """The full-vocab logits of this model's teacher-forced logits
        (gathered over ``vocab_tp``)."""
        return tpar.gather_vocab(logits, self.vocab_tp)

    def f32_params(self):
        """The parameters :func:`precast_` leaves f32 besides the
        LayerNorms': the decoder LM head's bias, consumed in f32."""
        return [self.dec.lm_head.bias] if self.use_decoder else []

    @property
    def bert(self) -> GSTEncoderModel:
        return self.encoder.bert_pretrained.bert

    @property
    def dec(self) -> GSTDecoderModel:
        return self.decoder.decoder

    @property
    def dtype(self) -> torch.dtype:
        """Activation dtype: the compute dtype, else that of the embedding
        tables."""
        return self.bert.embeddings.dtype

    @property
    def device(self) -> torch.device:
        return self.bert.embeddings.word_embeddings.weight.device

    # ------------------------------------------------------------------ #
    # encoder paths
    # ------------------------------------------------------------------ #

    def encode(self, input_ids, image_feat, image_loc, token_type_ids=None,
               attention_mask=None, image_attention_mask=None,
               pooled: bool = True, train: Optional[Training] = None):
        return self.bert(input_ids, image_feat, image_loc,
                         token_type_ids=token_type_ids,
                         attention_mask=attention_mask,
                         image_attention_mask=image_attention_mask,
                         pooled=pooled, train=train)

    def pretrain_scores(self, input_ids, image_feat, image_loc,
                        token_type_ids=None, attention_mask=None,
                        image_attention_mask=None,
                        train: Optional[Training] = None):
        """enc_only path: (prediction_t [B, L, vocab] f32, prediction_v
        [B, R, v_target], seq_relationship [B, 2]).  ``train``: the
        discriminative training forward (the encoder's dropout and
        recomputation, the heads' pooled dropout;
        ``gstx/models/encdec.py:119``)."""
        outs = self.encode(input_ids, image_feat, image_loc, token_type_ids,
                           attention_mask, image_attention_mask, train=train)
        return self.encoder.bert_pretrained.cls(*outs, train=train)

    def nsp_scores(self, input_ids, image_feat, image_loc,
                   token_type_ids=None, attention_mask=None,
                   image_attention_mask=None):
        """The third output of :meth:`pretrain_scores` alone ([B, 2], the
        activation dtype), without the MLM and region heads that the
        discriminative evaluator does not read (JAX's jit drops them from
        its program the same way)."""
        _, _, pooled_t, pooled_v = self.encode(
            input_ids, image_feat, image_loc, token_type_ids,
            attention_mask, image_attention_mask)
        return self.encoder.bert_pretrained.cls.seq_relationship(pooled_t,
                                                                 pooled_v)

    # ------------------------------------------------------------------ #
    # fusion + decoder paths
    # ------------------------------------------------------------------ #

    def fuse(self, hidden_t, hidden_v, attention_mask, image_attention_mask,
             train: Optional[Training] = None):
        """VLFusion: project both streams to the text width and concatenate
        [visual; text] into the memory (dropped at 0.1 under training)."""
        memory = torch.cat([linear(hidden_v, self.vlfusion.fc_v),
                            linear(hidden_t, self.vlfusion.fc_l)], dim=1)
        if train is not None:
            memory = train.dropout(memory, FUSION_DROPOUT,
                                   site_of(self.vlfusion))
        memory_mask = torch.cat([image_attention_mask.float(),
                                 attention_mask.float()], dim=1)
        return memory, memory_mask

    def _embed_dec(self, dec_input_ids, positions=None,
                   train: Optional[Training] = None):
        # the decoder reuses the dialog embeddings with segment 0
        return self.bert.embeddings(
            dec_input_ids, token_type_ids=torch.zeros_like(dec_input_ids),
            position_ids=positions, train=train, call=1)

    def decode_logits(self, dec_input_ids, dec_attention_mask, memory,
                      memory_mask, train: Optional[Training] = None):
        """Teacher-forced decoder pass -> [B, L, vocab] float32 logits."""
        x = self._embed_dec(dec_input_ids, train=train)
        mem_add = additive_mask(memory_mask, self.dtype)
        h = self.dec(x, dec_attention_mask, memory, mem_add, train)
        return self.dec.lm_logits(h)

    def decode_logits_cached(self, dec_input_ids, dec_attention_mask,
                             memory_kv, memory_add_mask):
        """Teacher-forced decoder pass over precomputed memory K/V."""
        x = self._embed_dec(dec_input_ids)
        h = self.dec.forward_cached(x, dec_attention_mask, memory_kv,
                                    memory_add_mask)
        return self.dec.lm_logits(h)

    def score(self, input_ids, image_feat, image_loc, token_type_ids,
              attention_mask, image_attention_mask, dec_input_ids,
              dec_attention_mask, train: Optional[Training] = None):
        """encode -> fuse -> teacher-forced decode: the train/eval forward
        of the reference EncoderDecoderModel.  ``train``: a training
        forward (dropout and recomputation), None for the deterministic
        one."""
        hidden_t, hidden_v, _, _ = self.encode(
            input_ids, image_feat, image_loc, token_type_ids,
            attention_mask, image_attention_mask, pooled=False, train=train)
        memory, memory_mask = self.fuse(hidden_t, hidden_v, attention_mask,
                                        image_attention_mask, train)
        return self.decode_logits(dec_input_ids, dec_attention_mask, memory,
                                  memory_mask, train)

    # ------------------------------------------------------------------ #
    # KV-cached decode
    # ------------------------------------------------------------------ #

    def decode_prepare(self, input_ids, image_feat, image_loc, token_type_ids,
                       attention_mask, image_attention_mask):
        """Run the encoder once and precompute the decoder's cross-attention
        K/V over the fused memory.  Returns (memory_kv, memory_add_mask)."""
        hidden_t, hidden_v, _, _ = self.encode(
            input_ids, image_feat, image_loc, token_type_ids,
            attention_mask, image_attention_mask, pooled=False)
        memory, memory_mask = self.fuse(hidden_t, hidden_v, attention_mask,
                                        image_attention_mask)
        return (self.dec.precompute_memory(memory),
                additive_mask(memory_mask, self.dtype))

    def decode_step(self, token_ids, pos: Union[int, torch.Tensor], caches,
                    memory_kv, memory_add_mask):
        """One decode step: token_ids [B, 1] at absolute position ``pos``, a
        Python int or a 0-d int64 tensor on the device (the captured decode
        step's; see ``GSTDecoderModel.step``).  Returns [B, vocab] float32
        logits, the full vocab (gathered under a sharded one); ``caches``
        are updated in place."""
        with profiling.span("gstx:decoder.embed"):
            positions = pos.expand(token_ids.shape) \
                if isinstance(pos, torch.Tensor) \
                else torch.full_like(token_ids, pos)
            x = self._embed_dec(token_ids, positions=positions)
        h = self.dec.step(x, pos, caches, memory_kv, memory_add_mask)
        with profiling.span("gstx:decoder.lm_head"):
            return self.full_logits(self.dec.lm_logits(h)[:, 0, :])


def precast_(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast the weights to the activation dtype once, in place (the engine's
    bf16 precast, ``gstx/decode/dialog_engine.py:230-263``).  LayerNorm
    parameters and the model's ``f32_params()`` stay f32: they are
    consumed in f32.  Parameter objects are kept (``p.data`` is replaced),
    so tying holds.  Serves :class:`GSTVisualDialog` and the attacker
    :class:`gstx_torch.models.mlm.BertMLM`."""
    keep = {id(p) for m in model.modules() if isinstance(m, LayerNorm)
            for p in m.parameters()}
    keep.update(id(p) for p in model.f32_params())
    with torch.no_grad():
        for p in model.parameters():
            if id(p) not in keep and p.dtype != dtype:
                p.data = p.data.to(dtype)
    return model


# ---------------------------------------------------------------------- #
# loss helpers
# ---------------------------------------------------------------------- #


def derive_labels_and_inputs(dec_input_ids, eos_id: int, pad_id: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels are the inputs shifted left; inputs map EOS -> PAD
    (reference visual_dialog_decoder.py:53-57)."""
    labels = torch.zeros_like(dec_input_ids)
    labels[:, :-1] = dec_input_ids[:, 1:]
    inputs = torch.where(dec_input_ids == eos_id, pad_id, dec_input_ids)
    return labels, inputs


def teacher_forced_nll(logits, labels, pad_id: int = 0,
                       tp=None) -> torch.Tensor:
    """Per-position CE with ignore_index=pad; [B, L] float32, 0 at ignored
    positions.  ``tp``: the group the logits' vocab is sharded over
    (``model.vocab_tp``; the vocab-parallel cross entropy)."""
    nll = -tpar.token_log_probs(logits, labels, tp)
    return torch.where(labels == pad_id, 0.0, nll)


def teacher_forced_loss(logits, labels, pad_id: int = 0,
                        denom=None, tp=None) -> torch.Tensor:
    """Mean CE over non-pad label positions (torch CrossEntropyLoss with
    ignore_index=pad, reduction='mean'; ``gstx/models/encdec.py:245-251``):
    a scalar, 0 when every label is pad.  ``denom``, when given, replaces
    the count of non-pad labels (at least 1): a data-parallel rank divides
    its rows' sum by the count over every rank's rows.  ``tp``: as
    :func:`teacher_forced_nll`'s."""
    nll = teacher_forced_nll(logits, labels, pad_id, tp)
    if denom is None:
        denom = (labels != pad_id).sum().clamp(min=1)
    return nll.sum() / denom


def candidate_log_likelihood(logits, dec_input_ids, pad_id: int = 0,
                             tp=None) -> torch.Tensor:
    """Sum log-likelihood of each candidate answer under teacher forcing,
    the generative ranking score (``gstx/models/encdec.py:254``, reference
    evaluate_gen.py:94-107): [B] float32.  Targets are the left-shifted
    decoder inputs; PAD targets count 0.  The log-softmax is taken in f32;
    the caller's f32 logits are not copied, and the [B, L, V] log-softmax
    lives only until the targets are gathered from it.  ``tp``: as
    :func:`teacher_forced_nll`'s."""
    targets = torch.zeros_like(dec_input_ids)
    targets[:, :-1] = dec_input_ids[:, 1:]
    tok = tpar.token_log_probs(logits, targets, tp)
    return torch.where(targets == pad_id, 0.0, tok).sum(-1)
