"""The standalone text-only BERT masked LM, the attacker of the random_token
attack (the port of ``gstx/models/mlm.py``).

The reference loads an independent Hugging Face ``BertForMaskedLM``
('bert-base-uncased') as the attacker (``utils/text_attack.py:19-27``), so
the attacker shares no weights with the victim dialog model.  BertMLM is
that model: BERT embeddings, a stack of post-LN layers and the MLM head
whose projection is the word table.  Its modules carry Hugging Face's
state-dict names (``bert.embeddings.*``, ``bert.encoder.layer.{i}.*``,
``cls.predictions.*``), so a ``pytorch_model.bin`` loads with
``strict=True`` (:func:`load_mlm_attacker`).  Its layers are the dialog
encoder's (:class:`gstx_torch.models.layers.TransformerLayer`), behind the
same fused-kernel gate: in bf16 at width 768 / 3,072 a forward launches
``fused_dense_ln`` and ``fused_ffn`` once a layer.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gstx_torch.core.checkpoint import refuse_directory
from gstx_torch.core.config import EncoderConfig
from gstx_torch.core.device import resolve_device
from gstx_torch.models.heads import PredictionTransform
from gstx_torch.models.layers import (LayerNorm, TransformerLayer,
                                      additive_mask, init_weights_,
                                      number_dropout_sites)


def mlm_config(vocab_size: int = 30522, hidden_size: int = 768,
               num_hidden_layers: int = 12, num_attention_heads: int = 12,
               intermediate_size: int = 3072,
               max_position_embeddings: int = 512) -> EncoderConfig:
    """bert-base-uncased's shape by default (``gstx/models/mlm.py:31-43``);
    the visual fields are unused."""
    return EncoderConfig(
        vocab_size=vocab_size, hidden_size=hidden_size,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=num_attention_heads,
        intermediate_size=intermediate_size,
        max_position_embeddings=max_position_embeddings,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


class BertEmbeddings(nn.Module):
    """word + learned position + segment embeddings under LayerNorm.  A
    segment id past ``type_vocab_size`` adds nothing, as the JAX attacker's
    zero-filled extension table (``gstx/models/mlm.py:97-103``)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        tv = self.token_type_embeddings.num_embeddings
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        seg = self.token_type_embeddings(token_type_ids.clamp(max=tv - 1))
        seg = torch.where((token_type_ids < tv)[..., None], seg, 0.0)
        dt = self.word_embeddings.weight.dtype
        return self.LayerNorm(self.word_embeddings(input_ids)
                              + self.position_embeddings(pos).to(dt)
                              + seg.to(dt))


class BertMLM(nn.Module):
    """``BertMLM(cfg, device="cuda", seed=0)``: the attacker with weights
    from a seeded generator (:func:`gstx_torch.models.layers.init_weights_`);
    load trained weights with :func:`load_mlm_attacker`.  The forward
    computes in the dtype of the word table (cast the model with
    :func:`gstx_torch.models.encdec.precast_` for bf16) and returns
    [B, L, vocab] f32 logits (Hugging Face ``BertForMaskedLM``
    semantics, with the reference's -10000 additive mask)."""

    def __init__(self, cfg: EncoderConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.config = cfg
        dev = resolve_device(device)
        heads = cfg.num_attention_heads
        with dev:
            self.bert = nn.Module()
            self.bert.embeddings = BertEmbeddings(cfg)
            self.bert.encoder = nn.Module()
            self.bert.encoder.layer = nn.ModuleList(
                TransformerLayer(cfg.hidden_size, heads,
                                 cfg.hidden_size // heads,
                                 cfg.intermediate_size, cfg.hidden_act,
                                 cfg.layer_norm_eps)
                for _ in range(cfg.num_hidden_layers))
            self.cls = nn.Module()
            self.cls.predictions = nn.Module()
            pred = self.cls.predictions
            pred.transform = PredictionTransform(cfg.hidden_size,
                                                 cfg.hidden_act,
                                                 cfg.layer_norm_eps)
            pred.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)
            pred.bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        init_weights_(self, torch.Generator(device=dev).manual_seed(seed),
                      cfg.initializer_range)
        pred.decoder.weight = self.bert.embeddings.word_embeddings.weight
        number_dropout_sites(self)

    def f32_params(self):
        """The MLM bias stays f32 under a precast: consumed in f32."""
        return [self.cls.predictions.bias]

    @property
    def device(self) -> torch.device:
        return self.cls.predictions.bias.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.bert.embeddings(input_ids, token_type_ids)
        mask = additive_mask(attention_mask, x.dtype)
        for layer in self.bert.encoder.layer:
            x = layer(x, mask)
        pred = self.cls.predictions
        h = pred.transform(x)
        # the tied projection in f32, as the JAX attacker's embed attend
        return F.linear(h.float(), pred.decoder.weight.float()) \
            + pred.bias.float()


def _infer_heads(hidden_size: int) -> int:
    """num_attention_heads under bert-base's 64-wide heads
    (``gstx/models/mlm.py:131-140``): a state dict does not say it."""
    if hidden_size % 64 != 0:
        raise ValueError(
            f"cannot infer num_attention_heads: hidden_size {hidden_size} "
            "is not a multiple of head_dim 64; pass a config to "
            "load_mlm_attacker")
    return hidden_size // 64


# BertForPreTraining's heads, present in the released bert-base-uncased
# file, which the masked LM does not have (the JAX converter reads past them)
_PRETRAINING_ONLY = ("bert.pooler.", "cls.seq_relationship.")


def hf_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A Hugging Face BERT masked-LM state dict in BertMLM's names, as the
    JAX converter reads it (``gstx/models/mlm.py:86-128``): DataParallel's
    ``module.`` stripped; the ``position_ids`` buffer, the decoder's bias
    (the same tensor as ``cls.predictions.bias``) and BertForPreTraining's
    pooler and NSP head dropped; the tied ``cls.predictions.decoder.weight``
    taken to be the word table, which the JAX attacker projects onto."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.endswith("position_ids") or \
                k == "cls.predictions.decoder.bias" or \
                k.startswith(_PRETRAINING_ONLY):
            continue
        out[k] = torch.as_tensor(v)
    word = out.get("bert.embeddings.word_embeddings.weight")
    if word is not None:
        out["cls.predictions.decoder.weight"] = word
    return out


def load_mlm_attacker(path: str, config: Optional[EncoderConfig] = None,
                      device="cuda") -> BertMLM:
    """The attacker from ``-mlm_path``, a torch state dict file
    (``pytorch_model.bin``-style), on ``device``: its config inferred from
    the shapes when not given (heads of 64), its weights loaded with
    ``strict=True`` (:func:`hf_state_dict`).  A directory (an orbax
    checkpoint of the JAX package) is refused."""
    refuse_directory(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = hf_state_dict(raw.get("model_state_dict", raw))
    if config is None:
        word = sd["bert.embeddings.word_embeddings.weight"]
        layers = {k.split(".")[3] for k in sd
                  if k.startswith("bert.encoder.layer.")}
        config = mlm_config(
            vocab_size=word.shape[0], hidden_size=word.shape[1],
            num_hidden_layers=len(layers),
            num_attention_heads=_infer_heads(word.shape[1]),
            intermediate_size=sd["bert.encoder.layer.0.intermediate.dense."
                                 "weight"].shape[0],
            max_position_embeddings=sd[
                "bert.embeddings.position_embeddings.weight"].shape[0])
    model = BertMLM(config, device=device).eval()
    model.load_state_dict(sd, strict=True)
    return model


def make_standalone_mlm_fill(model: BertMLM):
    """The refill callable of the independent attacker (reference
    text_attack.py:30-56; it sees the text only): numpy ids, segments and
    mask in, [B, L, vocab] f32 logits on the attacker's device out."""

    def fill(input_ids, token_type_ids, attention_mask, image=None):
        dev = model.device
        with torch.no_grad():
            return model(*(torch.from_numpy(np.asarray(a)).to(dev)
                           for a in (input_ids, token_type_ids,
                                     attention_mask)))

    return fill

