"""Plain reference of both benchmarked models, written from the published
architectures (ViLBERT's two-stream encoder, ``bert_base_6layer_6conect``,
Lu et al. 2019; VisDial-BERT's NSP scorer, Murahari et al. 2020; GST's
BERT decoder with cross-attention over the fused image and text memory,
github.com/gicheonkang/gst-visdial) with plain torch operations: no
kernels, no cache, no batching tricks.  Parameters are read from a dict
under the reference checkpoints' names.

``precision``: ``"f32"`` computes every product in float32 with TF32 off
(the reference); ``"fp8"`` rounds both operands of every product to
float8 e4m3 with one scale per tensor, the control that a precision below
the served bf16 must fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

MASK_VALUE = -10000.0
ENC = "encoder.bert_pretrained.bert."
CLS = "encoder.bert_pretrained.cls."
DEC = "decoder.decoder."
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the block: on this card a float32 product may run in
    TF32 otherwise."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #

def _linear(spec, name, d_out, d_in, bias=True):
    spec.append((name + ".weight", (d_out, d_in), "linear"))
    if bias:
        spec.append((name + ".bias", (d_out,), "bias"))


def _ln(spec, name, d):
    spec.append((name + ".weight", (d,), "ln_weight"))
    spec.append((name + ".bias", (d,), "bias"))


def _bert_layer(spec, p, d, f):
    for n in ("query", "key", "value"):
        _linear(spec, f"{p}attention.self.{n}", d, d)
    _linear(spec, f"{p}attention.output.dense", d, d)
    _ln(spec, f"{p}attention.output.LayerNorm", d)
    _linear(spec, f"{p}intermediate.dense", f, d)
    _linear(spec, f"{p}output.dense", d, f)
    _ln(spec, f"{p}output.LayerNorm", d)


def param_spec(enc: dict, dec: Optional[dict]) -> List[Tuple]:
    """Every distinct parameter as (name, shape, kind), kind one of
    ``embedding``, ``linear``, ``bias``, ``ln_weight``, ``lm``."""
    spec: List[Tuple] = []
    d, dv, bi = enc["hidden_size"], enc["v_hidden_size"], \
        enc["bi_hidden_size"]
    e = ENC + "embeddings."
    for n, rows in (("word_embeddings", enc["vocab_size"]),
                    ("position_embeddings", enc["max_position_embeddings"]),
                    ("token_type_embeddings", enc["type_vocab_size"]),
                    ("token_type_embeddings_extension",
                     enc["type_vocab_extension"]),
                    ("sep_embeddings", enc["sep_vocab_size"])):
        spec.append((e + n + ".weight", (rows, d), "embedding"))
    _ln(spec, e + "LayerNorm", d)
    v = ENC + "v_embeddings."
    _linear(spec, v + "image_embeddings", dv, enc["v_feature_size"])
    _linear(spec, v + "image_location_embeddings", dv, enc["v_loc_size"])
    _ln(spec, v + "LayerNorm", dv)
    for i in range(enc["num_hidden_layers"]):
        _bert_layer(spec, f"{ENC}encoder.layer.{i}.", d,
                    enc["intermediate_size"])
    for i in range(enc["v_num_hidden_layers"]):
        _bert_layer(spec, f"{ENC}encoder.v_layer.{i}.", dv,
                    enc["v_intermediate_size"])
    for i in range(len(enc["v_biattention_id"])):
        c = f"{ENC}encoder.c_layer.{i}."
        for n in ("query1", "key1", "value1"):
            _linear(spec, c + "biattention." + n, bi, dv)
        for n in ("query2", "key2", "value2"):
            _linear(spec, c + "biattention." + n, bi, d)
        _linear(spec, c + "biOutput.dense1", dv, bi)
        _ln(spec, c + "biOutput.LayerNorm1", dv)
        _linear(spec, c + "biOutput.q_dense1", dv, bi)
        _linear(spec, c + "biOutput.dense2", d, bi)
        _ln(spec, c + "biOutput.LayerNorm2", d)
        _linear(spec, c + "biOutput.q_dense2", d, bi)
        _linear(spec, c + "v_intermediate.dense", enc["v_intermediate_size"],
                dv)
        _linear(spec, c + "v_output.dense", dv, enc["v_intermediate_size"])
        _ln(spec, c + "v_output.LayerNorm", dv)
        _linear(spec, c + "t_intermediate.dense", enc["intermediate_size"], d)
        _linear(spec, c + "t_output.dense", d, enc["intermediate_size"])
        _ln(spec, c + "t_output.LayerNorm", d)
    _linear(spec, ENC + "t_pooler.dense", bi, d)
    _linear(spec, ENC + "v_pooler.dense", bi, dv)
    spec.append((CLS + "predictions.bias", (enc["vocab_size"],), "bias"))
    _linear(spec, CLS + "predictions.transform.dense", d, d)
    _ln(spec, CLS + "predictions.transform.LayerNorm", d)
    _linear(spec, CLS + "bi_seq_relationship", 2, bi)
    _linear(spec, CLS + "imagePredictions.transform.dense", dv, dv)
    _ln(spec, CLS + "imagePredictions.transform.LayerNorm", dv)
    _linear(spec, CLS + "imagePredictions.decoder", enc["v_target_size"], dv)
    if dec is not None:
        _linear(spec, "vlfusion.fc_l", d, d)
        _linear(spec, "vlfusion.fc_v", d, dv)
        for i in range(dec["num_hidden_layers"]):
            p = f"{DEC}bert.encoder.layer.{i}."
            _bert_layer(spec, p, dec["hidden_size"], dec["intermediate_size"])
            for n in ("query", "key", "value"):
                _linear(spec, f"{p}crossattention.self.{n}",
                        dec["hidden_size"], dec["hidden_size"])
            _linear(spec, f"{p}crossattention.output.dense",
                    dec["hidden_size"], dec["hidden_size"])
            _ln(spec, f"{p}crossattention.output.LayerNorm",
                dec["hidden_size"])
        spec.append((DEC + "lm_head.decoder.weight",
                     (dec["vocab_size"], dec["hidden_size"]), "lm"))
        spec.append((DEC + "lm_head.decoder.bias", (dec["vocab_size"],),
                     "bias"))
    return spec


def aliases(with_decoder: bool) -> Dict[str, str]:
    """Checkpoint names that are another name's tensor: the MLM head's
    projection is the word table, the decoder embeds with the encoder's
    embeddings, the LM head's bias is its projection's bias."""
    out = {CLS + "predictions.decoder.weight":
           ENC + "embeddings.word_embeddings.weight"}
    if with_decoder:
        for n in ("word_embeddings.weight", "position_embeddings.weight",
                  "token_type_embeddings.weight",
                  "token_type_embeddings_extension.weight",
                  "sep_embeddings.weight", "LayerNorm.weight",
                  "LayerNorm.bias"):
            out[DEC + "bert.embeddings." + n] = ENC + "embeddings." + n
        out[DEC + "lm_head.bias"] = DEC + "lm_head.decoder.bias"
    return out


# --------------------------------------------------------------------- #
# the forward
# --------------------------------------------------------------------- #

def _fp8(t):
    scale = t.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def additive(mask):
    """[B, L] {0, 1} -> [B, 1, 1, L], MASK_VALUE at masked slots."""
    return (1.0 - mask.float())[:, None, None, :] * MASK_VALUE


class Reference:
    """The forward passes of one model, in float32, from ``weights`` (every
    name of :func:`param_spec`, on one device).  ``enc``, ``dec``: the
    configuration's encoder and decoder groups (``dec`` None for the
    encoder-only model)."""

    def __init__(self, weights: Dict[str, torch.Tensor], enc: dict,
                 dec: Optional[dict] = None, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.w = {k: v.float() for k, v in weights.items()}
        self.enc, self.dec = enc, dec
        self.precision = precision

    # products ---------------------------------------------------------- #
    def mm(self, a, b):
        """a @ b in the reference's precision."""
        if self.precision == "fp8":
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)

    def lin(self, x, name, bias=True):
        y = self.mm(x, self.w[name + ".weight"].t())
        return y + self.w[name + ".bias"] if bias else y

    def ln(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"],
                            self.w[name + ".bias"], eps)

    def attend(self, q, k, v, mask, heads):
        b, lq, d = q.shape
        dh = d // heads

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], heads, dh).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(dh) + mask
        ctx = self.mm(torch.softmax(scores, -1), v)
        return ctx.transpose(1, 2).reshape(b, lq, d)

    def bert_layer(self, x, mask, p, heads, eps):
        ctx = self.attend(self.lin(x, p + "attention.self.query"),
                          self.lin(x, p + "attention.self.key"),
                          self.lin(x, p + "attention.self.value"), mask, heads)
        x = self.ln(self.lin(ctx, p + "attention.output.dense") + x,
                    p + "attention.output.LayerNorm", eps)
        return self.ffn(x, p + "intermediate.dense", p + "output", eps)

    def ffn(self, x, inner, out, eps):
        h = F.gelu(self.lin(x, inner))
        return self.ln(self.lin(h, out + ".dense") + x, out + ".LayerNorm",
                       eps)

    # encoder ----------------------------------------------------------- #
    def embed(self, ids, segments, positions=None):
        """Word + position + segment embeddings (segments past
        ``type_vocab_size`` index the extension table) under LayerNorm."""
        e, w = self.enc, self.w
        p = ENC + "embeddings."
        if positions is None:
            positions = torch.arange(ids.shape[1], device=ids.device)[None]
        tv = e["type_vocab_size"]
        seg = torch.where(
            (segments >= tv)[..., None],
            w[p + "token_type_embeddings_extension.weight"][
                (segments - tv).clamp(min=0)],
            w[p + "token_type_embeddings.weight"][segments.clamp(max=tv - 1)])
        x = (w[p + "word_embeddings.weight"][ids]
             + w[p + "position_embeddings.weight"][positions] + seg)
        return self.ln(x, p + "LayerNorm", e["layer_norm_eps"])

    def encode(self, ids, segments, att_mask, feat, loc, image_mask):
        """-> (hidden_t [B, L, d], hidden_v [B, R, dv]) of the two-stream
        encoder, in the published order of text, visual and co-attention
        layers."""
        e = self.enc
        eps = e["layer_norm_eps"]
        t = self.embed(ids, segments)
        v = ENC + "v_embeddings."
        x_v = self.ln(self.lin(feat.float(), v + "image_embeddings")
                      + self.lin(loc.float(), v + "image_location_embeddings"),
                      v + "LayerNorm", eps)
        t_mask, v_mask = additive(att_mask), additive(image_mask)
        v_start = t_start = 0
        for count, (v_end, t_end) in enumerate(zip(e["v_biattention_id"],
                                                   e["t_biattention_id"])):
            for i in range(v_start, v_end):
                x_v = self.bert_layer(x_v, v_mask,
                                      f"{ENC}encoder.v_layer.{i}.",
                                      e["v_num_attention_heads"], eps)
            for i in range(t_start, t_end):
                t = self.bert_layer(t, t_mask, f"{ENC}encoder.layer.{i}.",
                                    e["num_attention_heads"], eps)
            x_v, t = self.co_layer(x_v, v_mask, t, t_mask,
                                   f"{ENC}encoder.c_layer.{count}.")
            v_start, t_start = v_end, t_end
        for i in range(v_start, e["v_num_hidden_layers"]):
            x_v = self.bert_layer(x_v, v_mask, f"{ENC}encoder.v_layer.{i}.",
                                  e["v_num_attention_heads"], eps)
        for i in range(t_start, e["num_hidden_layers"]):
            t = self.bert_layer(t, t_mask, f"{ENC}encoder.layer.{i}.",
                                e["num_attention_heads"], eps)
        return t, x_v

    def co_layer(self, x_v, v_mask, x_t, t_mask, p):
        """The co-attention connection layer: text queries over the visual
        keys and values and the reverse, each projected back onto its
        stream with a residual LayerNorm, then each stream's FFN."""
        e = self.enc
        eps, h = e["layer_norm_eps"], e["bi_num_attention_heads"]
        b = p + "biattention."
        ctx_t = self.attend(self.lin(x_t, b + "query2"),
                            self.lin(x_v, b + "key1"),
                            self.lin(x_v, b + "value1"), v_mask, h)
        ctx_v = self.attend(self.lin(x_v, b + "query1"),
                            self.lin(x_t, b + "key2"),
                            self.lin(x_t, b + "value2"), t_mask, h)
        o = p + "biOutput."
        v_state = self.ln(self.lin(ctx_v, o + "dense1") + x_v,
                          o + "LayerNorm1", eps)
        t_state = self.ln(self.lin(ctx_t, o + "dense2") + x_t,
                          o + "LayerNorm2", eps)
        return (self.ffn(v_state, p + "v_intermediate.dense", p + "v_output",
                         eps),
                self.ffn(t_state, p + "t_intermediate.dense", p + "t_output",
                         eps))

    def nsp_logits(self, ids, segments, att_mask, feat, loc, image_mask):
        """[B, 2] next-sentence logits from the fused (multiplied) pooled
        streams."""
        t, v = self.encode(ids, segments, att_mask, feat, loc, image_mask)
        pooled_t = torch.relu(self.lin(t[:, 0], ENC + "t_pooler.dense"))
        pooled_v = torch.relu(self.lin(v[:, 0], ENC + "v_pooler.dense"))
        if self.enc["fusion_method"] == "mul":
            pooled = pooled_t * pooled_v
        elif self.enc["fusion_method"] == "sum":
            pooled = pooled_t + pooled_v
        else:
            raise ValueError(self.enc["fusion_method"])
        return self.lin(pooled, CLS + "bi_seq_relationship")

    # decoder ----------------------------------------------------------- #
    def memory(self, ids, segments, att_mask, feat, loc, image_mask):
        """The decoder's memory [visual; text] projected to the text width,
        and its [B, R + L] mask."""
        t, v = self.encode(ids, segments, att_mask, feat, loc, image_mask)
        mem = torch.cat([self.lin(v, "vlfusion.fc_v"),
                         self.lin(t, "vlfusion.fc_l")], 1)
        return mem, torch.cat([image_mask.float(), att_mask.float()], 1)

    def decode_logits(self, dec_ids, dec_mask, mem, mem_mask):
        """Teacher-forced [B, T, vocab] logits of the causal decoder over
        the whole sequence (no cache), the decoder embedding its tokens
        with the encoder's embeddings at segment 0."""
        d = self.dec
        eps, h = d["layer_norm_eps"], d["num_attention_heads"]
        x = self.embed(dec_ids, torch.zeros_like(dec_ids))
        t = dec_ids.shape[1]
        causal = torch.tril(torch.ones(t, t, device=dec_ids.device))
        self_mask = ((1.0 - causal[None] * dec_mask.float()[:, None, :])
                     * MASK_VALUE)[:, None]
        m_add = additive(mem_mask)
        for i in range(d["num_hidden_layers"]):
            p = f"{DEC}bert.encoder.layer.{i}."
            ctx = self.attend(self.lin(x, p + "attention.self.query"),
                              self.lin(x, p + "attention.self.key"),
                              self.lin(x, p + "attention.self.value"),
                              self_mask, h)
            x = self.ln(self.lin(ctx, p + "attention.output.dense") + x,
                        p + "attention.output.LayerNorm", eps)
            c = p + "crossattention."
            ctx = self.attend(self.lin(x, c + "self.query"),
                              self.lin(mem, c + "self.key"),
                              self.lin(mem, c + "self.value"), m_add, h)
            x = self.ln(self.lin(ctx, c + "output.dense") + x,
                        c + "output.LayerNorm", eps)
            x = self.ffn(x, p + "intermediate.dense", p + "output", eps)
        return self.lin(x, DEC + "lm_head.decoder")
