"""Model configuration for the port: a copy of the encoder and decoder
dataclasses and the special token ids of ``gstx/core/config.py`` (lines
24-144), kept here so the port imports nothing of the JAX package.

Field semantics match the reference model-config JSONs
(``config/bert_base_6layer_6conect_{enc,dec}.json``); those files stay
loadable through :meth:`EncoderConfig.from_json` /
:meth:`DecoderConfig.from_json`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple


def _load_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


@dataclass(frozen=True)
class EncoderConfig:
    """Two-stream ViLBERT encoder configuration."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.3
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    type_vocab_extension: int = 10  # extra segment table
    sep_vocab_size: int = 50  # sep_embeddings table (checkpoint-present)
    initializer_range: float = 0.02

    # visual stream
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 1024
    v_num_hidden_layers: int = 6
    v_num_attention_heads: int = 8
    v_intermediate_size: int = 1024
    v_attention_probs_dropout_prob: float = 0.1
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.3
    v_initializer_range: float = 0.02
    v_loc_size: int = 5  # normalized box + area

    # co-attention
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 8
    bi_intermediate_size: int = 1024
    v_biattention_id: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Tuple[int, ...] = (6, 7, 8, 9, 10, 11)
    with_coattention: bool = True
    fixed_t_layer: int = 0
    fixed_v_layer: int = 0

    # heads
    fusion_method: str = "mul"
    predict_feature: bool = False

    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def v_head_dim(self) -> int:
        return self.v_hidden_size // self.v_num_attention_heads

    @property
    def bi_head_dim(self) -> int:
        return self.bi_hidden_size // self.bi_num_attention_heads

    @classmethod
    def from_json(cls, path: str) -> "EncoderConfig":
        raw = _load_json(path)
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in names}
        for key in ("v_biattention_id", "t_biattention_id"):
            if key in kwargs:
                kwargs[key] = tuple(kwargs[key])
        return cls(**kwargs)


@dataclass(frozen=True)
class DecoderConfig:
    """Causal decoder with cross-attention (BertGeneration-style)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.3
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    add_cross_attention: bool = True
    is_decoder: bool = True
    layer_norm_eps: float = 1e-12
    bos_token_id: int = 101
    eos_token_id: int = 102
    pad_token_id: int = 0
    decoder_start_token_id: int = 101

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json(cls, path: str) -> "DecoderConfig":
        raw = _load_json(path)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})


# Token ids of bert-base-uncased specials, fixed by the WordPiece vocab.
PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
MASK_ID = 103
SPECIAL_TOKEN_IDS = (PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID)
