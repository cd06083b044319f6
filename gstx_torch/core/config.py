"""Configuration for the port: a copy of ``gstx/core/config.py`` (the
encoder and decoder dataclasses, the special token ids, the run
configuration ``GSTConfig`` and its ``-flag`` parser, lines 24-357), kept
here so the port imports nothing of the JAX package.

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


@dataclass(frozen=True)
class GSTConfig:
    """Full run configuration: every flag of the reference ``options.py``
    (reference ``options.py:7-106``) plus the JAX package's own knobs, so
    every flag of its CLIs parses here.  Some of those knobs have no
    effect in the port (``data_axis``, ``model_axis``: meshes are not
    ported yet); ``use_pallas`` switches the port's fused FFN / LayerNorm
    CUDA kernels (``gstx_torch.kernels.ffn.enable``)."""

    # --- data input (VisDial), options.py:12-41 ---
    visdial_processed_train: str = "data/visdial/visdial_1.0_train_processed.json"
    visdial_processed_val: str = "data/visdial/visdial_1.0_val_processed.json"
    visdial_processed_test: str = "data/visdial/visdial_1.0_test_processed.json"
    visdial_processed_train_09: str = "data/visdial/visdial_0.9_train_processed.json"
    visdial_processed_val_09: str = "data/visdial/visdial_0.9_val_processed.json"
    visdial_image_feats: str = "data/visdial/visdial_img_feat.store"
    visdial_processed_train_dense: str = "data/visdial/visdial_1.0_train_dense_processed.json"
    train_dense: bool = False
    visdial_processed_val_dense_annotations: str = (
        "data/visdial/visdial_1.0_val_dense_annotations_processed.json"
    )
    visdial_processed_val_coref_dependency: str = (
        "data/visdial/visdial_1.0_val_coref_dependency.json"
    )
    cos_sim_counter_fitting: str = "data/visdial/cos_sim_counter_fitting.npy"
    cos_sim_idx2word: str = "data/visdial/cos_sim_idx2word.pickle"
    cos_sim_word2idx: str = "data/visdial/cos_sim_word2idx.pickle"
    # independent attacker MLM for the random_token attack (the reference's
    # BertForMaskedLM('bert-base-uncased'), text_attack.py:19-27); empty ->
    # fall back to the dialog model's own MLM head
    mlm_path: str = ""
    start_path: str = ""
    start_path_q: str = ""
    start_path_a: str = ""
    model_enc_config: str = ""
    model_dec_config: str = ""
    vocab_path: str = "data/vocab/bert-base-uncased-vocab.txt"

    # --- data input (CC12M), options.py:44-50 ---
    cc12m_processed_train: str = "data/cc12m/dialogs/"
    cc12m_image_feats: str = "data/cc12m/features/"
    cc12m_caption: str = ""
    url_to_cap: str = "data/url_to_cap.json"  # generate.py:87
    image_id_to_url: str = "data/image_id_to_url.json"  # generate.py:88
    chunk: str = ""
    threshold: int = 50  # ppl data-selection threshold, options.py:50

    # --- training / mode, options.py:54-92 ---
    vd_version: str = "1.0"  # {'1.0', '0.9'}
    mode: str = "vd_train"  # {vd_train, vd_eval_val, vd_eval_test, vd_gen_val, cc12m_gen, cc12m_train}
    model: str = "enc_dec_a"  # {enc_only_a, enc_dec_a, enc_dec_q}
    iter: int = 1
    num_workers: int = 8
    batch_size: int = 72
    num_epochs: int = 100
    batch_multiply: int = 1
    save_every_steps: int = 0  # training: rotating step checkpoint
    select_data: bool = False
    lr: float = 2e-5
    image_lr: float = 2e-5
    min_lr: float = 1e-5
    overfit: bool = False
    continue_training: bool = False  # '-continue'
    num_train_samples: int = 0
    num_val_samples: int = 0
    num_options: int = 100
    sequences_per_image: int = 1
    visdial_tot_rounds: int = 11
    max_seq_len: int = 256
    max_utt_len: int = 25
    num_negative_samples: int = 1
    lm_loss_coeff: float = 1.0
    nsp_loss_coeff: float = 1.0
    img_loss_coeff: float = 1.0
    mask_prob: float = 0.15
    attack: str = "fgsm"  # {fgsm, random_token, coreference}
    save_path: str = "checkpoints/"
    save_name: str = ""

    # --- decode defaults (generate.py:138-141,177-180; visual_dialog_model.py:77) ---
    max_dec_len: int = 18
    temperature: float = 0.7
    top_k: int = 7
    top_p: float = 0.0
    ngram_blocking_size: int = 4
    num_dialog_rounds: int = 10
    max_regions: int = 37
    quantize_memory: bool = False  # int8 cross-attention decode memory
    # (bf16 engines only)
    dynamic_buckets: bool = False  # pick context buckets from the batch's
    # actual lengths each round (one host sync a round) instead of the
    # worst-case schedule
    context_buckets: str = ""  # e.g. "128,192": smaller context widths for
    # early dialog rounds (exact math, lower encoder cost)

    # --- numerics, devices, runtime ---
    dtype: str = "bfloat16"  # activation dtype; float32 for parity
    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1 = all devices
    model_parallel: int = 1
    warmup_steps: int = 1500  # train_gen.py:180 (disc uses 10000, train_disc.py:146)
    distributed: bool = False  # multi-host run
    remat: bool = True  # training: per-layer recomputation
    remat_policy: str = "small"  # training: what recomputation saves
    seed: int = 0
    log_every: int = 10
    use_pallas: bool = True  # fused FFN / projection-LayerNorm kernels
    # (bf16, widths the kernels take); the flag keeps the JAX package's name
    trace_dir: str = ""  # write a device trace and the spans of the
    # generation, training or evaluation loop here
    pipeline: int = 2  # generate: batches dispatched before the oldest is
    # drained to the host
    flush_every: int = 20  # generate: append completed batches to a
    # <out>.partial.jsonl sidecar every N batches so a preempted run can
    # resume (the reference dumps JSON only at the end, generate.py:258);
    # 0 disables the sidecar
    resume_generation: bool = True  # generate: when a sidecar whose meta
    # matches this run exists, splice its completed batches and continue
    # from the first unfinished batch (per-batch sampling seeds, so a
    # resumed run reproduces the uninterrupted one)
    fused_sampler: bool = True  # decode: top-k extract + categorical over
    # the k candidates instead of the full-vocab filter-then-sample chain;
    # same distribution, different random stream, so part of the
    # generation sidecar identity
    host_prefetch: bool = True  # generate: prepare batch i+1 (pad, host
    # bf16 cast, pinned buffers) on a background thread while batch i runs

    def encoder_config(self) -> EncoderConfig:
        if self.model_enc_config:
            return EncoderConfig.from_json(self.model_enc_config)
        return EncoderConfig()

    def decoder_config(self) -> DecoderConfig:
        if self.model_dec_config:
            return DecoderConfig.from_json(self.model_dec_config)
        return DecoderConfig()

    def replace(self, **kw) -> "GSTConfig":
        return dataclasses.replace(self, **kw)

    def context_bucket_tuple(self):
        if not self.context_buckets:
            return ()
        return tuple(int(x) for x in self.context_buckets.split(",") if x)


def add_config_args(parser, cls=GSTConfig):
    """Expose every GSTConfig field as a '-flag' (single-dash, like the
    reference options.py) on an argparse parser.

    Boolean fields get a PAIR of switches: ``-X`` (sets True, the reference
    options.py:27-70 surface) and ``-no_X`` (sets False) — so default-True
    fields like ``remat``/``use_pallas`` are controllable from every CLI.
    ``-continue`` is an explicit alias for ``-continue_training``
    (reference options.py:70), not an argparse prefix accident.
    """
    for f in dataclasses.fields(cls):
        name = "-" + f.name
        is_bool = f.type in ("bool", bool) or isinstance(f.default, bool)
        if is_bool:
            parser.add_argument(name, dest=f.name, action="store_true")
            parser.add_argument("-no_" + f.name, dest=f.name,
                                action="store_false")
            parser.set_defaults(**{f.name: f.default})
        else:
            ftype = {"int": int, "float": float, "str": str}.get(str(f.type), str)
            if isinstance(f.default, int):
                parser.add_argument(name, type=int, default=f.default)
            elif isinstance(f.default, float):
                parser.add_argument(name, type=float, default=f.default)
            else:
                parser.add_argument(name, type=ftype, default=f.default)
    if any(f.name == "continue_training" for f in dataclasses.fields(cls)):
        parser.add_argument("-continue", dest="continue_training",
                            action="store_true")
    return parser


def config_from_args(args, cls=GSTConfig) -> GSTConfig:
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})
