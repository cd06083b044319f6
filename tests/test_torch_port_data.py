"""The port's data pipeline against the JAX package's, on the CPU: the
WordPiece tokenizer (native fast path on and off), the GSTF feature store
(written by one package, read by the other, native and Python readers),
the encoders, the loader's batch order, the generation datasets, and the
checkpoint loader.  Everything here is host code, so agreement is exact."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from fixtures import (WORDS, init_tiny_params, make_cc12m_caption_json,
                      make_cc12m_dialog_json, make_visdial_env,
                      tiny_enc_dec_configs, write_vocab_file)
from gstx.core.checkpoint import to_torch_state_dict
from gstx.core.config import GSTConfig as JConfig
from gstx.data import cc12m as jcc12m
from gstx.data import encode as jencode
from gstx.data import feature_store as jstore
from gstx.data import loader as jloader
from gstx.data import tokenizer as jtok
from gstx.data import visdial as jvisdial
from gstx_torch import native
from gstx_torch.core import config as tcfg
from gstx_torch.core.checkpoint import (load_checkpoint, read_state_dict,
                                        state_dict_from_jax)
from gstx_torch.data import cc12m as tcc12m
from gstx_torch.data import encode as tencode
from gstx_torch.data import feature_store as tstore
from gstx_torch.data import loader as tloader
from gstx_torch.data import tokenizer as ttok
from gstx_torch.data import visdial as tvisdial
from gstx_torch.models.encdec import GSTVisualDialog

# ---------------------------------------------------------------------- #
# tokenizer
# ---------------------------------------------------------------------- #

EXTRA_WORDS = ["cafe", "naive", "hello", "world", "中", "文", ",", ".", "!",
               "?", "'", "-", "text", "greek", "upper", "ασ", "tab", "and",
               "newline", "ctrl", "chars", "##ly", "##ed", "un", "##known"]

TEXTS = [
    "A man riding a horse on the beach.",
    "Café naïve RIDING horses",          # accents and case
    "中文 text 中",                        # CJK spacing
    "hello, world!! what?'s-that",       # punctuation
    "tab\tand\nnewline\r  spaces",       # whitespace
    "ctrl\x00\x07chars\x7f here",        # control characters are deleted
    "[CLS] a man [SEP] is [MASK] riding",  # special tokens are never split
    "ΑΣ upper greek",                    # per-char lowercasing
    "unknown wordz ridingly",            # wordpieces and [UNK]
    "x" * 150,                           # longer than a word may be
    "",
    "　full width  space",      # Unicode spaces
]


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    write_vocab_file(path)
    with open(path, "a") as f:
        f.write("\n".join(w for w in EXTRA_WORDS if w not in WORDS) + "\n")
    return path


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_tokenizer_matches_jax(vocab_path, use_native, text):
    want = jtok.BertTokenizer(vocab_path=vocab_path, use_native=False)
    got = ttok.BertTokenizer(vocab_path=vocab_path, use_native=use_native)
    assert (got._native is not None) == use_native  # g++ builds it here
    assert got.tokenize(text) == want.tokenize(text)
    ids = want.encode(text)
    assert got.encode(text) == ids
    for skip in (True, False):
        assert got.decode(ids + [101, 102, 0], skip_special_tokens=skip) \
            == want.decode(ids + [101, 102, 0], skip_special_tokens=skip)


def test_native_tokenizer_serves_ascii(vocab_path):
    tok = ttok.BertTokenizer(vocab_path=vocab_path)
    native.reset_served()
    tok.encode("a man riding a horse")
    assert native.served["wordpiece"]
    native.reset_served()
    tok.encode("Café")  # declined: non-ASCII goes to the Python path
    assert not native.served["wordpiece"]


def test_make_test_vocab_matches_jax():
    assert ttok.make_test_vocab(WORDS) == jtok.make_test_vocab(WORDS)


# ---------------------------------------------------------------------- #
# feature store
# ---------------------------------------------------------------------- #

IDS = [7, 3, 1000, 123456789012]


def _items(reader):
    return [reader[i] for i in IDS]


def _assert_items_equal(got, want):
    for g, w in zip(got, want):
        assert g[1] == w[1]
        for a, b in zip(g[:1] + g[2:], w[:1] + w[2:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_store_crosses_packages(tmp_path, writer, use_native):
    path = str(tmp_path / "s.store")
    make = jstore.make_synthetic_store if writer == "jax" \
        else tstore.make_synthetic_store
    make(path, IDS, num_boxes=9, feat_dim=24, num_classes=7, seed=3)
    want = jstore.FeatureStoreReader(path, use_native=False)
    got = tstore.FeatureStoreReader(path, use_native=use_native)
    assert isinstance(got, native.NativeFeatureStore) == use_native
    assert len(got) == len(want) and sorted(got.keys()) == sorted(IDS)
    assert 1000 in got and 5 not in got
    _assert_items_equal(_items(got), _items(want))
    with pytest.raises(KeyError):
        got[5]


def test_synthetic_stores_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "a.store"), str(tmp_path / "b.store")
    jstore.make_synthetic_store(a, IDS, num_boxes=5, feat_dim=8,
                                num_classes=3, seed=1)
    tstore.make_synthetic_store(b, IDS, num_boxes=5, feat_dim=8,
                                num_classes=3, seed=1)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_in_memory_reader_keeps_python_path(tmp_path):
    path = str(tmp_path / "s.store")
    tstore.make_synthetic_store(path, IDS, num_boxes=4, feat_dim=8,
                                num_classes=3)
    reader = tstore.FeatureStoreReader(path, in_memory=True)
    assert isinstance(reader, tstore.FeatureStoreReader)
    assert reader[7] is reader[7]  # cached


# ---------------------------------------------------------------------- #
# encoding
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_functions_match_jax(seed):
    rng = np.random.RandomState(seed)
    utts = [list(rng.randint(104, 250, size=rng.randint(1, 9)))
            for _ in range(rng.randint(1, 6))]
    for max_seq_len in (16, 64):
        got = tencode.encode_input(utts, seed % 2, max_seq_len=max_seq_len,
                                   mask_prob=0.3,
                                   rng=np.random.RandomState(seed))
        want = jencode.encode_input(utts, seed % 2, max_seq_len=max_seq_len,
                                    mask_prob=0.3,
                                    rng=np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    n = rng.randint(3, 12)
    args = (rng.rand(n, 8).astype(np.float32), n,
            rng.rand(n, 5).astype(np.float32),
            rng.rand(n, 4).astype(np.float32))
    for regions in (5, 13):
        got = tencode.encode_image_input(*args, max_regions=regions,
                                         rng=np.random.RandomState(seed))
        want = jencode.encode_image_input(*args, max_regions=regions,
                                          rng=np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    lengths = rng.randint(0, 9, size=5)
    np.testing.assert_array_equal(tencode.sequence_mask(lengths, 10),
                                  jencode.sequence_mask(lengths, 10))
    sep = np.sort(rng.randint(1, 30, size=(5, 6)), axis=1)
    hist = rng.randint(0, 6, size=5)
    np.testing.assert_array_equal(
        tencode.nsp_attention_mask(sep, hist, 32),
        jencode.nsp_attention_mask(sep, hist, 32))
    np.testing.assert_array_equal(tencode.list2arraypad(utts[0], 4),
                                  jencode.list2arraypad(utts[0], 4))


# ---------------------------------------------------------------------- #
# loader
# ---------------------------------------------------------------------- #


class _Items:
    """Items carry their index and the seed the loader gave them."""

    def __len__(self):
        return 23

    def __getitem__(self, index, seed=None):
        return {"i": np.asarray([index]), "seed": np.asarray([seed])}


LOADER_CASES = [
    dict(shuffle=False, drop_last=False),
    dict(shuffle=True, seed=5, drop_last=True),
    dict(shuffle=True, seed=5, drop_last=False, start_batch=2),
    dict(shuffle=True, seed=1, process_index=0, process_count=2),
    dict(shuffle=True, seed=1, process_index=1, process_count=2),
    dict(shuffle=True, seed=1, process_index=1, process_count=2,
         even_stripes=True, drop_last=False),
]


@pytest.mark.parametrize("case", LOADER_CASES, ids=range(len(LOADER_CASES)))
@pytest.mark.parametrize("workers", [1, 3])
def test_loader_batches_match_jax(case, workers):
    kw = {k: v for k, v in case.items() if k != "start_batch"}
    start = case.get("start_batch", 0)

    def run(mod):
        ld = mod.DataLoader(_Items(), batch_size=4, num_workers=workers, **kw)
        return len(ld), [mod_batch for epoch in (0, 1)
                         for mod_batch in ld.epoch(epoch, start_batch=start)]
    (n_t, got), (n_j, want) = run(tloader), run(jloader)
    assert n_t == n_j and len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------- #
# generation datasets
# ---------------------------------------------------------------------- #


def _port_config(jcfg: JConfig) -> tcfg.GSTConfig:
    return tcfg.GSTConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def data_env(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("data"))
    jcfg = make_visdial_env(tmp, num_dialogs=4)
    vocab = write_vocab_file(os.path.join(tmp, "vocab.txt"))
    caps = os.path.join(tmp, "caps.json")
    make_cc12m_caption_json(caps, num_images=4)
    store = os.path.join(tmp, "cc.store")
    jstore.make_synthetic_store(store, [2000 + i for i in range(4)],
                                num_boxes=12, feat_dim=16, num_classes=11)
    dialogs = os.path.join(tmp, "dialogs.json")
    make_cc12m_dialog_json(dialogs, num_images=4)
    jcfg = jcfg.replace(vocab_path=vocab, cc12m_caption=caps,
                        cc12m_image_feats=store,
                        cc12m_processed_train=dialogs, select_data=True)
    return jcfg, _port_config(jcfg)


def _assert_item_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("index", [0, 3])
def test_visdial_gen_val_items_match_jax(data_env, index):
    jcfg, tcfg_ = data_env
    want = jvisdial.VisdialGenDataset(
        jcfg, jtok.BertTokenizer(vocab_path=jcfg.vocab_path),
        mode="vd_gen_val")
    got = tvisdial.VisdialGenDataset(
        tcfg_, ttok.BertTokenizer(vocab_path=tcfg_.vocab_path),
        mode="vd_gen_val")
    assert len(got) == len(want) == 4
    _assert_item_equal(got.__getitem__(index, seed=11),
                       want.__getitem__(index, seed=11))


@pytest.mark.parametrize("mode", ["cc12m_gen", "cc12m_train"])
def test_cc12m_items_match_jax(data_env, mode):
    jcfg, tcfg_ = data_env
    want = jcc12m.CC12mDataset(
        jcfg, jtok.BertTokenizer(vocab_path=jcfg.vocab_path), mode=mode)
    got = tcc12m.CC12mDataset(
        tcfg_, ttok.BertTokenizer(vocab_path=tcfg_.vocab_path), mode=mode)
    assert len(got) == len(want) == 4
    for index in range(4):
        _assert_item_equal(got.__getitem__(index, seed=index + 7),
                           want.__getitem__(index, seed=index + 7))


@pytest.mark.parametrize("mode", ["vd_train", "vd_eval_val",
                                  "vd_eval_test"])
def test_other_visdial_modes_name_their_roadmap_item(data_env, mode):
    """Every mode of both datasets serves: the vd_train modes, once
    refused naming ROADMAP queue 1 item 5, since generative and
    discriminative training, and the evaluation modes since evaluation
    (their items: tests/test_torch_port_train.py,
    tests/test_torch_port_disc.py, tests/test_torch_port_eval.py)."""
    _, tcfg_ = data_env
    tok = ttok.BertTokenizer(vocab_path=tcfg_.vocab_path)
    assert len(tvisdial.VisdialGenDataset(tcfg_, tok, mode=mode)) == 4
    assert len(tvisdial.VisdialDiscDataset(tcfg_, tok, mode=mode)) == 4


def test_prune_rounds_matches_jax():
    ctx = [[i] for i in range(9)]
    for n in (2, 4, 10):
        assert tvisdial.prune_rounds(ctx, n) == jvisdial.prune_rounds(ctx, n)


# ---------------------------------------------------------------------- #
# checkpoints
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def ckpt_env(tmp_path_factory):
    enc, dec = tiny_enc_dec_configs()
    np_params = jax.device_get(init_tiny_params(enc, dec))
    ref = {k: torch.from_numpy(np.array(v))
           for k, v in to_torch_state_dict(np_params).items()}
    cfgs = (tcfg.EncoderConfig(**dataclasses.asdict(enc)),
            tcfg.DecoderConfig(**dataclasses.asdict(dec)))
    return (str(tmp_path_factory.mktemp("ckpt")), ref,
            state_dict_from_jax(np_params), cfgs)


def _assert_sd_equal(model, want, prefix=""):
    got = model.state_dict()
    for k, v in want.items():
        if k.startswith(prefix):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_reference_ckpt_with_module_prefix_loads_strictly(ckpt_env):
    tmp, ref, bridge, cfgs = ckpt_env
    path = os.path.join(tmp, "ref.ckpt")
    torch.save({"model_state_dict": {"module." + k: v
                                     for k, v in ref.items()},
                "epoch": 3}, path)
    model = GSTVisualDialog(*cfgs, device="cpu", seed=9)
    assert load_checkpoint(model, path) == "full"
    assert model.state_dict().keys() == bridge.keys()
    _assert_sd_equal(model, bridge)


def test_port_state_dict_save_loads(ckpt_env):
    tmp, _, bridge, cfgs = ckpt_env
    path = os.path.join(tmp, "port.pt")
    src = GSTVisualDialog(*cfgs, device="cpu")
    src.load_state_dict(bridge, strict=True)
    torch.save(src.state_dict(), path)
    model = GSTVisualDialog(*cfgs, device="cpu", seed=4)
    assert load_checkpoint(model, path) == "full"
    _assert_sd_equal(model, bridge)


@pytest.mark.parametrize("flavour", ["bert_pretrained.", ""])
def test_encoder_only_ckpt_loads_and_seeds_lm_head(ckpt_env, flavour):
    """An encoder-only checkpoint (``bert_pretrained.*``, or bare
    ``bert.*``/``cls.*``) is strict over the encoder's names and seeds the
    decoder's LM projection from the word embeddings, as the JAX CLI's
    load_params does."""
    tmp, ref, bridge, cfgs = ckpt_env
    enc = {flavour + k[len("encoder.bert_pretrained."):]: v
           for k, v in ref.items() if k.startswith("encoder.")}
    path = os.path.join(tmp, f"enc{len(flavour)}.ckpt")
    torch.save({"model_state_dict": enc}, path)
    model = GSTVisualDialog(*cfgs, device="cpu", seed=9)
    assert load_checkpoint(model, path) == "encoder"
    _assert_sd_equal(model, bridge, prefix="encoder.")
    word = bridge["encoder.bert_pretrained.bert.embeddings."
                  "word_embeddings.weight"]
    torch.testing.assert_close(model.dec.lm_head.decoder.weight, word,
                               rtol=0, atol=0)
    # a missing encoder name is refused
    del enc[next(iter(enc))]
    torch.save({"model_state_dict": enc}, path)
    with pytest.raises(RuntimeError, match="missing encoder names"):
        load_checkpoint(GSTVisualDialog(*cfgs, device="cpu"), path)


def test_orbax_directory_is_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        read_state_dict(str(tmp_path))
