"""The port's preprocessing (gstx_torch.preprocessing) against the JAX
package's (gstx.preprocessing), on the inputs of tests/test_preprocessing.py
and tests/test_reference_preprocessing_parity.py (the same raw VisDial
generator and seeds, v1.0 and v0.9): equal JSON from the filters and the
CLI; byte-equal GSTF stores from a TSV, which both packages' readers read
alike; equal cosine matrices and vocab pickles; the Gaussian in-domain
scorer within NUM_TOL; CLIP feature extraction through one fake ``clip``
module."""

import base64
import json
import os
import pickle
import types

import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from fixtures import (WORDS, make_tokenizer, make_visdial_json,
                      write_vocab_file)
from gstx.data.feature_store import FeatureStoreReader as JReader
from gstx.preprocessing import clip_filtering as jclip
from gstx.preprocessing import comp_cos_sim_mat as jcos
from gstx.preprocessing import convert_to_store as jstore
from gstx.preprocessing import preprocess_visdial as jprep
from gstx_torch.data.feature_store import FeatureStoreReader as TReader
from gstx_torch.data.tokenizer import BertTokenizer, make_test_vocab
from gstx_torch.preprocessing import clip_filtering as tclip
from gstx_torch.preprocessing import comp_cos_sim_mat as tcos
from gstx_torch.preprocessing import convert_to_store as tstore
from gstx_torch.preprocessing import preprocess_visdial as tprep

NUM_TOL = 1e-6  # float64 on the host, the same numpy calls


def _copy(obj):
    return json.loads(json.dumps(obj))


def _port_tokenizer():
    return BertTokenizer(vocab=make_test_vocab(WORDS))


# ---------------------------------------------------------------------- #
# VisDial filtering
# ---------------------------------------------------------------------- #


def _dense(data, rng=None):
    return [{"image_id": d["image_id"],
             "round_id": 1 if rng is None else int(rng.randint(1, 11)),
             "gt_relevance": [0.0] * 100} for d in data["data"]["dialogs"]]


# (function, fixture kwargs, max_seq_len): tests/test_preprocessing.py's
# calls (its fixture's train dialogs are 98 tokens long by the reference's
# formula: 98 keeps them, 97 drops them), plus the train-dense filter on
# its train fixture
FILTERS = [("filter_train", {"num_dialogs": 6}, 10),
           ("filter_train", {"num_dialogs": 6}, 100000),
           ("filter_train", {"num_dialogs": 3}, 98),
           ("filter_train", {"num_dialogs": 3}, 97),
           ("filter_train_dense", {"num_dialogs": 6}, 120),
           ("filter_val", {"num_dialogs": 4}, 60),
           ("truncate_test", {"num_dialogs": 4, "test_mode": True}, 40)]


@pytest.mark.parametrize("name,kw,limit", FILTERS,
                         ids=[f"{n}-{m}" for n, _, m in FILTERS])
def test_filters_match_jax(tmp_path, name, kw, limit):
    data = make_visdial_json(str(tmp_path / "d.json"), **kw)
    args = {"filter_train": lambda d: (d,),
            "filter_train_dense": lambda d: (
                d, _dense(d, np.random.RandomState(3))),
            "filter_val": lambda d: (d, _dense(d)),
            "truncate_test": lambda d: (d,)}[name]
    want_in, got_in = args(_copy(data)), args(_copy(data))
    want = getattr(jprep, name)(*want_in, make_tokenizer(), limit)
    got = getattr(tprep, name)(*got_in, _port_tokenizer(), limit)
    assert got == want
    assert got_in == want_in  # the in-place edits
    if name == "filter_train":
        assert want == (0 if limit >= 98 else kw["num_dialogs"])


def _make_raw_visdial(path, rng, n_dialogs, n_q=25, n_a=30, long_every=3):
    """tests/test_reference_preprocessing_parity.py's raw VisDial 1.0
    fixture, verbatim: every ``long_every``-th dialog gets an oversized
    caption so the filters and the truncation fire at max_seq_len 64."""
    sample = lambda k: " ".join(WORDS[i] for i in rng.randint(0, 36, size=k))
    questions = [sample(3) for _ in range(n_q)]
    answers = [sample(2) for _ in range(n_a)]
    dialogs = []
    for d in range(n_dialogs):
        cap_len = 40 if d % long_every == 2 else 5
        rounds = []
        for r in range(10):
            options = [int(o) for o in rng.randint(0, n_a, size=100)]
            gt = int(rng.randint(0, 100))
            rounds.append({
                "question": int(rng.randint(0, n_q)),
                "answer": options[gt],
                "answer_options": options,
                "gt_index": gt,
            })
        dialogs.append({"image_id": 5000 + d, "caption": sample(cap_len),
                        "dialog": rounds})
    data = {"data": {"dialogs": dialogs, "questions": questions,
                     "answers": answers}, "split": "raw", "version": "1.0"}
    with open(path, "w") as f:
        json.dump(data, f)


def _make_raw_dense(path, rng, n_dialogs):
    dense = [{"image_id": 5000 + d, "round_id": int(rng.randint(1, 11)),
              "gt_relevance": [float(x) for x in rng.rand(100)]}
             for d in range(n_dialogs)]
    with open(path, "w") as f:
        json.dump(dense, f)


@pytest.mark.parametrize("version", ["1.0", "0.9"])
def test_cli_outputs_equal_jax(tmp_path, version):
    """The reference-parity inputs (seed 17 for v1.0 with dense and test
    files, 29 for v0.9's train and val) through both packages' main: every
    output file equal, the train-dense ones included."""
    d = str(tmp_path)
    vocab = write_vocab_file(os.path.join(d, "vocab.txt"))
    rng = np.random.RandomState(17 if version == "1.0" else 29)
    argv = ["-vocab_path", vocab, "-max_seq_len", "64"]
    for split in ("train", "val") + (("test",) if version == "1.0" else ()):
        path = os.path.join(d, f"raw_{split}.json")
        _make_raw_visdial(path, rng, 9)
        argv += [f"-visdial_{split}", path]
    if version == "1.0":
        for split in ("train", "val"):
            path = os.path.join(d, f"raw_{split}_dense.json")
            _make_raw_dense(path, rng, 9)
            argv += [f"-visdial_{split}_ndcg", path]
    jprep.main(argv + ["-save_prefix", os.path.join(d, "jax")])
    tprep.main(argv + ["-save_prefix", os.path.join(d, "port")])
    outputs = sorted(f[len("jax"):] for f in os.listdir(d)
                     if f.startswith("jax"))
    assert len(outputs) == (6 if version == "1.0" else 2)
    for suffix in outputs:
        with open(os.path.join(d, "jax" + suffix)) as f:
            want = json.load(f)
        with open(os.path.join(d, "port" + suffix)) as f:
            got = json.load(f)
        assert got == want, suffix
    with open(os.path.join(d, "port_val_processed.json")) as f:
        assert len(json.load(f)["data"]["dialogs"]) < 9  # a filter fired


# ---------------------------------------------------------------------- #
# TSV -> GSTF store
# ---------------------------------------------------------------------- #


def test_tsv_store_round_trip_matches_jax(tmp_path):
    """tests/test_preprocessing.py's TSV rows (two files here): the two
    packages write byte-equal stores, and each package's reader reads each
    store alike."""
    rng = np.random.RandomState(0)
    n, fd, nc = 4, 8, 5
    tsvs = []
    for part, images in enumerate(((11, 22), (33,))):
        rows = []
        for img in images:
            feats = rng.rand(n, fd).astype(np.float32)
            boxes = (rng.rand(n, 4) * 100).astype(np.float32)
            cls = rng.rand(n, nc).astype(np.float32)
            rows.append("\t".join([
                str(img), "640", "480", str(n),
                base64.b64encode(boxes.tobytes()).decode(),
                base64.b64encode(feats.tobytes()).decode(),
                base64.b64encode(cls.tobytes()).decode()]))
        tsvs.append(str(tmp_path / f"f{part}.tsv"))
        with open(tsvs[-1], "w") as f:
            f.write("\n".join(rows))
    stores = {pkg: str(tmp_path / f"{pkg}.store") for pkg in ("jax", "port")}
    assert jstore.convert_tsv(tsvs, stores["jax"], fd, nc) == 3
    tstore.main(["-tsv"] + tsvs + ["-out", stores["port"], "-feat_dim",
                                   str(fd), "-num_classes", str(nc)])
    with open(stores["jax"], "rb") as a, open(stores["port"], "rb") as b:
        assert a.read() == b.read()
    want = JReader(stores["jax"])
    for reader in (TReader(stores["port"]), TReader(stores["jax"]),
                   JReader(stores["port"])):
        assert sorted(reader.keys()) == [11, 22, 33]
        for img in (11, 22, 33):
            for g, w in zip(reader[img], want[img]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------- #
# cosine-similarity matrix
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("lines", [
    ["cat 1.0 0.0", "dog 0.9 0.1", "car 0.0 1.0"],
    ["cat 1.0 0.0", "cat 0.5 0.5", "dog 0.9 0.1", "car 0.0 1.0"],
    [f"w{i} " + " ".join(f"{x:.4f}" for x in np.random.RandomState(i).randn(
        6)) for i in range(20)]], ids=["words", "duplicate", "random"])
def test_cos_sim_matches_jax(tmp_path, lines):
    emb = str(tmp_path / "emb.txt")
    with open(emb, "w") as f:
        f.write("\n".join(lines))
    want = jcos.build(emb, str(tmp_path / "jax"))
    tcos.main([emb, "-out_dir", str(tmp_path / "port")])
    got = tcos.build(emb, str(tmp_path / "port"))
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for name in ("cos_sim_counter_fitting.npy", "cos_sim_idx2word.pickle",
                 "cos_sim_word2idx.pickle"):
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            if name.endswith(".npy"):
                np.testing.assert_array_equal(np.load(b), np.load(a))
            else:
                assert pickle.load(b) == pickle.load(a)


# ---------------------------------------------------------------------- #
# CLIP in-domain filtering
# ---------------------------------------------------------------------- #


def _features(seed=0):
    rng = np.random.RandomState(seed)
    in_domain = rng.randn(500, 4) * 0.5 + 1.0
    cand = np.concatenate([rng.randn(10, 4) * 0.5 + 1.0,
                           rng.randn(10, 4) * 0.5 + 10.0])
    return in_domain, cand


def test_gaussian_scorer_matches_jax(tmp_path):
    in_domain, cand = _features()
    for got, want in zip(tclip.cov_mean(in_domain), jclip.cov_mean(in_domain)):
        np.testing.assert_allclose(got, want, rtol=NUM_TOL, atol=NUM_TOL)
    t, j = tclip.GaussianOOD(in_domain), jclip.GaussianOOD(in_domain)
    np.testing.assert_allclose(t.log_prob(cand), j.log_prob(cand),
                               rtol=NUM_TOL, atol=NUM_TOL)
    assert t.log_prob(cand[:10]).mean() > t.log_prob(cand[10:]).mean()
    np.save(tmp_path / "in.npy", in_domain)
    np.save(tmp_path / "cand.npy", cand)
    with open(tmp_path / "ids.json", "w") as f:
        json.dump(list(range(100, 120)), f)
    np.save(tmp_path / "ids.npy", np.arange(100, 120))
    for ids in ("ids.json", "ids.npy"):
        argv = ["-in_domain_feats", str(tmp_path / "in.npy"),
                "-candidate_feats", str(tmp_path / "cand.npy"),
                "-candidate_ids", str(tmp_path / ids)]
        jclip.main(argv + ["-out", str(tmp_path / "jax.json")])
        tclip.main(argv + ["-out", str(tmp_path / "port.json")])
        with open(tmp_path / "jax.json") as a, \
                open(tmp_path / "port.json") as b:
            want, got = json.load(a), json.load(b)
        assert [g["image_id"] for g in got] == [w["image_id"] for w in want]
        np.testing.assert_allclose([g["log_prob"] for g in got],
                                   [w["log_prob"] for w in want],
                                   rtol=NUM_TOL, atol=NUM_TOL)
    direct = tclip.score_images(in_domain, cand, range(100, 120))
    assert direct == got


def _fake_clip():
    """tests/test_preprocessing.py's stub ``clip`` module: a visual tower
    with fp16 weights whose output pools each image; records the device
    asked for and the dtype of each batch."""
    seen = {"dtypes": [], "devices": []}

    class StubVisual(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = torch.nn.Conv2d(3, 4, 1)
            self.conv1.weight.data = self.conv1.weight.data.half()

        def forward(self, x):
            seen["dtypes"].append(x.dtype)
            pooled = x.float().mean(dim=(2, 3))
            return torch.cat([pooled, pooled.flip(1), pooled[:, :1]], dim=1)

    def preprocess(img):
        a = np.asarray(img, np.float32) / 255.0
        return torch.from_numpy(a).permute(2, 0, 1)

    def load(name, device=None):
        assert name == "ViT-B/32"
        seen["devices"].append(device)
        return types.SimpleNamespace(visual=StubVisual()), preprocess

    return types.SimpleNamespace(load=load), seen


def test_extract_clip_features_matches_jax(tmp_path):
    paths = []
    for i in range(5):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(np.full((8, 8, 3), i * 40, np.uint8)).save(p)
        paths.append(p)
    stub, seen = _fake_clip()
    want = jclip.extract_clip_features(paths, batch_size=2, clip_module=stub)
    for bs in (2, 64):
        got = tclip.extract_clip_features(paths, device="cpu", batch_size=bs,
                                          clip_module=stub)
        assert got.dtype == np.float32 and got.shape == (5, 7)
        np.testing.assert_allclose(got, want, rtol=NUM_TOL, atol=NUM_TOL)
    assert set(seen["dtypes"]) == {torch.float16}
    assert [str(d) for d in seen["devices"]] == ["cpu"] * 3
    if not torch.cuda.is_available():
        # the port's default is the card, which this machine lacks
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tclip.extract_clip_features(paths, clip_module=stub)
