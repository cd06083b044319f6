"""Synthetic data of the real shapes, made from the run's seed: a
30,522-word WordPiece vocabulary in bert-base-uncased's layout, region
features of 36 boxes x 2,048 per image in the program's feature-store
format, CC12M-style captions and VisDial v1.0-style dialogs with 100
answer options a round.

Words are whole vocabulary entries, so each word is one token whose id is
its line in the vocabulary: the reference reads the ids the benchmark drew
and never the program's tokenization.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

VOCAB_SIZE = 30522
NUM_BOXES = 36
FEAT_DIM = 2048
NUM_CLASSES = 1601
IMAGE_H, IMAGE_W = 480, 640


def make_vocab() -> List[str]:
    """Specials at 0 and 100-103, [unused*] between, then synthetic words
    and ## pieces."""
    def word(i):
        s = ""
        while i:
            s, i = chr(97 + i % 26) + s, i // 26
        return s
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + \
        ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    return vocab + [("##" if i % 5 == 0 else "") + word(i)
                    for i in range(len(vocab), VOCAB_SIZE)]


@dataclass
class Images:
    """Raw region data: features [N, boxes, F], boxes [N, boxes, 4] in
    pixels of an IMAGE_W x IMAGE_H image."""
    ids: List[int]
    feats: np.ndarray
    boxes: np.ndarray


@dataclass
class Corpus:
    vocab: List[str]
    images: Images
    paths: Dict[str, str] = field(default_factory=dict)
    captions: List[List[int]] = field(default_factory=list)   # cc12m
    questions: List[List[int]] = field(default_factory=list)  # visdial
    answers: List[List[int]] = field(default_factory=list)
    dialogs: List[dict] = field(default_factory=list)

    def text(self, ids) -> str:
        return " ".join(self.vocab[i] for i in ids)


def _words(rng, word_ids, lo, hi):
    return [int(x) for x in
            word_ids[rng.randint(0, len(word_ids), rng.randint(lo, hi + 1))]]


def make_images(rng, ids: List[int]) -> Images:
    n = len(ids)
    feats = rng.rand(n, NUM_BOXES, FEAT_DIM).astype(np.float32)
    x1 = rng.rand(n, NUM_BOXES) * 300
    y1 = rng.rand(n, NUM_BOXES) * 300
    boxes = np.stack([x1, y1, x1 + rng.rand(n, NUM_BOXES) * 100 + 1,
                      y1 + rng.rand(n, NUM_BOXES) * 100 + 1],
                     -1).astype(np.float32)
    return Images(list(ids), feats, boxes)


def write_common(tmp: str, images: Images) -> Dict[str, str]:
    """The vocabulary file and the feature store (through the program's
    writer: the store is the program's file format)."""
    from gstx_torch.data.feature_store import FeatureStoreWriter

    paths = {"vocab": os.path.join(tmp, "vocab.txt"),
             "store": os.path.join(tmp, "feats.store")}
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(make_vocab()) + "\n")
    cls_prob = np.full((NUM_BOXES, NUM_CLASSES), 1.0 / NUM_CLASSES,
                       np.float32)
    with FeatureStoreWriter(paths["store"], FEAT_DIM, NUM_CLASSES) as w:
        for i, image_id in enumerate(images.ids):
            w.add(image_id, IMAGE_H, IMAGE_W, images.feats[i],
                  images.boxes[i], cls_prob)
    return paths


def _word_ids(vocab):
    return np.asarray([i for i, w in enumerate(vocab)
                       if i >= 104 and not w.startswith("##")])


def cc12m(tmp: str, seed: int, mix: dict) -> Corpus:
    """``mix["images"]`` images with captions of ``mix["caption_words"]``
    words."""
    rng = np.random.RandomState(seed % 2**32)
    vocab = make_vocab()
    word_ids = _word_ids(vocab)
    ids = list(range(1000, 1000 + mix["images"]))
    images = make_images(rng, ids)
    lo, hi = mix["caption_words"]
    captions = [_words(rng, word_ids, lo, hi) for _ in ids]
    corpus = Corpus(vocab, images, write_common(tmp, images))
    corpus.captions = captions
    corpus.paths["captions"] = os.path.join(tmp, "captions.json")
    with open(corpus.paths["captions"], "w") as f:
        json.dump([{"image_id": i, "caption": corpus.text(c)}
                   for i, c in zip(ids, captions)], f)
    return corpus


def visdial(tmp: str, seed: int, mix: dict) -> Corpus:
    """``mix["dialogs"]`` VisDial v1.0 val dialogs of ``mix["rounds"]``
    rounds: a caption, a question and ``mix["options"]`` answer options
    a round drawn from pools of questions and answers, one of them the
    ground truth, and one densely annotated round a dialog."""
    rng = np.random.RandomState(seed % 2**32)
    vocab = make_vocab()
    word_ids = _word_ids(vocab)
    n_opt = mix["options"]
    questions = [_words(rng, word_ids, *mix["question_words"])
                 for _ in range(mix["pool"])]
    answers = [_words(rng, word_ids, *mix["answer_words"])
               for _ in range(mix["pool"])]
    ids = list(range(5000, 5000 + mix["dialogs"]))
    images = make_images(rng, ids)
    dialogs = []
    for i in ids:
        rounds = []
        for _ in range(mix["rounds"]):
            opts = rng.choice(len(answers), n_opt, replace=False)
            gt = int(rng.randint(n_opt))
            rounds.append({"question": int(rng.randint(len(questions))),
                           "answer": int(opts[gt]), "gt_index": gt,
                           "answer_options": [int(o) for o in opts]})
        dialogs.append({"image_id": i,
                        "caption": _words(rng, word_ids,
                                          *mix["caption_words"]),
                        "dialog": rounds})
    dense = [{"image_id": i,
              "round_id": int(rng.randint(1, mix["rounds"] + 1)),
              "gt_relevance": [float(x) for x in rng.randint(0, 5, n_opt)
                               / 4.0 * (rng.rand(n_opt) < 0.3)]}
             for i in ids]
    corpus = Corpus(vocab, images, write_common(tmp, images))
    corpus.questions, corpus.answers, corpus.dialogs = \
        questions, answers, dialogs
    text = {"data": {
        "questions": [corpus.text(q) for q in questions],
        "answers": [corpus.text(a) for a in answers],
        "dialogs": [dict(d, caption=corpus.text(d["caption"]))
                    for d in dialogs]}}
    corpus.paths["val"] = os.path.join(tmp, "val.json")
    corpus.paths["dense"] = os.path.join(tmp, "dense.json")
    with open(corpus.paths["val"], "w") as f:
        json.dump(text, f)
    with open(corpus.paths["dense"], "w") as f:
        json.dump(dense, f)
    return corpus
