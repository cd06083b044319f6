"""CC12M dataset: dialog-generation inputs and synthetic-dialog training
with perplexity-based data selection.

The port's copy of ``gstx/data/cc12m.py``, itself a NumPy port of the
reference ``dataloader/dataloader_cc12m_gen.py:11-266``:
  * cc12m_gen: region features + (<=38-token) caption context + [CLS]
    decoder seed (:55-102);
  * cc12m_train: 10-round synthetic dialogs from generated JSON; rounds with
    ``answer_ppl >= threshold`` get zeroed dec_labels under ``select_data``
    so they contribute no loss (:193-200).
"""

from __future__ import annotations

import glob as _glob
import json
import os
import re
from typing import Optional

import numpy as np

from gstx_torch.core.config import GSTConfig
from gstx_torch.data.encode import encode_image_input, encode_input
from gstx_torch.data.feature_store import FeatureStoreReader
from gstx_torch.data.tokenizer import BertTokenizer

NUM_ROUNDS = 10
MAX_CAP_LEN = 38  # dataloader_cc12m_gen.py:75,110


class CC12mDataset:
    def __init__(self, config: GSTConfig, tokenizer: BertTokenizer,
                 mode: str = "cc12m_gen",
                 reader: Optional[FeatureStoreReader] = None):
        assert mode in ("cc12m_gen", "cc12m_train")
        self.config = config
        self.mode = mode
        self.tokenizer = tokenizer
        self.reader = reader if reader is not None else FeatureStoreReader(
            config.cc12m_image_feats)
        self.CLS, self.SEP, self.MASK, self.PAD = (
            tokenizer.CLS, tokenizer.SEP, tokenizer.MASK, tokenizer.PAD)
        self.max_seq_len = config.max_seq_len
        self.max_utt_len = config.max_utt_len
        self.max_regions = config.max_regions

        self.captions = None
        self.dialogs = None
        if mode == "cc12m_gen":
            with open(config.cc12m_caption) as f:
                self.captions = json.load(f)
            assert len(self.captions) == len(self.reader)
        else:
            self.dialogs = load_dialog_json(config.cc12m_processed_train)

    def __len__(self) -> int:
        return len(self.captions if self.captions is not None
                   else self.dialogs)

    def __getitem__(self, index: int, seed: Optional[int] = None):
        rng = np.random.RandomState(
            seed if seed is not None else np.random.randint(2**31))
        if self.mode == "cc12m_gen":
            return self._gen_item(index, rng)
        return self._train_item(index, rng)

    def _gen_item(self, index: int, rng):
        cur = self.captions[index]
        features, num_boxes, boxes, _, image_target = self.reader[
            cur["image_id"]]
        feat, spat, img_mask, _, _ = encode_image_input(
            features, num_boxes, boxes, image_target,
            max_regions=self.max_regions, mask_prob=0, rng=rng)
        caption = self.tokenizer.encode(cur["caption"])[:MAX_CAP_LEN]
        tok, seg, sep, _, att = encode_input(
            [caption], 1, self.CLS, self.SEP, self.MASK, self.PAD,
            max_seq_len=self.max_seq_len, mask_prob=0, rng=rng)
        return {
            "enc_image_feat": feat,
            "enc_image_loc": spat,
            "enc_image_mask": img_mask,
            "image_id": np.asarray([cur["image_id"]], dtype=np.int64),
            "enc_input_ids": tok,
            "enc_segments": seg,
            "enc_sep_indices": sep,
            "enc_att_mask": att,
            "dec_input_ids": np.asarray([self.CLS], dtype=np.int64),
            "dec_att_mask": np.asarray([1.0], dtype=np.float32),
        }

    def _train_item(self, index: int, rng):
        cfg = self.config
        cur = self.dialogs[index]
        caption = self.tokenizer.encode(cur["caption"])[:MAX_CAP_LEN]
        full = [[caption]]
        contexts, targets, ppls = [], [], []
        for utt in cur["dialog"]:
            fu = full[-1].copy()
            q = self.tokenizer.encode(utt["question"])
            a = self.tokenizer.encode(utt["answer"])
            ctx = full[-1].copy() + [q]
            fu.extend([q, a])
            targets.append([a[: self.max_utt_len - 2]])
            contexts.append(ctx)
            full.append(fu)
            ppls.append(utt["answer_ppl"])
        assert len(contexts) == len(targets) == NUM_ROUNDS

        cols = {k: [] for k in (
            "enc_input_ids", "enc_segments", "enc_sep_indices",
            "enc_mlm_labels", "enc_next_sentence_labels", "enc_hist_len",
            "enc_att_mask", "dec_input_ids", "dec_att_mask", "dec_labels")}
        for j in range(NUM_ROUNDS):
            tok, seg, sep, mlm, att = encode_input(
                contexts[j], 1, self.CLS, self.SEP, self.MASK, self.PAD,
                max_seq_len=self.max_seq_len, mask_prob=cfg.mask_prob,
                rng=rng)
            dtok, _, _, _, datt = encode_input(
                targets[j], 1, self.CLS, self.SEP, self.MASK, self.PAD,
                max_seq_len=self.max_utt_len, mask_prob=0, rng=rng)
            # perplexity-based data selection: zero labels for high-ppl
            # rounds (dataloader_cc12m_gen.py:193-200)
            if cfg.select_data and ppls[j] >= cfg.threshold:
                dec_labels = np.zeros_like(dtok)
            else:
                dec_labels = np.zeros_like(dtok)
                dec_labels[:-1] = dtok[1:]
            dtok = np.where(dtok == self.SEP, self.PAD, dtok)
            cols["enc_input_ids"].append(tok)
            cols["enc_segments"].append(seg)
            cols["enc_sep_indices"].append(sep)
            cols["enc_mlm_labels"].append(mlm)
            cols["enc_next_sentence_labels"].append(
                np.asarray([-1], dtype=np.int64))
            cols["enc_hist_len"].append(
                np.asarray([len(contexts[j]) - 1], dtype=np.int64))
            cols["enc_att_mask"].append(att)
            cols["dec_input_ids"].append(dtok)
            cols["dec_att_mask"].append(datt)
            cols["dec_labels"].append(dec_labels)

        flat_keys = ("enc_hist_len", "enc_next_sentence_labels")
        item = {k: (np.stack(v) if k in flat_keys else np.stack(v)[:, None])
                for k, v in cols.items()}

        features, num_boxes, boxes, _, image_target = self.reader[
            cur["image_id"]]
        feat, spat, img_mask, img_target, img_label = encode_image_input(
            features, num_boxes, boxes, image_target,
            max_regions=self.max_regions, mask_prob=cfg.mask_prob, rng=rng)
        item.update(enc_image_feat=feat, enc_image_loc=spat,
                    enc_image_mask=img_mask, enc_image_target=img_target,
                    enc_image_label=img_label)
        return item


def load_dialog_json(path: str):
    """Load a generated-dialog JSON file, transparently concatenating the
    per-host output shards a multi-host ``cli/generate`` run writes
    (``name.procN.ext`` instead of the configured ``name.ext``).  A
    single-host run writes ONLY the exact file and a multi-host run writes
    ONLY shards, so both existing at once means two different runs' outputs
    share the directory — loading both would feed every image's dialogs
    twice to the student stage, so that is an error, not a concat."""
    root, ext = os.path.splitext(path)
    # only real .procN shards (N a bare integer) count — a sibling like
    # name.proc_backup.ext would match the glob but is not a shard
    shard_re = re.compile(
        re.escape(root) + r"\.proc(\d+)" + re.escape(ext) + r"$")
    matches = [(m, p) for p in _glob.glob(f"{_glob.escape(root)}.proc*{ext}")
               if (m := shard_re.match(p))]
    shards = [p for m, p in sorted(matches, key=lambda mp: int(mp[0].group(1)))]
    if os.path.exists(path) and shards:
        raise ValueError(
            f"ambiguous dialog directory: both {path} and per-host shards "
            f"{[os.path.basename(s) for s in shards]} exist; these are "
            "outputs of two different generate runs and loading both would "
            "duplicate every image's dialogs — remove the stale one")
    paths = [path] if os.path.exists(path) else shards
    if not paths:
        raise FileNotFoundError(
            f"no dialog file {path} and no per-host shards {root}.proc*{ext}")
    dialogs = []
    for p in paths:
        with open(p) as f:
            dialogs.extend(json.load(f))
    return dialogs



def load_cc12m_chunks(config: GSTConfig, tokenizer: BertTokenizer):
    """The student's training set (``gstx/data/cc12m.py:190-205``,
    reference train_gen.py:160-178): for each self-training iteration n in
    [1, iter], ``chunk`` feature stores ``{cc12m_image_feats}
    cc12m_img_feat_{i}.store`` and dialog files ``{cc12m_processed_train}
    iter{n}/cc12m_dialogs_{i}.txt``, concatenated."""
    datasets = []
    feat_root = config.cc12m_image_feats
    dialog_root = config.cc12m_processed_train
    for n in range(config.iter):
        iter_path = f"{dialog_root}iter{n + 1}/"
        for i in range(int(config.chunk)):
            sub = config.replace(
                cc12m_image_feats=f"{feat_root}cc12m_img_feat_{i}.store",
                cc12m_processed_train=f"{iter_path}cc12m_dialogs_{i}.txt",
            )
            datasets.append(CC12mDataset(sub, tokenizer, mode="cc12m_train"))
    return ConcatDataset(datasets)


class ConcatDataset:
    """Datasets end to end, each item keeping its own dataset's seed
    argument (``gstx/data/cc12m.py:208-219``)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index, seed=None):
        d = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[d].__getitem__(index - int(self._offsets[d]),
                                            seed=seed)
