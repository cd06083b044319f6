"""VisDial dataset pipelines: the port's copy of ``gstx/data/visdial.py``
(lines 31-356), itself a NumPy port of the reference dataloaders with
identical item keys and shapes.

This slice ports the generation mode ``vd_gen_val`` (caption-only context
and a [CLS] decoder seed, ``dataloader_visdial_gen.py:460-505``).  The
other generative modes and the discriminative dataset raise
``NotImplementedError`` naming the ROADMAP item that ports them:
``vd_eval_val`` / ``vd_eval_test`` and ``VisdialDiscDataset`` with
evaluation (queue 1 item 4), ``vd_train`` with training (item 5).

Questions and answers are shared index tables in the VisDial JSON, so
tokenization is memoized per index (the reference re-tokenizes on every
access).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from gstx_torch.core.config import GSTConfig
from gstx_torch.data.encode import encode_image_input, encode_input
from gstx_torch.data.feature_store import FeatureStoreReader
from gstx_torch.data.tokenizer import BertTokenizer

NUM_ROUNDS = 10


class _TokenCache:
    """Memoized tokenization over the shared question/answer index tables."""

    def __init__(self, tokenizer: BertTokenizer, texts: Sequence[str]):
        self._tok = tokenizer
        self._texts = texts
        self._cache: Dict[int, List[int]] = {}

    def __getitem__(self, idx: int) -> List[int]:
        got = self._cache.get(idx)
        if got is None:
            got = self._tok.encode(self._texts[idx])
            self._cache[idx] = got
        return got


def prune_rounds(context: List[List[int]], num_rounds: int):
    """Truncate history to the last ``num_rounds`` rounds
    (dataloader_visdial_disc.py:84-93)."""
    start_segment = 1
    cur_rounds = (len(context) // 2) + 1
    l_index = 0
    if cur_rounds > num_rounds:
        l_index = len(context) - (2 * num_rounds)
        start_segment = 0
    return context[l_index:], start_segment


class VisdialDatasetBase:
    def __init__(self, config: GSTConfig, tokenizer: BertTokenizer,
                 reader: Optional[FeatureStoreReader] = None):
        self.config = config
        self.tokenizer = tokenizer
        self.reader = reader if reader is not None else FeatureStoreReader(
            config.visdial_image_feats)
        self.CLS, self.SEP, self.MASK, self.PAD = (
            tokenizer.CLS, tokenizer.SEP, tokenizer.MASK, tokenizer.PAD)
        self.max_seq_len = config.max_seq_len
        self.max_utt_len = config.max_utt_len
        self.max_regions = config.max_regions
        self.num_options = config.num_options

        if config.vd_version == "0.9":
            train_key = config.visdial_processed_train_09
            val_key = config.visdial_processed_val_09
        else:
            train_key = config.visdial_processed_train
            val_key = config.visdial_processed_val
        with open(train_key) as f:
            self.data_train = json.load(f)["data"]
        with open(val_key) as f:
            self.data_val = json.load(f)["data"]
        try:
            with open(config.visdial_processed_test) as f:
                self.data_test = json.load(f)["data"]
        except FileNotFoundError:
            self.data_test = None
        self.dense_val = None
        if config.vd_version == "1.0":
            try:
                with open(config.visdial_processed_val_dense_annotations) as f:
                    self.dense_val = json.load(f)
            except FileNotFoundError:
                pass
        self.dense_train = None
        if config.train_dense:
            with open(config.visdial_processed_train_dense) as f:
                self.dense_train = json.load(f)

        self._q_cache = {}
        self._a_cache = {}

    def _caches(self, data):
        key = id(data)
        if key not in self._q_cache:
            self._q_cache[key] = _TokenCache(self.tokenizer, data["questions"])
            self._a_cache[key] = _TokenCache(self.tokenizer, data["answers"])
        return self._q_cache[key], self._a_cache[key]

    def _num_points(self, data, override: int, mode: str) -> int:
        n = len(data["dialogs"])
        if self.config.overfit:
            return override if override else 5
        return override if override else n

    def _image_item(self, img_id: int, mask_prob: float,
                    rng: np.random.RandomState, with_targets: bool):
        features, num_boxes, boxes, _, image_target = self.reader[img_id]
        feat, spat, img_mask, img_target, img_label = encode_image_input(
            features, num_boxes, boxes, image_target,
            max_regions=self.max_regions, mask_prob=mask_prob, rng=rng)
        item = {
            "enc_image_feat": feat,
            "enc_image_loc": spat,
            "enc_image_mask": img_mask,
        }
        if with_targets:
            item["enc_image_target"] = img_target
            item["enc_image_label"] = img_label
        return item


class VisdialGenDataset(VisdialDatasetBase):
    """Generative dataset (modes of dataloader_visdial_gen.py:59); this
    slice serves ``vd_gen_val``."""

    def __init__(self, config: GSTConfig, tokenizer: BertTokenizer,
                 mode: str = "vd_gen_val",
                 reader: Optional[FeatureStoreReader] = None):
        assert mode in ("vd_train", "vd_eval_val", "vd_gen_val",
                        "vd_eval_test")
        if mode != "vd_gen_val":
            raise NotImplementedError(_NOT_PORTED[mode])
        super().__init__(config, tokenizer, reader)
        self.mode = mode

    def __len__(self) -> int:
        return self._num_points(self.data_val, self.config.num_val_samples,
                                self.mode)

    def _data(self):
        return self.data_train if self.config.overfit else self.data_val

    def __getitem__(self, index: int, seed: Optional[int] = None):
        rng = np.random.RandomState(
            seed if seed is not None else np.random.randint(2**31))
        dialog = self._data()["dialogs"][index]
        return self._gen_val_item(dialog, dialog["image_id"], rng)

    def _gen_val_item(self, dialog, img_id, rng):
        """Caption-only context + [CLS] decoder seed
        (dataloader_visdial_gen.py:460-505)."""
        item = self._image_item(img_id, mask_prob=0, rng=rng,
                                with_targets=False)
        item["image_id"] = np.asarray([img_id], dtype=np.int64)
        caption = self.tokenizer.encode(dialog["caption"])
        tok, seg, sep, _, att = encode_input(
            [caption], 1, self.CLS, self.SEP, self.MASK, self.PAD,
            max_seq_len=self.max_seq_len, mask_prob=0, rng=rng)
        item["enc_input_ids"] = tok
        item["enc_segments"] = seg
        item["enc_sep_indices"] = sep
        item["enc_att_mask"] = att
        item["dec_input_ids"] = np.asarray([self.CLS], dtype=np.int64)
        item["dec_att_mask"] = np.asarray([1.0], dtype=np.float32)
        return item


class VisdialDiscDataset:
    """Discriminative dataset (dataloader_visdial_disc.py:10-475): not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED["disc"])


_NOT_PORTED = {
    "vd_train": "VisDial mode vd_train is ported with training "
                "(ROADMAP queue 1 item 5)",
    "vd_eval_val": "VisDial mode vd_eval_val is ported with evaluation "
                   "(ROADMAP queue 1 item 4)",
    "vd_eval_test": "VisDial mode vd_eval_test is ported with evaluation "
                    "(ROADMAP queue 1 item 4)",
    "disc": "VisdialDiscDataset is ported with evaluation and training "
            "(ROADMAP queue 1 items 4-5)",
}
