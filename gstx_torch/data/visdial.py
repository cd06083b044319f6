"""VisDial dataset pipelines: the port's copy of ``gstx/data/visdial.py``
(lines 31-612), itself a NumPy port of the reference dataloaders with
identical item keys and shapes.

The generative dataset serves ``vd_train`` (per-round context and target
pairs for the teacher or the questioner,
``dataloader_visdial_gen.py:123-293``), ``vd_gen_val`` (caption-only
context and a [CLS] decoder seed, ``dataloader_visdial_gen.py:460-505``)
and the ranking modes ``vd_eval_val`` / ``vd_eval_test`` (10 rounds x
num_options, or the last round x 100 options); the discriminative dataset
serves ``vd_train`` (the positive and random negative sequences with soft
NSP labels, ``dataloader_visdial_disc.py:117-288``) and ``vd_eval_val`` /
``vd_eval_test`` (full-sequence options).

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
    """Generative dataset (the modes of dataloader_visdial_gen.py:59)."""

    def __init__(self, config: GSTConfig, tokenizer: BertTokenizer,
                 mode: str = "vd_gen_val",
                 reader: Optional[FeatureStoreReader] = None):
        assert mode in ("vd_train", "vd_eval_val", "vd_gen_val",
                        "vd_eval_test")
        super().__init__(config, tokenizer, reader)
        self.mode = mode

    def __len__(self) -> int:
        if self.mode == "vd_train":
            return self._num_points(self.data_train,
                                    self.config.num_train_samples, self.mode)
        if self.mode in ("vd_eval_val", "vd_gen_val"):
            return self._num_points(self.data_val,
                                    self.config.num_val_samples, self.mode)
        return len(self.data_test["dialogs"])

    def _data(self):
        if self.mode == "vd_train":
            return self.data_train
        if self.mode in ("vd_eval_val", "vd_gen_val"):
            return self.data_train if self.config.overfit else self.data_val
        return self.data_test

    def __getitem__(self, index: int, seed: Optional[int] = None):
        rng = np.random.RandomState(
            seed if seed is not None else np.random.randint(2**31))
        data = self._data()
        dialog = data["dialogs"][index]
        q_cache, a_cache = self._caches(data)
        img_id = dialog["image_id"]
        if self.mode == "vd_train":
            return self._train_item(dialog, q_cache, a_cache, img_id, rng)
        if self.mode == "vd_eval_val":
            return self._eval_val_item(index, dialog, q_cache, a_cache,
                                       img_id, rng)
        if self.mode == "vd_gen_val":
            return self._gen_val_item(dialog, img_id, rng)
        return self._eval_test_item(dialog, q_cache, a_cache, img_id, rng)

    def _train_item(self, dialog, q_cache, a_cache, img_id, rng):
        """Per-round (context, target) pairs; the questioner
        (``-model enc_dec_q``) targets the questions, the teacher the
        answers (dataloader_visdial_gen.py:123-293).  [rounds, 1, L]
        sequences; labels are the targets shifted left, and [SEP] becomes
        [PAD] in the decoder inputs."""
        is_questioner = self.config.model == "enc_dec_q"
        caption = self.tokenizer.encode(dialog["caption"])
        full = [[caption]]
        contexts, targets = [], []
        for utt in dialog["dialog"]:
            q = q_cache[utt["question"]]
            a = a_cache[utt["answer"]]
            if is_questioner:
                ctx = full[-1].copy()
                tgt = [q[: self.max_utt_len - 2]]
            else:
                ctx = full[-1].copy() + [q]
                tgt = [a[: self.max_utt_len - 2]]
            full.append(full[-1].copy() + [q, a])
            contexts.append(ctx)
            targets.append(tgt)
        assert len(contexts) == len(targets) == NUM_ROUNDS

        cols = {k: [] for k in (
            "enc_input_ids", "enc_segments", "enc_sep_indices",
            "enc_mlm_labels", "enc_next_sentence_labels", "enc_hist_len",
            "enc_att_mask", "dec_input_ids", "dec_att_mask", "dec_labels")}
        for j in range(NUM_ROUNDS):
            tok, seg, sep, mlm, att = encode_input(
                contexts[j], 1, self.CLS, self.SEP, self.MASK, self.PAD,
                max_seq_len=self.max_seq_len, mask_prob=0, rng=rng)
            dtok, _, _, _, datt = encode_input(
                targets[j], 1, self.CLS, self.SEP, self.MASK, self.PAD,
                max_seq_len=self.max_utt_len, mask_prob=0, rng=rng)
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

        # hist_len and the NSP labels stay [rounds, 1], as the reference's
        # per-round scalars
        flat_keys = ("enc_hist_len", "enc_next_sentence_labels")
        item = {k: (np.stack(v) if k in flat_keys else np.stack(v)[:, None])
                for k, v in cols.items()}
        item.update(self._image_item(img_id, mask_prob=0, rng=rng,
                                     with_targets=True))
        return item

    def _eval_val_item(self, index, dialog, q_cache, a_cache, img_id, rng):
        """[10 rounds x num_options] ranking inputs + gt indices/relevance
        (dataloader_visdial_gen.py:295-458)."""
        num_options = self.num_options
        caption = self.tokenizer.encode(dialog["caption"])
        full = [[caption]]
        gt_option_inds = []
        gt_relevance = None
        all_ctx, all_opt = [], []
        # under the random_token attack the eval dataset masks history
        # tokens with mask_prob (dataloader_visdial_gen.py:387)
        mask_prob = (self.config.mask_prob
                     if self.config.attack == "random_token"
                     and getattr(self, "attack_mode", False) else 0)
        for rnd, utt in enumerate(dialog["dialog"]):
            fu = full[-1].copy()
            ctx = full[-1].copy() + [q_cache[utt["question"]]]
            fu.append(q_cache[utt["question"]])
            fu.append(a_cache[utt["answer"]])
            gt_ind = utt["gt_index"]
            option_inds = [gt_ind] + [
                k for k in range(100) if k != gt_ind][: num_options - 1]
            gt_option_inds.append(0)
            answer_options = [utt["answer_options"][k] for k in option_inds]
            assert answer_options[0] == utt["answer"]
            if self.dense_val is not None and \
                    rnd == self.dense_val[index]["round_id"] - 1:
                rel = np.asarray(self.dense_val[index]["gt_relevance"],
                                 dtype=np.float32)
                gt_relevance = rel[np.asarray(option_inds)]
            all_ctx.append([ctx] * num_options)
            all_opt.append([[a_cache[o][: self.max_utt_len - 2]]
                            for o in answer_options])
            full.append(fu)

        item = self._encode_option_grid(all_ctx, all_opt, rng,
                                        mask_prob=mask_prob)
        item["gt_option_inds"] = np.asarray(gt_option_inds, dtype=np.int64)
        item["image_id"] = np.asarray([img_id], dtype=np.int64)
        if self.dense_val is not None:
            item["round_id"] = np.asarray(
                [self.dense_val[index]["round_id"]], dtype=np.int64)
            item["gt_relevance"] = gt_relevance
        item.update(self._image_item(img_id, mask_prob=0, rng=rng,
                                     with_targets=False))
        return item

    def _encode_option_grid(self, all_ctx, all_opt, rng, mask_prob=0.0):
        rounds = len(all_ctx)
        n_opt = len(all_ctx[0])
        cols = {k: [] for k in (
            "enc_input_ids", "enc_segments", "enc_sep_indices",
            "enc_mlm_labels", "enc_hist_len", "enc_att_mask",
            "dec_input_ids", "dec_att_mask")}
        for j in range(rounds):
            row = {k: [] for k in cols}
            for k in range(n_opt):
                tok, seg, sep, mlm, att = encode_input(
                    all_ctx[j][k], 1, self.CLS, self.SEP, self.MASK,
                    self.PAD, max_seq_len=self.max_seq_len,
                    mask_prob=mask_prob, rng=rng)
                dtok, _, _, _, datt = encode_input(
                    all_opt[j][k], 1, self.CLS, self.SEP, self.MASK,
                    self.PAD, max_seq_len=self.max_utt_len, mask_prob=0,
                    rng=rng)
                row["enc_input_ids"].append(tok)
                row["enc_segments"].append(seg)
                row["enc_sep_indices"].append(sep)
                row["enc_mlm_labels"].append(mlm)
                row["enc_hist_len"].append(
                    np.asarray([len(all_ctx[j][k]) - 1], dtype=np.int64))
                row["enc_att_mask"].append(att)
                row["dec_input_ids"].append(dtok)
                row["dec_att_mask"].append(datt)
            for k in cols:
                cols[k].append(np.stack(row[k]))
        return {k: np.stack(v) for k, v in cols.items()}

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

    def _eval_test_item(self, dialog, q_cache, a_cache, img_id, rng):
        """Last round x 100 options (dataloader_visdial_gen.py:507-603)."""
        assert self.num_options == 100
        ctx = [self.tokenizer.encode(dialog["caption"])]
        for rnd, utt in enumerate(dialog["dialog"]):
            ctx.append(q_cache[utt["question"]])
            if rnd != len(dialog["dialog"]) - 1:
                ctx.append(a_cache[utt["answer"]])
        all_ctx = [[ctx] * 100]
        all_opt = [[[a_cache[o][: self.max_utt_len - 2]]
                    for o in dialog["dialog"][-1]["answer_options"]]]
        item = self._encode_option_grid(all_ctx, all_opt, rng)
        item["image_id"] = np.asarray([img_id], dtype=np.int64)
        item["round_id"] = np.asarray([dialog["round_id"]], dtype=np.int64)
        item.update(self._image_item(img_id, mask_prob=0, rng=rng,
                                     with_targets=False))
        return item


class VisdialDiscDataset(VisdialDatasetBase):
    """Discriminative dataset (dataloader_visdial_disc.py:10-475)."""

    def __init__(self, config: GSTConfig, tokenizer: BertTokenizer,
                 mode: str = "vd_train",
                 reader: Optional[FeatureStoreReader] = None):
        assert mode in ("vd_train", "vd_eval_val", "vd_eval_test")
        super().__init__(config, tokenizer, reader)
        self.mode = mode

    def __len__(self) -> int:
        if self.mode == "vd_train":
            return self._num_points(self.data_train,
                                    self.config.num_train_samples, self.mode)
        if self.mode == "vd_eval_val":
            return self._num_points(self.data_val,
                                    self.config.num_val_samples, self.mode)
        return len(self.data_test["dialogs"])

    def _data(self):
        if self.mode == "vd_train":
            return self.data_train
        if self.mode == "vd_eval_val":
            return self.data_train if self.config.overfit else self.data_val
        return self.data_test

    def __getitem__(self, index: int, seed: Optional[int] = None):
        rng = np.random.RandomState(
            seed if seed is not None else np.random.randint(2**31))
        data = self._data()
        dialog = data["dialogs"][index]
        q_cache, a_cache = self._caches(data)
        img_id = dialog["image_id"]
        if self.mode == "vd_train":
            return self._train_item(index, dialog, q_cache, a_cache, img_id,
                                    rng)
        if self.mode == "vd_eval_val":
            return self._eval_item(index, dialog, q_cache, a_cache, img_id,
                                   rng)
        return self._test_item(dialog, q_cache, a_cache, img_id, rng)

    def _image_keys(self, img_id, rng, mask_prob=0.0):
        """The discriminative items' region keys
        (dataloader_visdial_disc.py:381-392), regions masked with
        ``mask_prob`` (training)."""
        features, num_boxes, boxes, _, image_target = self.reader[img_id]
        feat, spat, img_mask, img_target, img_label = encode_image_input(
            features, num_boxes, boxes, image_target,
            max_regions=self.max_regions, mask_prob=mask_prob, rng=rng)
        return dict(image_feat=feat, image_loc=spat, image_mask=img_mask,
                    image_target=img_target, image_label=img_label)

    def _negatives(self, utt, answer, tot_len, prefix, a_cache, rng):
        """``num_negative_samples`` random wrong options of one round under
        the max-length constraint (dataloader_visdial_disc.py:150-178):
        each draws among the other options until one fits, dropping those
        that do not; when none fits, the last drawn is cut to the answer's
        length.  Returns (sequences, their option indices)."""
        cfg = self.config
        negatives, neg_indices = [], []
        for _ in range(cfg.num_negative_samples):
            all_inds = [k for k in range(100)
                        if k != utt["gt_index"]][: self.num_options - 1]
            tok_rand, opt_ind = None, None
            while all_inds:
                opt_ind = all_inds[rng.randint(len(all_inds))]
                tok_rand = a_cache[utt["answer_options"][opt_ind]]
                if cfg.max_seq_len >= tot_len + len(tok_rand) + 1:
                    neg_indices.append(opt_ind)
                    break
                all_inds.remove(opt_ind)
            if not all_inds:
                tok_rand = tok_rand[: len(answer)]
                neg_indices.append(opt_ind)
            negatives.append(prefix.copy() + [tok_rand])
        return negatives, neg_indices

    def _train_item(self, index, dialog, q_cache, a_cache, img_id, rng):
        """Each round's positive (the context with its answer) and
        ``num_negative_samples`` negatives (a random wrong option in its
        place), masked for the MLM with ``mask_prob``, with soft NSP
        labels: [1, 0] for the positive, [0, 1] for a negative, or
        ``[s, 1 - s]`` with the negative option's dense pseudo-label ``s``
        under ``-train_dense`` (dataloader_visdial_disc.py:117-288).
        [rounds, 1 + negatives, ...] sequences and the image's masked
        regions."""
        cfg = self.config
        caption = self.tokenizer.encode(dialog["caption"])
        utterances = [[caption]]
        utterances_random, neg_indices_all = [[caption]], []
        tot_len = len(caption) + 2
        for utt in dialog["dialog"]:
            q = q_cache[utt["question"]]
            a = a_cache[utt["answer"]]
            cur_rand = utterances[-1].copy() + [q]
            utterances.append(utterances[-1].copy() + [q, a])
            tot_len += len(q) + 1 + len(a) + 1
            negatives, neg_indices = self._negatives(utt, a, tot_len,
                                                     cur_rand, a_cache, rng)
            utterances_random.append(negatives)
            neg_indices_all.append(neg_indices)
        utterances = utterances[1:]
        utterances_random = utterances_random[1:]
        assert len(utterances) == len(utterances_random) == NUM_ROUNDS

        cols = {k: [] for k in ("tokens", "segments", "sep_indices", "mask",
                                "next_sentence_labels", "hist_len")}
        for j, context in enumerate(utterances):
            row = {k: [] for k in cols}
            for nsi, ctx in enumerate([context] + utterances_random[j]):
                ctx, start_seg = prune_rounds(ctx, cfg.visdial_tot_rounds)
                tok, seg, sep, mlm, _ = encode_input(
                    ctx, start_seg, self.CLS, self.SEP, self.MASK, self.PAD,
                    max_seq_len=cfg.max_seq_len, mask_prob=cfg.mask_prob,
                    rng=rng)
                row["tokens"].append(tok)
                row["segments"].append(seg)
                row["sep_indices"].append(sep)
                row["mask"].append(mlm)
                if nsi == 0:
                    label = [1.0, 0.0]
                elif self.dense_train is not None:
                    score = self.dense_train[index]["scores"][j][
                        neg_indices_all[j][nsi - 1]]
                    label = [score, 1.0 - score]
                else:
                    label = [0.0, 1.0]
                row["next_sentence_labels"].append(
                    np.asarray(label, dtype=np.float32))
                row["hist_len"].append(np.asarray([len(ctx) - 1],
                                                  dtype=np.int64))
            for k in cols:
                cols[k].append(np.stack(row[k]))
        item = {k: np.stack(v) for k, v in cols.items()}
        item.update(self._image_keys(img_id, rng, mask_prob=cfg.mask_prob))
        return item

    def _encode_options(self, options, rng):
        """Each option's pruned full sequence, encoded without masking."""
        cfg = self.config
        cols = {k: [] for k in ("tokens", "segments", "sep_indices", "mask",
                                "hist_len")}
        for option in options:
            opt, start_seg = prune_rounds(option, cfg.visdial_tot_rounds)
            tok, seg, sep, mlm, _ = encode_input(
                opt, start_seg, self.CLS, self.SEP, self.MASK, self.PAD,
                max_seq_len=cfg.max_seq_len, mask_prob=0, rng=rng)
            cols["tokens"].append(tok)
            cols["segments"].append(seg)
            cols["sep_indices"].append(sep)
            cols["mask"].append(mlm)
            cols["hist_len"].append(np.asarray([len(opt) - 1],
                                               dtype=np.int64))
        return {k: np.stack(v) for k, v in cols.items()}

    def _eval_item(self, index, dialog, q_cache, a_cache, img_id, rng):
        """[10 x num_options] full-sequence options
        (dataloader_visdial_disc.py:290-401)."""
        num_options = self.num_options
        utterances = [[self.tokenizer.encode(dialog["caption"])]]
        gt_option_inds, options_all = [], []
        gt_relevance = None
        for rnd, utt in enumerate(dialog["dialog"]):
            cur = utterances[-1].copy()
            cur.append(q_cache[utt["question"]])
            gt_ind = utt["gt_index"]
            option_inds = [gt_ind] + [
                k for k in range(100) if k != gt_ind][: num_options - 1]
            gt_option_inds.append(0)
            answer_options = [utt["answer_options"][k] for k in option_inds]
            assert answer_options[0] == utt["answer"]
            if self.dense_val is not None and \
                    rnd == self.dense_val[index]["round_id"] - 1:
                rel = np.asarray(self.dense_val[index]["gt_relevance"],
                                 dtype=np.float32)
                gt_relevance = rel[np.asarray(option_inds)]
            options_all.append(
                [cur.copy() + [a_cache[o]] for o in answer_options])
            cur.append(a_cache[utt["answer"]])
            utterances.append(cur)

        rows = [self._encode_options(opts, rng) for opts in options_all]
        item = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        item["gt_option_inds"] = np.asarray(gt_option_inds, dtype=np.int64)
        if self.dense_val is not None:
            item["round_id"] = np.asarray(
                [self.dense_val[index]["round_id"]], dtype=np.int64)
            item["gt_relevance"] = gt_relevance
        item["image_id"] = np.asarray([img_id], dtype=np.int64)
        item.update(self._image_keys(img_id, rng))
        return item

    def _test_item(self, dialog, q_cache, a_cache, img_id, rng):
        """Last round x 100 options (dataloader_visdial_disc.py:403-475)."""
        ctx = [self.tokenizer.encode(dialog["caption"])]
        for rnd, utt in enumerate(dialog["dialog"]):
            ctx.append(q_cache[utt["question"]])
            if rnd != len(dialog["dialog"]) - 1:
                ctx.append(a_cache[utt["answer"]])
        options = [ctx.copy() + [a_cache[o]]
                   for o in dialog["dialog"][-1]["answer_options"]]
        item = {k: v[None]
                for k, v in self._encode_options(options, rng).items()}
        item["image_id"] = np.asarray([img_id], dtype=np.int64)
        item["round_id"] = np.asarray([dialog["round_id"]], dtype=np.int64)
        item.update(self._image_keys(img_id, rng))
        return item

