"""Offline VisDial JSON preprocessing: length filtering / round truncation
(the port of ``gstx/preprocessing/preprocess_visdial.py``).

Equivalent of reference ``preprocessing/pre_process_visdial_v1.0.py`` and
``pre_process_visdial_v0.9.py``:
  * train: drop dialogs whose full tokenized length (caption + 10 QA rounds
    + 21 separators + CLS) exceeds max_seq_len (:92-104);
  * train dense annotations: keep only samples still present and whose
    dense round's options all fit (:106-142);
  * val: drop dialogs where any option of any round overflows (:148-170);
  * test: truncate leading rounds until the last round's options fit
    (:173-208), recording round_id.

Memoized tokenization replaces the reference's re-tokenization of shared
question/answer tables.

    python -m gstx_torch.preprocessing.preprocess_visdial \\
        -visdial_train train.json -visdial_val val.json -vocab_path vocab.txt \\
        -save_prefix data/visdial_1.0
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from gstx_torch.data.tokenizer import BertTokenizer


class _LenCache:
    def __init__(self, tokenizer, texts):
        self._tok = tokenizer
        self._texts = texts
        self._len: Dict[int, int] = {}

    def __getitem__(self, idx: int) -> int:
        got = self._len.get(idx)
        if got is None:
            got = len(self._tok.encode(self._texts[idx]))
            self._len[idx] = got
        return got


def filter_train(data: dict, tokenizer, max_seq_len: int = 256) -> int:
    """In-place: drop over-length train dialogs.  Returns #dropped."""
    dialogs = data["data"]["dialogs"]
    q_len = _LenCache(tokenizer, data["data"]["questions"])
    a_len = _LenCache(tokenizer, data["data"]["answers"])
    kept, dropped = [], 0
    for d in dialogs:
        # 21 separators + CLS + caption (reference :95)
        tot = 22 + len(tokenizer.encode(d["caption"]))
        for rnd in d["dialog"]:
            tot += a_len[rnd["answer"]] + q_len[rnd["question"]]
        if tot <= max_seq_len:
            kept.append(d)
        else:
            dropped += 1
    data["data"]["dialogs"] = kept
    return dropped


def filter_train_dense(data: dict, dense: List[dict], tokenizer,
                       max_seq_len: int = 256):
    """Keep dense annotations whose sample survived train filtering and
    whose dense-round options all fit; returns (filtered_dense,
    dense_dialogs)."""
    dialogs = data["data"]["dialogs"]
    q_len = _LenCache(tokenizer, data["data"]["questions"])
    a_len = _LenCache(tokenizer, data["data"]["answers"])
    img_to_idx = {d["image_id"]: i for i, d in enumerate(dialogs)}
    out_dense, out_dialogs = [], []
    for ann in dense:
        if ann["image_id"] not in img_to_idx:
            continue
        sample = dialogs[img_to_idx[ann["image_id"]]]
        cur_round = ann["round_id"] - 1
        tot = 1 + len(tokenizer.encode(sample["caption"])) + 1
        for rnd in range(cur_round):
            tot += q_len[sample["dialog"][rnd]["question"]] + 1
            tot += a_len[sample["dialog"][rnd]["answer"]] + 1
        ok = all(a_len[o] + 1 + tot <= max_seq_len
                 for o in sample["dialog"][cur_round]["answer_options"])
        if ok:
            out_dense.append(ann)
            out_dialogs.append(dict(sample))
    return out_dense, out_dialogs


def filter_val(data: dict, dense: Optional[List[dict]], tokenizer,
               max_seq_len: int = 256) -> int:
    """In-place: drop val dialogs where any round's option overflows
    (reference :148-170).  Dense annotations dropped in lockstep."""
    dialogs = data["data"]["dialogs"]
    q_len = _LenCache(tokenizer, data["data"]["questions"])
    a_len = _LenCache(tokenizer, data["data"]["answers"])
    kept, kept_dense, dropped = [], [], 0
    for i, d in enumerate(dialogs):
        tot = 1 + len(tokenizer.encode(d["caption"])) + 1
        ok = True
        for rnd in d["dialog"]:
            # the reference adds the question length BEFORE checking the
            # round's options (:159-163), then the answer after
            tot += q_len[rnd["question"]] + 1
            if any(a_len[o] + 1 + tot > max_seq_len
                   for o in rnd["answer_options"]):
                ok = False
                break
            tot += a_len[rnd["answer"]] + 1
        if ok:
            kept.append(d)
            if dense is not None:
                kept_dense.append(dense[i])
        else:
            dropped += 1
    data["data"]["dialogs"] = kept
    if dense is not None:
        dense[:] = kept_dense
    return dropped


def truncate_test(data: dict, tokenizer, max_seq_len: int = 256) -> int:
    """In-place: set round_id = #rounds and pop leading rounds until the
    last round's options fit (reference :173-208)."""
    q_len = _LenCache(tokenizer, data["data"]["questions"])
    a_len = _LenCache(tokenizer, data["data"]["answers"])
    n_truncated = 0
    for d in data["data"]["dialogs"]:
        cur = d["dialog"]
        d["round_id"] = len(cur)
        tot = 1 + len(tokenizer.encode(d["caption"])) + 1
        for rnd_i, rnd in enumerate(cur):
            tot += q_len[rnd["question"]] + 1
            if rnd_i != len(cur) - 1:
                tot += a_len[rnd["answer"]] + 1
        max_len = tot
        overflow = False
        for o in cur[-1]["answer_options"]:
            cur_len = a_len[o] + 1 + tot
            if cur_len > max_seq_len:
                overflow = True
                max_len = max(max_len, cur_len)
        if overflow:
            n_truncated += 1
            while max_len > max_seq_len and len(cur) > 1:
                first = cur[0]
                round_len = q_len[first["question"]] + 1 + \
                    a_len[first["answer"]] + 1
                cur.pop(0)
                max_len -= round_len
    return n_truncated


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)


def main(argv=None):
    p = argparse.ArgumentParser(description="gstx_torch visdial preprocessing")
    p.add_argument("-visdial_train", required=True)
    p.add_argument("-visdial_val", required=True)
    p.add_argument("-visdial_test", default="")
    p.add_argument("-visdial_train_ndcg", default="")
    p.add_argument("-visdial_val_ndcg", default="")
    p.add_argument("-vocab_path", required=True)
    p.add_argument("-max_seq_len", type=int, default=256)
    p.add_argument("-save_prefix", required=True)
    args = p.parse_args(argv)

    tok = BertTokenizer(vocab_path=args.vocab_path)
    train = _load(args.visdial_train)
    n = filter_train(train, tok, args.max_seq_len)
    print(f"illegal train samples dropped: {n}")
    _dump(train, args.save_prefix + "_train_processed.json")

    if args.visdial_train_ndcg:
        dense = _load(args.visdial_train_ndcg)
        out_dense, out_dialogs = filter_train_dense(
            train, dense, tok, args.max_seq_len)
        dense_pack = dict(train)
        dense_pack["data"] = dict(train["data"])
        dense_pack["data"]["dialogs"] = out_dialogs
        _dump(dense_pack, args.save_prefix + "_train_dense_processed.json")
        _dump(out_dense, args.save_prefix
              + "_train_dense_annotations_processed.json")

    val = _load(args.visdial_val)
    val_dense = (_load(args.visdial_val_ndcg) if args.visdial_val_ndcg
                 else None)
    n = filter_val(val, val_dense, tok, args.max_seq_len)
    print(f"illegal val samples dropped: {n}")
    _dump(val, args.save_prefix + "_val_processed.json")
    if val_dense is not None:
        _dump(val_dense,
              args.save_prefix + "_val_dense_annotations_processed.json")

    if args.visdial_test:
        test = _load(args.visdial_test)
        n = truncate_test(test, tok, args.max_seq_len)
        print(f"truncated test samples: {n}")
        _dump(test, args.save_prefix + "_test_processed.json")


if __name__ == "__main__":
    main()
