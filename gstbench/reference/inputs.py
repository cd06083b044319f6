"""The reference's own encoding of the benchmark's raw data into model
inputs, written from the published data layouts (ViLBERT's region
features with a prepended global <IMG> token; VisDial-BERT's packing of a
dialog as ``[CLS] caption [SEP] q1 [SEP] a1 [SEP] ...`` with alternating
segments).  It takes the word ids and region arrays that the benchmark
generated, never the program's batches.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

PAD, CLS, SEP = 0, 101, 102
SPECIAL = (0, 100, 101, 102, 103)


def image_inputs(feats: np.ndarray, boxes: np.ndarray, h: int, w: int,
                 max_regions: int) -> Tuple[np.ndarray, ...]:
    """Regions of one image: the mean feature as a global token at box
    [0, 0, 1, 1] of area 1, then each box as (x1/w, y1/h, x2/w, y2/h,
    relative area), padded to ``max_regions``.  Returns (features [R, F],
    locations [R, 5], mask [R])."""
    n = min(feats.shape[0] + 1, max_regions)
    f = np.zeros((max_regions, feats.shape[1]), np.float32)
    loc = np.zeros((max_regions, 5), np.float32)
    f[0] = feats.sum(0) / feats.shape[0]
    f[1:n] = feats[: n - 1]
    b = boxes[: n - 1].astype(np.float64)
    loc[0] = (0, 0, 1, 1, 1)
    loc[1:n, 0] = b[:, 0] / w
    loc[1:n, 1] = b[:, 1] / h
    loc[1:n, 2] = b[:, 2] / w
    loc[1:n, 3] = b[:, 3] / h
    loc[1:n, 4] = (b[:, 3] - b[:, 1]) * (b[:, 2] - b[:, 0]) / (w * h)
    mask = np.zeros(max_regions, np.float32)
    mask[:n] = 1
    return f, loc, mask


def pack(utterances: Sequence[Sequence[int]], max_len: int,
         start_segment: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """``[CLS] u1 [SEP] u2 [SEP] ...``, each utterance and its [SEP] in
    one segment, segments alternating from ``start_segment``, cut or
    zero-padded to ``max_len``.  Returns (ids, segments)."""
    ids, segs = [CLS], [start_segment]
    seg = start_segment
    for u in utterances:
        ids += list(u) + [SEP]
        segs += [seg] * (len(u) + 1)
        seg ^= 1
    out_i = np.zeros(max_len, np.int64)
    out_s = np.zeros(max_len, np.int64)
    n = min(len(ids), max_len)
    out_i[:n], out_s[:n] = ids[:n], segs[:n]
    return out_i, out_s


def recent_rounds(utterances: List, rounds: int) -> Tuple[List, int]:
    """The history kept for a VisDial sequence: at most ``rounds`` rounds
    (a caption and question/answer pairs); when older ones are dropped the
    first kept utterance starts at segment 0."""
    if len(utterances) // 2 + 1 > rounds:
        return utterances[len(utterances) - 2 * rounds:], 0
    return utterances, 1


def banned(history: List[Sequence[int]], prefix: Sequence[int],
           n: int) -> set:
    """Tokens that n-gram blocking bans after ``prefix`` (the decoded
    tokens with the start token): every token x such that the last n-1
    tokens of the prefix followed by x occur in an earlier question
    (with its [SEP]) with no special token among the n."""
    if n <= 0 or len(prefix) < n - 1:
        return set()
    tail = tuple(prefix[len(prefix) - (n - 1):])
    out = set()
    for q in history:
        for i in range(len(q) - n + 1):
            win = tuple(q[i:i + n])
            if win[:-1] == tail and not any(t in SPECIAL for t in win):
                out.add(win[-1])
    return out
