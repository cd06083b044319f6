"""Host-side input encoding into fixed shapes (the port's copy of
``gstx/data/encode.py``).

NumPy ports of the reference's ``utils/data_utils.py`` helpers:
  * :func:`list2arraypad`   — ``list2tensorpad`` (:25-32)
  * :func:`encode_input`    — dialog context packing + MLM masking (:34-71)
  * :func:`encode_image_input` — region padding + feature masking (:73-117)
  * :func:`sequence_mask`   — (:7-18)

All functions are pure (explicit ``numpy.random.RandomState``) so pipelines
are deterministic and testable.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from gstx_torch.core.config import CLS_ID, MASK_ID, PAD_ID, SEP_ID


def list2arraypad(inp_list: Sequence[int], max_seq_len: int) -> np.ndarray:
    """Truncate/zero-pad a token list to [max_seq_len] (data_utils.py:25-32)."""
    out = np.zeros(max_seq_len, dtype=np.int64)
    trunc = list(inp_list)[:max_seq_len]
    out[: len(trunc)] = trunc
    return out


def encode_input(
    utterances: Sequence[Sequence[int]],
    start_segment: int,
    cls_id: int = CLS_ID,
    sep_id: int = SEP_ID,
    mask_id: int = MASK_ID,
    pad_id: int = PAD_ID,
    max_seq_len: int = 256,
    max_sep_len: int = 25,
    mask_prob: float = 0.15,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack utterances as [CLS] u1 [SEP] u2 [SEP] ... with oscillating segment
    ids and random MLM masking (data_utils.py:34-71).

    Returns (tokens, segments, sep_indices, mlm_labels, att_mask), each
    [max_seq_len] (sep_indices is [max_sep_len]); mlm_labels holds the
    original token id at masked positions and -1 elsewhere.
    """
    if rng is None:
        rng = np.random.RandomState()
    cur_segment = start_segment
    token_ids: List[int] = [cls_id]
    segment_ids: List[int] = [cur_segment]
    masked_flags: List[int] = [pad_id]
    sep_indices: List[int] = []
    cur_sep_index = 0

    for utt in utterances:
        flags = [1 if rng.random_sample() < mask_prob else 0
                 for _ in range(len(utt))]
        masked_flags.extend(flags)
        token_ids.extend(utt)
        segment_ids.extend([cur_segment] * len(utt))
        token_ids.append(sep_id)
        segment_ids.append(cur_segment)
        masked_flags.append(pad_id)
        cur_sep_index += len(utt) + 1
        sep_indices.append(cur_sep_index)
        cur_segment ^= 1

    assert len(segment_ids) == len(token_ids) == len(masked_flags) \
        == sep_indices[-1] + 1

    tokens = list2arraypad(token_ids, max_seq_len)
    masked = list2arraypad(masked_flags, max_seq_len)
    masked[masked == 0] = -1
    mask = masked == 1
    masked[mask] = tokens[mask]      # store original ids as labels
    tokens[mask] = mask_id           # replace with [MASK]
    segments = list2arraypad(segment_ids, max_seq_len)
    att_mask = (tokens != 0).astype(np.float32)
    return tokens, segments, list2arraypad(sep_indices, max_sep_len), masked, \
        att_mask


def encode_image_input(
    features: np.ndarray,      # [N, feat_dim]
    num_boxes: int,
    boxes: np.ndarray,         # [N, 5] normalized loc+area
    image_target: np.ndarray,  # [N, num_classes]
    max_regions: int = 37,
    mask_prob: float = 0.15,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad regions to ``max_regions`` and apply random region masking
    (data_utils.py:73-117): masked regions (p=mask_prob) have an 80%/90%
    chance of zeroed features and label 1; at least one non-<IMG> region is
    always labelled; the <IMG> token (row 0) never contributes.

    Returns (features, spatials, image_mask, image_target, image_label).
    """
    if rng is None:
        rng = np.random.RandomState()
    num_boxes = min(int(num_boxes), max_regions)

    feat = np.zeros((max_regions, features.shape[-1]), dtype=np.float32)
    locs = np.zeros((max_regions, boxes.shape[-1]), dtype=np.float32)
    target = np.zeros((max_regions, image_target.shape[-1]), dtype=np.float32)
    feat[:num_boxes] = features[:num_boxes]
    locs[:num_boxes] = boxes[:num_boxes]
    target[:num_boxes] = image_target[:num_boxes]

    output_label: List[int] = []
    for i in range(num_boxes):
        prob = rng.random_sample()
        if prob < mask_prob:
            prob /= mask_prob
            if prob < 0.9:
                feat[i] = 0.0
            output_label.append(1)
        else:
            output_label.append(-1)

    image_mask = [1] * num_boxes
    while len(image_mask) < max_regions:
        image_mask.append(0)
        output_label.append(-1)

    # ensure at least one region is predicted (data_utils.py:109)
    output_label[rng.randint(1, len(output_label))] = 1
    image_label = np.asarray(output_label, dtype=np.int64)
    image_label[0] = 0  # <IMG> never contributes (data_utils.py:111)

    return (
        feat,
        locs,
        np.asarray(image_mask, dtype=np.float32),
        target,
        image_label,
    )


def sequence_mask(lengths: np.ndarray, max_len: Optional[int] = None) -> np.ndarray:
    """[B] lengths -> [B, max_len] boolean mask (data_utils.py:7-18)."""
    lengths = np.asarray(lengths)
    if max_len is None:
        max_len = int(lengths.max())
    return np.arange(max_len)[None, :] < lengths[:, None]


def nsp_attention_mask(sep_indices, hist_len, max_len: int):
    """Attention covers tokens up to the hist_len-th SEP inclusive
    (train_disc.py:97-99): length = sep_indices[hist_len] + 1.  Works on
    numpy arrays (one implementation shared by train and eval)."""
    seq_len = np.take_along_axis(np.asarray(sep_indices),
                                 np.asarray(hist_len)[:, None], axis=1)[:, 0] + 1
    return sequence_mask(seq_len, max_len).astype(np.float32)
