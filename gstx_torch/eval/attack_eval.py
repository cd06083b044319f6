"""The adversarial robustness evaluation loop (the port of
``gstx/eval/attack_eval.py``; reference ``evaluate_gen_attack.py:233-369``).

Eval batches of one dialog (VisDial v1.0), one chunk a round of its
``num_options`` candidates.  FGSM and coreference fire on the
dense-annotated round only (``evaluate_gen_attack.py:92-100``);
random_token refills every round's masked context (the eval dataset masks
history tokens with ``mask_prob`` under that attack,
``dataloader_visdial_gen.py:387``).  The batch's region features go to the
device once, in f32, and each chunk gathers its rows there, as
:mod:`gstx_torch.eval.rank_gen` does (JAX broadcasts them on the host);
f32, because FGSM steps them in f32, and the model casts them to its
activation dtype inside, as it does any features.  Scores come back to
the host once a batch.  Across the ranks of ``dp``, each round's chunk
splits over them as :mod:`gstx_torch.eval.rank_gen` splits its chunks: a
rank attacks and scores its rows (the padded rows take no FGSM step, their
relevance being 0, ``gstx/eval/attack_eval.py:51-53``), and rank 0 gathers
the scores and computes the metrics.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gstx_torch.core import profiling
from gstx_torch.core.config import PAD_ID, SEP_ID, GSTConfig
from gstx_torch.eval.attacks import TextAttack, make_fgsm_scorer
from gstx_torch.eval.metrics import NDCG, SparseGTMetrics
from gstx_torch.eval.rank_gen import (batch_to_device, chunk_inputs,
                                      flatten_gen, gather_scores,
                                      make_chunk_scorer, rank_share)
from gstx_torch.models.encdec import GSTVisualDialog


def rebuild_segments(ids: np.ndarray, start_segment: int = 1) -> np.ndarray:
    """Oscillating segment ids from the [SEP] positions (encode_input's,
    data_utils.py:34-57): an utterance's tokens and its trailing [SEP]
    share a segment; pads are 0."""
    is_sep = (ids == SEP_ID).astype(np.int64)
    before = np.cumsum(is_sep, axis=1) - is_sep
    seg = (start_segment + before) % 2
    seg[ids == PAD_ID] = 0
    return seg


def _text_attacked(config, text_attack, chunk, host, dep, is_dense):
    """``(chunk, changed)``: the chunk with its context attacked on the
    host, if this round is attacked (coreference on the dense round,
    random_token on every round), else as it is; ``changed`` compares the
    host ids, so counting it costs no device sync."""
    if text_attack is None:
        return chunk, False
    ids = host["enc_input_ids"]
    if config.attack == "coreference" and is_dense:
        new = text_attack.coreference_attack(ids, host["enc_sep_indices"],
                                             dep)
        # a re-tokenised context can change length: the attention mask
        # and segments follow it (the reference keeps the stale ones)
        extra = {"enc_att_mask": (new != PAD_ID).astype(np.float32),
                 "enc_segments": rebuild_segments(new)}
    elif config.attack == "random_token":
        new = text_attack.random_token_attack(
            ids, host["enc_segments"], host["enc_att_mask"],
            {"feat": chunk["enc_image_feat"],
             "loc": chunk["enc_image_loc"],
             "mask": chunk["enc_image_mask"]})
        extra = {}
    else:
        return chunk, False
    dev = chunk["enc_input_ids"].device
    extra["enc_input_ids"] = new
    return dict(chunk, **{k: torch.from_numpy(np.ascontiguousarray(v)).to(
        dev, chunk[k].dtype) for k, v in extra.items()}), \
        not np.array_equal(new, ids)


def evaluate_attack(model: GSTVisualDialog, loader, config: GSTConfig,
                    coref_dependency: Optional[List[dict]] = None,
                    text_attack: Optional[TextAttack] = None,
                    epsilon: float = 1.0, chunk_size: int = 100,
                    logger=None, stats_out=None, dp=None) -> Optional[Dict]:
    """The attacked generative evaluation of ``model`` over ``loader``'s
    collated ``VisdialGenDataset`` ``vd_eval_val`` batches of one dialog,
    on the model's device, across the ranks of ``dp`` when given; returns
    R@k / MRR / mean rank, and NDCG for VisDial v1.0 (under ``dp``, on
    rank 0; None on the others).

    ``stats_out``, a dict, receives this run's ``batches``, ``images``,
    scored ``sequences``, ``chunks``, ``fgsm_chunks`` (the chunks whose
    features were perturbed), ``text_attacked`` (the chunks whose context
    a text attack changed), ``loop_seconds`` and ``wait_seconds`` (as
    :func:`gstx_torch.eval.rank_gen.rank_candidates`)."""
    sparse, ndcg = SparseGTMetrics(), NDCG()
    score_chunk = make_chunk_scorer(model)
    fgsm = make_fgsm_scorer(model, epsilon) if config.attack == "fgsm" \
        else None
    device = model.device
    totals = {"batches": 0, "images": 0, "sequences": 0, "chunks": 0,
              "fgsm_chunks": 0, "text_attacked": 0, "wait_seconds": 0.0}
    t0 = time.perf_counter()
    batches = iter(loader)
    batch_idx = 0
    while True:
        t_wait = time.perf_counter()
        with profiling.span("gstx:eval.wait"):
            batch = next(batches, None)
        totals["wait_seconds"] += time.perf_counter() - t_wait
        if batch is None:
            break
        with profiling.span("gstx:eval.batch"):
            done = _attack_batch(batch, batch_idx, config, coref_dependency,
                                 text_attack, fgsm, score_chunk, chunk_size,
                                 device, dp, totals)
            # None on a rank other than 0: its share is sent
            if done is not None:
                with profiling.span("gstx:eval.metrics"):
                    scores, round_id = done
                    sparse.observe(scores, batch["gt_option_inds"])
                    if config.vd_version == "1.0":
                        ndcg.observe(scores[np.arange(1), round_id - 1],
                                     batch["gt_relevance"])
        batch_idx += 1
    if stats_out is not None:
        stats_out.update(totals, loop_seconds=time.perf_counter() - t0)
    if dp is not None and dp.rank != 0:
        return None

    metrics = dict(sparse.retrieve(reset=True))
    if config.vd_version == "1.0":
        metrics.update(ndcg.retrieve(reset=True))
    if logger is not None:
        for k, v in metrics.items():
            logger.write(f"{k}: {v}")
    return metrics


def _attack_batch(batch, batch_idx, config, coref_dependency, text_attack,
                  fgsm, score_chunk, chunk_size, device, dp, totals):
    """One dialog attacked and scored: (its [1, rounds, options] host
    scores, its dense round's id), or None on a rank other than dp's 0."""
    text, images, (b, rounds, options) = flatten_gen(batch)
    if b != 1 or chunk_size != options:
        raise ValueError(
            f"the attack evaluation takes batches of one dialog and "
            f"chunks of its {options} options (reference :378); got "
            f"{b} dialogs and chunks of {chunk_size}")
    sep = batch["enc_sep_indices"].reshape(rounds * options, -1)
    round_id = int(batch["round_id"][0, 0])
    rows, valid = rank_share(dp, options, device)
    relevance = np.asarray(batch["gt_relevance"][0], np.float32)
    if dp is not None:
        # a padded row repeats row 0 but takes relevance 0: no FGSM step
        relevance = np.where(valid, relevance[rows.cpu().numpy()], 0.0)
        host_rows = rows.cpu().numpy()
    out = []
    with torch.no_grad():
        with profiling.span("gstx:eval.h2d"):
            dev_text, dev_images = batch_to_device(text, images, device,
                                                   torch.float32, ())
            relevance = torch.from_numpy(np.ascontiguousarray(
                relevance, np.float32)).to(device)
        for j in range(rounds):
            with profiling.span("gstx:eval.chunk"):
                lo, hi = j * options, (j + 1) * options
                chunk = chunk_inputs(dev_text, dev_images, lo, hi,
                                     rounds * options, rows)
                # the round of the dialog from its [SEP] count
                # (evaluate_gen_attack.py:94-96)
                is_dense = int((sep[lo] != 0).sum() // 2) == round_id
                if fgsm is not None and is_dense:
                    out.append(fgsm(chunk, relevance))
                    totals["fgsm_chunks"] += 1
                    continue
                host = {k: v[lo:hi] for k, v in text.items()}
                host["enc_sep_indices"] = sep[lo:hi]
                if dp is not None:
                    host = {k: v[host_rows] for k, v in host.items()}
                dep = coref_dependency[batch_idx]["coreference"][j] \
                    if coref_dependency else {}
                attacked, changed = _text_attacked(
                    config, text_attack, chunk, host, dep, is_dense)
                totals["text_attacked"] += changed
                out.append(score_chunk(attacked))
        with profiling.span("gstx:eval.fetch"):
            scores = gather_scores(dp, torch.cat(out), rounds, options)
    profiling.count("eval.chunks", rounds)
    profiling.count("eval.sequences", rounds * options)
    totals["batches"] += 1
    totals["images"] += 1
    totals["sequences"] += rounds * options
    totals["chunks"] += rounds
    if scores is None:
        return None
    return scores.numpy().reshape(1, rounds, options), round_id
