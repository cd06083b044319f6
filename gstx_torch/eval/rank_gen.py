"""Generative ranking evaluation: score the candidate answers of every
round by teacher-forced log-likelihood (the port of
``gstx/eval/rank_gen.py``; reference ``evaluate_gen.py:22-142``).

Each eval batch holds [B, rounds, options] sequences.  They are flattened
and scored in chunks of ``chunk_size`` (reference 500), then reduced to
R@k / MRR / mean rank (+ NDCG for VisDial v1.0) or to the EvalAI ranks
list of test mode.  :func:`rank_candidates` is the loop that the
discriminative evaluator (:mod:`gstx_torch.eval.rank_disc`) shares.

Data parallel across ranks (``dp``, a :class:`gstx_torch.core.mesh.
DataParallel`): each chunk's rows, padded to a multiple of the ranks,
split over them (``gstx/eval/rank_gen.py:115-125``); each rank scores its
rows and rank 0 gathers a batch's scores, computes the metrics and alone
returns them.  Under tensor parallelism ``dp`` is the data group (the
ranks that hold the same shard) and the model's model group computes each
of a rank's rows together; the data group's rank 0 of every model rank
gathers the scores.

Differences from the JAX evaluator, none of which changes a score:
  * each batch goes to the device once: its flattened text rows, and its
    [B, ...] region features (cast there to the model's activation dtype,
    which the model's first layer would do to every row), whose rows each
    chunk gathers with ``index_select`` on ``row // (rounds * options)``.
    The JAX evaluator broadcasts the features over rounds x options on the
    host, a copy of 20,000 x 37 x 2,048 f32 (6 GB) a v1.0 batch;
  * the evaluator runs under ``torch.inference_mode`` and computes in the
    dtype the caller's model has: it casts nothing of the caller's model
    (the CLI precasts once, :func:`gstx_torch.models.encdec.precast_`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gstx_torch.core.config import PAD_ID, SEP_ID
from gstx_torch.eval.metrics import NDCG, SparseGTMetrics, scores_to_ranks
from gstx_torch.models.encdec import (GSTVisualDialog,
                                      candidate_log_likelihood)

# the generative batch's per-sequence and per-image keys
TEXT_KEYS = ("enc_input_ids", "enc_segments", "enc_att_mask",
             "dec_input_ids", "dec_att_mask")
IMAGE_KEYS = ("enc_image_feat", "enc_image_loc", "enc_image_mask")


def make_chunk_scorer(model: GSTVisualDialog) -> Callable:
    """Scorer of one flattened chunk (a dict of device tensors) -> [N] f32
    log-likelihoods.

    The decoder inputs get EOS->PAD scrubbed (the reference's in-decoder
    label derivation, visual_dialog_decoder.py:53-57) while the candidate
    log-likelihood targets keep the EOS, so its probability is scored
    (evaluate_gen.py:98-106)."""

    def score_chunk(chunk):
        dec_ids = chunk["dec_input_ids"]
        dec_inputs = torch.where(dec_ids == SEP_ID, PAD_ID, dec_ids)
        # the [N, T, V] f32 logits live only inside this call
        return candidate_log_likelihood(model.score(
            chunk["enc_input_ids"], chunk["enc_image_feat"],
            chunk["enc_image_loc"], chunk["enc_segments"],
            chunk["enc_att_mask"], chunk["enc_image_mask"], dec_inputs,
            chunk["dec_att_mask"]), dec_ids, PAD_ID, model.vocab_tp)

    return score_chunk


def batch_to_device(text: Dict[str, np.ndarray],
                    images: Dict[str, np.ndarray], device,
                    feat_dtype: torch.dtype, feat_keys: Sequence[str]):
    """One batch on the device: ``text`` ([total, L] rows) as they are,
    ``images`` ([B, ...]) with ``feat_keys`` cast to ``feat_dtype``."""
    dev_text = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in text.items()}
    dev_images = {}
    for k, v in images.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        dev_images[k] = t.to(feat_dtype) if k in feat_keys else t
    return dev_text, dev_images


def chunk_inputs(text, images, start: int, stop: int, per_image: int,
                 rows: Optional[torch.Tensor] = None):
    """Rows [start, stop) of the flattened batch: the text rows sliced, and
    each row's image gathered (row // per_image), equal to the rows of the
    host broadcast ``x[:, None, None]`` -> [B, rounds, options, ...]
    reshaped to [total, ...] (``gstx/eval/rank_gen.py:107-112``).
    ``rows``, on the device: only the rows ``start + rows`` (a rank's share
    of the chunk)."""
    any_image = next(iter(images.values()))
    if rows is None:
        chunk = {k: v[start:stop] for k, v in text.items()}
        idx = torch.arange(start, stop, device=any_image.device)
    else:
        idx = rows + start
        chunk = {k: v.index_select(0, idx) for k, v in text.items()}
    idx = idx // per_image
    chunk.update({k: v.index_select(0, idx) for k, v in images.items()})
    return chunk


def rank_share(dp, n: int, device):
    """(this rank's rows of an ``n``-row chunk as a device tensor, which of
    them are real rows), or (None, None) without ``dp``."""
    if dp is None:
        return None, None
    rows, valid = dp.row_indices(n)
    return torch.from_numpy(rows).to(device), valid


def gather_scores(dp, local: torch.Tensor, n_chunks: int, cs: int):
    """A batch's scores as one host [n_chunks * cs] tensor: ``local`` as it
    is without ``dp``; else each rank's [n_chunks * per] share gathered
    to rank 0 and put back in order (None on the other ranks)."""
    if dp is None:
        return local.float().cpu()
    got = dp.gather_rows(local.float().reshape(n_chunks, -1).t(), cs)
    return None if got is None else got.t().reshape(-1)


def rank_candidates(score_chunk: Callable, batches, flatten: Callable,
                    mode: str, vd_version: str, chunk_size: int, logger,
                    device, feat_dtype: torch.dtype,
                    feat_keys: Sequence[str], stats_out=None, dp=None):
    """The ranking loop of both evaluators.  ``flatten(batch)`` returns
    ``(text, images, (B, rounds, options))``: the [total, L] host rows and
    the [B, ...] per-image arrays.  Every chunk of a batch is queued on the
    device before its scores come back to the host, once a batch.

    Returns the metrics dict (``vd_eval_val``) or the ranks list
    (``vd_eval_test``); under ``dp``, on rank 0 only (None elsewhere).
    ``stats_out``, a dict, receives this run's ``batches``, ``images``,
    scored ``sequences``, ``chunks``, ``loop_seconds`` (the batch loop's
    wall time, data loading included) and ``wait_seconds`` (the part of
    it spent waiting for ``batches``).
    """
    sparse = SparseGTMetrics()
    ndcg = NDCG()
    ranks_json: List[dict] = []
    totals = {"batches": 0, "images": 0, "sequences": 0, "chunks": 0,
              "wait_seconds": 0.0}
    t0 = time.perf_counter()
    batches = iter(batches)
    with torch.inference_mode():
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            totals["wait_seconds"] += time.perf_counter() - t_wait
            if batch is None:
                break
            text, images, (b, rounds, options) = flatten(batch)
            total = b * rounds * options
            cs = min(chunk_size, total)
            if total % cs:
                raise ValueError(f"{total} sequences do not split into "
                                 f"chunks of {cs}")
            dev_text, dev_images = batch_to_device(text, images, device,
                                                   feat_dtype, feat_keys)
            rows, _ = rank_share(dp, cs, device)
            out = [score_chunk(chunk_inputs(dev_text, dev_images, j, j + cs,
                                            rounds * options, rows))
                   for j in range(0, total, cs)]
            scores = gather_scores(dp, torch.cat(out), total // cs, cs)
            totals["batches"] += 1
            totals["images"] += b
            totals["sequences"] += total
            totals["chunks"] += total // cs
            if scores is None:
                continue  # a rank other than 0: its share is sent
            scores = scores.numpy().reshape(b, rounds, options)

            if mode == "vd_eval_val":
                sparse.observe(scores, batch["gt_option_inds"])
                if vd_version == "1.0":
                    rel_round = batch["round_id"][:, 0]  # 1-based
                    ndcg.observe(scores[np.arange(b), rel_round - 1],
                                 batch["gt_relevance"])
            else:
                ranks = scores_to_ranks(scores)[:, 0, :]
                for i in range(b):
                    ranks_json.append({
                        "image_id": int(batch["image_id"][i, 0]),
                        "round_id": int(batch["round_id"][i, 0]),
                        "ranks": [int(r) for r in ranks[i]],
                    })
    if stats_out is not None:
        stats_out.update(totals, loop_seconds=time.perf_counter() - t0)
    if dp is not None and dp.rank != 0:
        return None

    if mode == "vd_eval_val":
        metrics = {}
        metrics.update(sparse.retrieve(reset=True))
        if vd_version == "1.0":
            metrics.update(ndcg.retrieve(reset=True))
        if logger is not None:
            for k, v in metrics.items():
                logger.write(f"{k}: {v}")
        return metrics
    return ranks_json


def flatten_gen(batch):
    """A generative eval batch as [total, L] text rows and [B, ...] image
    arrays (``gstx/eval/rank_gen.py:98-104``)."""
    b, rounds, options = batch["enc_input_ids"].shape[:3]
    total = b * rounds * options
    text = {k: batch[k].reshape(total, batch[k].shape[-1])
            for k in TEXT_KEYS}
    return text, {k: batch[k] for k in IMAGE_KEYS}, (b, rounds, options)


def evaluate_gen(model: GSTVisualDialog, loader, mode: str = "vd_eval_val",
                 vd_version: str = "1.0", chunk_size: int = 500,
                 logger=None, stats_out=None, dp=None):
    """Run the generative evaluation of ``model`` over ``loader``'s
    collated batches (``VisdialGenDataset`` ``vd_eval_val`` /
    ``vd_eval_test`` items) on the model's device, across the ranks of
    ``dp`` when given.  See :func:`rank_candidates` for what it
    returns."""
    return rank_candidates(
        make_chunk_scorer(model), loader, flatten_gen, mode, vd_version,
        chunk_size, logger, model.device, model.dtype,
        ("enc_image_feat", "enc_image_loc"), stats_out, dp)
