"""Discriminative ranking evaluation: a candidate's score is the NSP
softmax probability of the "is-next" class (the port of
``gstx/eval/rank_disc.py``; reference ``evaluate_disc.py:22-120``).

[B, rounds, options] full-sequence candidates are scored by
``softmax(seq_relationship)[:, 0]`` (:79-83) in chunks (reference 200)
and reduced to the same metrics as the generative evaluator, through its
loop (:func:`gstx_torch.eval.rank_gen.rank_candidates`, whose docstring
lists what differs from the JAX evaluator).
"""

from __future__ import annotations

from typing import Callable

import torch

from gstx_torch.data.encode import nsp_attention_mask
from gstx_torch.eval.rank_gen import rank_candidates
from gstx_torch.models.encdec import GSTVisualDialog

IMAGE_KEYS = ("image_feat", "image_loc", "image_mask")


def make_nsp_scorer(model: GSTVisualDialog) -> Callable:
    """Scorer of one flattened chunk -> [N] f32 is-next probabilities."""

    def score_chunk(chunk):
        nsp = model.nsp_scores(
            chunk["tokens"], chunk["image_feat"], chunk["image_loc"],
            chunk["segments"], chunk["att_mask"], chunk["image_mask"])
        return torch.softmax(nsp.float(), dim=-1)[:, 0]

    return score_chunk


def flatten_disc(batch):
    """A discriminative eval batch as [total, L] text rows, with the
    attention mask over each sequence up to its hist_len-th SEP
    (``gstx/eval/rank_disc.py:78-86``), and [B, ...] image arrays."""
    b, rounds, options = batch["tokens"].shape[:3]
    total = b * rounds * options
    seq_len = batch["tokens"].shape[-1]
    text = {k: batch[k].reshape(total, batch[k].shape[-1])
            for k in ("tokens", "segments")}
    text["att_mask"] = nsp_attention_mask(
        batch["sep_indices"].reshape(total, -1),
        batch["hist_len"].reshape(total), seq_len)
    return text, {k: batch[k] for k in IMAGE_KEYS}, (b, rounds, options)


def evaluate_disc(model: GSTVisualDialog, loader, mode: str = "vd_eval_val",
                  vd_version: str = "1.0", chunk_size: int = 200,
                  logger=None, stats_out=None, dp=None):
    """Run the discriminative evaluation of ``model`` (an encoder-only
    model, or a full one whose encoder is used) over ``loader``'s collated
    ``VisdialDiscDataset`` batches on the model's device, across the ranks
    of ``dp`` when given (``gstx/eval/rank_disc.py:96-98``)."""
    return rank_candidates(
        make_nsp_scorer(model), loader, flatten_disc, mode, vd_version,
        chunk_size, logger, model.device, model.dtype,
        ("image_feat", "image_loc"), stats_out, dp)
