"""KV-cached beam search (port of ``gstx/decode/beam.py``, lines 1-125).

Beams fold into the batch dimension: every cache tensor has B·K rows, and
after each step the rows are reordered in place to follow their parent
beams.  Semantics are JAX's: length-unnormalized log-prob beam search
(optional GNMT length penalty via ``alpha``), EOS-terminated; finished
beams continue with PAD only, at an unchanged score.

Differences from the JAX module, none of which changes what is computed:
  * the decode step updates its caches in place, so the parents' reorder
    (JAX's ``_gather_beams``) is an ``index_select`` of each cache tensor's
    B·K rows copied back into it;
  * the loop is a Python loop over all ``max_steps`` with no host sync
    inside it, as JAX's ``lax.scan`` runs them all;
  * ``torch.topk`` does not promise JAX's lowest-index order among exactly
    tied candidates: a tie may pick another sequence of the same score.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from gstx_torch.core.config import CLS_ID, PAD_ID, SEP_ID
from gstx_torch.ops.sampling import pad_after_eos

NEG_INF = -1e9


class BeamState(NamedTuple):
    tokens: torch.Tensor     # [B, K, T+1] int64, BOS first
    scores: torch.Tensor     # [B, K] f32 cumulative log-prob
    finished: torch.Tensor   # [B, K] bool
    caches: object           # cache tensors with leading dim B*K


def _map(fn, tree):
    """``fn`` over every tensor of a tree of lists, tuples, NamedTuples and
    dicts; other leaves (None, numbers) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _leaves(tree):
    out = []
    _map(out.append, tree)
    return out


def _reorder_(caches, rows):
    """Reorder every cache tensor's leading B·K rows by ``rows`` in place
    (``gstx/decode/beam.py:33-41``)."""
    _map(lambda t: t.copy_(t.index_select(0, rows)), caches)


def tile_for_beams(tree, num_beams: int):
    """Repeat batch-leading tensors K times: [B, ...] -> [B*K, ...] (the
    memory K/V, its int8 form with its scales, and the memory mask)."""
    return _map(lambda t: t.repeat_interleave(num_beams, dim=0), tree)


def beam_steps(step_fn, init_caches, batch: int, num_beams: int,
               max_steps: int, bos_id: int = CLS_ID, eos_id: int = SEP_ID,
               pad_id: int = PAD_ID) -> BeamState:
    """Run all ``max_steps`` steps of the search and return the final
    :class:`BeamState` (every beam, unranked).

    ``step_fn(tokens [B*K, 1], pos, caches) -> logits [B*K, V]`` is the
    decode step with the memory K/V tiled to B*K rows; it updates
    ``caches`` (leading dim B*K) in place, and so does the search."""
    k = num_beams
    t_max = max_steps + 1
    device = _leaves(init_caches)[0].device
    tokens = torch.zeros((batch, k, t_max), dtype=torch.long, device=device)
    tokens[:, :, 0] = bos_id
    # only beam 0 is live initially (identical prefixes would duplicate)
    scores = torch.full((batch, k), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((batch, k), dtype=torch.bool, device=device)
    base = torch.arange(batch, device=device)[:, None] * k
    pad_only = None
    for step in range(max_steps):
        cur = tokens.reshape(batch * k, t_max)[:, step:step + 1]
        logits = step_fn(cur, step, init_caches)
        vocab = logits.shape[-1]
        logp = F.log_softmax(logits.float(), dim=-1).reshape(batch, k, vocab)
        if pad_only is None:
            pad_only = torch.full((vocab,), NEG_INF, device=device)
            pad_only[pad_id] = 0.0
        # finished beams: only the PAD continuation, score unchanged
        logp = torch.where(finished[:, :, None], pad_only, logp)
        total = scores[:, :, None] + logp
        scores, top_idx = torch.topk(total.reshape(batch, k * vocab), k)
        parents = top_idx // vocab
        next_tok = top_idx % vocab
        tokens = tokens.gather(1, parents[:, :, None].expand(-1, -1, t_max))
        finished = finished.gather(1, parents)
        _reorder_(init_caches, (base + parents).reshape(-1))
        tokens[:, :, step + 1] = next_tok
        finished = finished | (next_tok == eos_id)
    return BeamState(tokens, scores, finished, init_caches)


def best_beam(state: BeamState, alpha: float = 0.0, eos_id: int = SEP_ID,
              pad_id: int = PAD_ID) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best beam of each row: (tokens [B, max_steps] with PAD after the
    first EOS, its unpenalized score [B]).  With ``alpha > 0`` beams rank
    by the GNMT length penalty over their non-PAD length; ``argmax`` takes
    the first of tied beams, as JAX's does."""
    tokens, scores = state.tokens[:, :, 1:], state.scores
    ranked = scores
    if alpha > 0.0:
        lengths = (tokens != pad_id).sum(-1).float()
        ranked = scores / ((5.0 + lengths) / 6.0) ** alpha
    best = ranked.argmax(dim=1)
    seq = tokens.gather(1, best[:, None, None].expand(
        -1, 1, tokens.shape[-1]))[:, 0]
    return (pad_after_eos(seq, eos_id, pad_id),
            scores.gather(1, best[:, None])[:, 0])


def beam_search(step_fn, init_caches, batch: int, num_beams: int,
                max_steps: int, bos_id: int = CLS_ID, eos_id: int = SEP_ID,
                pad_id: int = PAD_ID, alpha: float = 0.0):
    """Run beam search (:func:`beam_steps`, then :func:`best_beam`).

    Returns (best_tokens [B, max_steps], best_scores [B])."""
    state = beam_steps(step_fn, init_caches, batch, num_beams, max_steps,
                       bos_id, eos_id, pad_id)
    return best_beam(state, alpha, eos_id, pad_id)
