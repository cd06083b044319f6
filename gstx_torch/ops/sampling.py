"""Decoding / sampling ops (port of ``gstx/ops/sampling.py``, lines
103-231).

  * :func:`sample_token_topk` -- fused top-k extract + categorical over the
    k candidates (the engine's default sampler);
  * :func:`top_k_filter` / :func:`top_p_filter` -- batched top-k (ties at
    the k-th value kept) and nucleus filtering;
  * :func:`ngram_block` -- n-gram repetition blocking against the encoder
    input sequence, a vectorised windowed match;
  * :func:`sample_token` -- multinomial sampling;
  * :func:`pad_after_eos` -- PAD fill after the first EOS.

Random draws come from an explicit ``torch.Generator``; they are not JAX's
threefry numbers, so sampled tokens agree with the JAX package in
distribution only (greedy decoding agrees token for token).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gstx_torch.core.config import SPECIAL_TOKEN_IDS

NEG_INF = -1e9  # stands in for float('-inf'); never survives a softmax


def sample_token_topk(generator: torch.Generator, logits, k: int):
    """Sample from softmax over the k largest logits of each row; returns
    [B] int64 token ids.  Distribution-identical to ``sample_token(
    top_k_filter(logits, k))`` except that exact ties at the k-th value are
    cut to exactly k candidates."""
    vals, idx = torch.topk(logits, min(k, logits.shape[-1]), dim=-1)
    probs = torch.softmax(vals.float(), dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return idx.gather(-1, choice)[..., 0]


def top_k_filter(logits, top_k: int):
    """Keep the k highest logits per row; ties at the k-th value are kept
    (the reference's ``logits < kth -> -inf``)."""
    if top_k <= 0:
        return logits
    k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_filter(logits, top_p: float):
    """Nucleus filtering: sort descending, drop tokens once the cumulative
    probability exceeds top_p, shifted right so the first token crossing
    the threshold is kept.  The order of equal logits follows JAX's
    reversed stable ascending sort."""
    if top_p <= 0.0:
        return logits
    sorted_idx = torch.sort(logits, dim=-1, stable=True).indices.flip(-1)
    sorted_logits = logits.gather(-1, sorted_idx)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                       dim=-1)
    remove_vocab = torch.zeros_like(remove).scatter(-1, sorted_idx, remove)
    return torch.where(remove_vocab, NEG_INF, logits)


def top_k_top_p_filter(logits, top_k: int = 0, top_p: float = 0.0):
    return top_p_filter(top_k_filter(logits, top_k), top_p)


def ngram_block(logits, source_ids, dec_input_ids, cur_len: int,
                ngram_size: int,
                special_token_ids: Tuple[int, ...] = SPECIAL_TOKEN_IDS):
    """Ban token x if the n-gram (last n-1 generated tokens, x) occurs in
    ``source_ids`` [B, S] with no special token inside the n-gram window.
    ``dec_input_ids`` [B, T] is the generated prefix (incl. BOS), of which
    ``cur_len`` tokens are valid.  Blocking is a no-op while
    cur_len < n-1 (the reference's dict lookup never matches then)."""
    n = ngram_size
    if n <= 0:
        return logits
    b, s = source_ids.shape
    if s < n or cur_len < n - 1:
        return logits
    windows = source_ids.unfold(1, n, 1)  # [B, S-n+1, n]
    specials = torch.tensor(special_token_ids, device=source_ids.device,
                            dtype=source_ids.dtype)
    has_special = torch.isin(windows, specials).any(-1)
    t = dec_input_ids.shape[1]
    start = min(max(cur_len - (n - 1), 0), t - (n - 1))
    tail = dec_input_ids[:, start:start + n - 1]
    match = (windows[..., :n - 1] == tail[:, None, :]).all(-1)
    active = match & ~has_special
    # a token banned by several windows: count, then test > 0 (a plain
    # scatter of booleans would let duplicate indices overwrite each other)
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hits.scatter_add_(-1, windows[..., n - 1].long(), active.int())
    return torch.where(hits > 0, NEG_INF, logits)


def sample_token(generator: torch.Generator, logits):
    """Multinomial sample from softmax(logits); returns [B] int64."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def pad_after_eos(sequence, eos_id: int, pad_id: int = 0):
    """Replace everything strictly after the first EOS with PAD."""
    is_eos = (sequence == eos_id).int()
    after = torch.cumsum(is_eos, dim=-1) - is_eos
    return torch.where(after > 0, pad_id, sequence)
