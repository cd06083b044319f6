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

Every op here reads nothing back to the host, so a CUDA graph can capture
them (``gstx_torch/decode/sampler.py``'s captured decode step): the draw is
written out (:func:`draw`), and :func:`ngram_block` takes its length as a
tensor on the device.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

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
    return idx.gather(-1, draw(generator, probs))[..., 0]


def draw(generator: torch.Generator, probs):
    """One index a row of ``probs`` [B, N], drawn with those probabilities:
    [B, 1] int64.  This is the draw ``torch.multinomial(probs, 1,
    generator=generator)`` makes, written out: ``argmax(probs / q)`` with
    ``q ~ Exp(1)`` from the same generator, so the same indices and the same
    generator state after it.  Outside a CUDA graph's capture it makes
    multinomial's check that the probabilities are finite, non-negative and
    sum above 0, and raises as multinomial does; the check reads the device
    from the host, which a capture cannot hold, so a captured draw goes
    without it."""
    if not (probs.is_cuda and torch.cuda.is_current_stream_capturing()):
        _check_probs(probs)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / q).argmax(-1, keepdim=True)


def _check_probs(probs) -> None:
    """``torch.multinomial``'s check of its probabilities, one read."""
    valid, positive = torch.stack([
        ((probs >= 0) & (probs < float("inf"))).all(),
        (probs.sum(-1) > 0).all()]).tolist()
    if not valid:
        raise RuntimeError(
            "probability tensor contains either `inf`, `nan` or element < 0")
    if not positive:
        raise RuntimeError(
            "invalid multinomial distribution (sum of probabilities <= 0)")


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


@functools.lru_cache(maxsize=None)
def _id_tensor(ids: Tuple[int, ...], device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """``ids`` as a tensor on ``device``, made once: a host-to-device copy
    from pageable memory cannot be captured in a CUDA graph."""
    return torch.tensor(ids, device=device, dtype=dtype)


def ngram_block(logits, source_ids, dec_input_ids,
                cur_len: Union[int, torch.Tensor], ngram_size: int,
                special_token_ids: Tuple[int, ...] = SPECIAL_TOKEN_IDS):
    """Ban token x if the n-gram (last n-1 generated tokens, x) occurs in
    ``source_ids`` [B, S] with no special token inside the n-gram window.
    ``dec_input_ids`` [B, T] is the generated prefix (incl. BOS), of which
    ``cur_len`` tokens are valid: a Python int, or a 0-d int64 tensor on the
    device (the captured decode step's), read there and never on the host.
    The generated tail is gathered by device indices, and the rule that
    blocking is a no-op while cur_len < n-1 (the reference's dict lookup
    never matches then) is a mask, as the JAX version gates it."""
    n = ngram_size
    if n <= 0:
        return logits
    b, s = source_ids.shape
    t = dec_input_ids.shape[1]
    if s < n or t < n - 1:
        return logits  # no window, or no tail of n-1 tokens, can match
    windows = source_ids.unfold(1, n, 1)  # [B, S-n+1, n]
    specials = _id_tensor(tuple(special_token_ids), source_ids.device,
                          source_ids.dtype)
    has_special = torch.isin(windows, specials).any(-1)
    # an int becomes a CPU scalar, which an op on the device takes as such
    cur = torch.as_tensor(cur_len)
    start = (cur - (n - 1)).clamp(0, t - (n - 1))
    tail = dec_input_ids.index_select(
        1, start + torch.arange(n - 1, device=dec_input_ids.device))
    match = (windows[..., :n - 1] == tail[:, None, :]).all(-1)
    active = match & ~has_special & (cur >= n - 1)
    # a token banned by several windows: count, then test > 0 (a plain
    # scatter of booleans would let duplicate indices overwrite each other)
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hits.scatter_add_(-1, windows[..., n - 1].long(), active.int())
    return torch.where(hits > 0, NEG_INF, logits)


def sample_token(generator: torch.Generator, logits):
    """Multinomial sample from softmax(logits); returns [B] int64."""
    probs = torch.softmax(logits.float(), dim=-1)
    return draw(generator, probs)[..., 0]


def pad_after_eos(sequence, eos_id: int, pad_id: int = 0):
    """Replace everything strictly after the first EOS with PAD."""
    is_eos = (sequence == eos_id).int()
    after = torch.cumsum(is_eos, dim=-1) - is_eos
    return torch.where(after > 0, pad_id, sequence)
