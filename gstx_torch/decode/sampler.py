"""KV-cached autoregressive sampler (port of ``gstx/decode/sampler.py``,
lines 31-115).

The encoder's memory K/V are computed once per utterance; self-attention
K/V accumulate in a [B, H, max_steps + 1, Dh] cache written in place.
Sampling semantics: temperature, n-gram blocking against the question
history, top-k / nucleus filtering (or the fused top-k sampler), then a
multinomial draw; PAD after the first EOS.

Under tensor parallelism the step's logits are the full vocab (gathered by
the model), every rank of the model group samples them, and the model
group's rank 0's tokens are broadcast, so that no rank can drift; ``done``
follows from the tokens, so every rank leaves the loop on the same step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gstx_torch.core import profiling
from gstx_torch.core.config import CLS_ID, PAD_ID, SEP_ID
from gstx_torch.ops.sampling import (
    ngram_block,
    pad_after_eos,
    sample_token,
    sample_token_topk,
    top_k_top_p_filter,
)


class DecodeSettings(NamedTuple):
    """Static sampling configuration."""

    max_steps: int = 18
    temperature: float = 0.7
    top_k: int = 7
    top_p: float = 0.0
    ngram_blocking_size: int = 4
    fused_sampler: bool = False  # top-k extract + categorical over k


def init_cache(dec_config, batch: int, max_len: int, dtype=torch.float32,
               device="cuda", heads: Optional[int] = None):
    """Per-layer zero KV caches (updated in place by the decode steps);
    ``heads``: the heads a rank computes under tensor parallelism
    (``model.dec.local_heads``; default all of them)."""
    dh = dec_config.hidden_size // dec_config.num_attention_heads
    h = dec_config.num_attention_heads if heads is None else heads
    shape = (batch, h, max_len, dh)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(dec_config.num_hidden_layers)]


def sample_sequence(step_fn, generator: torch.Generator, batch: int, caches,
                    settings: DecodeSettings,
                    ngram_source: Optional[torch.Tensor] = None,
                    bos_id: int = CLS_ID, eos_id: int = SEP_ID,
                    device="cuda", tp=None):
    """Run up to ``settings.max_steps`` cached decode steps.

    ``step_fn(token_ids [B,1], pos, caches) -> logits [B,V]`` is the decode
    step, closed over memory K/V and weights; it updates ``caches`` in
    place.  ``ngram_source`` [B, S] holds the n-grams to ban.  Returns the
    sampled sequence [B, max_steps] with PAD after the first EOS.

    The loop stops early once every row has emitted EOS: the skipped steps
    would only produce tokens that pad_after_eos discards.  That test reads
    ``done`` on the host, one device sync per step.  ``tp``: the model
    group whose rank 0's tokens every rank takes (a broadcast a step).
    """
    profiling.count("decode.utterances")
    with profiling.span("gstx:decode.utterance"):
        return _sample(step_fn, generator, batch, caches, settings,
                       ngram_source, bos_id, eos_id, device, tp)


def _sample(step_fn, generator, batch, caches, settings, ngram_source,
            bos_id, eos_id, device, tp):
    tokens = torch.zeros((batch, settings.max_steps + 1), dtype=torch.long,
                         device=device)
    tokens[:, 0] = bos_id
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    fused = settings.fused_sampler and 0 < settings.top_k <= 16 \
        and settings.top_p <= 0.0
    for step in range(settings.max_steps):
        profiling.count("decode.steps")
        with profiling.span("gstx:decode.step"):
            with profiling.span("gstx:decode.model"):
                logits = step_fn(tokens[:, step:step + 1], step, caches)
            with profiling.span("gstx:decode.sample"):
                logits = logits / settings.temperature
                if settings.ngram_blocking_size > 0 and \
                        ngram_source is not None:
                    logits = ngram_block(logits, ngram_source, tokens,
                                         step + 1,
                                         settings.ngram_blocking_size)
                if fused:
                    nxt = sample_token_topk(generator, logits,
                                            settings.top_k)
                else:
                    logits = top_k_top_p_filter(logits, settings.top_k,
                                                settings.top_p)
                    nxt = sample_token(generator, logits)
                if tp is not None:
                    nxt = tp.broadcast(nxt)
                tokens[:, step + 1] = nxt
                done |= nxt == eos_id
            with profiling.sync_span("gstx:decode.sync", "engine"):
                finished = bool(done.all())
        if finished:
            break
    return pad_after_eos(tokens[:, 1:], eos_id, PAD_ID)
