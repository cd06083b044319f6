"""KV-cached autoregressive sampler (port of ``gstx/decode/sampler.py``,
lines 31-115).

The encoder's memory K/V are computed once per utterance; self-attention
K/V accumulate in a [B, H, max_steps + 1, Dh] cache written in place.
Sampling semantics: temperature, n-gram blocking against the question
history, top-k / nucleus filtering (or the fused top-k sampler), then a
multinomial draw; PAD after the first EOS.

One sampler iteration (:func:`iteration`) is a function of device state
only (:class:`DecodeState`): the token buffer, ``done`` and the position
``pos``, a 0-d int64 tensor that the iteration advances itself.  It embeds
the token at ``pos``, runs the model's cached step, applies the
temperature and the n-gram block, draws, writes the token at ``pos + 1``,
updates ``done`` and advances ``pos``.  :func:`sample_sequence` runs it
eagerly; :class:`CapturedSampler` captures it once as a CUDA graph and
replays the graph once a step, so that a step costs the host one replay in
place of the ~1,000 launches of its ops.  Both read ``done`` on the host
after every step and stop once every row has ended: a step after that
would move the generator, and so change later draws.

Under tensor parallelism the step's logits are the full vocab (gathered by
the model), every rank of the model group samples them, and the model
group's rank 0's tokens are broadcast, so that no rank can drift; ``done``
follows from the tokens, so every rank leaves the loop on the same step.
That path runs eagerly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gstx_torch import kernels
from gstx_torch.core import profiling
from gstx_torch.core.config import CLS_ID, PAD_ID, SEP_ID
# called through this module's names, so that a patch of them here (a fault
# injected into the sampled tokens) reaches the eager and the captured
# iteration alike
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


class DecodeState(NamedTuple):
    """The device state of one utterance's decode, which an iteration reads
    and updates in place."""

    tokens: torch.Tensor  # [B, max_steps + 1] int64: BOS, then the draws
    done: torch.Tensor    # [B] bool: the row has drawn EOS
    pos: torch.Tensor     # 0-d int64: the position of the token fed next


def new_state(batch: int, max_steps: int, bos_id: int = CLS_ID,
              device="cuda") -> DecodeState:
    state = DecodeState(
        tokens=torch.zeros((batch, max_steps + 1), dtype=torch.long,
                           device=device),
        done=torch.zeros(batch, dtype=torch.bool, device=device),
        pos=torch.zeros((), dtype=torch.long, device=device))
    state.tokens[:, 0] = bos_id
    return state


def reset_state(state: DecodeState, bos_id: int = CLS_ID) -> None:
    """Back to the start of an utterance, in place."""
    state.tokens.zero_()
    state.tokens[:, 0] = bos_id
    state.done.zero_()
    state.pos.zero_()


def iteration(step_fn, generator: torch.Generator, state: DecodeState,
              caches, settings: DecodeSettings,
              ngram_source: Optional[torch.Tensor] = None,
              eos_id: int = SEP_ID, tp=None) -> None:
    """One sampler iteration on device state only (see the module's
    docstring); it reads nothing back to the host, so a CUDA graph can
    capture it.  ``step_fn(token_ids [B,1], pos, caches) -> logits [B,V]``
    takes ``pos`` as a 0-d tensor.  ``tp``: the model group whose rank 0's
    tokens every rank takes (a broadcast: eager only)."""
    tokens, done, pos = state
    with profiling.span("gstx:decode.model"):
        logits = step_fn(tokens.index_select(1, pos.view(1)), pos, caches)
    with profiling.span("gstx:decode.sample"):
        logits = logits / settings.temperature
        if settings.ngram_blocking_size > 0 and ngram_source is not None:
            logits = ngram_block(logits, ngram_source, tokens, pos + 1,
                                 settings.ngram_blocking_size)
        if settings.fused_sampler and 0 < settings.top_k <= 16 \
                and settings.top_p <= 0.0:
            nxt = sample_token_topk(generator, logits, settings.top_k)
        else:
            logits = top_k_top_p_filter(logits, settings.top_k,
                                        settings.top_p)
            nxt = sample_token(generator, logits)
        if tp is not None:
            nxt = tp.broadcast(nxt)
        tokens.index_copy_(1, (pos + 1).view(1), nxt[:, None])
        done |= nxt == eos_id
        pos += 1


def iteration_ops():
    """The functions :func:`iteration` calls through this module's names,
    as they stand now: a graph replays the ones it was captured with."""
    return ngram_block, sample_token, sample_token_topk, top_k_top_p_filter


def sample_sequence(step_fn, generator: torch.Generator, batch: int, caches,
                    settings: DecodeSettings,
                    ngram_source: Optional[torch.Tensor] = None,
                    bos_id: int = CLS_ID, eos_id: int = SEP_ID,
                    device="cuda", tp=None):
    """Run up to ``settings.max_steps`` cached decode steps, eagerly.

    ``step_fn(token_ids [B,1], pos, caches) -> logits [B,V]`` is the decode
    step, closed over memory K/V and weights; it updates ``caches`` in
    place; ``pos`` is a 0-d int64 tensor on ``device``.  ``ngram_source``
    [B, S] holds the n-grams to ban.  Returns the sampled sequence [B,
    max_steps] with PAD after the first EOS.

    The loop stops early once every row has emitted EOS: the skipped steps
    would only produce tokens that pad_after_eos discards.  That test reads
    ``done`` on the host, one device sync per step.  ``tp``: the model
    group whose rank 0's tokens every rank takes (a broadcast a step).
    """
    state = new_state(batch, settings.max_steps, bos_id, device)
    return _utterance(state, settings.max_steps, eos_id, lambda: iteration(
        step_fn, generator, state, caches, settings, ngram_source, eos_id,
        tp))


def _utterance(state: DecodeState, max_steps: int, eos_id: int, step):
    """Call ``step`` (one iteration on ``state``) until every row has ended
    or ``max_steps`` times; the sequence with PAD after the first EOS."""
    profiling.count("decode.utterances")
    with profiling.span("gstx:decode.utterance"):
        for _ in range(max_steps):
            profiling.count("decode.steps")
            with profiling.span("gstx:decode.step"):
                step()
                with profiling.sync_span("gstx:decode.sync", "engine"):
                    finished = bool(state.done.all())
            if finished:
                break
        return pad_after_eos(state.tokens[:, 1:], eos_id, PAD_ID)


class CapturedSampler:
    """:func:`iteration` captured once as a CUDA graph over static buffers,
    replayed once a step by :meth:`sample`.

    The graph reads what ``step_fn`` closes over (the memory K/V and mask,
    which the caller refills before each utterance), ``ngram_source`` and
    the caches, and owns its :class:`DecodeState`.  ``generator`` is the
    one generator registered with the graph: a replay draws from its state
    as it stands and advances it by the graph's draws, so :meth:`sample`
    gives it the caller's generator's state first and hands the advanced
    state back: the same draws, and the same state after them, as the eager
    loop's.  ``pool`` and ``stream``: the memory pool and capture stream
    that every capture of a caller shares; graphs that share them must
    replay one at a time.
    """

    WARMUP_ITERATIONS = 3

    def __init__(self, step_fn, batch: int, caches, settings: DecodeSettings,
                 ngram_source: Optional[torch.Tensor],
                 generator: torch.Generator, pool, stream,
                 bos_id: int = CLS_ID, eos_id: int = SEP_ID):
        self.caches, self.settings = caches, settings
        self.bos_id, self.eos_id = bos_id, eos_id
        self.generator = generator
        self.state = new_state(batch, settings.max_steps, bos_id,
                               caches[0]["k"].device)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        self._launches = _capture(
            self.graph, lambda: iteration(step_fn, generator, self.state,
                                          caches, settings, ngram_source,
                                          eos_id),
            pool, stream, min(self.WARMUP_ITERATIONS, settings.max_steps))
        profiling.count("decode.graph_captures")

    def _replay(self) -> None:
        with profiling.span("gstx:decode.replay"):
            self.graph.replay()
        profiling.count("decode.graph_replays")
        for c, k, n in self._launches:
            c[k] += n

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """One utterance from the buffers as they stand, drawing from
        ``generator`` (advanced as the eager loop would); [B, max_steps]
        with PAD after the first EOS."""
        reset_state(self.state, self.bos_id)
        for cache in self.caches:
            for t in cache.values():
                t.zero_()
        self.generator.set_state(generator.get_state())
        seq = _utterance(self.state, self.settings.max_steps, self.eos_id,
                         self._replay)
        generator.set_state(self.generator.get_state())
        return seq


def _capture(graph, fn, pool, stream, warmup: int):
    """Call ``fn`` ``warmup`` times eagerly on ``stream`` (lazy
    initialisation: the kernels' build, library handles and workspaces),
    then capture one call into ``graph``.  The kernel wrappers count their
    launches in Python, which a replay does not run: returns (counter, key,
    launches) of what the capture counted in every registered counter
    (``gstx_torch.kernels.launch_counters``), taken off the counters, for
    each replay to add."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    current.wait_stream(stream)
    before = [dict(c) for c in kernels.launch_counters()]
    # thread_local: another thread's CUDA calls (a prefetch thread pinning
    # host memory) do not break this thread's capture
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        fn()
    launches = [(c, k, c[k] - b[k])
                for c, b in zip(kernels.launch_counters(), before)
                for k in c if c[k] != b[k]]
    for c, k, n in launches:
        c[k] -= n
    return launches
