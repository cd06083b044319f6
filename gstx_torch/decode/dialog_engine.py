"""The GST synthetic-dialog engine: questioner <-> teacher loop (port of
``gstx/decode/dialog_engine.py``, lines 33-391).

For each image, ``num_rounds`` rounds of: sample a question, append it to
the context, sample an answer, score the answer's perplexity, append the
answer.  Per round: two encoder forwards (questioner and teacher), two
KV-cached decodes, one teacher-forced scoring pass over the teacher's
cached memory.

Differences from the JAX engine, none of which changes the math:
  * PyTorch runs eagerly, so a round is a Python function and the decode
    loop a Python loop with an early-EOS exit read on the host; on a card,
    each decode step is one replay of a CUDA graph captured at first use,
    one a model, batch, memory width and settings (:class:`DecodeGraphs`),
    where the JAX engine compiles a round as one program;
  * the dialog context and the KV caches are updated in place;
  * the models carry their weights; the engine casts them to its dtype in
    place on first use (the JAX engine's one-time precast);
  * no device mesh: a model built with a model group (tensor parallelism)
    computes its rank's heads, the engine casts the rank's shards, the KV
    caches hold the rank's heads and the int8 memory quantizes them (one
    scale per head and channel, so sharding by head keeps it exact); each
    decode step's tokens are model-group rank 0's (the sampler's
    broadcast).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gstx_torch import kernels
from gstx_torch.core import profiling
from gstx_torch.core.config import CLS_ID, PAD_ID, SEP_ID
from gstx_torch.core.device import resolve_device
from gstx_torch.decode.sampler import (CapturedSampler, DecodeSettings,
                                       init_cache, iteration_ops,
                                       sample_sequence)
from gstx_torch.models import decoder as tdecoder
from gstx_torch.models.encdec import (GSTVisualDialog,
                                      derive_labels_and_inputs, precast_,
                                      teacher_forced_nll)


class DialogState(NamedTuple):
    enc_input_ids: torch.Tensor   # [B, S] int64
    enc_segments: torch.Tensor    # [B, S] int64
    enc_len: torch.Tensor         # [B] int64, number of valid tokens
    abnormal: torch.Tensor        # [B] bool, an overflow happened


class DialogOutput(NamedTuple):
    questions: torch.Tensor       # [R, B, T]
    answers: torch.Tensor         # [R, B, T]
    answer_ppl: torch.Tensor      # [R, B]
    abnormal: torch.Tensor        # [B]
    final_state: DialogState


def append_utterance(state: DialogState, utt, utt_len, segment: int,
                     write_segments: bool
                     ) -> Tuple[DialogState, torch.Tensor]:
    """Append each sample's utterance [B, T] (``utt_len`` tokens) at its
    current context length.  If start + len exceeds the context, a single
    SEP is written instead, the length becomes 1 and the sample is marked
    abnormal.  Returns (new_state, effective_len).

    JAX scatters with ``mode="drop"`` into a new array; here each context
    slot takes the utterance token at offset ``slot - start`` where that
    offset is a valid one (an explicit valid-slot mask; slots past the
    context fall away), and the context is rewritten in place."""
    s = state.enc_input_ids.shape[1]
    t = utt.shape[1]
    start = state.enc_len
    overflow = (start + utt_len) > s
    sep_only = torch.zeros_like(utt)
    sep_only[:, 0] = SEP_ID
    eff_utt = torch.where(overflow[:, None], sep_only, utt)
    eff_len = torch.where(overflow, 1, utt_len)

    slot = torch.arange(s, device=utt.device)[None, :]     # [1, S]
    off = slot - start[:, None]                            # [B, S]
    valid = (off >= 0) & (off < eff_len[:, None])
    src = eff_utt.gather(1, off.clamp(0, t - 1))
    state.enc_input_ids.copy_(torch.where(valid, src, state.enc_input_ids))
    if write_segments:
        state.enc_segments.masked_fill_(valid, segment)
    return DialogState(
        enc_input_ids=state.enc_input_ids,
        enc_segments=state.enc_segments,
        enc_len=start + eff_len,
        abnormal=state.abnormal | overflow,
    ), eff_len


def captures(model: GSTVisualDialog, device: torch.device) -> bool:
    """Whether the engine runs ``model``'s decode steps as CUDA graph
    replays: on a card, with the whole model in this process.  Under a
    model group the step's broadcast and collectives run eagerly."""
    return device.type == "cuda" and model.tp is None


class DecodeGraphs:
    """An engine's captured decode steps (:class:`CapturedSampler`), made at
    first use, one a (model, settings, memory shapes, n-gram source shape,
    kernel switches, sampler functions): in the engine, a model's question
    or answer at each memory width.  A graph replays the model as it was
    when it was captured: a later patch of the model's code does not reach
    it (a switch of a kernel, or a patch of the sampler's functions, takes
    a new graph).

    Each model's memory K/V and mask live in one static buffer each, sized
    at the engine's full width; a width's graph reads a contiguous prefix of
    them, laid out with the strides of the memory it stands for (so its
    products see the layouts the eager step sees), and every utterance
    copies its memory (and its n-gram source) into them before it replays.
    Memory that does not fit (a larger batch than before) takes new
    buffers, and the model's graphs are captured again.  The graphs share
    one memory pool, one capture stream and one generator of the engine's,
    registered with each; they replay one at a time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.generator = torch.Generator(device)
        self.memory = {}    # model -> flat buffers, one a memory tensor
        self.samplers = {}  # key -> (CapturedSampler, views, n-gram buffer)

    def sample(self, model, settings: DecodeSettings, mem_kv, mem_mask,
               ngram_source, generator: torch.Generator, full_width: int):
        """``sample_sequence``'s result for this utterance's memory, drawn
        from ``generator``; ``full_width``: the widest memory the engine
        can give ``model``."""
        tensors = [t for layer in mem_kv for t in layer] + [mem_mask]
        # what a capture fixes besides the shapes: the kernels' switches
        # and the sampler's functions as they stand
        key = (model, settings,
               tuple((t.shape, t.stride(), t.dtype)
                     for t in list(mem_kv[0]) + [mem_mask]),
               None if ngram_source is None else ngram_source.shape,
               kernels.switches(), iteration_ops())
        flats = self._buffers(model, tensors, full_width)
        entry = self.samplers.get(key)
        if entry is None:
            entry = self.samplers[key] = self._capture(
                model, settings, mem_kv, tensors, flats, ngram_source)
        sampler, views, ngram = entry
        for dst, src in zip(views, tensors):
            dst.copy_(src)
        if ngram is not None:
            ngram.copy_(ngram_source)
        return sampler.sample(generator)

    def _buffers(self, model, tensors, full_width: int):
        # the memory is dense (a permutation of a contiguous tensor), so a
        # view with its strides spans its number of elements
        width = tensors[-1].shape[-1]
        need = [-(-t.numel() * full_width // width) for t in tensors]
        flats = self.memory.get(model)
        if flats is None or any(f.numel() < n for f, n in zip(flats, need)):
            self.samplers = {k: v for k, v in self.samplers.items()
                             if k[0] is not model}
            self.memory.pop(model, None)
            flats = self.memory[model] = [
                torch.zeros(n, dtype=t.dtype, device=self.device)
                for n, t in zip(need, tensors)]
        return flats

    def _capture(self, model, settings, mem_kv, tensors, flats,
                 ngram_source):
        views = [f.as_strided(t.shape, t.stride())
                 for f, t in zip(flats, tensors)]
        per_layer = len(mem_kv[0])
        kv = [tuple(views[i:i + per_layer])
              for i in range(0, len(views) - 1, per_layer)]
        mask = views[-1]
        ngram = None if ngram_source is None else \
            torch.zeros_like(ngram_source)
        batch = mask.shape[0]
        caches = init_cache(model.dec_config, batch, settings.max_steps + 1,
                            model.dtype, self.device, model.dec.local_heads)

        def step_fn(tok, pos, caches):
            return model.decode_step(tok, pos, caches, kv, mask)
        sampler = CapturedSampler(step_fn, batch, caches, settings, ngram,
                                  self.generator, self.pool, self.stream,
                                  bos_id=CLS_ID, eos_id=SEP_ID)
        return sampler, views, ngram


def make_dialog_engine(num_rounds: int = 10,
                       q_settings: DecodeSettings = DecodeSettings(
                           ngram_blocking_size=4),
                       a_settings: DecodeSettings = DecodeSettings(
                           ngram_blocking_size=0),
                       dtype=torch.float32,
                       context_buckets: Tuple[int, ...] = (),
                       dynamic_buckets: bool = False,
                       quantize_memory: bool = False,
                       device="cuda"):
    """Build the dialog-generation function.

    Returns ``engine(q_model, a_model, batch, generator, init_max=None)
    -> DialogOutput``.  ``batch`` holds enc_input_ids, enc_segments,
    enc_image_feat, enc_image_loc and enc_image_mask (numpy arrays or
    tensors; image features and locations already in bf16 stay bf16);
    ``generator`` is a ``torch.Generator`` on ``device``.  ``init_max``:
    the batch's longest initial context, when the caller knows it from the
    host batch; the bucketed engine then skips the device sync that reads
    it (``gstx/decode/dialog_engine.py:305-311``).  The engine moves
    the models to ``device`` and casts their weights to ``dtype`` in place
    on first use (LayerNorm parameters and the LM bias stay f32).

    ``context_buckets``: ascending context widths smaller than the full
    buffer.  A round whose worst-case context fits a bucket runs at that
    width; the math is identical (masked tail positions contribute exactly
    0 after the softmax).  ``dynamic_buckets`` picks each round's bucket
    from the batch's actual maximum length (one host sync per round)
    instead of the static worst-case schedule.

    ``quantize_memory``: on a bf16 engine, each utterance's cross-attention
    memory is quantized to int8 (``decoder.quantize_memory_kv``) for its
    decode steps and its answer-scoring pass; an f32 engine never
    quantizes.  One-token decode steps then read the int8 memory through the
    ``quant_decode_attention`` kernel when
    ``gstx_torch.kernels.decode_attn.enable_kernel()`` is on.

    On a card, a model without a model group decodes through CUDA graphs
    (:func:`captures`, :class:`DecodeGraphs`), captured at the first
    utterance of each model and memory width; the tokens, perplexities and
    the generator's state after a batch are the eager loop's.  A patch of a
    model's code made after its first utterance does not reach the graphs
    already captured; the kernels' switches and ``decode.sampler``'s
    functions are part of a graph's key, so changing them takes new graphs.
    """
    device = resolve_device(device)
    graphs = None  # the engine's DecodeGraphs, made at the first capture

    def prepare(model: GSTVisualDialog) -> GSTVisualDialog:
        if model.device != device:
            model.to(device)
        if model.dtype != dtype:
            precast_(model, dtype)
        return model

    def decode_utterance(model, state, image, generator, settings,
                         ngram_source, full_width):
        nonlocal graphs
        batch = state.enc_input_ids.shape[0]
        att = (state.enc_input_ids != PAD_ID).long()
        with profiling.span("gstx:encoder.memory"):
            mem_kv, mem_mask = model.decode_prepare(
                state.enc_input_ids, image["feat"], image["loc"],
                state.enc_segments, att, image["mask"])
            if quantize_memory and dtype == torch.bfloat16:
                # the memory is static for the utterance: int8 halves what
                # every decode step reads
                # (gstx/decode/dialog_engine.py:157-166)
                mem_kv = tdecoder.quantize_memory_kv(mem_kv, mem_mask,
                                                     dtype)

        if captures(model, device):
            if graphs is None:
                graphs = DecodeGraphs(device)
            seq = graphs.sample(model, settings, mem_kv, mem_mask,
                                   ngram_source, generator, full_width)
            return seq, (mem_kv, mem_mask)

        def step_fn(tok, pos, caches):
            return model.decode_step(tok, pos, caches, mem_kv, mem_mask)

        caches = init_cache(model.dec_config, batch, settings.max_steps + 1,
                            model.dtype, device, model.dec.local_heads)
        seq = sample_sequence(step_fn, generator, batch, caches, settings,
                              ngram_source=ngram_source, bos_id=CLS_ID,
                              eos_id=SEP_ID, device=device, tp=model.tp)
        return seq, (mem_kv, mem_mask)

    def answer_ppl(model, ans_ids, mem_kv, mem_mask):
        """exp(sum NLL / answer length).  The attention mask is taken
        BEFORE the EOS->PAD rewrite (the EOS slot stays attendable) and the
        normalising length AFTER it (EOS excluded), the reference's order."""
        att_mask = (ans_ids != PAD_ID).long()
        labels, inputs = derive_labels_and_inputs(ans_ids, SEP_ID, PAD_ID)
        logits = model.decode_logits_cached(inputs, att_mask, mem_kv,
                                            mem_mask)
        nll = teacher_forced_nll(logits, labels, PAD_ID, model.vocab_tp)
        ans_len = (inputs != PAD_ID).sum(-1)
        ppl = torch.exp(nll.sum(-1) / ans_len.clamp(min=1))
        return ppl, inputs, ans_len

    def one_round(q_model, a_model, state, image, generator, full_width):
        """One dialog round: Q-decode, append, A-decode, ppl, append.
        ``full_width``: the memory's width at the full context."""
        # n-gram blocking source: earlier questions (segment id 0)
        hist_ques = state.enc_input_ids * (state.enc_segments == 0)
        ques, _ = decode_utterance(q_model, state, image, generator,
                                   q_settings, hist_ques, full_width)
        # includes EOS; a PAD drawn before EOS undershoots the count, as
        # the reference's ques_ids[:ques_len] copy does
        ques_len = (ques != PAD_ID).sum(-1)
        with profiling.span("gstx:engine.append"):
            state, _ = append_utterance(state, ques, ques_len, segment=0,
                                        write_segments=False)
        answ, (mem_kv, mem_mask) = decode_utterance(
            a_model, state, image, generator, a_settings, None, full_width)
        with profiling.span("gstx:engine.score"):
            ppl, ans_wo_eos, ans_len = answer_ppl(a_model, answ, mem_kv,
                                                  mem_mask)
        # the EOS->PAD-rewritten answer with its EOS-less length, segment 1
        with profiling.span("gstx:engine.append"):
            state, _ = append_utterance(state, ans_wo_eos, ans_len,
                                        segment=1, write_segments=True)
        return state, ques, answ, ppl

    growth = q_settings.max_steps + a_settings.max_steps

    def _widen(state: DialogState, pad: int) -> DialogState:
        return state._replace(
            enc_input_ids=F.pad(state.enc_input_ids, (0, pad)),
            enc_segments=F.pad(state.enc_segments, (0, pad)))

    def _tensor(x, dt):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=device, dtype=dt)

    def _features(x):
        # a bf16 engine's caller may hand bf16 features (the CLI casts on
        # the host, halving the upload); the embedding casts them to the
        # weights' dtype either way
        if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
            return x.to(device)
        return _tensor(x, torch.float32)

    @torch.no_grad()
    def engine(q_model, a_model, batch, generator: torch.Generator,
               init_max=None) -> DialogOutput:
        profiling.count("engine.batches")
        with profiling.span("gstx:engine.batch"):
            return run(q_model, a_model, batch, generator, init_max)

    def run(q_model, a_model, batch, generator, init_max):
        q_model = prepare(q_model)
        a_model = q_model if a_model is q_model else prepare(a_model)
        image = {"feat": _features(batch["enc_image_feat"]),
                 "loc": _features(batch["enc_image_loc"]),
                 "mask": _tensor(batch["enc_image_mask"], torch.float32)}
        # cloned: the context is updated in place
        ids = _tensor(batch["enc_input_ids"], torch.long).clone()
        segs = _tensor(batch["enc_segments"], torch.long).clone()
        full_s = ids.shape[1]
        buckets = sorted(b for b in set(context_buckets) if b < full_s)
        buckets.append(full_s)

        state = DialogState(
            enc_input_ids=ids, enc_segments=segs,
            enc_len=(ids != PAD_ID).sum(-1),
            abnormal=torch.zeros(ids.shape[0], dtype=torch.bool,
                                 device=device))
        if len(buckets) > 1:
            # one host sync up front unless the caller knows the length;
            # afterwards the schedule is static
            if init_max is None:
                with profiling.sync_span("gstx:engine.sync", "engine"):
                    init_max = int(state.enc_len.max())
            start = next((b for b in buckets
                          if b >= min(init_max + growth, full_s)), full_s)
            state = state._replace(
                enc_input_ids=state.enc_input_ids[:, :start].contiguous(),
                enc_segments=state.enc_segments[:, :start].contiguous())

        qs, ans, ppls = [], [], []
        for rnd_idx in range(num_rounds):
            if len(buckets) > 1:
                cur_w = state.enc_input_ids.shape[1]
                if dynamic_buckets:
                    # host sync on the previous round's actual lengths
                    with profiling.sync_span("gstx:engine.sync", "engine"):
                        worst = min(int(state.enc_len.max()) + growth,
                                    full_s)
                else:
                    worst = init_max + (rnd_idx + 1) * growth
                target = next((b for b in buckets if b >= worst), full_s)
                target = max(target, cur_w)
                if target > cur_w:
                    state = _widen(state, target - cur_w)
            profiling.count("engine.rounds")
            with profiling.span("gstx:engine.round"):
                state, ques, answ, ppl = one_round(
                    q_model, a_model, state, image, generator,
                    image["mask"].shape[1] + full_s)
            qs.append(ques)
            ans.append(answ)
            ppls.append(ppl)

        if state.enc_input_ids.shape[1] < full_s:
            state = _widen(state, full_s - state.enc_input_ids.shape[1])
        return DialogOutput(questions=torch.stack(qs),
                            answers=torch.stack(ans),
                            answer_ppl=torch.stack(ppls),
                            abnormal=state.abnormal, final_state=state)

    return engine
