"""The GST synthetic-dialog engine: questioner <-> teacher loop (port of
``gstx/decode/dialog_engine.py``, lines 33-391).

For each image, ``num_rounds`` rounds of: sample a question, append it to
the context, sample an answer, score the answer's perplexity, append the
answer.  Per round: two encoder forwards (questioner and teacher), two
KV-cached decodes, one teacher-forced scoring pass over the teacher's
cached memory.

Differences from the JAX engine, none of which changes the math:
  * PyTorch runs eagerly, so a round is a Python function and the decode
    loop a Python loop with an early-EOS exit read on the host;
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

from gstx_torch.core import profiling
from gstx_torch.core.config import CLS_ID, PAD_ID, SEP_ID
from gstx_torch.core.device import resolve_device
from gstx_torch.decode.sampler import (DecodeSettings, init_cache,
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
    """
    device = resolve_device(device)

    def prepare(model: GSTVisualDialog) -> GSTVisualDialog:
        if model.device != device:
            model.to(device)
        if model.dtype != dtype:
            precast_(model, dtype)
        return model

    def decode_utterance(model, state, image, generator, settings,
                         ngram_source):
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

    def one_round(q_model, a_model, state, image, generator):
        """One dialog round: Q-decode, append, A-decode, ppl, append."""
        # n-gram blocking source: earlier questions (segment id 0)
        hist_ques = state.enc_input_ids * (state.enc_segments == 0)
        ques, _ = decode_utterance(q_model, state, image, generator,
                                   q_settings, hist_ques)
        # includes EOS; a PAD drawn before EOS undershoots the count, as
        # the reference's ques_ids[:ques_len] copy does
        ques_len = (ques != PAD_ID).sum(-1)
        with profiling.span("gstx:engine.append"):
            state, _ = append_utterance(state, ques, ques_len, segment=0,
                                        write_segments=False)
        answ, (mem_kv, mem_mask) = decode_utterance(
            a_model, state, image, generator, a_settings, None)
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
                state, ques, answ, ppl = one_round(q_model, a_model, state,
                                                   image, generator)
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
