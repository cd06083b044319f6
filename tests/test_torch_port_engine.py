"""The port's sampling ops, sampler and dialog engine against the JAX
package's, f32 on the CPU.  Filters and n-gram blocking agree exactly;
greedy decoding agrees token for token; sampled decoding agrees in
distribution (torch's generator is not JAX's threefry)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from fixtures import init_tiny_params, make_gen_batch, tiny_enc_dec_configs
from gstx.decode import sampler as jsampler
from gstx.decode.dialog_engine import make_dialog_engine as j_make_engine
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx.ops import sampling as jsampling
from gstx_torch.core import config as tcfg
from gstx_torch.core import profiling
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.decode import sampler as tsampler
from gstx_torch.decode.dialog_engine import (DialogState, append_utterance,
                                             make_dialog_engine)
from gstx_torch.models.encdec import GSTVisualDialog
from gstx_torch.ops import sampling as tsampling

PPL_TOL = 1e-4  # composed model, f32 on the CPU


def _logits(seed, b=6, v=300):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, v).astype(np.float32)
    x[0, 10:14] = x[0].max() + 1.0  # a tie straddling the k-th value
    return x


@pytest.mark.parametrize("k", [1, 3, 7, 20])
def test_top_k_filter_exact(k):
    x = _logits(0)
    want = np.asarray(jsampling.top_k_filter(jnp.asarray(x), k))
    got = tsampling.top_k_filter(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.3, 0.9])
def test_top_p_filter_exact(p):
    x = _logits(1)
    want = np.asarray(jsampling.top_p_filter(jnp.asarray(x), p))
    got = tsampling.top_p_filter(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cur_len", [2, 3, 5, 7])
def test_ngram_block_exact(cur_len):
    rng = np.random.RandomState(2)
    b, s, t = 4, 40, 8
    src = rng.randint(104, 112, size=(b, s)).astype(np.int32)
    src[1, 5] = 102  # a special token inside some windows
    dec = rng.randint(104, 112, size=(b, t)).astype(np.int32)
    dec[:, 0] = 101
    dec[0, 1:4] = src[0, 7:10]  # a guaranteed match
    logits = rng.randn(b, 120).astype(np.float32)
    want = np.asarray(jsampling.ngram_block(
        jnp.asarray(logits), jnp.asarray(src), jnp.asarray(dec), cur_len, 4))
    got = tsampling.ngram_block(
        torch.from_numpy(logits), torch.from_numpy(src).long(),
        torch.from_numpy(dec).long(), cur_len, 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_pad_after_eos_exact():
    seq = np.array([[5, 102, 7, 102, 9], [102, 1, 2, 3, 4], [1, 2, 3, 4, 5]],
                   np.int32)
    want = np.asarray(jsampling.pad_after_eos(jnp.asarray(seq), 102))
    got = tsampling.pad_after_eos(torch.from_numpy(seq).long(), 102).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_sampled_frequencies_match_softmax_over_top_k(fused):
    """>= 20k draws from fixed logits: total-variation distance to the
    softmax over the top k below 0.02 (its expected value at 20k draws is
    ~0.008), and no draw outside the top k."""
    n, k = 20000, 7
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(50).astype(np.float32) * 2.0)
    gen = torch.Generator().manual_seed(0)
    batch = logits.expand(n, -1).contiguous()
    if fused:
        draws = tsampling.sample_token_topk(gen, batch, k)
    else:
        draws = tsampling.sample_token(gen, tsampling.top_k_filter(batch, k))
    top = torch.topk(logits, k).indices
    want = torch.zeros(50)
    want[top] = torch.softmax(logits[top], -1)
    freq = torch.bincount(draws, minlength=50).float() / n
    assert float(freq[want == 0].sum()) == 0.0
    assert 0.5 * float((freq - want).abs().sum()) < 0.02


def _fixed_step_tables(v=40, t=8, seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(v, v).astype(np.float32) * 3,
            rng.randn(t, v).astype(np.float32))


@pytest.mark.parametrize("fused", [False, True])
def test_greedy_sample_sequence_token_identical(fused):
    table, pos_bias = _fixed_step_tables()
    settings_kw = dict(max_steps=7, temperature=0.7, top_k=1,
                       ngram_blocking_size=3, fused_sampler=fused)
    rng = np.random.RandomState(5)
    src = rng.randint(0, 40, size=(5, 30)).astype(np.int32)

    def j_step(tok, pos, caches):
        return (jnp.asarray(table)[tok[:, 0]]
                + jnp.asarray(pos_bias)[pos], caches)

    def t_step(tok, pos, caches):
        return torch.from_numpy(table)[tok[:, 0]] + \
            torch.from_numpy(pos_bias)[pos]

    want = np.asarray(jsampler.sample_sequence(
        j_step, jax.random.PRNGKey(0), 5, None,
        jsampler.DecodeSettings(**settings_kw), ngram_source=jnp.asarray(src),
        bos_id=1, eos_id=2))
    got = tsampler.sample_sequence(
        t_step, torch.Generator().manual_seed(0), 5, None,
        tsampler.DecodeSettings(**settings_kw),
        ngram_source=torch.from_numpy(src).long(), bos_id=1, eos_id=2,
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_append_utterance_overflow_and_exact_fill():
    ids = torch.tensor([[101, 5, 0, 0, 0], [101, 5, 6, 0, 0]])
    state = DialogState(ids.clone(), torch.zeros_like(ids),
                        torch.tensor([2, 3]), torch.zeros(2, dtype=torch.bool))
    utt = torch.tensor([[7, 8, 9, 0], [7, 8, 9, 0]])
    new, eff = append_utterance(state, utt, torch.tensor([3, 3]), segment=1,
                                write_segments=True)
    # row 0 fills the context exactly; row 1 overflows -> one SEP, abnormal
    assert new.enc_input_ids.tolist() == [[101, 5, 7, 8, 9],
                                          [101, 5, 6, 102, 0]]
    assert new.enc_segments.tolist() == [[0, 0, 1, 1, 1], [0, 0, 0, 1, 0]]
    assert new.enc_len.tolist() == [5, 4] and eff.tolist() == [3, 1]
    assert new.abnormal.tolist() == [False, True]


def _torch_configs(enc, dec):
    return (tcfg.EncoderConfig(**dataclasses.asdict(enc)),
            tcfg.DecoderConfig(**dataclasses.asdict(dec)))


@pytest.fixture(scope="module")
def engine_setup():
    enc, dec = tiny_enc_dec_configs()
    q_params = init_tiny_params(enc, dec, seed=0)
    a_params = init_tiny_params(enc, dec, seed=1)
    models = []
    for p in (q_params, a_params):
        m = GSTVisualDialog(*_torch_configs(enc, dec), device="cpu")
        m.load_state_dict(state_dict_from_jax(jax.device_get(p)),
                          strict=True)
        models.append(m)
    return enc, dec, q_params, a_params, models


# seq_len 32: every greedy utterance runs its 5 steps, so the context
# overflows in round 2 and `abnormal` is exercised
@pytest.mark.parametrize("buckets", [(), (24,)])
def test_greedy_engine_matches_jax_engine(engine_setup, buckets):
    enc, dec, q_params, a_params, (q_model, a_model) = engine_setup
    batch = make_gen_batch(enc, b=4, seq_len=32, regions=7, cap_len=14)
    kw = dict(num_rounds=3, context_buckets=buckets)
    greedy_q = dict(max_steps=5, top_k=1, ngram_blocking_size=4)
    greedy_a = dict(max_steps=5, top_k=1, ngram_blocking_size=0)
    j_engine = j_make_engine(
        JGST(enc, dec), dec,
        q_settings=jsampler.DecodeSettings(**greedy_q),
        a_settings=jsampler.DecodeSettings(**greedy_a), **kw)
    want = j_engine(q_params, a_params,
                    {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(11))
    t_engine = make_dialog_engine(
        q_settings=tsampler.DecodeSettings(**greedy_q),
        a_settings=tsampler.DecodeSettings(**greedy_a), device="cpu", **kw)
    got = t_engine(q_model, a_model, batch, torch.Generator().manual_seed(11))

    np.testing.assert_array_equal(got.questions.numpy(),
                                  np.asarray(want.questions))
    np.testing.assert_array_equal(got.answers.numpy(),
                                  np.asarray(want.answers))
    np.testing.assert_array_equal(got.abnormal.numpy(),
                                  np.asarray(want.abnormal))
    assert got.abnormal.any()
    np.testing.assert_allclose(got.answer_ppl.numpy(),
                               np.asarray(want.answer_ppl),
                               rtol=PPL_TOL, atol=PPL_TOL)
    np.testing.assert_array_equal(
        got.final_state.enc_input_ids.numpy(),
        np.asarray(want.final_state.enc_input_ids))
    np.testing.assert_array_equal(got.final_state.enc_len.numpy(),
                                  np.asarray(want.final_state.enc_len))


def test_dynamic_buckets_identical_to_static(engine_setup):
    enc, dec, _, _, (q_model, a_model) = engine_setup
    batch = make_gen_batch(enc, b=3, seq_len=48, regions=7, cap_len=10)
    settings = dict(q_settings=tsampler.DecodeSettings(
        max_steps=4, top_k=1, ngram_blocking_size=4),
        a_settings=tsampler.DecodeSettings(max_steps=4, top_k=1,
                                           ngram_blocking_size=0),
        num_rounds=3, device="cpu")
    outs = [make_dialog_engine(context_buckets=b, dynamic_buckets=d,
                               **settings)(q_model, a_model, batch,
                                           torch.Generator().manual_seed(0))
            for b, d in (((), False), ((20, 30), True))]
    for a, b in zip(outs[0][:4], outs[1][:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def test_engine_counts_the_steps_the_sampler_ran(engine_setup,
                                                 monkeypatch):
    """One engine call, collected: the decode-step counter and spans
    against the model's decode steps, and one host sync a step plus the
    dynamic schedule's (one up front, one a round)."""
    enc, _, _, _, (q_model, a_model) = engine_setup
    calls = []
    for m in (q_model, a_model):
        def counted(*a, _step=m.decode_step, **k):
            calls.append(1)
            return _step(*a, **k)
        monkeypatch.setattr(m, "decode_step", counted)
    batch = make_gen_batch(enc, b=2, seq_len=48, regions=7, cap_len=10)
    engine = make_dialog_engine(
        q_settings=tsampler.DecodeSettings(max_steps=3, top_k=1,
                                           ngram_blocking_size=4),
        a_settings=tsampler.DecodeSettings(max_steps=3, top_k=1,
                                           ngram_blocking_size=0),
        num_rounds=2, context_buckets=(20, 30), dynamic_buckets=True,
        device="cpu")
    profiling.reset()
    with profiling.collecting():
        engine(q_model, a_model, batch, torch.Generator().manual_seed(0))
    snap = profiling.snapshot()
    profiling.reset()
    steps = len(calls)
    c, spans = snap["counters"], snap["spans"]
    assert steps > 0 and c["decode.steps"] == steps
    assert spans["gstx:decode.step"]["count"] == steps
    assert spans["gstx:decoder.ffn"]["count"] == \
        steps * a_model.dec_config.num_hidden_layers
    assert c["decode.utterances"] == 4 and c["engine.rounds"] == 2
    assert c["engine.batches"] == 1 and c["engine.host_syncs"] == steps + 3
    assert spans["gstx:encoder.memory"]["count"] == 4


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        make_dialog_engine(device="cuda")


# ---------------------------------------------------------------------- #
# the decode step's position on the device (the captured decode step)
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("quant", [False, True])
def test_decoder_step_tensor_pos_matches_int(engine_setup, quant):
    """``decode_step`` with ``pos`` a 0-d tensor gives the int form's logits
    and caches, bit for bit, at every position of an utterance."""
    from gstx_torch.models.decoder import quantize_memory_kv

    enc, dec, _, _, (model, _) = engine_setup
    batch = make_gen_batch(enc, b=3, seq_len=32, regions=7, cap_len=10)
    ids = torch.from_numpy(batch["enc_input_ids"]).long()
    with torch.no_grad():
        mem_kv, mem_mask = model.decode_prepare(
            ids, torch.from_numpy(batch["enc_image_feat"]),
            torch.from_numpy(batch["enc_image_loc"]),
            torch.from_numpy(batch["enc_segments"]).long(),
            (ids != 0).long(), torch.from_numpy(batch["enc_image_mask"]))
        if quant:
            mem_kv = quantize_memory_kv(mem_kv, mem_mask, torch.float32)
        toks = torch.from_numpy(np.random.RandomState(6).randint(
            1, dec.vocab_size, size=(3, 7))).long()
        caches = [tsampler.init_cache(dec, 3, 8, torch.float32, "cpu")
                  for _ in range(2)]
        for i in range(7):
            by_int = model.decode_step(toks[:, i:i + 1], i, caches[0],
                                       mem_kv, mem_mask)
            by_tensor = model.decode_step(toks[:, i:i + 1], torch.tensor(i),
                                          caches[1], mem_kv, mem_mask)
            assert torch.equal(by_int, by_tensor), i
            for a, b in zip(caches[0], caches[1]):
                assert torch.equal(a["k"], b["k"]) and \
                    torch.equal(a["v"], b["v"]), i


def _ngram_inputs():
    rng = np.random.RandomState(2)
    b, s, t = 4, 40, 8
    src = rng.randint(104, 112, size=(b, s)).astype(np.int32)
    src[1, 5] = 102  # a special token inside some windows
    dec = rng.randint(104, 112, size=(b, t)).astype(np.int32)
    dec[:, 0] = 101
    dec[0, 1:4] = src[0, 7:10]  # a guaranteed match
    dec[2, 1:4] = src[2, 0:3]
    logits = rng.randn(b, 120).astype(np.float32)
    return src, dec, logits


@pytest.mark.parametrize("cur_len", range(9))
def test_ngram_block_tensor_cur_len_matches_int(cur_len):
    """Every length of the generated prefix, the gated ones below n - 1
    included: a 0-d tensor ``cur_len`` gives the int form's logits, which
    are JAX's."""
    src, dec, logits = _ngram_inputs()
    args = (torch.from_numpy(logits), torch.from_numpy(src).long(),
            torch.from_numpy(dec).long())
    by_int = tsampling.ngram_block(*args, cur_len, 4)
    by_tensor = tsampling.ngram_block(*args, torch.tensor(cur_len), 4)
    np.testing.assert_array_equal(by_tensor.numpy(), by_int.numpy())
    want = np.asarray(jsampling.ngram_block(
        jnp.asarray(logits), jnp.asarray(src), jnp.asarray(dec), cur_len, 4))
    np.testing.assert_array_equal(by_int.numpy(), want)
    if cur_len < 3:  # gated: no tail of n - 1 tokens yet
        np.testing.assert_array_equal(by_tensor.numpy(), logits)
    if cur_len == 4:  # the tail of row 0 is src[0, 7:10]
        assert by_tensor.numpy()[0, src[0, 10]] == tsampling.NEG_INF


def _loop_before(step_fn, generator, batch, settings, ngram_source, bos_id,
                 eos_id):
    """The sampler's loop as it was with an int position and
    ``torch.multinomial``: the reference of the refactored one."""
    tokens = torch.zeros((batch, settings.max_steps + 1), dtype=torch.long)
    tokens[:, 0] = bos_id
    done = torch.zeros(batch, dtype=torch.bool)
    for step in range(settings.max_steps):
        logits = step_fn(tokens[:, step:step + 1], step, None)
        logits = logits / settings.temperature
        logits = tsampling.ngram_block(logits, ngram_source, tokens,
                                       step + 1,
                                       settings.ngram_blocking_size)
        if settings.fused_sampler:
            vals, idx = torch.topk(logits, settings.top_k, dim=-1)
            probs = torch.softmax(vals.float(), dim=-1)
            nxt = idx.gather(-1, torch.multinomial(
                probs, 1, generator=generator))[..., 0]
        else:
            logits = tsampling.top_k_top_p_filter(logits, settings.top_k,
                                                  settings.top_p)
            nxt = torch.multinomial(torch.softmax(logits.float(), -1), 1,
                                    generator=generator)[..., 0]
        tokens[:, step + 1] = nxt
        done |= nxt == eos_id
        if bool(done.all()):
            break
    return tsampling.pad_after_eos(tokens[:, 1:], eos_id, 0)


@pytest.mark.parametrize("fused", [False, True])
def test_sampler_loop_matches_the_loop_before(fused):
    """Sampled at T 0.7, top-k 7, 3-gram blocking: the refactored loop (a
    tensor position, the written-out draw) gives the tokens and leaves the
    generator where the loop before it did."""
    table, pos_bias = _fixed_step_tables(v=40, t=12, seed=7)
    settings = tsampler.DecodeSettings(max_steps=11, temperature=0.7,
                                       top_k=7, ngram_blocking_size=3,
                                       fused_sampler=fused)
    src = torch.from_numpy(np.random.RandomState(8).randint(
        3, 40, size=(6, 30))).long()

    def step(tok, pos, caches):
        return torch.from_numpy(table)[tok[:, 0]] + \
            torch.from_numpy(pos_bias)[pos]

    gens = [torch.Generator().manual_seed(13) for _ in range(2)]
    want = _loop_before(step, gens[0], 6, settings, src, 1, 2)
    got = tsampler.sample_sequence(step, gens[1], 6, None, settings,
                                   ngram_source=src, bos_id=1, eos_id=2,
                                   device="cpu")
    assert torch.equal(got, want)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert len(set(got.flatten().tolist())) > 7  # the draws vary


class _ReplayedEagerly:
    """A stand-in for ``torch.cuda.CUDAGraph`` whose replay calls the
    iteration the capture was given."""

    def register_generator_state(self, generator):
        self.generator = generator


def _capture_eagerly(graph, fn, pool, stream, warmup):
    for _ in range(warmup):
        fn()
    graph.replay = fn
    return []


def test_engine_graph_path_with_eager_replays(engine_setup, monkeypatch):
    """The engine's captured path on the CPU, each replay a call of the
    iteration it captured: its static memory at three widths, the copies
    into it, the keys, the caches' reset and the generator's hand-over give
    the eager engine's dialogs, perplexities and generator state, with one
    capture a model and width and one replay a step."""
    from gstx_torch.decode import dialog_engine

    enc, _, _, _, (q_model, a_model) = engine_setup
    batch = make_gen_batch(enc, b=3, seq_len=48, regions=7, cap_len=10)
    kw = dict(q_settings=tsampler.DecodeSettings(
        max_steps=4, top_k=7, ngram_blocking_size=4, fused_sampler=True),
        a_settings=tsampler.DecodeSettings(max_steps=4, top_k=7,
                                           ngram_blocking_size=0),
        num_rounds=5, context_buckets=(24, 36), device="cpu")
    gens = [torch.Generator().manual_seed(21) for _ in range(2)]
    want = make_dialog_engine(**kw)(q_model, a_model, batch, gens[0])

    monkeypatch.setattr(dialog_engine, "captures", lambda model, dev: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _ReplayedEagerly)
    monkeypatch.setattr(tsampler, "_capture", _capture_eagerly)
    profiling.reset()
    with profiling.collecting():
        got = make_dialog_engine(**kw)(q_model, a_model, batch, gens[1])
    c = profiling.snapshot()["counters"]
    profiling.reset()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # widths 7 + (24, 36, 48): both models meet all three
    assert c["decode.graph_captures"] == 6
    assert c["decode.graph_replays"] == c["decode.steps"] > 0


def test_graph_key_follows_switches_and_sampler_functions(engine_setup,
                                                          monkeypatch):
    """A graph fixes the kernels' switches and the sampler's functions it
    was captured with: the engine's next batch with a switch turned, or
    with ``sampler.sample_token_topk`` patched, captures new graphs (and
    the patch reaches the tokens); a batch with neither changed captures
    nothing."""
    from gstx_torch.decode import dialog_engine
    from gstx_torch.kernels import attention as kattn

    enc, _, _, _, (q_model, a_model) = engine_setup
    batch = make_gen_batch(enc, b=2, seq_len=32, regions=5, cap_len=8)
    monkeypatch.setattr(dialog_engine, "captures", lambda model, dev: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _ReplayedEagerly)
    monkeypatch.setattr(tsampler, "_capture", _capture_eagerly)
    engine = make_dialog_engine(
        q_settings=tsampler.DecodeSettings(
            max_steps=3, top_k=7, ngram_blocking_size=4, fused_sampler=True),
        a_settings=tsampler.DecodeSettings(max_steps=3, top_k=7,
                                           ngram_blocking_size=0),
        num_rounds=2, device="cpu")

    def captures(**patch):
        gen = torch.Generator().manual_seed(5)
        profiling.reset()
        with profiling.collecting():
            out = engine(q_model, a_model, batch, gen)
        c = profiling.snapshot()["counters"]
        profiling.reset()
        return c.get("decode.graph_captures", 0), out

    first, plain = captures()
    assert first == 2  # one width, both models
    assert captures()[0] == 0
    monkeypatch.setattr(kattn, "_ENABLED", not kattn.is_enabled())
    assert captures()[0] == 2
    topk = tsampler.sample_token_topk
    monkeypatch.setattr(tsampler, "sample_token_topk",
                        lambda *a: (topk(*a) + 1) % 100)
    n, patched = captures()
    assert n == 2
    assert not torch.equal(patched.questions, plain.questions)


def test_capture_moves_the_capture_launches_to_each_replay(monkeypatch):
    """``sampler._capture`` takes what the captured call counted off every
    registered launch counter and leaves the warm-up calls' launches; each
    replay of a ``CapturedSampler`` adds the captured call's back."""
    import contextlib

    from gstx_torch import kernels

    monkeypatch.setattr(kernels, "_MODULES", list(kernels._MODULES))
    old, new = {"k_old": 0}, {"k_new": 0}
    for c in (old, new):
        kernels.register(c, lambda: True)

    def fn():
        old["k_old"] += 2
        new["k_new"] += 1

    class _Stream:
        device = None

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    launches = tsampler._capture(None, fn, None, _Stream(), 1)
    assert old == {"k_old": 2} and new == {"k_new": 1}  # the warm-up's
    assert sorted((k, n) for _, k, n in launches) == [("k_new", 1),
                                                      ("k_old", 2)]
    replaying = tsampler.CapturedSampler.__new__(tsampler.CapturedSampler)
    replaying.graph = type("G", (), {"replay": lambda self: None})()
    replaying._launches = launches
    for _ in range(3):
        replaying._replay()
    assert old == {"k_old": 8} and new == {"k_new": 4}


@pytest.mark.parametrize("probs", [
    [[0.5, float("nan")]], [[0.5, float("inf")]], [[0.5, -0.1]],
    [[0.2, 0.8], [0.0, 0.0]]], ids=["nan", "inf", "negative", "zero"])
def test_draw_refuses_what_multinomial_refuses(probs):
    """Outside a capture, the written-out draw raises where
    ``torch.multinomial`` does, with its message."""
    probs = torch.tensor(probs)
    with pytest.raises(RuntimeError) as want:
        torch.multinomial(probs, 1, generator=torch.Generator())
    with pytest.raises(RuntimeError, match=re.escape(str(want.value))):
        tsampling.draw(torch.Generator(), probs)
