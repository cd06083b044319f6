"""The port's beam search (gstx_torch.decode.beam) against the JAX
package's, f32 on the CPU, on the tiny model with the JAX weights bridged
into the port: identical sequences and scores within SCORE_TOL, against
JAX's beam_search and against the cache-less oracle of tests/test_beam.py;
K = 1 equal to greedy; the GNMT penalty; a beam that finishes early; the
int8 memory through the decode kernel's plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import init_tiny_params, tiny_enc_dec_configs
from gstx.decode import beam as jbeam
from gstx.decode.sampler import init_cache as j_init_cache
from gstx.models import decoder as jdecoder
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx_torch.core import config as tcfg
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.decode import beam as tbeam
from gstx_torch.decode import sampler as tsampler
from gstx_torch.kernels import decode_attn as kdecode
from gstx_torch.models.encdec import GSTVisualDialog
from test_beam import reference_beam_search

SCORE_TOL = 1e-4  # the composed model, f32 on the CPU
EOS_BIAS = 4.0    # on the LM head's SEP bias: beams end within the steps


def _bridge(params, eos_bias=0.0):
    """The JAX params with ``eos_bias`` added to the decoder's SEP bias,
    and the port model holding the same weights."""
    enc, dec = tiny_enc_dec_configs()
    params = jax.tree_util.tree_map(np.array, jax.device_get(params))
    params["params"]["decoder"]["lm_bias"][tcfg.SEP_ID] += eos_bias
    model = GSTVisualDialog(tcfg.EncoderConfig(**dataclasses.asdict(enc)),
                            tcfg.DecoderConfig(**dataclasses.asdict(dec)),
                            device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, model.eval()


@pytest.fixture(scope="module")
def setup():
    """The tiny JAX model and a batch of 2 (test_beam.py's shapes), the
    JAX params plain and with EOS_BIAS, the port model of each, and both
    sides' own memory K/V."""
    enc, dec = tiny_enc_dec_configs()
    rng = np.random.RandomState(0)
    b, l, r = 2, 20, 5
    batch = dict(
        input_ids=rng.randint(1, 100, (b, l)).astype(np.int32),
        image_feat=rng.rand(b, r, enc.v_feature_size).astype(np.float32),
        image_loc=rng.rand(b, r, 5).astype(np.float32),
        token_type_ids=np.zeros((b, l), np.int32),
        attention_mask=np.ones((b, l), np.int32),
        image_attention_mask=np.ones((b, r), np.int32))
    jmodel = JGST(enc, dec)
    base = init_tiny_params(enc, dec)
    out = {"jmodel": jmodel, "dec": dec, "batch": batch}
    for name, bias in (("plain", 0.0), ("eos", EOS_BIAS)):
        params, model = _bridge(base, bias)
        j_mem = jmodel.apply(params, *(jnp.asarray(v) for v in batch.values()),
                             method=JGST.decode_prepare)
        with torch.no_grad():
            t_mem = model.decode_prepare(
                *(torch.from_numpy(v).long() if v.dtype == np.int32
                  else torch.from_numpy(v) for v in batch.values()))
        out[name] = (params, model, j_mem, t_mem)
    return out


def _jax_beams(setup, params, j_mem, beams, steps, alpha=0.0):
    jmodel, dec = setup["jmodel"], setup["dec"]
    kv, mask = (jbeam.tile_for_beams(x, beams) for x in j_mem)

    def step_fn(tok, pos, caches):
        return jmodel.apply(params, tok, pos, caches, kv, mask,
                            method=JGST.decode_step)

    b = j_mem[1].shape[0]
    seq, scores = jbeam.beam_search(
        step_fn, j_init_cache(dec, b * beams, steps + 1), b, beams, steps,
        alpha=alpha)
    return np.asarray(seq), np.asarray(scores)


def _port_step(model, t_mem, beams):
    kv, mask = (tbeam.tile_for_beams(x, beams) for x in t_mem)
    return lambda tok, pos, caches: model.decode_step(tok, pos, caches, kv,
                                                      mask)


def _port_caches(setup, b, steps):
    return tsampler.init_cache(setup["dec"], b, steps + 1, torch.float32,
                               "cpu")


@torch.no_grad()
def _port_beams(setup, model, t_mem, beams, steps, alpha=0.0):
    b = t_mem[1].shape[0]
    seq, scores = tbeam.beam_search(
        _port_step(model, t_mem, beams), _port_caches(setup, b * beams, steps),
        b, beams, steps, alpha=alpha)
    assert seq.dtype == torch.long and tuple(seq.shape) == (b, steps)
    assert scores.dtype == torch.float32
    return seq.numpy(), scores.numpy()


CASES = [("plain", 3, 4, 0.0), ("plain", 4, 6, 0.6), ("eos", 3, 6, 0.0),
         ("eos", 3, 6, 1.0)]


@pytest.mark.parametrize("weights,beams,steps,alpha", CASES,
                         ids=[f"{w}-k{k}-t{t}-a{a}" for w, k, t, a in CASES])
def test_beam_search_matches_jax(setup, weights, beams, steps, alpha):
    params, model, j_mem, t_mem = setup[weights]
    want_seq, want_scores = _jax_beams(setup, params, j_mem, beams, steps,
                                       alpha)
    got_seq, got_scores = _port_beams(setup, model, t_mem, beams, steps,
                                      alpha)
    np.testing.assert_array_equal(got_seq, want_seq)
    np.testing.assert_allclose(got_scores, want_scores, rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_beam_search_matches_cache_less_oracle(setup):
    """tests/test_beam.py's oracle: every candidate prefix re-forwarded in
    full by the JAX model, no cache."""
    params, model, _, t_mem = setup["plain"]
    jmodel, batch = setup["jmodel"], setup["batch"]
    beams, steps = 3, 4
    hidden_t, hidden_v, _, _ = jmodel.apply(
        params, *(jnp.asarray(v) for v in batch.values()),
        method=JGST.encode)
    memory, memory_mask = jmodel.apply(
        params, hidden_t, hidden_v, jnp.asarray(batch["attention_mask"]),
        jnp.asarray(batch["image_attention_mask"]), method=JGST.fuse)
    want = reference_beam_search(jmodel, params, memory, memory_mask, batch,
                                 beams, steps, setup["dec"].vocab_size)
    seq, scores = _port_beams(setup, model, t_mem, beams, steps)
    for i, (w_seq, w_score) in enumerate(want):
        assert seq[i].tolist() == w_seq, (i, seq[i], w_seq)
        np.testing.assert_allclose(scores[i], w_score, rtol=SCORE_TOL,
                                   atol=SCORE_TOL)


@pytest.mark.parametrize("weights", ["plain", "eos"])
def test_beam1_equals_greedy(setup, weights):
    _, model, _, t_mem = setup[weights]
    b, steps = t_mem[1].shape[0], 6
    seq, _ = _port_beams(setup, model, t_mem, 1, steps)
    with torch.no_grad():
        greedy = tsampler.sample_sequence(
            _port_step(model, t_mem, 1), torch.Generator().manual_seed(0), b,
            _port_caches(setup, b, steps),
            tsampler.DecodeSettings(max_steps=steps, temperature=1.0,
                                    top_k=1, ngram_blocking_size=0),
            device="cpu")
    np.testing.assert_array_equal(seq, greedy.numpy())


@torch.no_grad()
def test_finished_beams_continue_with_pad_at_their_score(setup):
    """With the EOS bias some beams end before the last step: from then
    on they hold PAD, and their score is that of the step they ended at;
    the best sequences have PAD after their first EOS."""
    _, model, _, t_mem = setup["eos"]
    b, beams, steps = t_mem[1].shape[0], 3, 6
    history = []

    def recording_step(tok, pos, caches):
        history.append(tok.reshape(b, beams).clone())
        return step(tok, pos, caches)

    step = _port_step(model, t_mem, beams)
    state = tbeam.beam_steps(recording_step,
                             _port_caches(setup, b * beams, steps), b, beams,
                             steps)
    tokens = state.tokens[:, :, 1:]
    is_eos = tokens == tcfg.SEP_ID
    first = torch.where(is_eos.any(-1), is_eos.int().argmax(-1), steps)
    early = state.finished & (first < steps - 1)
    assert bool(early.any()), "no beam finished early: raise EOS_BIAS"
    after = torch.arange(steps)[None, None, :] > first[..., None]
    assert bool((tokens[after] == tcfg.PAD_ID).all())
    seq, _ = tbeam.best_beam(state)
    assert bool((seq[:, 1:][(seq == tcfg.SEP_ID).cumsum(-1)[:, :-1] > 0]
                 == tcfg.PAD_ID).all())
    assert len(history) == steps  # no early exit: every step runs


@pytest.mark.parametrize("kernel", [False, True], ids=["unfused", "kernel"])
def test_beam_over_int8_memory_matches_jax(setup, kernel):
    """One int8 memory, quantized by JAX and handed to both sides (as
    tests/test_torch_port_quant.py does), tiled K times with its scales;
    the port's one-token steps read it through the decode kernel's plain
    version when the kernel's switch is on."""
    params, model, j_mem, _ = setup["eos"]
    beams, steps = 3, 5
    j_q = (jdecoder.quantize_memory_kv(j_mem[0], j_mem[1], jnp.float32),
           j_mem[1])
    t_q = ([tuple(torch.from_numpy(np.array(x)) for x in layer)
            for layer in j_q[0]], torch.from_numpy(np.array(j_q[1])))
    want_seq, want_scores = _jax_beams(setup, params, j_q, beams, steps)
    kdecode.reset_launches()
    kdecode.enable_kernel(kernel)
    try:
        got_seq, got_scores = _port_beams(setup, model, t_q, beams, steps)
    finally:
        kdecode.enable_kernel(False)
    np.testing.assert_array_equal(got_seq, want_seq)
    np.testing.assert_allclose(got_scores, want_scores, rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    # CPU tensors take the plain version, which counts no launch
    assert kdecode.launches == {"quant_decode_attention": 0}


def test_tile_and_reorder_match_jax():
    """tile_for_beams over lists, tuples, NamedTuples and dicts (the int8
    memory's 4-tuples among them) equals JAX's; the in-place reorder
    equals JAX's _gather_beams."""
    rng = np.random.RandomState(1)
    b, k = 3, 4
    tree = {"kv": [(rng.randn(b, 2, 5, 4).astype(np.float32),
                    rng.randint(-127, 128, (b, 2, 5, 4)).astype(np.int8),
                    rng.randn(b, 2, 1, 4).astype(np.float32),
                    rng.randn(b, 2, 1, 4).astype(np.float32))],
            "mask": rng.randn(b, 1, 1, 5).astype(np.float32)}
    want = jbeam.tile_for_beams(jax.tree_util.tree_map(jnp.asarray, tree), k)
    got = tbeam.tile_for_beams(
        jax.tree_util.tree_map(torch.from_numpy, tree), k)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_equal(g.numpy(), np.asarray(w)),
        got, want)
    state = tbeam.BeamState(None, None, None, got)
    assert tbeam.tile_for_beams(state, 1).caches["mask"].shape == (b * k, 1,
                                                                   1, 5)

    parents = rng.randint(0, k, (b, k))
    want = jbeam._gather_beams(want, jnp.asarray(parents), b, k)
    caches = got
    alias = caches["kv"][0][1]
    rows = (torch.arange(b)[:, None] * k + torch.from_numpy(parents)
            ).reshape(-1)
    tbeam._reorder_(caches, rows)
    assert caches["kv"][0][1] is alias  # in place
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_equal(g.numpy(), np.asarray(w)),
        caches, want)


def test_exact_ties_keep_the_best_score():
    """A step whose logits tie exactly: torch.topk need not pick JAX's
    lowest index among tied candidates (a deliberate difference), so the
    sequence may differ, but the best score is JAX's and it is the score
    of the returned sequence.  Every row of the step's table permutes one
    set of rounded values (PAD, BOS and EOS held low), so whichever tied
    candidate a search keeps, the kept scores are the same at every
    step."""
    v, b, k, steps = 12, 2, 3, 4
    rng = np.random.RandomState(2)
    values = np.round(rng.randn(v - 3) * 2).astype(np.float32)  # ties
    table = np.full((v, v), -30.0, np.float32)
    for row in table:
        row[3:] = rng.permutation(values)

    def j_step(tok, pos, caches):
        return jnp.asarray(table)[tok[:, 0] % v], caches

    def t_step(tok, pos, caches):
        return torch.from_numpy(table)[tok[:, 0] % v]

    j_seq, j_scores = jbeam.beam_search(
        j_step, {"x": jnp.zeros((b * k, 1))}, b, k, steps, bos_id=1,
        eos_id=2)
    t_seq, t_scores = tbeam.beam_search(
        t_step, {"x": torch.zeros(b * k, 1)}, b, k, steps, bos_id=1,
        eos_id=2)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores),
                               rtol=1e-6, atol=1e-6)
    logp = torch.log_softmax(torch.from_numpy(table), -1)
    for i in range(b):
        prev, total = 1, 0.0
        for t in t_seq[i].tolist():
            if t == tcfg.PAD_ID:
                break
            total += float(logp[prev, t])
            prev = t
            if t == 2:
                break
        assert abs(total - float(t_scores[i])) <= 1e-5
