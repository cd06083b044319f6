"""The port's int8 decode memory (gstx_torch.models.decoder,
gstx_torch.kernels.decode_attn) on the CPU against the JAX package: the
plain decode kernel against the Pallas kernel in interpret mode, the
quantization bit for bit, the int8 decode step, scoring pass and greedy
decode, and the engine's quantize wiring.  The CUDA kernel itself runs only
on the card (chip_smoke.py, and tests/test_torch_port_cuda.py there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from fixtures import init_tiny_params, make_gen_batch, tiny_enc_dec_configs
from gstx.decode import sampler as jsampler
from gstx.decode.sampler import init_cache as j_init_cache
from gstx.kernels.decode_attn import \
    quant_decode_attention as j_quant_decode_attention
from gstx.models import decoder as jdecoder
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx_torch.core import config as tcfg
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.decode import sampler as tsampler
from gstx_torch.decode.dialog_engine import make_dialog_engine
from gstx_torch.kernels import decode_attn as kdecode
from gstx_torch.models import decoder as tdecoder
from gstx_torch.models.encdec import GSTVisualDialog

COMPOSED_TOL = 1e-4  # the composed model, f32 on the CPU


def _int8_inputs(seed, b, h, m, dh, valid_m=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, 1, dh).astype(np.float32)
    k = rng.randint(-127, 128, (b, h, m, dh)).astype(np.int8)
    v = rng.randint(-127, 128, (b, h, m, dh)).astype(np.int8)
    mask = None
    if valid_m is not None:
        binm = (np.arange(m)[None, :] < valid_m).astype(np.float32)
        mask = np.broadcast_to(((1.0 - binm) * -10000.0)[:, None, None, :],
                               (b, 1, 1, m)).copy()
    return q, k, v, mask


@pytest.mark.parametrize("b,h,m,dh,valid_m", [(3, 4, 37, 16, 30),
                                              (2, 2, 8, 8, None),
                                              (2, 3, 69, 64, 50)])
def test_decode_plain_matches_pallas_interpret(b, h, m, dh, valid_m):
    q, k, v, mask = _int8_inputs(3, b, h, m, dh, valid_m)
    want = j_quant_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), interpret=True)
    got = kdecode.quant_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, 1, dh)
    # tests/test_pallas.py:91: summation-order noise on O(100)-magnitude
    # int8 dots
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=5e-3)


def test_decode_gate_and_cpu_launch_count():
    q, k, v, mask = (None if x is None else torch.from_numpy(x)
                     for x in _int8_inputs(1, 2, 2, 9, 16, 6))
    kdecode.reset_launches()
    assert kdecode.maybe_quant_decode_attention(q, k, v, mask) is None
    kdecode.enable_kernel()
    try:
        assert kdecode.is_kernel_enabled()
        got = kdecode.maybe_quant_decode_attention(q, k, v, mask)
        np.testing.assert_array_equal(
            got.numpy(),
            kdecode.quant_decode_attention_plain(q, k, v, mask).numpy())
        # more than one query row: the caller's unfused ops
        assert kdecode.maybe_quant_decode_attention(
            q.expand(-1, -1, 2, -1), k, v, mask) is None
    finally:
        kdecode.enable_kernel(False)
    assert kdecode.launches == {"quant_decode_attention": 0}


def _memory(seed, b, h, m, dh, valid_m, dtype):
    rng = np.random.RandomState(seed)
    k = (rng.randn(b, h, m, dh) * 2.0).astype(np.float32)
    v = (rng.randn(b, h, m, dh) * 3.0).astype(np.float32)
    k[:, :, valid_m:] *= 50.0  # padding slots must not set the scale
    binm = (np.arange(m)[None, :] < valid_m).astype(np.float32)
    mask = np.broadcast_to(((1.0 - binm) * -10000.0)[:, None, None, :],
                           (b, 1, 1, m)).astype(np.float32)
    jd, td = dtype
    return ((jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(mask)),
            (torch.from_numpy(k).to(td), torch.from_numpy(v).to(td),
             torch.from_numpy(mask)))


@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_quantize_memory_kv_matches_jax(dtype):
    (jk, jv, jm), (tk, tv, tm) = _memory(0, 2, 3, 40, 16, 29, dtype)
    (want,) = jdecoder.quantize_memory_kv([(jk, jv)], jm, dtype[0])
    (got,) = tdecoder.quantize_memory_kv([(tk, tv)], tm, dtype[1])
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.int8 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == dtype[1] and tuple(g.shape) == (2, 3, 1, 16)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-6,
                                   atol=0)
    assert not got[0][:, :, 29:].any()  # padding slots zeroed


def test_quantized_scales_independent_of_bucket_width():
    (_, _, _), (k, v, mask) = _memory(1, 2, 3, 64, 16, 40,
                                      (jnp.float32, torch.float32))
    (wide,) = tdecoder.quantize_memory_kv([(k, v)], mask, torch.float32)
    (narrow,) = tdecoder.quantize_memory_kv(
        [(k[:, :, :48], v[:, :, :48])], mask[..., :48], torch.float32)
    for w, n in zip(wide[2:], narrow[2:]):
        np.testing.assert_array_equal(w.numpy(), n.numpy())
    for w, n in zip(wide[:2], narrow[:2]):
        np.testing.assert_array_equal(w[:, :, :40].numpy(),
                                      n[:, :, :40].numpy())


def test_dequantized_error_within_half_a_step():
    (_, _, _), (k, v, mask) = _memory(2, 2, 3, 30, 16, 25,
                                      (jnp.float32, torch.float32))
    mem = tdecoder.quantize_memory_kv([(k, v)], mask, torch.float32)[0]
    assert tdecoder.dequantize_kv((k, v)) == (k, v)
    for orig, deq, sc in zip((k, v), tdecoder.dequantize_kv(mem), mem[2:]):
        err = (orig - deq).abs()[:, :, :25]
        assert bool((err <= sc * 0.51).all())


def _torch_configs(enc, dec):
    return (tcfg.EncoderConfig(**dataclasses.asdict(enc)),
            tcfg.DecoderConfig(**dataclasses.asdict(dec)))


@pytest.fixture(scope="module")
def int8_setup():
    """The tiny JAX model, the port with its weights, and one int8 memory
    quantized by JAX and handed to both (so a K/V value within 1e-7 of a
    rounding boundary cannot make the two sides' int8 differ)."""
    enc, dec = tiny_enc_dec_configs()
    params = init_tiny_params(enc, dec)
    model = GSTVisualDialog(*_torch_configs(enc, dec), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                          strict=True)
    batch = make_gen_batch(enc, b=3, seq_len=24, regions=7, cap_len=12)
    ids = batch["enc_input_ids"]
    jmodel = JGST(enc, dec)
    mem_kv, mem_mask = jmodel.apply(
        params, jnp.asarray(ids), jnp.asarray(batch["enc_image_feat"]),
        jnp.asarray(batch["enc_image_loc"]),
        jnp.asarray(batch["enc_segments"]),
        jnp.asarray((ids != 0).astype(np.int32)),
        jnp.asarray(batch["enc_image_mask"]), method=JGST.decode_prepare)
    j_mem = jdecoder.quantize_memory_kv(mem_kv, mem_mask, jnp.float32)
    t_mem = [tuple(torch.from_numpy(np.array(x)) for x in layer)
             for layer in j_mem]
    t_mask = torch.from_numpy(np.array(mem_mask))
    return enc, dec, params, jmodel, model, (j_mem, mem_mask), (t_mem, t_mask)


@pytest.mark.parametrize("kernel", [False, True], ids=["unfused", "kernel"])
def test_int8_decode_step_matches_jax(int8_setup, kernel):
    _, dec, params, jmodel, model, (j_mem, j_mask), (t_mem, t_mask) = \
        int8_setup
    b = t_mask.shape[0]
    tok = np.full((b, 1), 101, np.int32)
    want, _ = jmodel.apply(params, jnp.asarray(tok), 0,
                           j_init_cache(dec, b, 3, jnp.float32), j_mem,
                           j_mask, method=JGST.decode_step)
    kdecode.enable_kernel(kernel)
    try:
        with torch.no_grad():
            got = model.decode_step(
                torch.from_numpy(tok).long(), 0,
                tsampler.init_cache(dec, b, 3, torch.float32, "cpu"),
                t_mem, t_mask)
    finally:
        kdecode.enable_kernel(False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=COMPOSED_TOL, atol=COMPOSED_TOL)


def test_int8_scoring_pass_matches_jax(int8_setup):
    _, dec, params, jmodel, model, (j_mem, j_mask), (t_mem, t_mask) = \
        int8_setup
    rng = np.random.RandomState(8)
    ids = rng.randint(1, dec.vocab_size, size=(3, 9)).astype(np.int32)
    att = np.ones((3, 9), np.int32)
    att[0, 5:] = 0
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(att), j_mem,
                        j_mask, method=JGST.decode_logits_cached)
    with torch.no_grad():
        got = model.decode_logits_cached(torch.from_numpy(ids).long(),
                                         torch.from_numpy(att).long(),
                                         t_mem, t_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=COMPOSED_TOL, atol=COMPOSED_TOL)


def test_greedy_decode_over_int8_memory_token_identical(int8_setup):
    _, dec, params, jmodel, model, (j_mem, j_mask), (t_mem, t_mask) = \
        int8_setup
    b, steps = t_mask.shape[0], 6
    settings = dict(max_steps=steps, top_k=1, ngram_blocking_size=0)

    def j_step(tok, pos, caches):
        return jmodel.apply(params, tok, pos, caches, j_mem, j_mask,
                            method=JGST.decode_step)

    want = jsampler.sample_sequence(
        j_step, jax.random.PRNGKey(0), b,
        j_init_cache(dec, b, steps + 1, jnp.float32),
        jsampler.DecodeSettings(**settings), bos_id=101, eos_id=102)
    kdecode.enable_kernel()
    try:
        with torch.no_grad():
            got = tsampler.sample_sequence(
                lambda tok, pos, c: model.decode_step(tok, pos, c, t_mem,
                                                      t_mask),
                torch.Generator().manual_seed(0), b,
                tsampler.init_cache(dec, b, steps + 1, torch.float32, "cpu"),
                tsampler.DecodeSettings(**settings), bos_id=101, eos_id=102,
                device="cpu")
    finally:
        kdecode.enable_kernel(False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _count_quantize(monkeypatch):
    called = []
    real = tdecoder.quantize_memory_kv
    monkeypatch.setattr(tdecoder, "quantize_memory_kv",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    return called


def _engine_run(dtype, rounds=1):
    enc, dec = _torch_configs(*tiny_enc_dec_configs())
    model = GSTVisualDialog(enc, dec, device="cpu", seed=3)
    batch = make_gen_batch(enc, b=2, seq_len=32, regions=5, cap_len=6)
    engine = make_dialog_engine(
        num_rounds=rounds,
        q_settings=tsampler.DecodeSettings(max_steps=3),
        a_settings=tsampler.DecodeSettings(max_steps=3,
                                           ngram_blocking_size=0),
        dtype=dtype, quantize_memory=True, device="cpu")
    return engine(model, model, batch, torch.Generator().manual_seed(0))


def test_f32_engine_never_quantizes(monkeypatch):
    called = _count_quantize(monkeypatch)
    _engine_run(torch.float32)
    assert not called


def test_bf16_engine_quantizes_each_utterance(monkeypatch):
    called = _count_quantize(monkeypatch)
    out = _engine_run(torch.bfloat16)
    assert len(called) == 2  # the question's memory and the answer's
    assert tuple(out.answer_ppl.shape) == (1, 2)
    assert bool(torch.isfinite(out.answer_ppl).all())
