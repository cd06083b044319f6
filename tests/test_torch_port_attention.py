"""The port's attention kernels (gstx_torch.kernels.attention) on the CPU:
the plain versions against the JAX Pallas kernels run in interpret mode on
the same numpy inputs, the kernel gate in ``layers.attend``, and the model
and greedy engine with the switch on against the JAX package.  The CUDA
kernel itself runs only on the card (chip_smoke.py, and
tests/test_torch_port_cuda.py there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from fixtures import init_tiny_params, make_gen_batch, tiny_enc_dec_configs
from gstx.decode import sampler as jsampler
from gstx.decode.dialog_engine import make_dialog_engine as j_make_engine
from gstx.kernels.attention import fused_attention as j_fused_attention
from gstx.kernels.attention import \
    fused_attention_batch as j_fused_attention_batch
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx_torch.core import config as tcfg
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.decode import sampler as tsampler
from gstx_torch.decode.dialog_engine import make_dialog_engine
from gstx_torch.decode.sampler import init_cache
from gstx_torch.kernels import attention as kattn
from gstx_torch.models.encdec import GSTVisualDialog
from gstx_torch.models.layers import attend

F32_TOL = 2e-5      # tests/test_pallas.py: f32 on both sides, summation order
BF16_TOL = 2e-2     # bf16 I/O: the output rounds to bf16 on both sides
COMPOSED_TOL = 1e-4  # the composed model, f32 on the CPU


def _binary(seed, b, n, p):
    return (np.random.RandomState(seed).rand(b, n) > p).astype(np.float32)


def _padding(binary):
    return ((1.0 - binary) * -10000.0)[:, None, None, :].astype(np.float32)


def _causal(b, n):
    tri = np.tril(np.ones((n, n), np.float32))
    return np.broadcast_to(((1.0 - tri) * -10000.0)[None, None],
                           (b, 1, n, n)).copy()


# (b, h, lq, lk, dh, mask) at the shapes of tests/test_pallas.py:23-64
SHAPES = {
    "text_self": (2, 4, 256, 256, 64,
                  lambda: _padding(_binary(1, 2, 256, 0.2))),
    "visual_self": (2, 2, 37, 37, 128,
                    lambda: _padding(np.ones((2, 37), np.float32))),
    "co_t2v": (1, 2, 256, 37, 128,
               lambda: _padding(np.ones((1, 37), np.float32))),
    "co_v2t": (1, 2, 37, 256, 128,
               lambda: _padding(_binary(2, 1, 256, 0.3))),
    "causal": (2, 2, 24, 24, 64, lambda: _causal(2, 24)),
    "no_mask": (1, 2, 16, 16, 32, lambda: None),
}


def _per_head_mask():
    rng = np.random.RandomState(7)
    return ((rng.rand(2, 2, 24, 40) > 0.7) * -10000.0).astype(np.float32)


def _inputs(b, h, lq, lk, dh, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, lq, dh).astype(np.float32),
            rng.randn(b, h, lk, dh).astype(np.float32),
            rng.randn(b, h, lk, dh).astype(np.float32))


def _compare(port_fn, jax_fn, b, h, lq, lk, dh, mask, act):
    jd, td = ((jnp.float32, torch.float32) if act == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    q, k, v = _inputs(b, h, lq, lk, dh)
    want = jax_fn(*(jnp.asarray(x, jd) for x in (q, k, v)),
                  None if mask is None else jnp.asarray(mask),
                  interpret=True)
    got = port_fn(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                  None if mask is None else torch.from_numpy(mask))
    assert got.dtype == td and tuple(got.shape) == (b, h, lq, dh)
    tol = F32_TOL if act == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES) + ["per_head_mask"])
def test_attention_plain_matches_pallas_interpret(shape, act):
    if shape == "per_head_mask":
        b, h, lq, lk, dh, mask = 2, 2, 24, 40, 64, _per_head_mask()
    else:
        b, h, lq, lk, dh, make = SHAPES[shape]
        mask = make()
    _compare(kattn.attention_plain, j_fused_attention, b, h, lq, lk, dh,
             mask, act)


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_attention_batch_plain_matches_pallas_interpret(shape, act):
    b, h, lq, lk, dh, make = SHAPES[shape]
    _compare(kattn.attention_batch_plain, j_fused_attention_batch,
             b, h, lq, lk, dh, make(), act)


def test_batch_plain_reproduces_unfused_attend():
    """The unfused body of ``attend`` casts the probabilities to the
    activation dtype before PV, which is fused_attention_batch's function:
    in bf16 the two differ by at most the final rounding."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(2, 3, 20, 33, 64, seed=4))
    mask = torch.from_numpy(_padding(_binary(5, 2, 33, 0.3)))
    assert not kattn.is_enabled()
    got, want = attend(q, k, v, mask), kattn.attention_batch_plain(q, k, v,
                                                                   mask)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    kattn.reset_launches()
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 9, 11, 16))
    for fn, plain in ((kattn.fused_attention, kattn.attention_plain),
                      (kattn.fused_attention_batch,
                       kattn.attention_batch_plain)):
        np.testing.assert_array_equal(fn(q, k, v).numpy(),
                                      plain(q, k, v).numpy())
    assert kattn.launches == {"fused_attention": 0,
                              "fused_attention_batch": 0}


LOG2E = np.float32(1.4426950408889634)


def _emulate_bf16_kernel(q, k, v, mask, round_probs):
    """The bf16 kernel's arithmetic (``mma_attention_kernel`` in
    csrc/attention.cu) in f32 on the CPU: 64-key tiles; S from exact bf16
    products; ``s * scale``, then ``+ mask``; a running row max and a running
    sum of the unrounded exponentials ``2^(s log2e - m log2e)``; the
    accumulator rescaled at each tile; P rounded to bf16 (``round_probs``) or
    split into bf16 hi + lo for PV; one multiply by the reciprocal sum at the
    end, rounded once to bf16."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    scale = kattn.softmax_scale(dh)
    mx = torch.full((b, h, lq, 1), -np.inf)
    total = torch.zeros(b, h, lq, 1)
    acc = torch.zeros(b, h, lq, dh)

    def exp_shift(x, m):
        return torch.exp2(x * LOG2E - m * LOG2E)
    for j0 in range(0, lk, 64):
        kt, vt = kf[:, :, j0:j0 + 64], vf[:, :, j0:j0 + 64]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask[..., j0:j0 + 64].float()
        m = torch.maximum(mx, s.amax(-1, keepdim=True))
        base = torch.where(m == -np.inf, 0.0, m)
        alpha = exp_shift(mx, base)
        p = exp_shift(s, base)
        total = total * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.matmul(hi, vt)
        if not round_probs:
            pv = pv + torch.matmul((p - hi).to(torch.bfloat16).float(), vt)
        acc = acc * alpha + pv
        mx = m
    return (acc * (1.0 / total)).to(torch.bfloat16)


# (b, h, lq, lk, dh, mask): the engine's shape kinds, scaled down to B = H = 2
EMULATED = {
    "text_self_256x64": (2, 2, 256, 256, 64, "padding"),
    "visual_self_37x128": (2, 2, 37, 37, 128, "padding"),
    "scoring_cross_18x293x64": (2, 2, 18, 293, 64, "padding"),
    "scoring_self_18x64_causal": (2, 2, 18, 18, 64, "causal"),
    "ragged_100x171x64": (2, 2, 100, 171, 64, "padding"),
}


@pytest.mark.parametrize("round_probs", [False, True],
                         ids=["fused_attention", "fused_attention_batch"])
@pytest.mark.parametrize("shape", sorted(EMULATED))
def test_bf16_kernel_arithmetic_holds_phase2_tolerance(shape, round_probs):
    """The kernel's online-softmax arithmetic, rehearsed on the CPU, stays
    within chip_smoke phase 2's ``1e-2 + 1.6e-2 |plain|`` of the plain
    version on the same bf16 inputs."""
    b, h, lq, lk, dh, kind = EMULATED[shape]
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(b, h, lq, lk, dh, seed=11))
    mask = _padding(_binary(12, b, lk, 0.3))
    mask[:, :, :, 0] = 0.0  # every row keeps a key
    if kind == "causal":
        mask = mask + _causal(b, lq)
    mask = torch.from_numpy(mask)
    plain = (kattn.attention_batch_plain if round_probs
             else kattn.attention_plain)(q, k, v, mask)
    got = _emulate_bf16_kernel(q, k, v, mask, round_probs)
    assert got.dtype == torch.bfloat16 and got.shape == plain.shape
    err = (got.float() - plain.float()).abs()
    limit = 1e-2 + 1.6e-2 * plain.float().abs()
    assert bool((err <= limit).all()), float((err / limit).max())


def test_max_key_length_per_instance():
    # f32: the score rows in shared memory; bf16: the streamed keys' int
    # indices
    assert kattn.max_key_length(128, torch.float32) == 1408
    assert kattn.max_key_length(64, torch.float32) > 293
    assert kattn.max_key_length(64, torch.bfloat16) == 2 ** 31 - 64


def test_non_cpu_non_cuda_device_raises():
    q = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        kattn.fused_attention(q, q, q)


def test_gate_order_and_switch():
    q = torch.zeros(2, 2, 8, 16)
    k = torch.zeros(2, 2, 5, 16)
    assert kattn.maybe_fused_attention(q, k, k, None) is None  # switch off
    kattn.enable()
    try:
        assert kattn.maybe_fused_attention(q, k, k, None) is not None
        assert kattn.maybe_fused_attention(q[:, :, :7], k, k, None) is None
        # a decode step's 1-D cache mask is never looked at: Lq < 8 first
        assert kattn.maybe_fused_attention(q[:, :, :1], k, k,
                                           torch.zeros(5)) is None
        assert kattn.maybe_fused_attention(
            q, k, k, torch.zeros(1, 1, 1, 5)) is None  # mask batch 1 != 2
    finally:
        kattn.enable(False)


def _torch_configs(enc, dec):
    return (tcfg.EncoderConfig(**dataclasses.asdict(enc)),
            tcfg.DecoderConfig(**dataclasses.asdict(dec)))


def _kernel_head_configs():
    """The tiny configs with 2 heads of 16 in every attention (text, visual,
    co-attention, decoder): a head width the CUDA kernel takes, so the gate
    sends every eligible attention to the wrapper (its plain version on the
    CPU).  The tiny configs' own heads of 8 and 6 it declines."""
    enc, dec = tiny_enc_dec_configs()
    enc = dataclasses.replace(
        enc, num_attention_heads=2, v_hidden_size=32, v_num_attention_heads=2,
        bi_hidden_size=32, bi_num_attention_heads=2)
    return enc, dataclasses.replace(dec, num_attention_heads=2)


def _count_calls(monkeypatch):
    calls = []
    real = kattn.fused_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(kattn, "fused_attention", counting)
    return calls


@pytest.mark.parametrize("regions,want", [(8, 4 + 2 + 2 * 2), (5, 4 + 2)])
def test_encoder_forward_calls_the_kernel_per_gate(monkeypatch, regions,
                                                   want):
    """Tiny encoder (4 text, 2 visual, 2 co-attention layers): every
    attention with 8 or more query rows takes the kernel.  With 5 regions
    the visual self-attentions and the visual-query co-attentions fall
    below the gate; a decode step (one query row) never reaches it."""
    enc, dec = _torch_configs(*_kernel_head_configs())
    model = GSTVisualDialog(enc, dec, device="cpu")
    calls = _count_calls(monkeypatch)
    b, s = 2, 12
    ids = torch.randint(1, enc.vocab_size, (b, s),
                        generator=torch.Generator().manual_seed(0))
    kattn.enable()
    try:
        with torch.no_grad():
            kv, mask = model.decode_prepare(
                ids, torch.rand(b, regions, enc.v_feature_size),
                torch.rand(b, regions, 5), torch.zeros_like(ids),
                torch.ones_like(ids), torch.ones(b, regions))
            assert len(calls) == want
            caches = init_cache(dec, b, 4, torch.float32, "cpu")
            model.decode_step(torch.full((b, 1), 101), 0, caches, kv, mask)
        assert len(calls) == want
    finally:
        kattn.enable(False)


def test_encoder_forward_at_head_widths_the_kernel_refuses(monkeypatch):
    """The tiny configs' heads of 8 (text) and 6 (visual, co-attention):
    with the switch on the gate declines every attention, and the unfused
    ops give the switch-off result."""
    enc, dec = _torch_configs(*tiny_enc_dec_configs())
    model = GSTVisualDialog(enc, dec, device="cpu")
    calls = _count_calls(monkeypatch)
    b, s, r = 2, 12, 8
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(1, enc.vocab_size, (b, s), generator=gen)
    args = (ids, torch.rand(b, r, enc.v_feature_size, generator=gen),
            torch.rand(b, r, 5, generator=gen), torch.zeros_like(ids),
            torch.ones_like(ids), torch.ones(b, r))
    with torch.no_grad():
        want, _ = model.decode_prepare(*args)
        kattn.enable()
        try:
            got, _ = model.decode_prepare(*args)
        finally:
            kattn.enable(False)
    assert calls == []
    for pair_got, pair_want in zip(got, want):
        for g, w in zip(pair_got, pair_want):
            assert torch.equal(g, w)


@pytest.fixture(scope="module")
def jax_setup():
    enc, dec = _kernel_head_configs()
    params = init_tiny_params(enc, dec)
    model = GSTVisualDialog(*_torch_configs(enc, dec), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                          strict=True)
    return enc, dec, params, model


def test_composed_model_with_switch_on_matches_jax(jax_setup, monkeypatch):
    """Encoder, memory K/V and the scoring pass with every eligible
    attention through fused_attention (its plain version here) against the
    JAX model (whose gate is off the TPU): f32 within 1e-4."""
    enc, dec, params, model = jax_setup
    batch = make_gen_batch(enc, b=3, seq_len=24, regions=9, cap_len=14)
    ids = batch["enc_input_ids"]
    args = (ids, batch["enc_image_feat"], batch["enc_image_loc"],
            batch["enc_segments"], (ids != 0).astype(np.int32),
            batch["enc_image_mask"])
    jmodel = JGST(enc, dec)
    want_kv, want_mask = jmodel.apply(params, *map(jnp.asarray, args),
                                      method=JGST.decode_prepare)
    rng = np.random.RandomState(4)
    dec_ids = rng.randint(1, dec.vocab_size, size=(3, 9)).astype(np.int32)
    dec_att = np.ones((3, 9), np.int32)
    dec_att[1, 6:] = 0
    want = jmodel.apply(params, jnp.asarray(dec_ids), jnp.asarray(dec_att),
                        want_kv, want_mask, method=JGST.decode_logits_cached)

    calls = _count_calls(monkeypatch)
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    kattn.enable()
    try:
        with torch.no_grad():
            got_kv, got_mask = model.decode_prepare(
                t[0].long(), t[1], t[2], t[3].long(), t[4].long(), t[5])
            got = model.decode_logits_cached(
                torch.from_numpy(dec_ids).long(),
                torch.from_numpy(dec_att).long(), got_kv, got_mask)
    finally:
        kattn.enable(False)
    # 10 encoder attentions + 2 decoder self-attentions (the cross-attention
    # over the memory, 9 queries, is eligible too)
    assert len(calls) == 10 + 2 * dec.num_hidden_layers
    for (gk, gv), (wk, wv) in zip(got_kv, want_kv):
        for g, w in ((gk, wk), (gv, wv)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=COMPOSED_TOL, atol=COMPOSED_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=COMPOSED_TOL, atol=COMPOSED_TOL)


def test_greedy_engine_with_switch_on_matches_jax(jax_setup):
    enc, dec, params, model = jax_setup
    batch = make_gen_batch(enc, b=3, seq_len=32, regions=9, cap_len=12)
    greedy_q = dict(max_steps=4, top_k=1, ngram_blocking_size=4)
    greedy_a = dict(max_steps=4, top_k=1, ngram_blocking_size=0)
    want = j_make_engine(
        JGST(enc, dec), dec, num_rounds=2,
        q_settings=jsampler.DecodeSettings(**greedy_q),
        a_settings=jsampler.DecodeSettings(**greedy_a))(
        params, params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(3))
    engine = make_dialog_engine(
        num_rounds=2, q_settings=tsampler.DecodeSettings(**greedy_q),
        a_settings=tsampler.DecodeSettings(**greedy_a), device="cpu")
    kattn.enable()
    try:
        got = engine(model, model, batch, torch.Generator().manual_seed(3))
    finally:
        kattn.enable(False)
    np.testing.assert_array_equal(got.questions.numpy(),
                                  np.asarray(want.questions))
    np.testing.assert_array_equal(got.answers.numpy(),
                                  np.asarray(want.answers))
    np.testing.assert_allclose(got.answer_ppl.numpy(),
                               np.asarray(want.answer_ppl),
                               rtol=COMPOSED_TOL, atol=COMPOSED_TOL)
