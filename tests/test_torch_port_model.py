"""The port's model (gstx_torch.models) against the JAX package's, f32 on
the CPU: the weight bridge, each block, the composed decode path, and the
KV-cache invariant.  JAX params come from the tiny fixture init and reach
the port through ``state_dict_from_jax`` + a strict ``load_state_dict``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from fixtures import init_tiny_params, make_gen_batch, tiny_enc_dec_configs
from gstx.core.checkpoint import to_torch_state_dict
from gstx.models.decoder import DecoderLayer as JDecoderLayer
from gstx.models.embeddings import DialogEmbeddings as JDialogEmbeddings
from gstx.models.embeddings import ImageEmbeddings as JImageEmbeddings
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx.models.layers import TransformerLayer as JTransformerLayer
from gstx.models.two_stream import CoAttentionLayer as JCoAttentionLayer
from gstx_torch.core import config as tcfg
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models.encdec import GSTVisualDialog
from gstx_torch.models.layers import additive_mask as t_additive_mask

BLOCK_TOL = 1e-5     # one block, f32 on the CPU
COMPOSED_TOL = 1e-4  # the composed model, f32 on the CPU


def torch_configs(enc, dec):
    return (tcfg.EncoderConfig(**dataclasses.asdict(enc)),
            tcfg.DecoderConfig(**dataclasses.asdict(dec)))


def port_model(enc, dec, np_params):
    model = GSTVisualDialog(*torch_configs(enc, dec), device="cpu")
    model.load_state_dict(state_dict_from_jax(np_params), strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    enc, dec = tiny_enc_dec_configs()
    params = init_tiny_params(enc, dec)
    np_params = jax.device_get(params)
    return enc, dec, params, np_params, port_model(enc, dec, np_params)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


def _add_mask(binary):
    return ((1.0 - binary[:, None, None, :]) * -10000.0).astype(np.float32)


def test_state_dict_matches_jax_converter(setup):
    _, _, _, np_params, model = setup
    got = state_dict_from_jax(np_params)
    want = to_torch_state_dict(np_params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the port owns every name the reference layout has, and nothing else
    assert sorted(model.state_dict()) == sorted(want)


def test_unused_q_dense_names_are_owned_and_zero(setup):
    """The co-attention biOutput.q_dense1/q_dense2 projections are never
    called; the port keeps them as parameters so a reference checkpoint
    loads strictly, and the bridge fills them with zeros."""
    _, _, _, _, model = setup
    sd = model.state_dict()
    names = [k for k in sd if ".biOutput.q_dense" in k]
    assert len(names) == 4 * 2  # 2 co-attention layers x {1,2} x {w,b}
    assert all(float(sd[k].abs().max()) == 0.0 for k in names)


def test_tying_topology(setup):
    _, _, _, _, model = setup
    emb = model.bert.embeddings
    assert model.dec.bert.embeddings is emb
    assert model.encoder.bert_pretrained.cls.predictions.decoder.weight \
        is emb.word_embeddings.weight
    assert model.dec.lm_head.bias is model.dec.lm_head.decoder.bias
    assert model.dec.lm_head.decoder.weight is not emb.word_embeddings.weight


def test_dialog_and_image_embeddings(setup):
    enc, _, params, _, model = setup
    rng = np.random.RandomState(0)
    ids = rng.randint(0, enc.vocab_size, size=(3, 11)).astype(np.int32)
    segs = rng.randint(0, 6, size=(3, 11)).astype(np.int32)  # incl. extension
    want = JDialogEmbeddings(enc).apply(
        {"params": params["params"]["encoder"]["embeddings"]},
        jnp.asarray(ids), jnp.asarray(segs))
    got = model.bert.embeddings(_t(ids).long(), _t(segs).long())
    _close(got, want, BLOCK_TOL)

    feat = rng.rand(3, 7, enc.v_feature_size).astype(np.float32)
    loc = rng.rand(3, 7, 5).astype(np.float32)
    want = JImageEmbeddings(enc).apply(
        {"params": params["params"]["encoder"]["v_embeddings"]},
        jnp.asarray(feat), jnp.asarray(loc))
    _close(model.bert.v_embeddings(_t(feat), _t(loc)), want, BLOCK_TOL)


def test_transformer_layer(setup):
    enc, _, params, _, model = setup
    rng = np.random.RandomState(1)
    x = rng.randn(3, 9, enc.hidden_size).astype(np.float32)
    m = np.ones((3, 9), np.float32)
    m[1, 6:] = 0
    layer = JTransformerLayer(
        num_heads=enc.num_attention_heads, head_dim=enc.head_dim,
        intermediate_size=enc.intermediate_size, attn_dropout=0.0,
        hidden_dropout=0.0)
    want = layer.apply(
        {"params": params["params"]["encoder"]["encoder"]["layer_0"]},
        jnp.asarray(x), jnp.asarray(_add_mask(m)))
    got = model.bert.encoder.layer[0](_t(x), _t(_add_mask(m)))
    _close(got, want, BLOCK_TOL)


def test_coattention_layer(setup):
    enc, _, params, _, model = setup
    rng = np.random.RandomState(2)
    v = rng.randn(3, 7, enc.v_hidden_size).astype(np.float32)
    t = rng.randn(3, 9, enc.hidden_size).astype(np.float32)
    vm = _add_mask(np.ones((3, 7), np.float32))
    tm_bin = np.ones((3, 9), np.float32)
    tm_bin[0, 5:] = 0
    tm = _add_mask(tm_bin)
    want_v, want_t = JCoAttentionLayer(enc).apply(
        {"params": params["params"]["encoder"]["encoder"]["c_layer_0"]},
        jnp.asarray(v), jnp.asarray(vm), jnp.asarray(t), jnp.asarray(tm))
    got_v, got_t = model.bert.encoder.c_layer[0](_t(v), _t(vm), _t(t),
                                                  _t(tm))
    _close(got_v, want_v, BLOCK_TOL)
    _close(got_t, want_t, BLOCK_TOL)


def test_decoder_layer(setup):
    _, dec, params, _, model = setup
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, dec.hidden_size).astype(np.float32)
    mem = rng.randn(2, 10, dec.hidden_size).astype(np.float32)
    mem_bin = np.ones((2, 10), np.float32)
    mem_bin[1, 8:] = 0
    causal = np.tril(np.ones((6, 6), np.float32))
    self_mask = ((1.0 - causal) * -10000.0)[None, None].repeat(2, 0)
    want = JDecoderLayer(dec).apply(
        {"params": params["params"]["decoder"]["layer_0"]},
        jnp.asarray(x), jnp.asarray(self_mask), jnp.asarray(mem),
        jnp.asarray(_add_mask(mem_bin)))
    got = model.dec.layers[0](_t(x), _t(self_mask), _t(mem),
                              _t(_add_mask(mem_bin)))
    _close(got, want, BLOCK_TOL)


def _prepare_inputs(enc, b=3, seq_len=24):
    batch = make_gen_batch(enc, b=b, seq_len=seq_len, regions=7, cap_len=14)
    ids = batch["enc_input_ids"]
    att = (ids != 0).astype(np.int32)
    return (ids, batch["enc_image_feat"], batch["enc_image_loc"],
            batch["enc_segments"], att, batch["enc_image_mask"])


def _torch_inputs(args):
    ids, feat, loc, segs, att, imask = args
    return (_t(ids).long(), _t(feat), _t(loc), _t(segs).long(), _t(att).long(),
            _t(imask))


def test_decode_prepare_and_cached_logits(setup):
    enc, dec, params, _, model = setup
    args = _prepare_inputs(enc)
    jmodel = JGST(enc, dec)
    want_kv, want_mask = jmodel.apply(
        params, *map(jnp.asarray, args), method=JGST.decode_prepare)
    got_kv, got_mask = model.decode_prepare(*_torch_inputs(args))
    assert len(got_kv) == len(want_kv) == dec.num_hidden_layers
    for (gk, gv), (wk, wv) in zip(got_kv, want_kv):
        _close(gk, wk, COMPOSED_TOL)
        _close(gv, wv, COMPOSED_TOL)
    _close(got_mask, want_mask, 0.0)

    rng = np.random.RandomState(4)
    dec_ids = rng.randint(1, dec.vocab_size, size=(3, 7)).astype(np.int32)
    dec_att = np.ones((3, 7), np.int32)
    dec_att[2, 5:] = 0
    want = jmodel.apply(params, jnp.asarray(dec_ids), jnp.asarray(dec_att),
                        want_kv, want_mask, method=JGST.decode_logits_cached)
    got = model.decode_logits_cached(_t(dec_ids).long(), _t(dec_att).long(),
                                     got_kv, got_mask)
    assert got.dtype == torch.float32
    _close(got, want, COMPOSED_TOL)


def test_score_teacher_forced_from_scratch(setup):
    """encode -> fuse -> teacher-forced decode, without the cached memory."""
    enc, dec, params, _, model = setup
    args = _prepare_inputs(enc)
    rng = np.random.RandomState(6)
    dec_ids = rng.randint(1, dec.vocab_size, size=(3, 6)).astype(np.int32)
    dec_att = np.ones((3, 6), np.int32)
    dec_att[0, 4:] = 0
    want = JGST(enc, dec).apply(params, *map(jnp.asarray, args),
                                jnp.asarray(dec_ids), jnp.asarray(dec_att),
                                method=JGST.score)
    got = model.score(*_torch_inputs(args), _t(dec_ids).long(),
                      _t(dec_att).long())
    _close(got, want, COMPOSED_TOL)


def test_precast_keeps_layernorm_and_lm_bias_f32():
    enc, dec = torch_configs(*tiny_enc_dec_configs())
    from gstx_torch.models.encdec import precast_
    from gstx_torch.models.layers import LayerNorm

    model = precast_(GSTVisualDialog(enc, dec, device="cpu"))
    ln_params = {id(p) for m in model.modules() if isinstance(m, LayerNorm)
                 for p in m.parameters()}
    for name, p in model.named_parameters():
        f32 = id(p) in ln_params or p is model.dec.lm_head.bias
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    assert model.dtype == torch.bfloat16
    # tying survives the in-place cast
    assert model.encoder.bert_pretrained.cls.predictions.decoder.weight \
        is model.bert.embeddings.word_embeddings.weight


def test_pretrain_scores(setup):
    enc, dec, params, _, model = setup
    args = _prepare_inputs(enc)
    want = JGST(enc, dec).apply(params, *map(jnp.asarray, args),
                                method=JGST.pretrain_scores)
    got = model.pretrain_scores(*_torch_inputs(args))
    for g, w in zip(got, want):
        _close(g, w, COMPOSED_TOL)


def test_kv_cached_steps_equal_teacher_forced(setup):
    """CLAUDE.md invariant: KV-cached decode == teacher-forced logits."""
    enc, dec, _, _, model = setup
    from gstx_torch.decode.sampler import init_cache

    with torch.no_grad():
        mem_kv, mem_mask = model.decode_prepare(
            *_torch_inputs(_prepare_inputs(enc)))
        rng = np.random.RandomState(5)
        ids = torch.from_numpy(
            rng.randint(1, dec.vocab_size, size=(3, 8))).long()
        want = model.decode_logits_cached(ids, torch.ones_like(ids), mem_kv,
                                          mem_mask)
        caches = init_cache(dec, 3, 8, torch.float32, "cpu")
        got = torch.stack([
            model.decode_step(ids[:, i:i + 1], i, caches, mem_kv, mem_mask)
            for i in range(8)], dim=1)
    _close(got, want.numpy(), BLOCK_TOL)


def test_fused_gate_routes_bf16_at_aligned_widths(monkeypatch):
    """At bf16 with widths divisible by 128 every attention-output
    projection and every encoder FFN goes through the kernel wrappers (on
    the CPU they take the plain versions): T + V + 2C calls of each per
    encoder forward, 30 at the production widths and depth."""
    enc = tcfg.EncoderConfig(
        vocab_size=160, hidden_size=128, num_hidden_layers=3,
        num_attention_heads=2, intermediate_size=256, v_feature_size=16,
        v_hidden_size=128, v_num_hidden_layers=2, v_num_attention_heads=2,
        v_intermediate_size=128, bi_hidden_size=128,
        bi_num_attention_heads=2, v_biattention_id=(0, 1),
        t_biattention_id=(1, 2))
    dec = tcfg.DecoderConfig(vocab_size=160, hidden_size=128,
                             num_hidden_layers=1, num_attention_heads=2,
                             intermediate_size=256)
    calls = {"dense_ln": 0, "ffn": 0}
    plain_dense_ln, plain_ffn = kffn.dense_ln_plain, kffn.ffn_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kffn, "dense_ln_plain",
                        count("dense_ln", plain_dense_ln))
    monkeypatch.setattr(kffn, "ffn_plain", count("ffn", plain_ffn))
    from gstx_torch.models.encdec import precast_

    model = precast_(GSTVisualDialog(enc, dec, device="cpu"))
    b, s, r = 2, 16, 5
    ids = torch.randint(1, 160, (b, s))
    with torch.no_grad():
        kv, _ = model.decode_prepare(
            ids, torch.rand(b, r, 16), torch.rand(b, r, 5),
            torch.zeros_like(ids), torch.ones_like(ids), torch.ones(b, r))
    per_forward = enc.num_hidden_layers + enc.v_num_hidden_layers \
        + 2 * len(enc.v_biattention_id)
    assert calls == {"dense_ln": per_forward, "ffn": per_forward}
    assert kv[0][0].dtype == torch.bfloat16
    # f32 keeps the unfused ops
    calls.update(dense_ln=0, ffn=0)
    model32 = GSTVisualDialog(enc, dec, device="cpu")
    with torch.no_grad():
        model32.decode_prepare(
            ids, torch.rand(b, r, 16), torch.rand(b, r, 5),
            torch.zeros_like(ids), torch.ones_like(ids), torch.ones(b, r))
    assert calls == {"dense_ln": 0, "ffn": 0}


def test_additive_mask_dtype():
    m = torch.tensor([[1, 0]])
    out = t_additive_mask(m, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 1, 1, 2)
    assert float(out[0, 0, 0, 0]) == 0.0 and float(out[0, 0, 0, 1]) < -9000
