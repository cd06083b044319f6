"""The port's CUDA kernels on the card: each against its plain version at
small and ragged shapes, the launch counters, the wrappers' refusals, and
the fused kernels under autograd.
Marked ``cuda``; skipped on a machine without a card.  On the card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import pytest
import torch
from torch import nn

from gstx_torch.kernels import attention as kattn
from gstx_torch.kernels import build
from gstx_torch.kernels import decode_attn as kdecode
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models import layers

pytestmark = pytest.mark.cuda

ABS_TOL, REL_TOL = 1e-2, 1.6e-2  # about 2 bf16 ulps, as chip_smoke.py
# bf16 kernel-path eval scores, centred over each round's options, against
# the f32 model's (relative error); a control with the FFN lost exceeds it
EVAL_SCORE_TOL = 4e-2


@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(k, p):
    err = (k.float() - p.float()).abs()
    assert bool((err <= ABS_TOL + REL_TOL * p.float().abs()).all()), \
        float(err.max())


def _dense_ln_args(dev, m, k, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0, dtype=torch.bfloat16, shift=0.0):
        return (torch.randn(*s, generator=g, device=dev) * scale
                + shift).to(dtype)
    return (r(m, k), r(d, k, scale=0.02), r(d, scale=0.02, dtype=torch.float32),
            r(m, d), r(d, scale=0.1, shift=1.0, dtype=torch.float32),
            r(d, scale=0.1, dtype=torch.float32))


def _ffn_args(dev, m, d, f, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0, dtype=torch.bfloat16, shift=0.0):
        return (torch.randn(*s, generator=g, device=dev) * scale
                + shift).to(dtype)
    f32 = torch.float32
    return (r(m, d), r(f, d, scale=0.02), r(f, scale=0.02, dtype=f32),
            r(d, f, scale=0.02), r(d, scale=0.02, dtype=f32),
            r(d, scale=0.1, shift=1.0, dtype=f32), r(d, scale=0.1, dtype=f32))


@pytest.mark.parametrize("m,k,d", [(70, 256, 256), (33, 1024, 768),
                                   (1, 128, 1024), (500, 768, 128)])
def test_dense_ln_kernel_matches_plain(dev, m, k, d):
    args = _dense_ln_args(dev, m, k, d)
    _close(kffn.fused_dense_ln(*args), kffn.dense_ln_plain(*args))


# dense_ln across the block-row rule (64 x 132 rows) at the text width;
# inner widths past the first design's 1,024 limit; D = 1,024 at 32 rows
# (the visual shape itself last)
DENSE_LN_EDGES = [(8447, 768, 768), (8448, 768, 768), (8449, 768, 768),
                  (100, 1152, 768), (65, 2048, 768), (33, 1152, 1024),
                  (40, 2048, 256), (3552, 1024, 1024)]


@pytest.mark.parametrize("m,k,d", DENSE_LN_EDGES, ids=str)
def test_dense_ln_kernel_tiling_edges_match_plain(dev, m, k, d):
    args = _dense_ln_args(dev, m, k, d)
    _close(kffn.fused_dense_ln(*args), kffn.dense_ln_plain(*args))


def _dense_ln_entry(args, bm):
    """The C entry at a given number of rows per CTA (fused_dense_ln takes
    block_rows'); returns the output, or raises on the entry's error."""
    x, w, b, r, g, be = args
    out = torch.empty_like(r)
    m, d = r.shape
    build.check(build.library().gstx_dense_ln(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), r.data_ptr(), g.data_ptr(),
        be.data_ptr(), out.data_ptr(), m, x.shape[1], d, bm, 1e-12,
        torch.cuda.current_stream().cuda_stream), "gstx_dense_ln")
    return out


# (70, 48, 256): an odd number of 16-column tiles, which the entry takes
@pytest.mark.parametrize("bm", [32, 64])
@pytest.mark.parametrize("m,k,d", [(130, 768, 768), (97, 256, 128),
                                   (1, 1152, 640), (70, 48, 256)], ids=str)
def test_dense_ln_kernel_both_block_rows_match_plain(dev, m, k, d, bm):
    args = _dense_ln_args(dev, m, k, d)
    _close(_dense_ln_entry(args, bm), kffn.dense_ln_plain(*args))


def test_dense_ln_entry_refuses_64_rows_past_768_columns(dev):
    args = _dense_ln_args(dev, 8, 128, 1024)
    with pytest.raises(RuntimeError):
        _dense_ln_entry(args, 64)
    with pytest.raises(RuntimeError):
        _dense_ln_entry(args, 48)
    with pytest.raises(RuntimeError):  # inner width not % 16
        _dense_ln_entry(_dense_ln_args(dev, 8, 24, 128), 32)


GATE_TOL = 3e-2  # bf16 unfused ops against a kernel: a few bf16 ulps


def _bf16_linear(dev, gen, d_in, d_out):
    lin = nn.Linear(d_in, d_out, device=dev)
    with torch.no_grad():
        lin.weight.normal_(0.0, d_in ** -0.5, generator=gen)
        lin.bias.normal_(0.0, 0.02, generator=gen)
    return lin.to(torch.bfloat16)


@pytest.mark.parametrize("d,inner,fused", [(1152, 1152, False),
                                           (1024, 1152, True)], ids=str)
def test_ffn_family_gate_on_the_card(dev, d, inner, fused):
    """The layers at a 1,152-wide stream run the unfused ops (the kernels
    take D <= 1,024); at D = 1,024 with an inner width of 1,152 both go
    through the kernels.  Either way the result is the unfused ops'."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(2, 40, inner, generator=gen, device=dev
                    ).to(torch.bfloat16)
    xd = torch.randn(2, 40, d, generator=gen, device=dev).to(torch.bfloat16)
    dense = _bf16_linear(dev, gen, inner, d)
    inter, out = _bf16_linear(dev, gen, d, inner), \
        _bf16_linear(dev, gen, inner, d)
    ln = layers.LayerNorm(d).to(dev)
    kffn.reset_launches()
    with torch.no_grad():
        y = layers.dense_ln(x, dense, ln, xd)
        z = layers.feed_forward(xd, inter, out, ln)
        y0 = ln(layers.linear(x, dense) + xd)
        z0 = ln(layers.linear(nn.functional.gelu(layers.linear(xd, inter)),
                              out) + xd)
    assert kffn.launches == {"fused_dense_ln": int(fused),
                             "fused_ffn": int(fused)}
    for got, want in ((y, y0), (z, z0)):
        if fused:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=GATE_TOL, rtol=GATE_TOL)
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("dh,lk,dtype", [(48, 256, torch.bfloat16),
                                         (64, 1601, torch.float32),
                                         (64, 256, torch.bfloat16)], ids=str)
def test_attention_gate_on_the_card(dev, dh, lk, dtype):
    """With the switch on, a head width of 48 and f32 keys past 1,600 at
    dh = 64 run the unfused ops; dh = 64 with 256 bf16 keys the kernel."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(2, 3, 40, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(2, 3, lk, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(2, 3, lk, dh, generator=gen, device=dev).to(dtype)
    mask = torch.where(torch.rand(2, 1, 1, lk, generator=gen, device=dev)
                       < 0.3, -10000.0, 0.0)
    fused = kattn.attention_takes(dh, lk, dtype)
    kattn.reset_launches()
    kattn.enable()
    try:
        with torch.no_grad():
            out = layers.attend(q, k, v, mask)
    finally:
        kattn.enable(False)
    with torch.no_grad():
        unfused = layers.attend(q, k, v, mask)
    assert kattn.launches["fused_attention"] == int(fused)
    if fused:
        torch.testing.assert_close(out.float(), unfused.float(),
                                   atol=GATE_TOL, rtol=GATE_TOL)
    else:
        assert torch.equal(out, unfused)


# the text FFN across the block-row rule (64 x 132 rows) and the block
# edges; the visual FFN as the engine calls it; one and two F chunks
FFN_SHAPES = [(70, 256, 1024), (33, 768, 3072), (17, 1024, 1024),
              (5, 128, 128), (63, 768, 3072), (64, 768, 3072),
              (65, 768, 3072), (8448, 768, 3072), (8449, 768, 3072),
              (3552, 1024, 1024), (40, 256, 128), (100, 768, 256),
              (8500, 256, 512)]


@pytest.mark.parametrize("m,d,f", FFN_SHAPES, ids=str)
def test_ffn_kernel_matches_plain(dev, m, d, f):
    args = _ffn_args(dev, m, d, f)
    _close(kffn.fused_ffn(*args), kffn.ffn_plain(*args))


def _ffn_entry(args, bm):
    """The C entry at a given number of rows per CTA (fused_ffn takes
    block_rows'); returns the output, or raises on the entry's error."""
    x, w1, b1, w2, b2, g, be = args
    out = torch.empty_like(x)
    m, d = x.shape
    build.check(build.library().gstx_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), g.data_ptr(), be.data_ptr(), out.data_ptr(), m, d,
        w1.shape[0], bm, 1e-12, torch.cuda.current_stream().cuda_stream),
        "gstx_ffn")
    return out


@pytest.mark.parametrize("bm", [32, 64])
@pytest.mark.parametrize("m,d,f", [(130, 768, 384), (97, 128, 256),
                                   (1, 640, 128)], ids=str)
def test_ffn_kernel_both_block_rows_match_plain(dev, m, d, f, bm):
    args = _ffn_args(dev, m, d, f)
    _close(_ffn_entry(args, bm), kffn.ffn_plain(*args))


def test_ffn_entry_refuses_64_rows_past_768_columns(dev):
    args = _ffn_args(dev, 8, 1024, 128)
    with pytest.raises(RuntimeError):
        _ffn_entry(args, 64)
    with pytest.raises(RuntimeError):
        _ffn_entry(args, 48)


def test_launch_counter_counts_each_launch(dev):
    kffn.reset_launches()
    args = _ffn_args(dev, 40, 256, 512)
    for _ in range(3):
        kffn.fused_ffn(*args)
    kffn.fused_dense_ln(*_dense_ln_args(dev, 40, 256, 256))
    assert kffn.launches == {"fused_dense_ln": 1, "fused_ffn": 3}


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, w, b, r, g, be = _dense_ln_args(dev, 8, 256, 256)
    with pytest.raises(TypeError):
        kffn.fused_dense_ln(x.float(), w, b, r, g, be)
    with pytest.raises(ValueError):
        kffn.fused_dense_ln(x[:, :192].contiguous(), w[:, :192].contiguous(),
                            b, r, g, be)  # inner width not % 128
    with pytest.raises(ValueError):
        kffn.fused_dense_ln(x.t(), w, b, r, g, be)


@pytest.mark.parametrize("kind", ["ffn", "dense_ln"])
def test_function_grads_on_the_card(dev, kind):
    """The autograd.Function on the card: the kernel forward (one launch,
    none in the backward) against the plain version, and the f32
    recompute backward against autograd through the plain version on the
    same inputs upcast to f32; every gradient within ABS_TOL + REL_TOL *
    |plain| (the bf16 inputs' gradients are bf16)."""
    if kind == "ffn":
        args = list(_ffn_args(dev, 200, 256, 512))
        fn, plain = kffn.fused_ffn, kffn.ffn_plain
    else:
        args = list(_dense_ln_args(dev, 200, 384, 256))
        fn, plain = kffn.fused_dense_ln, kffn.dense_ln_plain
    args = [a.requires_grad_(True) for a in args]
    cot = torch.randn(200, 256, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(9))
    kffn.reset_launches()
    out = fn(*args)
    got = torch.autograd.grad(out, args, cot.to(out.dtype))
    assert sum(kffn.launches.values()) == 1
    with torch.no_grad():
        _close(out, plain(*args))
    wide = [a.detach().float().requires_grad_(True) for a in args]
    want = torch.autograd.grad(plain(*wide), wide,
                               cot.to(out.dtype).float())
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype
        _close(g, w)


F32_TOL = 2e-5  # f32 attention: summation order only


def _attn_inputs(dev, b, h, lq, lk, dh, dtype, mask, seed=2, split=False):
    """q, k, v [B, H, L, dh] (as heads-split views of [B, L, H*dh] when
    ``split``) and an additive mask of the kind asked for."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(n):
        if split:
            x = torch.randn(b, n, h * dh, generator=g, device=dev)
            return x.to(dtype).view(b, n, h, dh).transpose(1, 2)
        return torch.randn(b, h, n, dh, generator=g, device=dev).to(dtype)
    q, k, v = r(lq), r(lk), r(lk)
    shape = {"none": None, "padding": (b, 1, 1, lk),
             "per_query": (b, 1, lq, lk), "per_head": (b, h, lq, lk)}[mask]
    m = None
    if shape is not None:
        m = torch.where(torch.rand(*shape, generator=g, device=dev) < 0.3,
                        -10000.0, 0.0)
        m[..., 0] = 0.0
    return q, k, v, m


def _attn_close(k, p, dtype):
    if dtype == torch.float32:
        assert torch.allclose(k, p, rtol=F32_TOL, atol=F32_TOL), \
            float((k - p).abs().max())
    else:
        _close(k, p)


ATTN_SHAPES = [(2, 3, 70, 131, 64), (2, 2, 33, 9, 128), (1, 3, 8, 17, 32),
               (2, 2, 40, 24, 16), (3, 12, 18, 18, 64), (1, 2, 256, 37, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mask", ["padding", "per_query", "per_head",
                                  "none"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_attention_kernel_matches_plain(dev, shape, mask, dtype):
    q, k, v, m = _attn_inputs(dev, *shape, dtype, mask,
                              split=shape[0] == 2)
    _attn_close(kattn.fused_attention(q, k, v, m),
                kattn.attention_plain(q, k, v, m), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mask", ["padding", "per_query", "none"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_attention_batch_kernel_matches_plain(dev, shape, mask, dtype):
    q, k, v, m = _attn_inputs(dev, *shape, dtype, mask,
                              split=shape[0] == 2)
    _attn_close(kattn.fused_attention_batch(q, k, v, m),
                kattn.attention_batch_plain(q, k, v, m), dtype)


def test_attention_takes_a_bf16_mask_and_longest_keys(dev):
    # the f32 instance's cap (its score rows in shared memory); bf16 has none
    q, k, v, m = _attn_inputs(dev, 1, 2, 40,
                              kattn.max_key_length(128, torch.float32), 128,
                              torch.float32, "padding")
    _close(kattn.fused_attention(q, k, v, m.to(torch.bfloat16)),
           kattn.attention_plain(q, k, v, m.to(torch.bfloat16)))


# the bf16 kernel's edges: one key, a ragged last key tile, exactly one
# tile, one key past it, the scoring pass's 293; one query row, a warp
# partly past Lq, a second 64-row query tile
EDGE_SHAPES = ([(2, 3, 33, lk, 64) for lk in (1, 63, 64, 65, 293)]
               + [(2, 2, lq, 70, 128) for lq in (1, 17, 65)])


@pytest.mark.parametrize("kernel", ["fused_attention", "fused_attention_batch"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_attention_bf16_edges_match_plain(dev, shape, kernel):
    # a per-head mask through fused_attention, per-query through the batch
    # kernel (which takes no per-head mask)
    mask = "per_head" if kernel == "fused_attention" else "per_query"
    q, k, v, m = _attn_inputs(dev, *shape, torch.bfloat16, mask, split=True)
    plain = {"fused_attention": kattn.attention_plain,
             "fused_attention_batch": kattn.attention_batch_plain}[kernel]
    _close(getattr(kattn, kernel)(q, k, v, m), plain(q, k, v, m))


@pytest.mark.parametrize("kernel", ["fused_attention", "fused_attention_batch"])
def test_attention_bf16_ignores_nan_rows_past_lk(dev, kernel):
    """K and V are views of a larger buffer whose rows past Lk hold NaN:
    the kernel must read none of them."""
    b, h, lq, lk, dh = 2, 3, 40, 70, 64
    g = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randn(2, b, 128, h * dh, generator=g, device=dev
                      ).to(torch.bfloat16)
    buf[:, :, lk:] = float("nan")
    k, v = (x[:, :lk].view(b, lk, h, dh).transpose(1, 2) for x in buf)
    q = torch.randn(b, h, lq, dh, generator=g, device=dev).to(torch.bfloat16)
    m = torch.where(torch.rand(b, 1, 1, lk, generator=g, device=dev) < 0.3,
                    -10000.0, 0.0)
    plain = {"fused_attention": kattn.attention_plain,
             "fused_attention_batch": kattn.attention_batch_plain}[kernel]
    out = getattr(kattn, kernel)(q, k, v, m)
    assert bool(torch.isfinite(out.float()).all())
    _close(out, plain(q, k, v, m))


def test_attention_launch_counters(dev):
    kattn.reset_launches()
    q, k, v, m = _attn_inputs(dev, 2, 2, 16, 16, 64, torch.bfloat16,
                              "padding")
    kattn.fused_attention(q, k, v, m)
    kattn.fused_attention(q, k, v, None)
    kattn.fused_attention_batch(q, k, v, m)
    kattn.attention_plain(q, k, v, m)
    assert kattn.launches == {"fused_attention": 2,
                              "fused_attention_batch": 1}


def test_attention_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v, m = _attn_inputs(dev, 2, 2, 16, 20, 64, torch.bfloat16,
                              "per_head")
    with pytest.raises(ValueError):  # per-head mask: not the batch kernel's
        kattn.fused_attention_batch(q, k, v, m)
    with pytest.raises(TypeError):
        kattn.fused_attention(q, k.float(), v, None)
    with pytest.raises(ValueError):  # head width 24
        kattn.fused_attention(q[..., :24].contiguous(),
                              k[..., :24].contiguous(),
                              v[..., :24].contiguous(), None)
    with pytest.raises(ValueError):  # last dimension not contiguous
        kattn.fused_attention(q.transpose(2, 3), k, v, None)
    # a row stride of 68 elements: whole 16-byte vectors in f32, not in bf16
    padded = torch.zeros(2, 2, 16, 68, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        kattn.fused_attention(padded[..., :64], k, v, None)
    kattn.fused_attention(padded.float()[..., :64], k.float(), v.float(),
                          None)
    long_k = torch.zeros(2, 2, kattn.max_key_length(64, torch.float32) + 1,
                         64, device=dev)
    with pytest.raises(ValueError):
        kattn.fused_attention(q.float(), long_k, long_k, None)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError):
        kattn.fused_attention(q, k, v, None)


def _decode_inputs(dev, b, h, m, dh, qdtype, valid=0.8, seed=3):
    """q as the decoder folds it (K scale and 1/sqrt(dh): scores of O(1)),
    int8 K/V zero past the valid slots, and the additive mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.05
         ).to(qdtype)
    n_valid = torch.randint(1, m + 1, (b,), generator=g, device=dev)
    n_valid[0] = max(1, int(valid * m))
    slot = torch.arange(m, device=dev)
    valid_slots = slot[None, :] < n_valid[:, None]                # [B, M]
    kv = [torch.randint(-127, 128, (b, h, m, dh), generator=g, device=dev,
                        dtype=torch.int8) * valid_slots[:, None, :, None]
          for _ in range(2)]
    mask = torch.where(valid_slots, 0.0, -10000.0)[:, None, None, :]
    return q, kv[0].to(torch.int8), kv[1].to(torch.int8), mask


def _decode_close(k, p):
    assert bool((k - p).abs().le(5e-3 + 1e-4 * p.abs()).all()), \
        float((k - p).abs().max())


@pytest.mark.parametrize("mask", ["f32", "bf16", "broadcast", "none"])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(3, 4, 37, 16), (7, 12, 229, 64),
                                   (2, 3, 70, 128), (5, 2, 100, 32),
                                   (1, 1, 1, 64)], ids=str)
def test_quant_decode_kernel_matches_plain(dev, shape, qdtype, mask):
    q, k, v, m = _decode_inputs(dev, *shape, qdtype)
    m = {"f32": m, "bf16": m.to(torch.bfloat16), "broadcast": m[:1],
         "none": None}[mask]
    _decode_close(kdecode.quant_decode_attention(q, k, v, m),
                  kdecode.quant_decode_attention_plain(q, k, v, m))


# a rank's heads under -model_parallel 2 (12 / 2 = 6): the decode steps'
# memory at B = 96 and at the beam's 128 rows, and the encoder's text
# self-attention (the kernels take the head count at run time)
@pytest.mark.parametrize("shape", [(96, 6, 293, 64), (128, 6, 293, 64)],
                         ids=str)
def test_quant_decode_kernel_on_a_ranks_six_heads(dev, shape):
    q, k, v, m = _decode_inputs(dev, *shape, torch.bfloat16)
    m = m.to(torch.bfloat16)
    _decode_close(kdecode.quant_decode_attention(q, k, v, m),
                  kdecode.quant_decode_attention_plain(q, k, v, m))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_attention_kernel_on_a_ranks_six_heads(dev, dtype):
    q, k, v, m = _attn_inputs(dev, 8, 6, 256, 256, 64, dtype, "padding",
                              split=True)
    _attn_close(kattn.fused_attention(q, k, v, m),
                kattn.attention_plain(q, k, v, m), dtype)


def test_quant_decode_launch_counter_and_refusals(dev):
    q, k, v, m = _decode_inputs(dev, 2, 3, 40, 64, torch.bfloat16)
    kdecode.reset_launches()
    kdecode.quant_decode_attention(q, k, v, m)
    kdecode.quant_decode_attention_plain(q, k, v, m)
    assert kdecode.launches == {"quant_decode_attention": 1}
    with pytest.raises(TypeError):
        kdecode.quant_decode_attention(q, k.float(), v, m)
    with pytest.raises(ValueError):  # non-contiguous K
        kdecode.quant_decode_attention(q, k.transpose(2, 3), v, m)
    with pytest.raises(ValueError):  # two query rows
        kdecode.quant_decode_attention(q.expand(-1, -1, 2, -1), k, v, m)
    with pytest.raises(ValueError):  # head width 24
        kdecode.quant_decode_attention(q[..., :24].contiguous(),
                                       k[..., :24].contiguous(),
                                       v[..., :24].contiguous(), m)


def _cli_env(tmp, width):
    """Vocab, a synthetic store, captions and a seeded port model saved as
    a checkpoint, at an encoder/decoder ``width`` (32: no kernel takes it;
    128: both fused kernels do)."""
    import json

    from gstx_torch.core.config import DecoderConfig, EncoderConfig
    from gstx_torch.data.feature_store import make_synthetic_store
    from gstx_torch.data.tokenizer import make_test_vocab
    from gstx_torch.models.encdec import GSTVisualDialog

    words = ["a", "man", "dog", "on", "the", "beach", "red", "hat"]
    vocab = make_test_vocab(words)
    lines = [f"[unused{i}]" for i in range(160)]
    for tok, idx in vocab.items():
        lines[idx] = tok
    paths = {k: str(tmp / k) for k in ("vocab.txt", "feats.store",
                                       "caps.json", "enc.json", "dec.json",
                                       "model.pt")}
    open(paths["vocab.txt"], "w").write("\n".join(lines) + "\n")
    ids = [7, 8, 9]
    make_synthetic_store(paths["feats.store"], ids, num_boxes=5, feat_dim=16,
                         num_classes=3)
    json.dump([{"image_id": i, "caption": "a man on the beach"} for i in ids],
              open(paths["caps.json"], "w"))
    enc = dict(vocab_size=160, hidden_size=width, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=2 * width,
               v_feature_size=16, v_hidden_size=width, v_num_hidden_layers=1,
               v_num_attention_heads=2, v_intermediate_size=width,
               bi_hidden_size=width, bi_num_attention_heads=2,
               v_biattention_id=[0], t_biattention_id=[1])
    dec = dict(vocab_size=160, hidden_size=width, num_hidden_layers=1,
               num_attention_heads=2, intermediate_size=2 * width)
    json.dump(enc, open(paths["enc.json"], "w"))
    json.dump(dec, open(paths["dec.json"], "w"))
    model = GSTVisualDialog(EncoderConfig.from_json(paths["enc.json"]),
                            DecoderConfig.from_json(paths["dec.json"]),
                            device="cpu")
    torch.save(model.state_dict(), paths["model.pt"])
    return ["-mode", "cc12m_gen", "-vocab_path", paths["vocab.txt"],
            "-cc12m_image_feats", paths["feats.store"],
            "-cc12m_caption", paths["caps.json"],
            "-model_enc_config", paths["enc.json"],
            "-model_dec_config", paths["dec.json"],
            "-start_path_q", paths["model.pt"],
            "-start_path_a", paths["model.pt"],
            "-save_path", str(tmp / "out"), "-save_name", "gen.json",
            "-dtype", "bfloat16", "-batch_size", "2", "-max_seq_len", "64",
            "-max_regions", "6", "-num_dialog_rounds", "2",
            "-max_dec_len", "4", "-num_workers", "1"]


@pytest.mark.parametrize("width,fused", [(32, False), (128, True)])
def test_cli_bf16_on_the_card(dev, tmp_path, width, fused):
    """The port's CLI in bf16 on the card writes its JSON; fused_ffn and
    fused_dense_ln launch only where the widths are ones they take."""
    import json

    from gstx_torch.cli import generate

    argv = _cli_env(tmp_path, width)
    kffn.reset_launches()
    records = generate.main(argv, device="cuda")
    assert json.load(open(tmp_path / "out" / "gen.json")) == records
    assert len(records) > 0
    assert (kffn.launches["fused_ffn"] > 0) == fused
    assert (kffn.launches["fused_dense_ln"] > 0) == fused


def test_evaluate_gen_bf16_on_the_card_matches_cpu_f32(dev, monkeypatch):
    """The generative evaluator with a width-128 model (both fused kernels
    take it) in bf16 on the card: its scores, centred over each round's
    options, within EVAL_SCORE_TOL relative of the same model's f32 scores
    on the CPU, while a control (every fused_ffn's FFN branch zeroed)
    exceeds it; the fused kernels launched, and finite metrics."""
    import copy

    import numpy as np

    from gstx_torch.core.config import DecoderConfig, EncoderConfig
    from gstx_torch.eval import rank_gen
    from gstx_torch.models.encdec import GSTVisualDialog, precast_

    enc = EncoderConfig(vocab_size=160, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        v_feature_size=16, v_hidden_size=128,
                        v_num_hidden_layers=1, v_num_attention_heads=2,
                        v_intermediate_size=128, bi_hidden_size=128,
                        bi_num_attention_heads=2, v_biattention_id=(0,),
                        t_biattention_id=(1,))
    dec = DecoderConfig(vocab_size=160, hidden_size=128, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=256)
    ref = GSTVisualDialog(enc, dec, device="cpu", seed=3)
    model = precast_(copy.deepcopy(ref).to(dev), torch.bfloat16)
    rng = np.random.RandomState(0)
    b, rounds, options, seq, utt, regions = 2, 3, 10, 40, 8, 6
    ids = rng.randint(104, 160, size=(b, rounds, options, seq))
    ids[..., 0], ids[..., 30:] = 101, 0
    dec_ids = rng.randint(104, 160, size=(b, rounds, options, utt))
    dec_ids[..., 0], dec_ids[..., 5], dec_ids[..., 6:] = 101, 102, 0
    batch = {
        "enc_input_ids": ids, "enc_segments": np.zeros_like(ids),
        "enc_att_mask": (ids != 0).astype(np.float32),
        "dec_input_ids": dec_ids,
        "dec_att_mask": (dec_ids != 0).astype(np.float32),
        "enc_image_feat": rng.rand(b, regions, 16).astype(np.float32),
        "enc_image_loc": rng.rand(b, regions, 5).astype(np.float32),
        "enc_image_mask": np.ones((b, regions), np.float32),
        "gt_option_inds": np.zeros((b, rounds), np.int64),
        "round_id": np.ones((b, 1), np.int64),
        "gt_relevance": rng.rand(b, options).astype(np.float32)}
    def centred(m, where):
        text, images, _ = rank_gen.flatten_gen(batch)
        t, i = rank_gen.batch_to_device(text, images, where, m.dtype,
                                        ("enc_image_feat", "enc_image_loc"))
        with torch.inference_mode():
            s = rank_gen.make_chunk_scorer(m)(rank_gen.chunk_inputs(
                t, i, 0, b * rounds * options,
                rounds * options)).float().cpu().reshape(-1, options)
        return s - s.mean(1, keepdim=True)

    def err(got):
        return float((got - want).norm() / want.norm())
    want = centred(ref, "cpu")
    sound = err(centred(model, dev))
    real_ffn = kffn.fused_ffn

    def ffn_lost(x, w1, b1, w2, b2, *ln, **eps):
        return real_ffn(x, w1, b1, torch.zeros_like(w2),
                        torch.zeros_like(b2), *ln, **eps)
    with monkeypatch.context() as m:
        m.setattr(kffn, "fused_ffn", ffn_lost)
        control = err(centred(model, dev))
    kffn.reset_launches()
    metrics = rank_gen.evaluate_gen(model, [batch], chunk_size=30)
    assert kffn.launches["fused_ffn"] > 0 and \
        kffn.launches["fused_dense_ln"] > 0
    print(f"centred scores, relative error to the CPU f32 model: bf16 "
          f"kernel path {sound:.4g}, control {control:.4g}")
    assert sound <= EVAL_SCORE_TOL < control, (sound, control)
    assert all(np.isfinite(v) for v in metrics.values()), metrics


def _width128_configs():
    from gstx_torch.core.config import DecoderConfig, EncoderConfig

    enc = EncoderConfig(vocab_size=160, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        v_feature_size=16, v_target_size=7,
                        v_hidden_size=128, v_num_hidden_layers=1,
                        v_num_attention_heads=2, v_intermediate_size=128,
                        bi_hidden_size=128, bi_num_attention_heads=2,
                        v_biattention_id=(0,), t_biattention_id=(1,),
                        hidden_dropout_prob=0.0, v_hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0,
                        v_attention_probs_dropout_prob=0.0)
    dec = DecoderConfig(vocab_size=160, hidden_size=128, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=256)
    return enc, dec


# the fused sites of one forward of _width128_configs' encoder: one of each
# kernel a text or visual layer, two a co-attention layer
WIDTH128_SITES = 2 + 1 + 2
# FGSM on the card: the input gradient's cosine similarity to the CPU f32
# model's (chip_smoke.py's limit; this model read 0.99995 on an H100)
FGSM_COS_TOL = 0.98


def test_fgsm_through_the_kernels_matches_cpu_f32(dev):
    """FGSM on a width-128 model in bf16 on the card: the gradient pass runs
    the fused kernels forward (once each a site) and their f32 recompute
    backward; the input gradient's cosine similarity to the same model's
    f32 gradient on the CPU is at least FGSM_COS_TOL, and the perturbed
    scores, centred over the options and computed from the same perturbed
    features, within EVAL_SCORE_TOL of the f32 model's."""
    import copy

    import numpy as np

    from gstx_torch.eval import attacks
    from gstx_torch.models.encdec import GSTVisualDialog, precast_

    ref = GSTVisualDialog(*_width128_configs(), device="cpu", seed=5)
    model = precast_(copy.deepcopy(ref).to(dev), torch.bfloat16)
    rng = np.random.RandomState(1)
    n, seq, utt, regions = 10, 40, 8, 6
    ids = rng.randint(104, 160, size=(n, seq))
    ids[:, 0], ids[:, 30:] = 101, 0
    dec_ids = rng.randint(104, 160, size=(n, utt))
    dec_ids[:, 0], dec_ids[:, 5], dec_ids[:, 6:] = 101, 102, 0
    chunk = {"enc_input_ids": ids, "enc_segments": np.zeros_like(ids),
             "enc_att_mask": (ids != 0).astype(np.float32),
             "dec_input_ids": dec_ids,
             "dec_att_mask": (dec_ids != 0).astype(np.float32),
             "enc_image_feat": np.repeat(rng.rand(1, regions, 16), n, 0
                                         ).astype(np.float32),
             "enc_image_loc": np.repeat(rng.rand(1, regions, 5), n, 0
                                        ).astype(np.float32),
             "enc_image_mask": np.ones((n, regions), np.float32)}
    rel = (rng.rand(n) * (rng.rand(n) > 0.4)).astype(np.float32)
    on = {k: torch.from_numpy(v).to(dev) for k, v in chunk.items()}
    cpu = {k: torch.from_numpy(v) for k, v in chunk.items()}
    kffn.reset_launches()
    g = attacks.make_fgsm_scorer(model).nll_grad(
        on["enc_image_feat"], on, torch.from_numpy(rel).to(dev))
    assert kffn.launches == {"fused_ffn": WIDTH128_SITES,
                             "fused_dense_ln": WIDTH128_SITES}
    want = attacks.make_fgsm_scorer(ref).nll_grad(
        cpu["enc_image_feat"], cpu, torch.from_numpy(rel))
    cos = float(torch.nn.functional.cosine_similarity(
        g.cpu().flatten(), want.flatten(), dim=0))
    perturbed = cpu["enc_image_feat"] + torch.sign(g.cpu())
    with torch.no_grad():
        got = attacks.make_chunk_scorer(model)(dict(
            on, enc_image_feat=perturbed.to(dev))).float().cpu()
        f32 = attacks.make_chunk_scorer(ref)(dict(
            cpu, enc_image_feat=perturbed))
    got, f32 = got - got.mean(), f32 - f32.mean()
    err = float((got - f32).norm() / f32.norm())
    print(f"FGSM on the card: gradient cosine {cos:.5f}, perturbed "
          f"scores' centred relative error {err:.4g}")
    assert cos >= FGSM_COS_TOL and err <= EVAL_SCORE_TOL, (cos, err)
    assert not np.abs(g.cpu().numpy()[rel == 0]).any()


def test_disc_step_grad_norms_match_unfused_on_the_card(dev):
    """One discriminative step's losses on a width-128 encoder-only model,
    bf16 compute over f32 parameters, every dropout 0 but the heads'
    pooled 0.1 (one seed: one mask): with the kernels (each launched once a
    site: 'small' recomputes no fused site) and without, the loss within
    1e-3 and the per-tensor gradient norms within 0.5 relative, as
    chip_smoke.py's phase 9 (b)."""
    import numpy as np

    from gstx_torch.models.encdec import GSTVisualDialog
    from gstx_torch.models.layers import Training
    from gstx_torch.train import train_disc

    enc, dec = _width128_configs()
    rng = np.random.RandomState(2)
    n, seq, regions = 12, 40, 6
    ids = rng.randint(104, 160, size=(n, seq))
    sep = np.sort(rng.randint(5, seq, size=(n, 4)), axis=1)
    rows = {"tokens": ids, "segments": rng.randint(0, 2, (n, seq)),
            "sep_indices": sep, "hist_len": rng.randint(0, 4, n),
            "mask": np.where(rng.rand(n, seq) < 0.15,
                             rng.randint(104, 160, (n, seq)), -1),
            "next_sentence_labels": np.repeat(
                np.asarray([[1.0, 0.0]], np.float32), n, 0),
            "image_feat": rng.rand(n, regions, 16).astype(np.float32),
            "image_loc": rng.rand(n, regions, 5).astype(np.float32),
            "image_mask": np.ones((n, regions), np.float32),
            "image_target": rng.dirichlet(np.ones(7), (n, regions)
                                          ).astype(np.float32),
            "image_label": rng.randint(0, 2, (n, regions))}
    rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in rows.items()}

    class Coeffs:
        lm_loss_coeff = nsp_loss_coeff = img_loss_coeff = 1.0

    out = {}
    for fused in (True, False):
        model = GSTVisualDialog(enc, dec, device=dev, seed=4,
                                use_decoder=False, dtype=torch.bfloat16)
        kffn.enable(fused)
        kffn.reset_launches()
        try:
            loss = train_disc.row_losses(model, rows, Coeffs,
                                         Training(9, "small"))["loss"]
            loss.backward()
        finally:
            kffn.enable(True)
        want = WIDTH128_SITES if fused else 0
        assert kffn.launches == {"fused_ffn": want, "fused_dense_ln": want}
        out[fused] = (float(loss.detach()), {
            n_: float(p.grad.float().norm())
            for n_, p in model.named_parameters() if p.grad is not None})
    (lk, nk), (lu, nu) = out[True], out[False]
    assert abs(lk - lu) <= 1e-3 * abs(lu), (lk, lu)
    assert nk.keys() == nu.keys()
    worst = max(abs(nk[k] - nu[k]) / max(nu[k], 1e-12) for k in nu
                if not k.endswith(("key.bias", "key1.bias", "key2.bias")))
    assert worst <= 0.5, worst
