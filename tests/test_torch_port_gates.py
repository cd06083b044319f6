"""The layer-level gates in front of the port's CUDA kernels decline exactly
what the kernels refuse, and the unfused ops run there instead, as the
reference's ``maybe_fused_*`` return None (gstx/kernels/ffn.py:395-427,
gstx/kernels/attention.py:221-235).  On the CPU the wrappers take the plain
versions, so these tests count the wrapper calls; the card cases are in
tests/test_torch_port_cuda.py."""

import pytest
import torch
from torch import nn

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from gstx_torch.kernels import attention as kattn
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models import layers

# bf16 unfused ops (rounded after the product and after the residual add)
# against the f32-accumulating wrapper: a few bf16 ulps apart
BF16_TOL = 3e-2

# (D, inner width) -> whether the kernels take it: D a multiple of 128 up
# to 1,024; the inner width (dense_ln's Din, the FFN's F) any multiple of
# 128
WIDTHS = [(128, 128, True), (768, 768, True), (1024, 1152, True),
          (768, 2048, True), (1152, 1152, False), (1152, 128, False),
          (1280, 1024, False), (768, 192, False), (64, 128, False),
          (0, 128, False), (768, 0, False)]


@pytest.mark.parametrize("d,inner,takes", WIDTHS, ids=str)
def test_width_predicate(d, inner, takes):
    assert kffn.widths_taken(d, inner) is takes


@pytest.mark.parametrize("d,inner,takes", WIDTHS, ids=str)
def test_wrapper_width_check_raises_exactly_where_the_predicate_says_no(
        d, inner, takes):
    for name in ("fused_dense_ln", "fused_ffn"):
        if takes:
            kffn._check_width(name, d, inner)
        else:
            with pytest.raises(ValueError):
                kffn._check_width(name, d, inner)


def _counting(monkeypatch):
    calls = {"fused_dense_ln": 0, "fused_ffn": 0}
    for name in calls:
        real = getattr(kffn, name)

        def wrapped(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(kffn, name, wrapped)
    return calls


def _linear(d_in, d_out, gen):
    lin = nn.Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.normal_(0.0, d_in ** -0.5, generator=gen)
        lin.bias.normal_(0.0, 0.02, generator=gen)
    return lin.to(torch.bfloat16)


def _unfused_dense_ln(x, dense, ln, residual):
    return ln(layers.linear(x, dense) + residual)


def _unfused_ffn(x, inter, out, ln):
    return ln(layers.linear(torch.nn.functional.gelu(
        layers.linear(x, inter)), out) + x)


def test_gate_runs_unfused_ops_at_a_1152_wide_stream(monkeypatch):
    """A bf16 block with a 1,152-wide stream: the kernels refuse D > 1,024,
    so neither wrapper is called and the unfused ops give the result."""
    calls = _counting(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    d, f = 1152, 256
    x = torch.randn(2, 5, d, generator=gen).to(torch.bfloat16)
    res = torch.randn(2, 5, d, generator=gen).to(torch.bfloat16)
    dense, inter, out = _linear(d, d, gen), _linear(d, f, gen), \
        _linear(f, d, gen)
    ln = layers.LayerNorm(d)
    with torch.no_grad():
        y = layers.dense_ln(x, dense, ln, res)
        z = layers.feed_forward(x, inter, out, ln)
        assert torch.equal(y, _unfused_dense_ln(x, dense, ln, res))
        assert torch.equal(z, _unfused_ffn(x, inter, out, ln))
    assert calls == {"fused_dense_ln": 0, "fused_ffn": 0}
    assert y.dtype == z.dtype == torch.bfloat16


def test_gate_takes_a_1152_wide_inner_width_at_d_1024(monkeypatch):
    """D = 1,024 with an inner width of 1,152: both kernels take it (x
    streams through dense_ln in 16-column tiles), so both wrappers run."""
    calls = _counting(monkeypatch)
    gen = torch.Generator().manual_seed(1)
    d, inner = 1024, 1152
    x = torch.randn(3, inner, generator=gen).to(torch.bfloat16)
    xd = torch.randn(3, d, generator=gen).to(torch.bfloat16)
    res = torch.randn(3, d, generator=gen).to(torch.bfloat16)
    dense, inter, out = _linear(inner, d, gen), _linear(d, inner, gen), \
        _linear(inner, d, gen)
    ln = layers.LayerNorm(d)
    with torch.no_grad():
        y = layers.dense_ln(x, dense, ln, res)
        z = layers.feed_forward(xd, inter, out, ln)
        torch.testing.assert_close(
            y.float(), _unfused_dense_ln(x, dense, ln, res).float(),
            atol=BF16_TOL, rtol=BF16_TOL)
        torch.testing.assert_close(
            z.float(), _unfused_ffn(xd, inter, out, ln).float(),
            atol=BF16_TOL, rtol=BF16_TOL)
    assert calls == {"fused_dense_ln": 1, "fused_ffn": 1}


F32_MAX_LK_64 = 1600  # max_key_length(64, float32): its score rows' room


def test_attention_predicate():
    assert kattn.max_key_length(64, torch.float32) == F32_MAX_LK_64
    assert kattn.attention_takes(64, 256, torch.float32)
    assert kattn.attention_takes(64, F32_MAX_LK_64, torch.float32)
    assert not kattn.attention_takes(64, F32_MAX_LK_64 + 1, torch.float32)
    assert kattn.attention_takes(64, F32_MAX_LK_64 + 1, torch.bfloat16)
    assert not kattn.attention_takes(48, 256, torch.bfloat16)
    assert not kattn.attention_takes(64, 0, torch.bfloat16)
    assert not kattn.attention_takes(64, 256, torch.float16)
    for dh in (16, 32, 64, 128):
        assert kattn.attention_takes(dh, 37, torch.bfloat16)


@pytest.mark.parametrize("dh,lk,dtype,fused", [
    (48, 256, torch.float32, False), (48, 40, torch.bfloat16, False),
    (64, F32_MAX_LK_64 + 1, torch.float32, False),
    (64, F32_MAX_LK_64, torch.float32, True),
    (64, 256, torch.float32, True), (64, 256, torch.bfloat16, True)],
    ids=str)
def test_attention_gate_declines_what_the_kernel_refuses(dh, lk, dtype,
                                                         fused):
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(1, 2, 8, dh, generator=gen).to(dtype)
    k = torch.randn(1, 2, lk, dh, generator=gen).to(dtype)
    mask = torch.zeros(1, 1, 1, lk)
    kattn.enable()
    try:
        got = kattn.maybe_fused_attention(q, k, k, mask)
        assert (got is not None) is fused
        # the layer runs either way, and the unfused ops where declined
        with torch.no_grad():
            out = layers.attend(q, k, k, mask)
    finally:
        kattn.enable(False)
    with torch.no_grad():
        unfused = layers.attend(q, k, k, mask)
    if fused:
        torch.testing.assert_close(out.float(), unfused.float(),
                                   atol=BF16_TOL, rtol=BF16_TOL)
    else:
        assert torch.equal(out, unfused)
