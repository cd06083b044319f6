"""The port's plain kernel versions (gstx_torch.kernels.ffn) against the
JAX Pallas kernels run in interpret mode, on the same numpy inputs: ragged
M (70 rows, a multiple of no block size), f32 and bf16 I/O.  The CUDA
kernels themselves run only on the card (chip_smoke.py, and
tests/test_torch_port_cuda.py there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from gstx.kernels.ffn import fused_dense_ln, fused_ffn
from gstx_torch.kernels import ffn as kffn

F32_TOL = 2e-5   # both sides accumulate in f32; only summation order differs
BF16_TOL = 3e-2  # bf16 I/O: the hidden and the output round to bf16


def _ffn_inputs(seed, d=256, f=1024, m=70):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(m, d) * 0.5, w1=rng.randn(d, f) * 0.02,
        b1=rng.randn(f) * 0.02, w2=rng.randn(f, d) * 0.02,
        b2=rng.randn(d) * 0.02, g=rng.rand(d) + 0.5, be=rng.randn(d) * 0.1)


def _dense_ln_inputs(seed, din=192, d=256, m=70):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(m, din) * 0.5, w=rng.randn(din, d) * 0.02,
        b=rng.randn(d) * 0.02, r=rng.randn(m, d) * 0.5,
        g=rng.rand(d) + 0.5, be=rng.randn(d) * 0.1)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_ffn_plain_matches_pallas_interpret(act):
    i = _ffn_inputs(0)
    jd, td = ((jnp.float32, torch.float32) if act == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = fused_ffn(_j(i["x"], jd), _j(i["w1"], jd), _j(i["b1"], jnp.float32),
                     _j(i["w2"], jd), _j(i["b2"], jnp.float32),
                     _j(i["g"], jnp.float32), _j(i["be"], jnp.float32),
                     block_m=64, interpret=True)
    # nn.Linear layout: [out, in]
    got = kffn.fused_ffn(_t(i["x"], td), _t(i["w1"].T, td),
                         _t(i["b1"], torch.float32), _t(i["w2"].T, td),
                         _t(i["b2"], torch.float32),
                         _t(i["g"], torch.float32), _t(i["be"], torch.float32))
    assert got.dtype == td and got.shape == (70, 256)
    tol = F32_TOL if act == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_dense_ln_plain_matches_pallas_interpret(act):
    i = _dense_ln_inputs(2)
    jd, td = ((jnp.float32, torch.float32) if act == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = fused_dense_ln(_j(i["x"], jd), _j(i["w"], jd),
                          _j(i["b"], jnp.float32), _j(i["r"], jd),
                          _j(i["g"], jnp.float32), _j(i["be"], jnp.float32),
                          block_m=64, interpret=True)
    got = kffn.fused_dense_ln(_t(i["x"], td), _t(i["w"].T, td),
                              _t(i["b"], torch.float32), _t(i["r"], td),
                              _t(i["g"], torch.float32),
                              _t(i["be"], torch.float32))
    assert got.dtype == td and got.shape == (70, 256)
    tol = F32_TOL if act == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_ffn_plain_rounds_hidden_to_activation_dtype():
    """The bf16 hidden rounding before the second product (ffn.py:224) is
    part of the function: the plain version must differ from an all-f32
    chain exactly by that rounding."""
    i = _ffn_inputs(1, d=128, f=256, m=9)
    td = torch.bfloat16
    x, w1, w2 = _t(i["x"], td), _t(i["w1"].T, td), _t(i["w2"].T, td)
    b1, b2 = _t(i["b1"], torch.float32), _t(i["b2"], torch.float32)
    g, be = _t(i["g"], torch.float32), _t(i["be"], torch.float32)
    got = kffn.ffn_plain(x, w1, b1, w2, b2, g, be)
    h = torch.nn.functional.gelu(x.float() @ w1.float().t() + b1)
    y = h.to(td).float() @ w2.float().t() + b2 + x.float()
    want = torch.nn.functional.layer_norm(y, (128,), g, be, 1e-12).to(td)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    kffn.reset_launches()
    i = _dense_ln_inputs(3, din=128, d=128, m=5)
    td = torch.bfloat16
    out = kffn.fused_dense_ln(_t(i["x"], td), _t(i["w"].T, td),
                              _t(i["b"], torch.float32), _t(i["r"], td),
                              _t(i["g"], torch.float32),
                              _t(i["be"], torch.float32))
    assert out.shape == (5, 128)
    assert kffn.launches == {"fused_dense_ln": 0, "fused_ffn": 0}


def test_non_cpu_non_cuda_device_raises():
    x = torch.zeros(2, 128, device="meta", dtype=torch.bfloat16)
    w = torch.zeros(128, 128, device="meta", dtype=torch.bfloat16)
    v = torch.zeros(128, device="meta")
    with pytest.raises(ValueError):
        kffn.fused_dense_ln(x, w, v, x, v, v)
