"""The dense_ln kernel's tiling (gstx_torch/kernels/csrc/ffn.cu::
dense_ln_kernel), emulated in PyTorch on the CPU and held against the plain
version and the JAX Pallas kernel in interpret mode on the same numpy
inputs; and the rule that picks its rows per CTA.  The kernel itself runs
only on the card (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from gstx.kernels.ffn import fused_dense_ln as jax_fused_dense_ln
from gstx_torch.kernels import ffn as kffn

# chip_smoke.py phase 2's tolerance for every bf16 kernel: about 2 bf16 ulps
ABS_TOL, REL_TOL = 1e-2, 1.6e-2
K_TILE = 16     # inner columns per ring tile
COL_WARPS = 8   # warps across a row: the LayerNorm's partial sums


def emulate_dense_ln_kernel(x, w, b, res, gamma, beta, eps=1e-12, bm=None):
    """What dense_ln_kernel computes, in its order: row blocks of ``bm``
    rows, x and the residual zero-filled past M; the f32 accumulator
    starting at b + residual, the product added a 16-column tile of x and
    W at a time; the LayerNorm's mean and centred variance from the 8
    column warps' partial sums; the output rounded to bf16 once."""
    m, k = x.shape
    d = w.shape[0]
    bm = bm or kffn.block_rows(m, d)
    wf = w.float()
    out = []
    for r0 in range(0, m, bm):
        n = min(bm, m - r0)
        xb, rb = torch.zeros(bm, k), torch.zeros(bm, d)
        xb[:n], rb[:n] = x[r0:r0 + n].float(), res[r0:r0 + n].float()
        v = b + rb
        for k0 in range(0, k, K_TILE):
            v = v + xb[:, k0:k0 + K_TILE] @ wf[:, k0:k0 + K_TILE].t()
        mean = v.view(bm, COL_WARPS, -1).sum(-1).sum(-1, keepdim=True) / d
        dev = v - mean
        var = dev.square().view(bm, COL_WARPS, -1).sum(-1).sum(
            -1, keepdim=True) / d
        y = dev * torch.rsqrt(var + eps) * gamma + beta
        out.append(y[:n])
    return torch.cat(out).to(torch.bfloat16)


def _inputs(m, k, d, seed=0):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(m, k), w=rng.randn(d, k) * 0.02,
                b=rng.randn(d) * 0.02, r=rng.randn(m, d),
                g=rng.rand(d) * 0.2 + 0.9, be=rng.randn(d) * 0.1)


def _torch_args(i):
    bf, f32 = torch.bfloat16, torch.float32

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return (t(i["x"], bf), t(i["w"], bf), t(i["b"], f32), t(i["r"], bf),
            t(i["g"], f32), t(i["be"], f32))


@functools.lru_cache(maxsize=None)
def _jax_out(m, k, d):
    """The Pallas kernel in interpret mode ([in, out] weight layout)."""
    i = _inputs(m, k, d)

    def j(a, dtype=jnp.float32):
        return jnp.asarray(np.asarray(a, np.float32), dtype)
    bf = jnp.bfloat16
    out = jax_fused_dense_ln(j(i["x"], bf), j(i["w"].T, bf), j(i["b"]),
                             j(i["r"], bf), j(i["g"]), j(i["be"]),
                             block_m=64, interpret=True)
    return np.asarray(out, np.float32)


def _within(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    lim = ABS_TOL + REL_TOL * np.abs(want)
    assert np.isfinite(got).all() and (err <= lim).all(), \
        f"max |err| {err.max():.4g}, worst err/limit {(err / lim).max():.3g}"


@pytest.mark.parametrize("m", [1, 31, 33, 64, 65])
@pytest.mark.parametrize("k", [128, 256, 1152])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("bm", [32, 64])
def test_tiling_emulation_matches_plain_and_pallas(bm, d, k, m):
    args = _torch_args(_inputs(m, k, d))
    got = emulate_dense_ln_kernel(*args, bm=bm)
    assert got.shape == (m, d) and got.dtype == torch.bfloat16
    _within(got.float().numpy(), kffn.dense_ln_plain(*args).float().numpy())
    _within(got.float().numpy(), _jax_out(m, k, d))


def test_tiling_emulation_takes_the_rule_by_default():
    args = _torch_args(_inputs(65, 256, 128, seed=1))
    assert torch.equal(emulate_dense_ln_kernel(*args),
                       emulate_dense_ln_kernel(*args, bm=32))


# (M, D) -> rows per CTA at the encoder's dense_ln calls (B = 96): the text
# attention outputs at each context bucket, BiOutput's text side (inner
# width 1,024, D = 768), the visual attention outputs and BiOutput's visual
# side (D = 1,024); chip_smoke's ragged shape; the rule's edges
DENSE_LN_ROWS = [(96 * 256, 768, 64), (96 * 128, 768, 64),
                 (96 * 192, 768, 64), (3552, 1024, 32), (1000, 768, 32),
                 (64 * 132 - 1, 768, 32), (64 * 132, 768, 64),
                 (64 * 132 + 1, 768, 64), (24576, 1024, 32)]


@pytest.mark.parametrize("m,d,rows", DENSE_LN_ROWS, ids=str)
def test_dense_ln_block_rows(m, d, rows):
    assert kffn.block_rows(m, d) == rows
