"""The FFN kernel's tiling (gstx_torch/kernels/csrc/ffn.cu::ffn_kernel),
emulated in PyTorch on the CPU and held against the plain version and the
JAX Pallas kernel in interpret mode on the same numpy inputs; and the rule
that picks its rows per CTA.  The kernel itself runs only on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from gstx.kernels.ffn import fused_ffn as jax_fused_ffn
from gstx_torch.kernels import ffn as kffn

# chip_smoke.py phase 2's tolerance for every bf16 kernel: about 2 bf16 ulps
ABS_TOL, REL_TOL = 1e-2, 1.6e-2
FC = 128        # hidden columns per F chunk
COL_WARPS = 8   # warps across a row: the LayerNorm's partial sums


def emulate_ffn_kernel(x, w1, b1, w2, b2, gamma, beta, eps=1e-12, bm=None):
    """What ffn_kernel computes, in its order: row blocks of ``bm`` rows
    zero-filled past M; F in FC-column chunks, each chunk's hidden made in
    f32, + b1, erf GELU in f32, rounded to bf16; the second product
    accumulated in f32 a 16-column weight tile at a time, in chunk order;
    + b2 + x; the LayerNorm's mean and centred variance from the 8 column
    warps' partial sums; the output rounded to bf16 once."""
    m, d = x.shape
    f = w1.shape[0]
    bm = bm or kffn.block_rows(m, d)
    w1f, w2f = w1.float(), w2.float()
    out = []
    for r0 in range(0, m, bm):
        xb = torch.zeros(bm, d)
        xb[:min(bm, m - r0)] = x[r0:r0 + bm].float()
        acc = torch.zeros(bm, d)
        for f0 in range(0, f, FC):
            h = xb @ w1f[f0:f0 + FC].t()
            h = kffn._gelu_erf(h + b1[f0:f0 + FC]).to(torch.bfloat16).float()
            for k in range(0, FC, 16):
                acc = acc + h[:, k:k + 16] @ w2f[:, f0 + k:f0 + k + 16].t()
        v = acc + b2 + xb
        mean = v.view(bm, COL_WARPS, -1).sum(-1).sum(-1, keepdim=True) / d
        dev = v - mean
        var = dev.square().view(bm, COL_WARPS, -1).sum(-1).sum(
            -1, keepdim=True) / d
        y = dev * torch.rsqrt(var + eps) * gamma + beta
        out.append(y[:min(bm, m - r0)])
    return torch.cat(out).to(torch.bfloat16)


def _inputs(m, d, f, seed=0):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(m, d), w1=rng.randn(f, d) * 0.02,
                b1=rng.randn(f) * 0.02, w2=rng.randn(d, f) * 0.02,
                b2=rng.randn(d) * 0.02, g=rng.rand(d) * 0.2 + 0.9,
                be=rng.randn(d) * 0.1)


def _torch_args(i):
    bf, f32 = torch.bfloat16, torch.float32

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return (t(i["x"], bf), t(i["w1"], bf), t(i["b1"], f32), t(i["w2"], bf),
            t(i["b2"], f32), t(i["g"], f32), t(i["be"], f32))


@functools.lru_cache(maxsize=None)
def _jax_out(m, d, f):
    """The Pallas kernel in interpret mode ([in, out] weight layout)."""
    i = _inputs(m, d, f)

    def j(a, dtype=jnp.float32):
        return jnp.asarray(np.asarray(a, np.float32), dtype)
    bf = jnp.bfloat16
    out = jax_fused_ffn(j(i["x"], bf), j(i["w1"].T, bf), j(i["b1"]),
                        j(i["w2"].T, bf), j(i["b2"]), j(i["g"]), j(i["be"]),
                        block_m=64, interpret=True)
    return np.asarray(out, np.float32)


def _within(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    lim = ABS_TOL + REL_TOL * np.abs(want)
    assert np.isfinite(got).all() and (err <= lim).all(), \
        f"max |err| {err.max():.4g}, worst err/limit {(err / lim).max():.3g}"


@pytest.mark.parametrize("m", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("d,f", [(128, 256), (128, 512), (256, 256),
                                 (256, 512)])
@pytest.mark.parametrize("bm", [32, 64])
def test_tiling_emulation_matches_plain_and_pallas(bm, d, f, m):
    args = _torch_args(_inputs(m, d, f))
    got = emulate_ffn_kernel(*args, bm=bm)
    assert got.shape == (m, d) and got.dtype == torch.bfloat16
    _within(got.float().numpy(), kffn.ffn_plain(*args).float().numpy())
    _within(got.float().numpy(), _jax_out(m, d, f))


def test_tiling_emulation_takes_the_rule_by_default():
    args = _torch_args(_inputs(65, 128, 256, seed=1))
    assert torch.equal(emulate_ffn_kernel(*args),
                       emulate_ffn_kernel(*args, bm=32))


# (M, D) -> rows per CTA: the encoder's text FFN at each context bucket and
# its visual / co-attention FFN (B = 96), chip_smoke's small model check,
# and the rule's edges (64 x 132 rows; D = 768 against 896 and 1024)
ENGINE = [(96 * 128, 768, 64), (96 * 192, 768, 64), (96 * 256, 768, 64),
          (3552, 1024, 32), (4 * 128, 768, 32)]
EDGES = [(64 * 132 - 1, 768, 32), (64 * 132, 768, 64), (64 * 132 + 1, 768, 64),
         (24576, 896, 32), (24576, 1024, 32), (64 * 132, 128, 64),
         (1, 768, 32)]


@pytest.mark.parametrize("m,d,rows", ENGINE + EDGES, ids=str)
def test_ffn_block_rows(m, d, rows):
    assert kffn.block_rows(m, d) == rows


# (M, D, F) -> whether the call takes the warp-specialised kernel: every
# D = 768 text shape of the cells (the encoder's buckets, the
# discriminative and generative scoring chunks) and the small ones (beam,
# random_token's refill, one row), none of the D = 1,024 visual ones, no
# other width, no partial F chunk.  The rows do not enter: phase 2 timed it
# the faster at every D = 768 shape.
WGMMA = [(96 * 128, 768, 3072, True), (96 * 192, 768, 3072, True),
         (96 * 256, 768, 3072, True), (51200, 768, 3072, True),
         (128000, 768, 3072, True), (12289, 768, 3072, True),
         (8192, 768, 3072, True), (256, 768, 3072, True), (1, 768, 3072, True),
         (24576, 768, 64, True), (3552, 1024, 1024, False),
         (7400, 1024, 1024, False), (18500, 1024, 1024, False),
         (128000, 1024, 3072, False), (24576, 896, 3072, False),
         (24576, 640, 3072, False), (24576, 768, 3104, False)]


@pytest.mark.parametrize("m,d,f,wgmma", WGMMA, ids=str)
def test_ffn_takes_wgmma(m, d, f, wgmma):
    assert kffn.takes_wgmma(d, f) is wgmma


def test_ffn_block_rows_fills_the_card_once():
    # where the rule takes 64 rows the grid has at least one CTA per SM
    for m in range(8000, 9000, 7):
        if kffn.block_rows(m, 768) == 64:
            assert -(-m // 64) >= kffn.SM_COUNT
