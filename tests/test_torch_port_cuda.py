"""The port's CUDA kernels on the card: each against its plain version at
small and ragged shapes, the launch counter, and the wrapper's refusals.
Marked ``cuda``; skipped on a machine without a card.  On the card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from gstx_torch.kernels import ffn as kffn

pytestmark = pytest.mark.cuda

ABS_TOL, REL_TOL = 1e-2, 1.6e-2  # about 2 bf16 ulps, as chip_smoke.py


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


@pytest.mark.parametrize("m,d,f", [(70, 256, 1024), (33, 768, 3072),
                                   (17, 1024, 1024), (5, 128, 128)])
def test_ffn_kernel_matches_plain(dev, m, d, f):
    args = _ffn_args(dev, m, d, f)
    _close(kffn.fused_ffn(*args), kffn.ffn_plain(*args))


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
    w.requires_grad_(True)
    with pytest.raises(RuntimeError):
        kffn.fused_dense_ln(x, w, b, r, g, be)
