"""Fused feed-forward and projection-LayerNorm epilogues.

The port of ``gstx/kernels/ffn.py``: hand-written CUDA kernels for Hopper
(``csrc/ffn.cu``, and ``csrc/ffn_sm90.cu`` for the FFN at D = 768) and their
plain PyTorch versions.

  * :func:`fused_dense_ln` -- ``LayerNorm(residual + x @ W^T + b)``, the
    attention-output projection with its residual LayerNorm (reference
    BertSelfOutput / BertBiOutput); replaces ``_dense_ln_pallas``
    (``gstx/kernels/ffn.py:254``).
  * :func:`fused_ffn` -- ``LayerNorm(x + gelu(x @ W1^T + b1) @ W2^T + b2)``
    with the [M, F] hidden kept on chip (reference BertIntermediate +
    BertOutput, exact-erf GELU); replaces ``_ffn_pallas``
    (``gstx/kernels/ffn.py:198``).  Two designs compute it, chosen from the
    call's widths alone (:func:`takes_wgmma`): a warp-specialised kernel
    (TMA ring, wgmma) at D = 768, and the mma.sync kernel at the others.

Weights are in ``nn.Linear`` layout ([out, in]).  Numerics: products
accumulate in f32; bias, residual, GELU and LayerNorm (eps inside the rsqrt)
run in f32; the FFN hidden is rounded to the activation dtype before the
second product, as the Pallas kernel does (``ffn.py:224``); the output has
the activation dtype.

:func:`widths_taken` says which widths the kernels take: the layers' gate
declines the others, and the wrappers raise on them.  The switch
:func:`enable` (on by default) lets the layers' gate route bf16 calls to the
kernels at all; the CLIs set it from ``-use_pallas``.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  There is no fallback from the kernel to the plain version.  Each
wrapper counts its kernel launches in :data:`launches`; the FFN also counts,
in the program's registry while it collects, ``ffn.calls`` (every launch)
and ``ffn.wgmma_calls`` (those that took the D = 768 design).

Both wrappers differentiate (:class:`FusedDenseLN`, :class:`FusedFFN`, the
counterparts of the JAX package's ``jax.custom_vjp``,
``gstx/kernels/ffn.py:306-367``): the forward is the kernel (the plain
version on the CPU), the backward recomputes the block in f32 with plain
torch ops and differentiates that.  There is no backward kernel, as the JAX
package has none.
"""

from __future__ import annotations

import torch

from gstx_torch import kernels
from gstx_torch.core import profiling
from gstx_torch.kernels import build

# kernel launches per wrapper since the last reset_launches()
launches = {"fused_dense_ln": 0, "fused_ffn": 0}

# the H100 SXM's streaming multiprocessors: one CTA of either kernel runs
# on each
SM_COUNT = 132
# a CTA keeps whole output rows in registers, 8 column warps of D / 8
# columns (D = 128 * NT, NT <= 8)
MAX_WIDTH = 1024


# the layers' fused path: on by default, unlike the JAX package's module
# default (off, ``gstx/kernels/ffn.py:33``), whose CLIs turn it on from
# -use_pallas (default True) before any use.  The port's default matches
# what its CLIs and the reference's bf16 path run.
_ENABLED = True


def enable(flag: bool = True):
    """Switch the layers' fused FFN / projection-LayerNorm path on or
    off (``gstx/kernels/ffn.py:42``); a direct wrapper call ignores it."""
    global _ENABLED
    _ENABLED = bool(flag)


def is_enabled() -> bool:
    return _ENABLED


kernels.register(launches, is_enabled)


def block_rows(m, d):
    """Rows per CTA of both kernels for an [m, d] output: 64 where the
    [64, d] f32 accumulator fits the register file (d <= 768) and 64-row
    blocks fill the card at least once (m >= 64 * SM_COUNT), else 32."""
    return 64 if d <= 768 and m >= 64 * SM_COUNT else 32


# fused_ffn's warp-specialised design (csrc/ffn_sm90.cu): its one output
# width and its F chunk.  It takes every call of that width, whatever M:
# timed against the mma.sync kernel at every D = 768 shape of the port (64
# to 128,000 rows), it was the faster at each (PERF.md).
WGMMA_WIDTH = 768
WGMMA_CHUNK = 64


def takes_wgmma(d, f):
    """Whether an FFN call of output width d and inner width f runs the
    warp-specialised kernel (else the mma.sync one): d = 768 and whole F
    chunks.  A function of the shape alone."""
    return d == WGMMA_WIDTH and f % WGMMA_CHUNK == 0


def widths_taken(d, inner):
    """Whether both kernels take an output width ``d`` and an inner width
    ``inner`` (dense_ln's Din, the FFN's F): d % 128 == 0 up to MAX_WIDTH,
    inner % 128 == 0 of any size (dense_ln streams x in 16-column tiles,
    the FFN walks F in 128-column chunks).  The layers' gate and the
    wrappers' check both use it."""
    return d % 128 == 0 and 0 < d <= MAX_WIDTH and inner % 128 == 0 \
        and inner > 0


def reset_launches():
    for k in launches:
        launches[k] = 0


def _layer_norm(y, gamma, beta, eps):
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * gamma + beta


def _gelu_erf(x):
    return x * 0.5 * (1.0 + torch.erf(x * (2.0 ** -0.5)))


def dense_ln_plain(x, weight, bias, residual, gamma, beta, eps=1e-12):
    """Plain version of :func:`fused_dense_ln` (the Pallas kernel body,
    ``gstx/kernels/ffn.py:275-281``)."""
    y = x.float() @ weight.float().t()
    y = y + bias.float() + residual.float()
    return _layer_norm(y, gamma.float(), beta.float(),
                       eps).to(residual.dtype)


def ffn_plain(x, w1, b1, w2, b2, gamma, beta, eps=1e-12):
    """Plain version of :func:`fused_ffn` (the Pallas kernel body,
    ``gstx/kernels/ffn.py:218-230``), including the rounding of the hidden
    to x's dtype before the second product."""
    xf = x.float()
    h = _gelu_erf(xf @ w1.float().t() + b1.float()).to(x.dtype)
    y = h.float() @ w2.float().t() + b2.float() + xf
    return _layer_norm(y, gamma.float(), beta.float(), eps).to(x.dtype)


def _check_cuda(name, dev, bf16=(), f32=()):
    """Validate what the kernel takes; raise on anything else."""
    for t, dtype in [(t, torch.bfloat16) for t in bf16] + \
            [(t, torch.float32) for t in f32]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        # tensor-core fragment loads need 256-bit aligned bases
        if dtype == torch.bfloat16 and t.data_ptr() % 32:
            raise ValueError(f"{name}: bf16 tensors must be 32-byte aligned")


def _check_width(name, d, k):
    """Raise exactly where :func:`widths_taken` (the gate's predicate) says
    no."""
    if not widths_taken(d, k):
        raise ValueError(f"{name}: needs D % 128 == 0, D <= {MAX_WIDTH} and "
                         f"an inner width % 128 == 0; got D={d}, inner={k}")


def _dense_ln_forward(x, weight, bias, residual, gamma, beta, eps):
    """The forward of :func:`fused_dense_ln`: the plain version for CPU
    tensors, the kernel for CUDA ones."""
    if x.device.type == "cpu":
        return dense_ln_plain(x, weight, bias, residual, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_ln: unsupported device {x.device}")
    d, din = weight.shape
    if x.shape[-1] != din or residual.shape[-1] != d or \
            x.shape[:-1] != residual.shape[:-1] or \
            tuple(bias.shape) != (d,) or tuple(gamma.shape) != (d,) or \
            tuple(beta.shape) != (d,):
        raise ValueError("fused_dense_ln: shape mismatch")
    _check_width("fused_dense_ln", d, din)
    _check_cuda("fused_dense_ln", x.device, bf16=(x, weight, residual),
                f32=(bias, gamma, beta))
    out = torch.empty_like(residual)
    m = residual.numel() // d
    if m:
        lib = build.library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib.gstx_dense_ln(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            residual.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), m, din, d, block_rows(m, d), float(eps), stream),
            "fused_dense_ln")
        launches["fused_dense_ln"] += 1
    return out


def _ffn_forward(x, w1, b1, w2, b2, gamma, beta, eps):
    """The forward of :func:`fused_ffn`: the plain version for CPU tensors,
    the kernel for CUDA ones."""
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    f, d = w1.shape
    if x.shape[-1] != d or tuple(w2.shape) != (d, f) or \
            tuple(b1.shape) != (f,) or tuple(b2.shape) != (d,) or \
            tuple(gamma.shape) != (d,) or tuple(beta.shape) != (d,):
        raise ValueError("fused_ffn: shape mismatch")
    _check_width("fused_ffn", d, f)
    _check_cuda("fused_ffn", x.device, bf16=(x, w1, w2),
                f32=(b1, b2, gamma, beta))
    out = torch.empty_like(x)
    m = x.numel() // d
    if m:
        lib = build.library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                out.data_ptr())
        if takes_wgmma(d, f):
            build.check(lib.gstx_ffn_sm90(*ptrs, m, d, f, float(eps), stream),
                        "fused_ffn")
            profiling.count("ffn.wgmma_calls")
        else:
            build.check(lib.gstx_ffn(*ptrs, m, d, f, block_rows(m, d),
                                     float(eps), stream), "fused_ffn")
        profiling.count("ffn.calls")
        launches["fused_ffn"] += 1
    return out


# ---------------------------------------------------------------------- #
# reverse mode: the kernels' forward, an f32 recompute backward
# ---------------------------------------------------------------------- #


def dense_ln_recompute(x, weight, bias, residual, gamma, beta, eps):
    """The backward's f32 math of :class:`FusedDenseLN`
    (``_dense_ln_ref_math``, ``gstx/kernels/ffn.py:332``)."""
    y = x.float() @ weight.float().t() + bias.float() + residual.float()
    return _layer_norm(y, gamma.float(), beta.float(),
                       eps).to(residual.dtype)


def ffn_recompute(x, w1, b1, w2, b2, gamma, beta, eps):
    """The backward's f32 math of :class:`FusedFFN` (``_ffn_ref_math``,
    ``gstx/kernels/ffn.py:313-318``).  Unlike the forward (the kernel and
    :func:`ffn_plain`), it does NOT round the hidden to x's dtype: the JAX
    package differentiates this unrounded math, and so does the port."""
    xf = x.float()
    h = _gelu_erf(xf @ w1.float().t() + b1.float())
    y = h @ w2.float().t() + b2.float() + xf
    return _layer_norm(y, gamma.float(), beta.float(), eps).to(x.dtype)


def _recompute_grads(ctx, math, g):
    """The vector-Jacobian product of ``math`` at the saved inputs: the
    inputs that need a gradient get it in their own dtype (a bf16 weight's
    gradient is bf16; autograd carries it back through the cast to the f32
    parameter), the others None."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = math(*leaves, ctx.eps)
        wanted = [t for t, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(out, wanted, g)) if wanted else None
    return tuple(next(got) if n else None for n in need) + (None,)


class FusedDenseLN(torch.autograd.Function):
    """:func:`fused_dense_ln` under autograd: the kernel forward (the plain
    version on the CPU), the backward :func:`dense_ln_recompute`'s vjp, as
    ``_dense_ln_vjp`` (``gstx/kernels/ffn.py:337-365``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, gamma, beta, eps):
        ctx.save_for_backward(x, weight, bias, residual, gamma, beta)
        ctx.eps = eps
        return _dense_ln_forward(x, weight, bias, residual, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        return _recompute_grads(ctx, dense_ln_recompute, g)


class FusedFFN(torch.autograd.Function):
    """:func:`fused_ffn` under autograd: the kernel forward (the plain
    version on the CPU), the backward :func:`ffn_recompute`'s vjp, as
    ``_ffn_vjp`` (``gstx/kernels/ffn.py:306-330``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, eps):
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta)
        ctx.eps = eps
        return _ffn_forward(x, w1, b1, w2, b2, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        return _recompute_grads(ctx, ffn_recompute, g)


def fused_dense_ln(x, weight, bias, residual, gamma, beta, eps=1e-12):
    """``LayerNorm(residual + x @ weight^T + bias)``, differentiable
    (:class:`FusedDenseLN`).

    x: [..., Din]; weight: [D, Din]; bias, gamma, beta: [D];
    residual: [..., D].  On CUDA: x, weight, residual bf16; bias, gamma,
    beta f32; widths that :func:`widths_taken`.  Returns residual's dtype
    and shape."""
    return FusedDenseLN.apply(x, weight, bias, residual, gamma, beta, eps)


def fused_ffn(x, w1, b1, w2, b2, gamma, beta, eps=1e-12):
    """``LayerNorm(x + gelu(x @ w1^T + b1) @ w2^T + b2)``, differentiable
    (:class:`FusedFFN`).

    x: [..., D]; w1: [F, D]; b1: [F]; w2: [D, F]; b2, gamma, beta: [D].
    On CUDA: x, w1, w2 bf16; b1, b2, gamma, beta f32; widths that
    :func:`widths_taken`.  Returns x's dtype and shape."""
    return FusedFFN.apply(x, w1, b1, w2, b2, gamma, beta, eps)
