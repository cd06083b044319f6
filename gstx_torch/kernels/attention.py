"""Fused attention: ``softmax(q k^T / sqrt(dh) + mask) v`` with the scores
kept on chip.

The port of ``gstx/kernels/attention.py``: one hand-written CUDA kernel for
Hopper (``csrc/attention.cu``) in two instances, and their plain PyTorch
versions.

  * :func:`fused_attention` -- f32 scores and probabilities, output in
    q's dtype; replaces ``fused_attention``
    (``gstx/kernels/attention.py:64``).  Masks [B, 1|H, 1|Lq, Lk].
  * :func:`fused_attention_batch` -- the same function with the
    probabilities cast to V's dtype before PV, which is what the unfused
    :func:`gstx_torch.models.layers.attend` computes; replaces
    ``fused_attention_batch`` (``attention.py:143``).  Masks [B, 1, 1|Lq, Lk].
    Neither package calls it on a model path.

bf16 inputs run both products on the tensor cores with an online softmax
(f32 probabilities as a hi + lo pair of bf16 for :func:`fused_attention`);
they hold within about one bf16 ulp of the plain versions, not bit for bit.
f32 inputs run f32 FMAs with the score rows in shared memory, which caps Lk
(:func:`max_key_length`).

The switch :func:`enable` (off by default, as in the reference) routes
``layers.attend`` through :func:`maybe_fused_attention`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  There is no fallback from the kernel to the plain version.  Each
wrapper counts its kernel launches in :data:`launches`.  There is no
backward: a CUDA call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from gstx_torch import kernels
from gstx_torch.kernels import build

# kernel launches per wrapper since the last reset_launches()
launches = {"fused_attention": 0, "fused_attention_batch": 0}

_ENABLED = False

# the f32 instances' tiling (csrc/attention.cu): 32 query rows and 64-key
# tiles, Q/K/V rows padded by 4 floats, score rows of Lk rounded up to 32
# plus 4
_QT, _KT, _PAD, _SMEM_LIMIT = 32, 64, 4, 232448
# the bf16 instances keep no score rows: key indices stay 32-bit ints
_BF16_MAX_LK = 2 ** 31 - _KT
_HEAD_DIMS = (16, 32, 64, 128)


def enable(flag: bool = True):
    global _ENABLED
    _ENABLED = flag


def is_enabled() -> bool:
    return _ENABLED


kernels.register(launches, is_enabled)


def reset_launches():
    for k in launches:
        launches[k] = 0


def softmax_scale(dh: int) -> float:
    """1/sqrt(dh) rounded in f32 as jnp computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _scores(q, k, mask):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * softmax_scale(q.shape[-1])
    return s if mask is None else s + mask.float()


def attention_plain(q, k, v, mask=None):
    """Plain version of :func:`fused_attention` (the Pallas kernel body,
    ``gstx/kernels/attention.py:103-115``): everything in f32, the output
    rounded once to q's dtype."""
    probs = torch.softmax(_scores(q, k, mask), dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def attention_batch_plain(q, k, v, mask=None):
    """Plain version of :func:`fused_attention_batch` (the Pallas kernel
    body, ``attention.py:184-198``): the probabilities are cast to V's dtype
    before PV, which accumulates in f32."""
    probs = torch.softmax(_scores(q, k, mask), dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def max_key_length(dh: int, dtype: torch.dtype) -> int:
    """The longest Lk the kernel takes: for f32, whose score rows fit its
    shared memory; for bf16, which streams the keys, the int range."""
    if dtype == torch.bfloat16:
        return _BF16_MAX_LK
    rows = (_SMEM_LIMIT // 4 - (_QT + _KT) * (dh + _PAD)) // _QT
    return (rows - _PAD) // 32 * 32


def attention_takes(dh: int, lk: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes a head width ``dh`` and ``lk`` keys in
    ``dtype``: the gate's predicate, which the launch raises by."""
    return dtype in (torch.bfloat16, torch.float32) and \
        dh in _HEAD_DIMS and 0 < lk <= max_key_length(dh, dtype)


def _launch(name, q, k, v, mask, round_probs):
    """Validate what the kernel takes, raise on anything else, launch."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, mask)):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call "
                           "it under torch.no_grad()")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B, H, Lq, dh], k and v [B, H, Lk, dh]")
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != dh:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share bf16 or f32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not attention_takes(dh, lk, q.dtype):
        raise ValueError(f"{name}: needs a head width in {_HEAD_DIMS} and "
                         f"Lk in 1..{max_key_length(dh, q.dtype)}; got "
                         f"dh={dh}, Lk={lk}")
    # 16-byte loads (cp.async for bf16, float4 for f32): unit last stride,
    # batch, head and row strides of whole 16-byte vectors, aligned base
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v need a contiguous last "
                             f"dimension, strides divisible by {vec} and "
                             "16-byte aligned data")
    mask_strides = (0, 0, 0)
    if mask is not None:
        if mask.device != q.device:
            raise ValueError(f"{name}: mask on {mask.device}, q on "
                             f"{q.device}")
        heads_ok = (1,) if round_probs else (1, h)
        if mask.dim() != 4 or mask.shape[0] != b or \
                mask.shape[1] not in heads_ok or \
                mask.shape[2] not in (1, lq) or mask.shape[3] != lk:
            raise ValueError(f"{name}: mask {tuple(mask.shape)} is not "
                             f"[{b}, {'|'.join(map(str, heads_ok))}, "
                             f"1|{lq}, {lk}]")
        mask = mask.to(torch.float32).contiguous()
        mask_strides = tuple(st if n != 1 else 0 for st, n in
                             zip(mask.stride()[:3], mask.shape[:3]))
    # written as [B, Lq, H, dh]: merging the heads afterwards is a free view
    out = torch.empty((b, lq, h, dh), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if b * h * lq == 0:
        return out
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *mask_strides,
        *out.stride()[:3])
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.gstx_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b, h, lq, lk, dh, strides, softmax_scale(dh),
        1 if q.dtype == torch.bfloat16 else 0, int(round_probs), stream),
        name)
    launches[name] += 1
    return out


def _route(name, plain, round_probs, q, k, v, mask):
    if q.device.type == "cpu":
        return plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return _launch(name, q, k, v, mask, round_probs)


def fused_attention(q, k, v, mask=None):
    """``softmax(q k^T / sqrt(dh) + mask) v`` in f32, returned in q's dtype.

    q: [B, H, Lq, dh]; k, v: [B, H, Lk, dh]; mask: additive, [B, 1|H, 1|Lq,
    Lk], any float dtype, or None.  On CUDA: q, k, v bf16 or f32 with a
    contiguous last dimension (the heads-split views of a projection
    qualify), dh in {16, 32, 64, 128}, Lk up to :func:`max_key_length`."""
    return _route("fused_attention", attention_plain, False, q, k, v, mask)


def fused_attention_batch(q, k, v, mask=None):
    """As :func:`fused_attention`, with the probabilities cast to V's dtype
    before PV; mask [B, 1, 1|Lq, Lk] or None."""
    return _route("fused_attention_batch", attention_batch_plain, True,
                  q, k, v, mask)


def maybe_fused_attention(q, k, v, mask) -> Optional[torch.Tensor]:
    """The kernel's result when eligible, else None (the caller runs the
    unfused ops).  The conditions of ``attention.py:221-235``, in order,
    without its TPU test: the switch is on; attention dropout is inactive
    (always, the port's forward is deterministic); Lq >= 8 (decode steps are
    too small to gain); the mask carries q's batch.  Then the kernel's own
    limits (:func:`attention_takes`), where the reference pads dh and Lk
    instead (``attention.py:78-100``): the unfused ops compute the same
    function."""
    if not _ENABLED:
        return None
    if q.shape[2] < 8:
        return None
    if mask is not None and mask.shape[0] != q.shape[0]:
        return None
    if not attention_takes(q.shape[-1], k.shape[2], q.dtype):
        return None
    return fused_attention(q, k, v, mask)
