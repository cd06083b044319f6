"""One-token decode cross-attention over int8 memory.

The port of ``gstx/kernels/decode_attn.py``: a hand-written CUDA kernel for
Hopper (``csrc/decode_attn.cu``) and its plain PyTorch version.
:func:`quant_decode_attention` computes ``softmax(q . K_i8^T + mask) . V_i8``
with f32 scores, softmax and output, reading K and V at int8 width on every
call; replaces ``quant_decode_attention`` (``decode_attn.py:60``).  The K
scale and 1/sqrt(dh) are folded into q beforehand and the caller applies the
V scale (``gstx_torch/models/decoder.py``, ``_quant_cross_attend``).

The switch :func:`enable_kernel` (off by default, as in the reference)
routes the decode steps' int8 cross-attention through
:func:`maybe_quant_decode_attention`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  There is no fallback from the kernel to the plain version.  The
wrapper counts its kernel launches in :data:`launches`.  There is no
backward: a CUDA call that would need a gradient raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from gstx_torch import kernels
from gstx_torch.kernels import build

# kernel launches since the last reset_launches()
launches = {"quant_decode_attention": 0}

_KERNEL_ENABLED = False

_HEAD_DIMS = (16, 32, 64, 128)
# the M f32 scores live in shared memory beside 4 KB of static scratch
_MAX_M = (232448 - 4096) // 4


def enable_kernel(flag: bool = True):
    global _KERNEL_ENABLED
    _KERNEL_ENABLED = flag


def is_kernel_enabled() -> bool:
    return _KERNEL_ENABLED


kernels.register(launches, is_kernel_enabled)


def reset_launches():
    for k in launches:
        launches[k] = 0


def quant_decode_attention_plain(q, k_i8, v_i8, mask=None):
    """Plain version of :func:`quant_decode_attention` (the Pallas kernel
    body, ``gstx/kernels/decode_attn.py:34-46``): f32 scores, + mask,
    max-subtract, exp, divide by the sum, f32 PV."""
    s = torch.matmul(q.float(), k_i8.float().transpose(-1, -2))  # [B,H,1,M]
    if mask is not None:
        s = s + mask.float()
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v_i8.float())


def quant_decode_attention(q, k_i8, v_i8, mask=None):
    """``softmax(q . K_i8^T + mask) . V_i8`` for one query token.

    q: [B, H, 1, dh] with the K scale and 1/sqrt(dh) folded in; k_i8, v_i8:
    [B, H, M, dh] int8; mask: additive [B or 1, 1, 1, M] or None.  Returns
    [B, H, 1, dh] f32 (the caller applies the V scale).  On CUDA: q bf16 or
    f32 and contiguous, K and V contiguous and 16-byte aligned, dh in
    {16, 32, 64, 128}; a bf16 or f32 mask is read as it is, any other dtype
    is converted to f32."""
    if q.device.type == "cpu":
        return quant_decode_attention_plain(q, k_i8, v_i8, mask)
    if q.device.type != "cuda":
        raise ValueError(f"quant_decode_attention: unsupported device "
                         f"{q.device}")
    name = "quant_decode_attention"
    if torch.is_grad_enabled() and q.requires_grad:
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call "
                           "it under torch.no_grad()")
    if q.dim() != 4 or q.shape[2] != 1 or k_i8.dim() != 4 or \
            k_i8.shape != v_i8.shape or k_i8.shape[:2] != q.shape[:2] or \
            k_i8.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q [B, H, 1, dh] and k, v [B, H, M, dh]; "
                         f"got {tuple(q.shape)}, {tuple(k_i8.shape)}, "
                         f"{tuple(v_i8.shape)}")
    b, h, _, dh = q.shape
    m = k_i8.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise TypeError(f"{name}: q bf16 or f32, k and v int8; got "
                        f"{q.dtype}, {k_i8.dtype}, {v_i8.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head width {dh} not in {_HEAD_DIMS}")
    if not 0 < m <= _MAX_M:
        raise ValueError(f"{name}: M={m} outside 1..{_MAX_M}")
    for t in (q, k_i8, v_i8):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: q, k and v must be contiguous")
    if k_i8.data_ptr() % 16 or v_i8.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must be 16-byte aligned")
    mask_sb, mask_dtype = 0, 0
    if mask is not None:
        if mask.device != q.device:
            raise ValueError(f"{name}: mask on {mask.device}, q on "
                             f"{q.device}")
        if mask.dim() != 4 or mask.shape[0] not in (1, b) or \
                mask.shape[1] != 1 or mask.shape[2] != 1 or \
                mask.shape[3] != m:
            raise ValueError(f"{name}: mask {tuple(mask.shape)} is not "
                             f"[{b} or 1, 1, 1, {m}]")
        if mask.dtype not in (torch.bfloat16, torch.float32):
            mask = mask.float()
        mask = mask.contiguous()
        mask_sb = m if mask.shape[0] == b and b > 1 else 0
        mask_dtype = 1 if mask.dtype == torch.bfloat16 else 0
    out = torch.empty((b, h, 1, dh), dtype=torch.float32, device=q.device)
    if b * h == 0:
        return out
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.gstx_quant_decode_attention(
        q.data_ptr(), k_i8.data_ptr(), v_i8.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b, h, m, dh, mask_sb, 1 if q.dtype == torch.bfloat16 else 0,
        mask_dtype, stream), name)
    launches[name] += 1
    return out


def maybe_quant_decode_attention(q, k_i8, v_i8, mask
                                 ) -> Optional[torch.Tensor]:
    """The kernel's result for a one-token query when the switch is on, else
    None (the caller runs its unfused ops).  The JAX gate
    (``decode_attn.py:108-122``) also requires the fused-FFN switch, a TPU
    and no tensor parallelism; the port's fused kernels are always on at
    bf16, so the first has no counterpart.  The last is GSPMD's: a
    ``pallas_call`` is opaque to it.  The port shards by head explicitly
    (:mod:`gstx_torch.models.tensor_parallel`): a rank holds whole heads of
    the memory, and the kernel runs unchanged on them."""
    if not _KERNEL_ENABLED:
        return None
    if q.shape[2] != 1:
        return None
    return quant_decode_attention(q, k_i8, v_i8, mask)
