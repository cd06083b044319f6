"""The yardstick's arithmetic: the H100's published peaks, the matmul
operations of the models' passes counted from their shapes, and each fused
kernel's operations and compulsory bytes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), valid
at the card's full 700 W power limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # tensor cores, bf16 in, f32 accumulate
PEAK_BYTES = 3.35e12       # HBM3


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time a call can take: its operations at the bf16 peak or
    its bytes at the memory peak, the larger."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


# --------------------------------------------------------------------- #
# fused kernels: LayerNorm(residual + x @ W^T + b) and
# LayerNorm(x + gelu(x @ W1^T + b1) @ W2^T + b2)
# --------------------------------------------------------------------- #

def dense_ln_flops(m: int, k: int, n: int) -> float:
    """The product of an [m, k] input with a [n, k] weight."""
    return 2.0 * m * k * n


def ffn_flops(m: int, d: int, f: int) -> float:
    """The two products of an [m, d] input through an [f, d] and a [d, f]
    weight."""
    return 4.0 * m * d * f


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dense_ln_bytes(x, weight, bias, residual, gamma, beta) -> int:
    """Each input read once and the output (residual's shape and dtype)
    written once."""
    return tensor_bytes(x, weight, bias, residual, gamma, beta, residual)


def ffn_bytes(x, w1, b1, w2, b2, gamma, beta) -> int:
    """Each input read once (x is also the residual) and the output (x's
    shape and dtype) written once; the [m, f] hidden never leaves the
    chip."""
    return tensor_bytes(x, w1, b1, w2, b2, gamma, beta, x)


# --------------------------------------------------------------------- #
# model passes (every weight and attention product; lookups, softmax and
# elementwise work not counted)
# --------------------------------------------------------------------- #

def encoder_flops(enc: dict, l: int, r: int) -> float:
    """One two-stream encoder forward of one row at text context ``l`` and
    ``r`` regions, the region embedding included."""
    d, f, dv, fv, bi = (enc["hidden_size"], enc["intermediate_size"],
                        enc["v_hidden_size"], enc["v_intermediate_size"],
                        enc["bi_hidden_size"])
    text = l * (2 * (4 * d * d + 2 * d * f) + 4 * l * d)
    vis = r * (2 * (4 * dv * dv + 2 * dv * fv) + 4 * r * dv)
    co = (r * (2 * 3 * dv * bi + 4 * l * bi + 2 * bi * dv + 4 * dv * fv)
          + l * (2 * 3 * d * bi + 4 * r * bi + 2 * bi * d + 4 * d * f))
    emb = r * 2 * (enc["v_feature_size"] + enc["v_loc_size"]) * dv
    return float(enc["num_hidden_layers"] * text
                 + enc["v_num_hidden_layers"] * vis
                 + len(enc["v_biattention_id"]) * co + emb)


def nsp_head_flops(enc: dict) -> float:
    """The two poolers and the NSP head of one row."""
    bi = enc["bi_hidden_size"]
    return float(2 * (enc["hidden_size"] + enc["v_hidden_size"]) * bi
                 + 2 * bi * 2)


def fusion_flops(enc: dict, l: int, r: int) -> float:
    """VLFusion's two projections of one row onto the text width."""
    d = enc["hidden_size"]
    return float(r * 2 * enc["v_hidden_size"] * d + l * 2 * d * d)


def memory_kv_flops(dec: dict, m: int) -> float:
    """Every decoder layer's cross-attention K and V of an ``m``-slot
    memory, one row."""
    d = dec["hidden_size"]
    return float(dec["num_hidden_layers"] * m * 2 * 2 * d * d)


def decoder_flops(dec: dict, t: int, m: int, keys: int) -> float:
    """``t`` decoder positions of one row over precomputed memory K/V of
    ``m`` slots, each attending ``keys`` self-attention keys (the whole
    causal square counted), and the LM head."""
    d, f = dec["hidden_size"], dec["intermediate_size"]
    layer = t * (2 * 4 * d * d + 4 * keys * d + 2 * 2 * d * d
                 + 4 * m * d + 4 * d * f)
    return float(dec["num_hidden_layers"] * layer
                 + t * 2 * d * dec["vocab_size"])
