"""Seeded weights, made by the benchmark on the device in one draw.

One ``torch.Generator`` on the device draws a single normal vector as long
as all of a model's distinct parameters together; each parameter is a
slice of it, scaled by its kind: linear weights N(0, 1/fan_in), embedding
tables and the LM projection N(0, 0.02), biases N(0, 0.02), LayerNorm
gains 1 + N(0, 0.02).  That draw is the configuration's own
(``weights_seed``): at random weights how soon a model samples [SEP], and
so how much work a dialog is, depends on the draw (4,170 to 15,045 tokens
a batch of 96 dialogs over five draws on the card).  The run's seed then
permutes every feed-forward block's hidden units (the rows of its first
projection and the columns of its second), which changes the weights and
leaves the function: every seed runs the same model on its own data.  The
same seed gives the same weights to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from gstbench.reference import model as ref_model

SEP_ID = 102
STD = 0.02


def seed_for(seed: int, *purpose: int) -> int:
    """A 63-bit generator seed from the run's seed and a purpose."""
    return int(np.random.SeedSequence([seed, *purpose])
               .generate_state(1, np.uint64)[0] >> 1)


def make(config: dict, seed: int, purpose: int, device,
         eos_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """Every distinct float32 parameter of ``config``'s model, by its
    reference name, on ``device``: the configuration's draw for
    ``purpose`` (one model of a cell), its feed-forward hidden units
    permuted by the run's ``seed``.  ``eos_bias`` is added to the [SEP]
    logit's bias of the decoder's LM head."""
    spec = ref_model.param_spec(config["encoder"], config.get("decoder"))
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(
        seed_for(config["weights_seed"], purpose))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "linear":
            t.mul_(1.0 / math.sqrt(shape[1]))
        elif kind == "ln_weight":
            t.mul_(STD).add_(1.0)
        else:
            t.mul_(STD)
        out[name] = t
    perm = torch.Generator(device=device).manual_seed(seed_for(seed, purpose))
    for name in [k for k in out if k.endswith("intermediate.dense.weight")]:
        inner = name[: -len(".weight")]
        outer = inner.replace("intermediate.dense", "output.dense")
        p = torch.randperm(out[name].shape[0], generator=perm, device=device)
        out[name] = out[name][p]
        out[inner + ".bias"] = out[inner + ".bias"][p]
        out[outer + ".weight"] = out[outer + ".weight"][:, p]
    if eos_bias and config.get("decoder") is not None:
        out[ref_model.DEC + "lm_head.decoder.bias"][SEP_ID] += eos_bias
    return out


def state_dict_for(program_keys, weights: Dict[str, torch.Tensor],
                   with_decoder: bool) -> Dict[str, torch.Tensor]:
    """The program's state dict (its checkpoint names, tied names
    included) from ``weights``; raises if the program names a parameter
    the reference does not know or misses one it does."""
    alias = ref_model.aliases(with_decoder)
    keys = set(program_keys)
    unknown = sorted(k for k in keys if alias.get(k, k) not in weights)
    missing = sorted(set(weights) - {alias.get(k, k) for k in keys})
    if unknown or missing:
        raise RuntimeError(f"the program's parameters differ from the "
                           f"reference's: unknown {unknown[:5]}, "
                           f"missing {missing[:5]}")
    return {k: weights[alias.get(k, k)] for k in keys}
