"""Optimizer: the reference's AdamW with two learning-rate groups and the
warmup-linear-nonzero schedule (the port of ``gstx/train/optim.py``).

  * :func:`warmup_linear_nonzero` (reference ``utils/optim_utils.py:19-26``):
    linear warmup, then linear decay, floored at ``min_lr`` on both sides;
  * two LR groups (reference ``train_gen.py:204-242``): the text embeddings,
    the text-stream layers and the MLM head take ``lr``; the visual stream,
    co-attention, poolers, NSP and image heads, fusion and the decoder take
    ``image_lr`` (:func:`is_language_param`);
  * no weight decay for biases and LayerNorm weights, 0.01 otherwise
    (:func:`is_no_decay_param`);
  * the exact step of pytorch-transformers 1.2.0 ``AdamW``: b1 0.9,
    b2 0.999, eps 1e-6 added to the uncorrected sqrt(v) before the bias
    correction folds into the step size, and weight decay applied after the
    update to the updated parameters with the scheduled group lr.

The JAX package writes its predicates on Flax paths; the port's are written
on the reference torch names that ``gstx_torch.core.checkpoint.
state_dict_from_jax`` gives those paths.  The frozen prefixes
(``fixed_t_layer`` / ``fixed_v_layer``) and the co-attention
``biOutput.q_dense*`` projections, which the forward never calls and the
JAX package does not have, are left out of the optimizer.  Every other
parameter is updated each step, with a zero gradient where the loss does
not reach it (the poolers and the pretraining heads), as the JAX
optimizer's tree update does.
"""

from __future__ import annotations

import re
from typing import Iterable, Tuple

import torch

ENC = "encoder.bert_pretrained."
_LANGUAGE = (ENC + "bert.embeddings.", ENC + "bert.encoder.layer.",
             ENC + "cls.predictions.transform.")


def warmup_linear_nonzero(base_lr: float, warmup_steps: int, t_total: int,
                          min_lr: float = 1e-5):
    """The schedule of ``gstx/train/optim.py:44-57``: lr at update
    ``step`` (0-based), in f32 as the JAX package computes it."""

    def schedule(step: int) -> float:
        step = torch.tensor(float(step))
        warm = step / max(1.0, warmup_steps)
        decay = torch.clamp((t_total - step)
                            / max(1.0, t_total - warmup_steps), min=0.0)
        lr = base_lr * torch.where(step < warmup_steps, warm, decay)
        return float(torch.where(lr > min_lr, lr, min_lr))

    return schedule


def is_language_param(name: str) -> bool:
    """The language group (``gstx/train/optim.py:64-83``): the text
    embeddings, the text-stream layers and the MLM head's transform and
    bias.  The NSP head stays in the image group, as the reference's
    name list misses it."""
    return name.startswith(_LANGUAGE) or \
        name == ENC + "cls.predictions.bias"


def is_no_decay_param(name: str) -> bool:
    """No weight decay for a bias or a LayerNorm weight
    (``gstx/train/optim.py:86-93``: leaves ``bias`` and ``scale``)."""
    return name.endswith("bias") or \
        re.search(r"\.LayerNorm\d?\.weight$", name) is not None


def is_frozen_param(name: str, fixed_t_layer: int = 0,
                    fixed_v_layer: int = 0) -> bool:
    """A parameter of the frozen prefixes (``gstx/train/optim.py:150-162``)."""
    m = re.match(re.escape(ENC) + r"bert\.encoder\.(v_)?layer\.(\d+)\.",
                 name)
    if m is None:
        return False
    return int(m.group(2)) < (fixed_v_layer if m.group(1) else fixed_t_layer)


def trained_params(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   fixed_t_layer: int = 0, fixed_v_layer: int = 0):
    """(name, param) of the parameters the optimizer updates: tied
    parameters once, under their first name; no frozen prefix and no
    ``biOutput.q_dense*``."""
    seen, out = set(), []
    for name, p in named_params:
        if id(p) in seen or ".biOutput.q_dense" in name or \
                is_frozen_param(name, fixed_t_layer, fixed_v_layer):
            continue
        seen.add(id(p))
        out.append((name, p))
    return out


class AdamW(torch.optim.Optimizer):
    """The JAX package's ``make_optimizer`` (``gstx/train/optim.py:
    136-192``) as a torch optimizer over named parameters.

    Four groups, (language | image) x (decay | no decay); each group holds
    its parameters' names, its schedule's base lr and its weight decay, and
    ``step``, the number of updates done, which picks the lr of the next
    one.  Per parameter: ``exp_avg``, ``exp_avg_sq``.  The update of one
    group at step t (1-based), lr the schedule at t - 1:

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        p = p - lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)
        p = p - lr * wd * p
    """

    def __init__(self, named_params, lr: float, image_lr: float,
                 warmup_steps: int, t_total: int, min_lr: float = 1e-5,
                 weight_decay: float = 0.01, fixed_t_layer: int = 0,
                 fixed_v_layer: int = 0, betas=(0.9, 0.999),
                 eps: float = 1e-6):
        groups = {}
        for name, p in trained_params(named_params, fixed_t_layer,
                                      fixed_v_layer):
            lang = is_language_param(name)
            decay = 0.0 if is_no_decay_param(name) else weight_decay
            g = groups.setdefault((lang, decay), {
                "params": [], "names": [], "base_lr": lr if lang
                else image_lr, "weight_decay": decay, "language": lang})
            g["params"].append(p)
            g["names"].append(name)
        defaults = dict(betas=betas, eps=eps, warmup_steps=warmup_steps,
                        t_total=t_total, min_lr=min_lr, step=0)
        super().__init__(list(groups.values()), defaults)

    def current_lrs(self) -> Tuple[float, float]:
        """(language lr, image lr) of the next update (``current_lrs``,
        ``gstx/train/optim.py:205``)."""
        out = {}
        for g in self.param_groups:
            out[g["language"]] = self._lr(g)
        return out.get(True, 0.0), out.get(False, 0.0)

    @staticmethod
    def _lr(group) -> float:
        return warmup_linear_nonzero(group["base_lr"], group["warmup_steps"],
                                     group["t_total"],
                                     group["min_lr"])(group["step"])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr = self._lr(group)
            group["step"] += 1
            t = group["step"]
            b1, b2 = group["betas"]
            params, grads, ms, vs = [], [], [], []
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                params.append(p)
                grads.append(p.grad if p.grad is not None
                             else torch.zeros_like(p))
                ms.append(state["exp_avg"])
                vs.append(state["exp_avg_sq"])
            if not params:
                continue
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
            denom = torch._foreach_sqrt(vs)
            torch._foreach_add_(denom, group["eps"])
            step_size = lr * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
            torch._foreach_addcdiv_(params, ms, denom, value=-step_size)
            if group["weight_decay"] > 0.0:
                torch._foreach_add_(params, params,
                                    alpha=-lr * group["weight_decay"])
