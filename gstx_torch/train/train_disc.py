"""Discriminative training: masked-LM + masked-region + soft-NSP losses on
the encoder-only model (the port of ``gstx/train/train_disc.py``,
reference ``train_disc.py``).

Each batch holds [B, 10 rounds, 1 + negatives] sequences.  A step draws
``batch_size`` of the flattened rows without replacement (the reference's
random permutation, ``train_disc.py:54-55``), attends each row up to its
``hist_len``-th [SEP] (``:97-99``), runs ``pretrain_scores`` under
dropout and the remat policy, and takes one AdamW step on the
coefficient-weighted sum of the three losses (``:116-123``).

Randomness as in :mod:`gstx_torch.train.train_gen`: iteration ``i``
draws its rows and its dropout seed from the CPU generator
``iteration_generator(seed, i)``, so a resumed run replays what the
uninterrupted one would have drawn; the rows and masks differ from the
JAX package's threefry draws.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from gstx_torch.core import checkpoint as ckpt_lib
from gstx_torch.core import mesh
from gstx_torch.core.config import GSTConfig
from gstx_torch.core.mesh import DataParallel
from gstx_torch.models.encdec import GSTVisualDialog
from gstx_torch.models.heads import (masked_img_loss, masked_lm_loss,
                                     soft_nsp_loss)
from gstx_torch.models.layers import Training
from gstx_torch.train import train_gen
from gstx_torch.train.optim import AdamW
from gstx_torch.train.train_gen import rows_to_device

DISC_WARMUP_STEPS = 10000  # reference train_disc.py:146

ROW_KEYS = ("tokens", "segments", "sep_indices", "mask",
            "next_sentence_labels", "hist_len")
IMAGE_KEYS = ("image_feat", "image_loc", "image_mask", "image_target",
              "image_label")
LOSS_NAMES = ("loss", "lm_loss", "nsp_loss", "img_loss")


def nsp_attention_mask(sep_indices: torch.Tensor, hist_len: torch.Tensor,
                       max_len: int) -> torch.Tensor:
    """[N, max_len] f32 mask over each row's tokens up to its
    ``hist_len``-th [SEP] inclusive, on the rows' device: the twin of
    :func:`gstx_torch.data.encode.nsp_attention_mask`
    (``gstx/train/train_disc.py:23-29``)."""
    seq_len = sep_indices.gather(1, hist_len[:, None])[:, 0] + 1
    pos = torch.arange(max_len, device=sep_indices.device)
    return (pos[None, :] < seq_len[:, None]).float()


def select_rows(batch: Dict[str, np.ndarray],
                sample_indices: np.ndarray) -> Dict[str, np.ndarray]:
    """The sampled rows of [B, rounds, 1 + negatives]
    (:func:`gstx_torch.train.train_gen.select_rows`,
    ``gstx/train/train_disc.py:64-80``), ``hist_len`` as [N]."""
    out = train_gen.select_rows(batch, sample_indices, ROW_KEYS, IMAGE_KEYS)
    out["hist_len"] = out["hist_len"].reshape(-1)
    return out


def loss_denominators(rows: Dict[str, np.ndarray], predict_feature: bool
                      ) -> Dict[str, float]:
    """What each of the three losses divides by over the host ``rows``
    (every drawn row of the step): the labelled MLM positions, the masked
    regions (their elements under ``predict_feature``), the rows; each at
    least 1, as :mod:`gstx_torch.models.heads` clamps them."""
    masked = rows["image_label"] == 1
    regions = float(masked.sum())
    if predict_feature:
        regions *= rows["image_target"].shape[-1]
    return {"lm_loss": max(1, int((rows["mask"] != -1).sum())),
            "img_loss": max(1.0, regions) if predict_feature
            else max(1, int(masked.sum())),
            "nsp_loss": rows["next_sentence_labels"].reshape(-1, 2).shape[0]}


def row_losses(model: GSTVisualDialog, rows, config: GSTConfig,
               train: Optional[Training],
               denoms: Optional[Dict[str, float]] = None
               ) -> Dict[str, torch.Tensor]:
    """The three losses of a row batch on the model's device and their
    coefficient-weighted sum ``loss`` (the JAX ``loss_fn``,
    ``gstx/train/train_disc.py:44-57``).  ``denoms``
    (:func:`loss_denominators` over every rank's rows) replaces what each
    loss divides by, for a data-parallel rank's share."""
    denoms = denoms or {}
    att_mask = nsp_attention_mask(rows["sep_indices"], rows["hist_len"],
                                  rows["tokens"].shape[-1])
    pred_t, pred_v, nsp = model.pretrain_scores(
        rows["tokens"], rows["image_feat"], rows["image_loc"],
        rows["segments"], att_mask, rows["image_mask"], train=train)
    out = {"lm_loss": masked_lm_loss(pred_t, rows["mask"],
                                     denoms.get("lm_loss"), model.vocab_tp),
           "img_loss": masked_img_loss(
               pred_v, rows["image_target"], rows["image_label"],
               model.enc_config.predict_feature, denoms.get("img_loss")),
           "nsp_loss": soft_nsp_loss(nsp, rows["next_sentence_labels"],
                                     denoms.get("nsp_loss"))}
    out["loss"] = (config.lm_loss_coeff * out["lm_loss"]
                   + config.nsp_loss_coeff * out["nsp_loss"]
                   + config.img_loss_coeff * out["img_loss"])
    return out


def make_disc_train_step(model: GSTVisualDialog, optimizer: AdamW,
                         config: GSTConfig, remat: Optional[str] = None,
                         dp: Optional[DataParallel] = None):
    """``step(batch, gen) -> losses``: one update from a numpy batch.  It
    draws ``batch_size`` distinct rows, then the seed of its dropout masks,
    from ``gen``.  The gradients stay on the parameters until the next step
    clears them.  Returns the four losses as device scalars,
    unsynchronised.  With ``dp``, as
    :func:`gstx_torch.train.train_gen.make_train_step`: the global batch
    gathered, the same rows drawn on every rank, each rank's share divided
    by the counts over all of them, the gradients and losses summed."""
    mine = train_gen.rank_rows(config.batch_size, dp)

    def step(batch, gen: torch.Generator):
        optimizer.zero_grad(set_to_none=True)
        if dp is not None:
            batch = dp.gather_batch(batch)
        total = int(np.prod(batch["tokens"].shape[:3]))
        idx = torch.randperm(total, generator=gen)[:config.batch_size]
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        drawn = select_rows(batch, idx.numpy())
        denoms = loss_denominators(drawn, model.enc_config.predict_feature)
        rows = rows_to_device({k: v[mine] for k, v in drawn.items()},
                              model.device)
        losses = row_losses(model, rows, config,
                            Training(train_gen.rank_seed(seed, dp), remat),
                            denoms)
        losses["loss"].backward()
        if dp is not None:
            dp.all_reduce_grads_(model.parameters())
        optimizer.step()
        return {k: v.detach() if dp is None else dp.sum(v.detach())
                for k, v in losses.items()}

    return step


def load_start_checkpoint(config: GSTConfig, model: GSTVisualDialog,
                          optimizer: AdamW):
    """Resume or warm start from ``-start_path``.  Returns
    ``(start_iter_id, start_exact)``.

    With ``-continue``, a checkpoint this trainer wrote (it has ``step``)
    whose path holds the mode restores the weights strictly, the optimizer
    and the step; ``start_exact`` as in
    :func:`gstx_torch.train.train_gen.load_start_checkpoint`.  Otherwise
    the weights load from an encoder-only or a full (encoder-decoder)
    file, whose encoder part is taken (:func:`gstx_torch.core.checkpoint.
    load_state`, the JAX CLI's ``load_params``)."""
    path = config.start_path
    raw = ckpt_lib.restore_checkpoint(path)
    sd = ckpt_lib.state_dict_of(raw)
    if config.continue_training and "step" in raw and \
            "optimizer_state_dict" in raw and config.mode in path:
        model.load_state_dict(sd, strict=True)
        optimizer.load_state_dict(ckpt_lib.shard_optimizer_state(
            raw["optimizer_state_dict"], model))
        return (int(raw["step"]), os.path.basename(
            path.rstrip("/")).endswith("_step.ckpt"))
    ckpt_lib.load_state(model, sd, path)
    return 0, False


def train_disc(config: GSTConfig, dataset, max_steps: Optional[int] = None,
               device="cuda", stats_out: Optional[dict] = None):
    """The training loop (``gstx/cli/train_disc.py:35-160``) through
    :func:`gstx_torch.train.train_gen.run_training`, whose ``stats_out`` it
    takes (the losses are LOSS_NAMES); returns (model, optimizer).  No
    final checkpoint, as the JAX CLI.  Data parallel across a process
    group as :func:`gstx_torch.train.train_gen.train_gen`."""
    os.makedirs(config.save_path, exist_ok=True)
    num_iter_epoch = max(1, len(dataset) // config.batch_size)
    device = torch.device(device)
    # the 2-D data x model layout without the decoder's dimensions
    # (gstx/cli/train_disc.py:66-73)
    mesh.validate_model_parallel(config.encoder_config(), None,
                                 config.model_parallel)
    axes = mesh.make_layout(config.data_parallel, config.model_parallel,
                            device)
    model, optimizer = train_gen.init_model_and_state(
        config, num_iter_epoch * config.num_epochs, device,
        use_decoder=False, warmup_steps=DISC_WARMUP_STEPS, tp=axes.tp)
    start = (0, False)
    if config.start_path:
        start = load_start_checkpoint(config, model, optimizer)
    step_fn = make_disc_train_step(
        model, optimizer, config,
        config.remat_policy if config.remat else None, axes.dp)
    loader = train_gen.striped_loader(config, dataset, axes)
    train_gen.run_training(
        config, model, optimizer, step_fn, loader, num_iter_epoch, start,
        "log_disc.txt",
        lambda v, lr: ("[Loss: %.4g][LM: %.4g][NSP: %.4g][IMG: %.4g]" % (
            v["loss"], v["lm_loss"], v["nsp_loss"], v["img_loss"]), v),
        epoch_ckpt="vd_train_disc_{epoch}.ckpt",
        # '_disc': both trainers run -mode vd_train, so their rotating
        # checkpoints in a shared save_path stay apart
        step_ckpt=f"{config.mode}_disc_step.ckpt",
        max_steps=max_steps, stats_out=stats_out)
    return model, optimizer
