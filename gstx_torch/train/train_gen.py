"""Generative training (teacher / questioner / student): the port of
``gstx/train/train_gen.py``.

Per-dialog batches carry [B, 10 rounds, 1 sample] sequences; each step
samples exactly ``batch_size`` rows with non-empty labels (with
replacement, the reference's static-shape trick, ``train_gen.py:63-68``),
runs the encoder-decoder teacher-forced forward with dropout under the
remat policy, and takes one AdamW step under the warmup-linear-nonzero
schedule.  ``batch_multiply`` > 1 accumulates that many independently
sampled micro-batches into one update, their gradients' mean.

Randomness: iteration ``i`` draws its rows and its dropout seeds from a
CPU ``torch.Generator`` seeded from ``SeedSequence([seed, i])`` (the JAX
package folds ``i`` into its key), so a resumed run replays exactly what
the uninterrupted one would have drawn.  Torch's generators are not JAX's
threefry, so the rows and masks differ from the JAX package's.

Tensor parallelism (``-model_parallel`` > 1, :func:`gstx_torch.core.mesh.
make_layout`): the ranks form ``dp`` replicas of ``mp`` shards.  The
data axis (the batch's gather, the gradients' all-reduce, the dropout
seed's offset) is the data group of the ranks that hold the same shard;
the ranks of one model group read the same stripe, draw the same rows and
the same dropout masks, and compute them together.  Checkpoints hold full
tensors (:func:`gstx_torch.core.checkpoint.save_checkpoint`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from gstx_torch.core import checkpoint as ckpt_lib
from gstx_torch.core import mesh, profiling
from gstx_torch.core.config import PAD_ID, GSTConfig
from gstx_torch.core.logging import Logger, MetricsWriter
from gstx_torch.core.mesh import Axes, DataParallel
from gstx_torch.data.loader import DataLoader, batch_iter
from gstx_torch.models.encdec import GSTVisualDialog, teacher_forced_loss
from gstx_torch.models.layers import Training
from gstx_torch.train.optim import AdamW

ROW_KEYS = ("enc_input_ids", "enc_segments", "enc_sep_indices",
            "enc_mlm_labels", "enc_att_mask", "dec_input_ids",
            "dec_att_mask", "dec_labels")
IMAGE_KEYS = ("enc_image_feat", "enc_image_loc", "enc_image_mask",
              "enc_image_target", "enc_image_label")


def select_rows(batch: Dict[str, np.ndarray], sample_indices: np.ndarray,
                row_keys=ROW_KEYS, image_keys=IMAGE_KEYS
                ) -> Dict[str, np.ndarray]:
    """Flatten [B, rounds, samples, ...] to rows and gather the sampled ones
    (``gstx/train/train_gen.py:34-55``, ``gstx/train/train_disc.py:64-80``);
    a row's per-image tensors come from image ``row // (rounds *
    samples)``.  Keys the batch lacks are left out."""
    b, rounds, samples = batch[row_keys[0]].shape[:3]
    total = b * rounds * samples
    out = {k: batch[k].reshape(total, *batch[k].shape[3:])[sample_indices]
           for k in row_keys if k in batch}
    img_idx = sample_indices // (rounds * samples)
    out.update({k: batch[k][img_idx] for k in image_keys if k in batch})
    return out


def candidate_weights(dec_labels: np.ndarray) -> torch.Tensor:
    """The sampling weight of each flattened row: 1 for a row with a label,
    1e-9 for one without (``gstx/train/train_gen.py:100-103``: categorical
    over ``log(max(cand, 1e-9))``).  When no row has a label (a
    ``-select_data`` batch whose rounds all pass the threshold) the rows
    are drawn uniformly and the loss is 0."""
    flat = dec_labels.reshape(-1, dec_labels.shape[-1])
    cand = (flat.sum(-1) != 0).astype(np.float32)
    return torch.from_numpy(np.maximum(cand, np.float32(1e-9)))


def iteration_generator(seed: int, iter_id: int) -> torch.Generator:
    """The CPU generator of iteration ``iter_id``: a function of
    (seed, iter_id) only."""
    state = np.random.SeedSequence([seed, iter_id]).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def rows_to_device(rows, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in rows.items()}


def row_loss(model: GSTVisualDialog, rows, train: Optional[Training],
             denom=None):
    """The teacher-forced loss of a row batch on the model's device (the
    JAX ``loss_fn``, ``gstx/train/train_gen.py:75-85``); ``denom``: see
    :func:`gstx_torch.models.encdec.teacher_forced_loss`."""
    logits = model.score(
        rows["enc_input_ids"], rows["enc_image_feat"], rows["enc_image_loc"],
        rows["enc_segments"], rows["enc_att_mask"], rows["enc_image_mask"],
        rows["dec_input_ids"], rows["dec_att_mask"], train=train)
    return teacher_forced_loss(logits, rows["dec_labels"], denom=denom,
                               tp=model.vocab_tp)


def rank_rows(n: int, dp: Optional[DataParallel]):
    """The sampled rows of ``n`` that this rank computes: all of them
    without ``dp``, else its run of :meth:`DataParallel.row_indices`.  The
    rows must split evenly over the ranks (``mesh.local_batch_size``
    raises otherwise), since a padded row would count twice in the loss."""
    if dp is None:
        return slice(None)
    mesh.local_batch_size(n, dp.size)
    return dp.row_indices(n)[0]


def rank_seed(seed: int, dp: Optional[DataParallel]) -> int:
    """The dropout seed of this rank's rows: the step's seed plus the
    rank on the data axis, so that the replicas' masks differ and replica
    0's are the single process's (a function of (seed, iteration, data
    rank); a resume replays it).  ``dp`` is the data group, never the
    world: the ranks of one model group must draw the same masks."""
    return seed if dp is None else seed + dp.rank


def make_train_step(model: GSTVisualDialog, optimizer: AdamW,
                    batch_size: int, batch_multiply: int = 1,
                    remat: Optional[str] = None,
                    dp: Optional[DataParallel] = None):
    """``step(batch, gen) -> loss``: one update from a numpy batch.  Each of
    the ``batch_multiply`` micro-steps draws ``batch_size`` rows, then the
    seed of its dropout masks, from ``gen``; their gradients are summed and
    divided by ``batch_multiply`` (``gstx/train/train_gen.py:86-118``).
    The gradients stay on the parameters until the next step clears them.
    Returns the (mean) loss as a device scalar, unsynchronised.

    With ``dp`` the batch is this rank's stripe.  The step is the
    single-process step on the global batch, every rank's stripe in rank
    order (the JAX package's ``make_global_batch``): the stripes are
    all-gathered, every rank draws the same rows from ``gen`` over them and
    computes its share (:func:`rank_rows`), each share's NLL sum is
    divided by the non-pad label count of all the drawn rows, and the
    gradients are summed over the ranks.  Gathering the whole batch (not
    only the rows a rank needs) keeps every rank's share the same size,
    ``batch_size / ranks`` rows, as the sharded JAX step has it, for one
    all-gather of the host batch a step.  The returned loss is the global
    one (summed over the ranks)."""
    device = model.device
    mine = rank_rows(batch_size, dp)

    def step(batch, gen: torch.Generator):
        optimizer.zero_grad(set_to_none=True)
        if dp is not None:
            batch = dp.gather_batch(batch)
        weights = candidate_weights(batch["dec_labels"])
        losses = []
        for _ in range(max(1, batch_multiply)):
            idx = torch.multinomial(weights, batch_size, replacement=True,
                                    generator=gen).numpy()
            seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
            labels = select_rows(batch, idx, ("dec_labels",), ())
            count = max(1, int((labels["dec_labels"] != PAD_ID).sum()))
            rows = rows_to_device(select_rows(batch, idx[mine]), device)
            with profiling.span("gstx:train.forward"):
                loss = row_loss(model, rows, Training(rank_seed(seed, dp),
                                                      remat), denom=count)
            with profiling.span("gstx:train.backward"):
                loss.backward()
            losses.append(loss.detach())
        if dp is not None:
            dp.all_reduce_grads_(model.parameters())
        with profiling.span("gstx:train.optimizer"):
            if batch_multiply > 1:
                with torch.no_grad():
                    for p in model.parameters():
                        if p.grad is not None:
                            p.grad.div_(batch_multiply)
            optimizer.step()
        loss = torch.stack(losses).mean()
        return loss if dp is None else dp.sum(loss)

    return step


def init_model_and_state(config: GSTConfig, t_total: int, device,
                         use_decoder: bool = True,
                         warmup_steps: Optional[int] = None, tp=None):
    """The model from a seed (bf16 compute over f32 parameters under
    ``-dtype bfloat16``; encoder-only unless ``use_decoder``; the rank's
    shard of it under the model group ``tp``) and its optimizer (warmup
    ``warmup_steps``, by default ``-warmup_steps``), whose moments are
    shaped as the rank's parameters."""
    enc_cfg = config.encoder_config()
    dtype = torch.bfloat16 if config.dtype == "bfloat16" else None
    model = GSTVisualDialog(enc_cfg, config.decoder_config(), device=device,
                            seed=config.seed, use_decoder=use_decoder,
                            dtype=dtype, tp=tp)
    optimizer = AdamW(model.named_parameters(), config.lr, config.image_lr,
                      config.warmup_steps if warmup_steps is None
                      else warmup_steps, t_total, config.min_lr,
                      fixed_t_layer=enc_cfg.fixed_t_layer,
                      fixed_v_layer=enc_cfg.fixed_v_layer)
    return model, optimizer


def load_start_checkpoint(config: GSTConfig, model: GSTVisualDialog,
                          optimizer: AdamW):
    """Resume or warm start from ``-start_path`` (``gstx/train/
    train_gen.py:282-362``).  Returns ``(start_iter_id, start_exact)``.

    With ``-continue`` the weights load (strictly when the file has the
    decoder), and a checkpoint this trainer wrote (it has ``step``) whose
    path holds the mode also restores the optimizer and the step;
    ``start_exact`` is True for the rotating ``*_step.ckpt``, whose step
    counts completed iterations (nothing is replayed), unlike the epoch
    and final checkpoints, whose stored iteration runs again.  Without
    ``-continue`` only the encoder and its heads warm-start, and when the
    file has no decoder the LM projection is seeded from the loaded word
    table."""
    path = config.start_path
    raw = ckpt_lib.restore_checkpoint(path)
    sd = ckpt_lib.state_dict_of(raw)
    full = any(k.startswith("decoder.") for k in sd)
    if config.continue_training:
        model.load_state_dict(sd, strict=full)
        if "step" in raw and "optimizer_state_dict" in raw and \
                config.mode in path:
            optimizer.load_state_dict(ckpt_lib.shard_optimizer_state(
                raw["optimizer_state_dict"], model))
            return (int(raw["step"]), os.path.basename(
                path.rstrip("/")).endswith("_step.ckpt"))
        return 0, False
    ckpt_lib.load_encoder_part(model, sd, path, seed_lm_head=not full)
    return 0, False


def checkpoint_saver(save_path: str, model, optimizer,
                     stats_out: Optional[dict] = None):
    """``save(name, step)``: a training checkpoint of ``model`` and
    ``optimizer`` at ``save_path/name``; its path, size and save time go to
    ``stats_out["saves"]`` when ``stats_out`` is given."""

    def save(name, step):
        path = os.path.join(save_path, name)
        t0 = time.perf_counter()
        with profiling.span("gstx:train.save"):
            ckpt_lib.save_checkpoint(path, model, optimizer, step)
        if stats_out is not None:
            stats_out["saves"].append(dict(
                path=path, bytes=os.path.getsize(path),
                seconds=time.perf_counter() - t0))

    return save


def striped_loader(config: GSTConfig, dataset,
                   axes: Optional[Axes] = None) -> DataLoader:
    """The trainers' loader: shuffled, and in a multi-process run this
    replica's stripe of the shuffled order in batches of ``batch_size /
    replicas``, every replica the same number of batches an epoch
    (``gstx/train/train_gen.py:203-213``).  The replicas are the data axis
    of ``axes`` (the ranks when it is None): the ranks of one model group
    read the same stripe."""
    if axes is None:
        index, count = mesh.process_index(), mesh.process_count()
    else:
        index, count = axes.data_rank, axes.data_size
    return DataLoader(dataset,
                      batch_size=mesh.local_batch_size(config.batch_size,
                                                       count),
                      shuffle=True, num_workers=config.num_workers,
                      seed=config.seed, process_index=index,
                      process_count=count, even_stripes=True)


def grad_norms(model) -> Dict[str, float]:
    """Each parameter's gradient norm, by name.  Under tensor parallelism
    a sharded parameter's squares are summed over the model group, and a
    replicated one's norm is its own (it is the same on every rank), so
    each counts once (a collective of the model group)."""
    tp = getattr(model, "tp", None)
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        sq = p.grad.float().square().sum()
        if tp is not None and mesh.sharded_dim(
                name, model._full_shapes[name], tp.size) is not None:
            sq = tp.all_reduce(sq)
        out[name] = float(sq.sqrt())
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(config: GSTConfig, model, optimizer, step_fn, loader,
                 num_iter_epoch: int, start, log_name: str, log_fields,
                 epoch_ckpt: str, step_ckpt: str,
                 final_ckpt: Optional[str] = None,
                 max_steps: Optional[int] = None,
                 stats_out: Optional[dict] = None):
    """The loop both trainers run (``gstx/train/train_gen.py:139-279``,
    ``gstx/cli/train_disc.py:35-160``): one ``step_fn(batch, generator)
    -> {name: device scalar}`` an iteration, from ``start = (start_iter_id,
    start_exact)`` (:func:`load_start_checkpoint`); every ``-log_every``
    iterations a line of ``log_name`` under ``-save_path``, whose fields
    after the time and the ``metrics.jsonl`` record come from
    ``log_fields(losses as floats, lr) -> (text, record)``; the checkpoint
    ``epoch_ckpt.format(epoch=...)`` at each epoch boundary,
    ``step_ckpt`` under ``-save_every_steps`` and ``final_ckpt``, if
    given, at the end.

    ``stats_out``, a dict, receives per step of this run each loss
    (``losses``: a dict of lists) and the wall time to the end of the step
    on the device (``step_seconds``); the first step's gradient norm per
    parameter (``grad_norms``, by name); each checkpoint's path, size and
    save time (``saves``); and ``start_iter_id``.  Reading them
    synchronises every step.

    In a multi-process run every rank runs the loop (the checkpoints are
    collective: rank 0 writes them) and rank 0 alone writes the log.
    ``-trace_dir`` writes a trace of the loop and its spans
    (:func:`gstx_torch.core.profiling.trace`)."""
    device = model.device
    primary = mesh.process_index() == 0
    logger = metrics_writer = None
    if primary:
        logger = Logger(os.path.join(config.save_path, log_name))
        metrics_writer = MetricsWriter(
            os.path.join(config.save_path, "metrics.jsonl"))
    start_iter_id, start_exact = start
    if stats_out is not None:
        stats_out.update(losses={}, step_seconds=[], grad_norms={},
                         saves=[], start_iter_id=start_iter_id)
    save = checkpoint_saver(config.save_path, model, optimizer, stats_out)
    start_t = time.time()
    start_epoch, start_idx = divmod(start_iter_id, num_iter_epoch)
    iter_id = start_iter_id  # the final save works on a zero-batch run
    with profiling.trace(config.trace_dir):
        for epoch_id, idx, batch in batch_iter(loader, config.num_epochs,
                                               start_epoch, start_idx):
            iter_id = idx + epoch_id * num_iter_epoch
            t0 = time.perf_counter()
            profiling.count("train.steps")
            with profiling.span("gstx:train.step"):
                losses = step_fn(batch, iteration_generator(config.seed,
                                                            iter_id))
            if stats_out is not None:
                sync(device)
                stats_out["step_seconds"].append(time.perf_counter() - t0)
                for k, v in losses.items():
                    stats_out["losses"].setdefault(k, []).append(float(v))
                if not stats_out["grad_norms"]:
                    stats_out["grad_norms"] = grad_norms(model)
            if primary and iter_id % config.log_every == 0:
                lr, _ = optimizer.current_lrs()
                text, record = log_fields(
                    {k: float(v) for k, v in losses.items()}, lr)
                now = time.time()
                logger.write(
                    "[%s][LR: %.7f][Ep: %.2f][Iter: %d][Time: %5.2fs]%s" % (
                        time.strftime("%a %d %b %y %X", time.gmtime()), lr,
                        iter_id / num_iter_epoch, iter_id, now - start_t,
                        text))
                metrics_writer.log(iter_id, **record)
                start_t = now
            # an epoch checkpoint, except for the stored iteration an epoch
            # checkpoint's resume replays (reference train_gen.py:345); a
            # rotating checkpoint's resume replays nothing, so its first
            # iteration is fresh (start_exact)
            if iter_id % num_iter_epoch == 0 and (
                    start_exact or iter_id != start_iter_id):
                save(epoch_ckpt.format(epoch=epoch_id), iter_id)
                if primary:
                    logger.write(f"\n{epoch_id} epoch ended.")
            if config.save_every_steps > 0 and \
                    (iter_id + 1) % config.save_every_steps == 0:
                # step = completed iterations: a resume replays nothing
                save(step_ckpt, iter_id + 1)
            if max_steps is not None and \
                    iter_id - start_iter_id + 1 >= max_steps:
                break
    if final_ckpt is not None:
        save(final_ckpt, iter_id)
    if primary:
        logger.close()
        metrics_writer.close()


def train_gen(config: GSTConfig, dataset, num_iter_epoch: int,
              max_steps: Optional[int] = None, device="cuda",
              stats_out: Optional[dict] = None):
    """The generative training loop (``gstx/train/train_gen.py:139-279``,
    reference train_gen.py:139-358) through :func:`run_training`, whose
    ``stats_out`` it takes (the loss is ``loss``); returns (model,
    optimizer).  Under a process group every replica trains on its stripe
    of the data (:func:`make_train_step`), each over its model group
    under ``-model_parallel`` > 1."""
    os.makedirs(config.save_path, exist_ok=True)
    num_iter_epoch = max(1, num_iter_epoch)
    t_total = num_iter_epoch * 100  # train_gen.py:172 (reference :179)
    device = torch.device(device)
    mesh.validate_model_parallel(config.encoder_config(),
                                 config.decoder_config(),
                                 config.model_parallel)
    axes = mesh.make_layout(config.data_parallel, config.model_parallel,
                            device)
    model, optimizer = init_model_and_state(config, t_total, device,
                                            tp=axes.tp)
    start = (0, False)
    if config.start_path:
        start = load_start_checkpoint(config, model, optimizer)
    step_fn = make_train_step(model, optimizer, config.batch_size,
                              config.batch_multiply,
                              config.remat_policy if config.remat else None,
                              axes.dp)
    loader = striped_loader(config, dataset, axes)
    run_training(
        config, model, optimizer,
        lambda batch, gen: {"loss": step_fn(batch, gen)}, loader,
        num_iter_epoch, start, f"log_{config.mode}.txt",
        lambda v, lr: ("[LM Loss: %.4g]" % v["loss"],
                       dict(lm_loss=v["loss"], lr=lr)),
        epoch_ckpt=f"{config.mode}_{config.chunk}_{{epoch}}.ckpt",
        step_ckpt=f"{config.mode}_step.ckpt", final_ckpt="final.ckpt",
        max_steps=max_steps, stats_out=stats_out)
    return model, optimizer
