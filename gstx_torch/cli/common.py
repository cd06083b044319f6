"""Shared CLI plumbing (the port of ``gstx/cli/common.py``): flag parsing
with the reference's ``-flag`` surface, tokenizer, model and checkpoint
construction, and the runtime switches.

Multi-process runs (``-distributed`` under a launcher, a rank a card),
``-data_parallel`` and ``-model_parallel`` follow the JAX CLIs
(:mod:`gstx_torch.core.mesh`): ``world = dp x mp`` ranks, rank ``d * mp +
m`` holding shard ``m`` of replica ``d``; one process runs the whole model
whatever ``-model_parallel`` asks, as the JAX CLIs do on one device.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from gstx_torch.core import mesh
from gstx_torch.core.checkpoint import load_checkpoint
from gstx_torch.core.config import (GSTConfig, add_config_args,
                                    config_from_args)
from gstx_torch.core.device import resolve_device
# re-exported for the CLIs, as the JAX package does (gstx/cli/common.py:19)
from gstx_torch.core.mesh import pad_batch_rows  # noqa: F401
from gstx_torch.data.tokenizer import BertTokenizer
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models.encdec import GSTVisualDialog


def _check_choice(name, value, choices):
    if value not in choices:
        raise SystemExit(
            f"error: -{name} must be one of {list(choices)}, got {value!r}")


def default_device(device=None):
    """The device an entry point runs on: ``device`` when given, else
    ``cpu`` when ``GSTX_PLATFORM=cpu`` (the JAX CLIs' subprocess seam,
    ``gstx/cli/common.py:30-45``), else ``cuda``, which raises without a
    card.  A rank of a multi-process run takes ``cuda:(LOCAL_RANK %
    device_count)`` (:func:`gstx_torch.core.mesh.rank_device`)."""
    if device is None:
        device = "cpu" if os.environ.get("GSTX_PLATFORM") == "cpu" \
            else "cuda"
    dev = mesh.rank_device(resolve_device(device))
    if dev.type == "cuda":
        # the kernels launch on the current device's stream
        torch.cuda.set_device(dev)
    return dev


def parse_config(argv=None, description: str = "gstx_torch") -> GSTConfig:
    parser = argparse.ArgumentParser(description=description)
    add_config_args(parser)
    cfg = config_from_args(parser.parse_args(argv))
    # choice validation (the reference's argparse choices, options.py:54-56,85)
    _check_choice("vd_version", cfg.vd_version, ("1.0", "0.9"))
    _check_choice("mode", cfg.mode,
                  ("vd_train", "vd_eval_val", "vd_eval_test", "vd_gen_val",
                   "cc12m_gen", "cc12m_train"))
    _check_choice("model", cfg.model,
                  ("enc_only_a", "enc_dec_a", "enc_dec_q"))
    _check_choice("attack", cfg.attack,
                  ("fgsm", "random_token", "coreference"))
    _check_choice("dtype", cfg.dtype, ("bfloat16", "float32"))
    if cfg.save_path == "checkpoints/":
        # timestamped default save path (options.py:94-98)
        stamp = time.strftime("%d-%b-%y-%X-%a", time.gmtime())
        cfg = cfg.replace(save_path=os.path.join(cfg.save_path, stamp))
    if cfg.sequences_per_image > 8 or cfg.visdial_tot_rounds > 11:
        raise SystemExit("error: -sequences_per_image must be <= 8 and "
                         "-visdial_tot_rounds <= 11")
    return cfg


def apply_runtime_flags(config: GSTConfig, device=None,
                        enc_only: bool = False):
    """Join the process group under ``-distributed`` (the launcher's
    environment; a no-op in a plain process) for the rank on ``device``
    (default: :func:`default_device`'s), check that ``-model_parallel``
    divides every head count and intermediate size (JAX's
    ``validate_model_parallel``, its message, raised early) and set the
    fused FFN / projection-LayerNorm kernels' switch from ``-use_pallas``.
    The attention and decode kernels stay off, as the JAX CLIs leave
    them.  ``enc_only``: the encoder-only model (no decoder dimensions)."""
    mesh.validate_model_parallel(
        config.encoder_config(), None if enc_only else
        config.decoder_config(), config.model_parallel)
    if config.distributed:
        device = default_device(device)
        backend = mesh.init_distributed(device)
        if backend is not None:
            print(f"[gstx_torch] rank {mesh.process_index()} of "
                  f"{mesh.process_count()} on {device}, "
                  f"backend {backend}", flush=True)
    kffn.enable(config.use_pallas)


def primary_process_only(what: str = "evaluation") -> bool:
    """True when this process should run a single-process evaluation
    (``gstx/cli/common.py:113-125``): in a multi-process run whose
    evaluation does not span the ranks, the ranks other than 0 would
    duplicate the whole computation and race on the output files; they
    log and skip instead."""
    if mesh.process_count() > 1 and mesh.process_index() != 0:
        print(f"[gstx_torch] {what} runs on rank 0: rank "
              f"{mesh.process_index()} idle")
        return False
    return True


def build_tokenizer(config: GSTConfig) -> BertTokenizer:
    return BertTokenizer(vocab_path=config.vocab_path)


def build_model(config: GSTConfig, device="cuda", seed: int = 0,
                use_decoder: bool = True, tp=None) -> GSTVisualDialog:
    """The port's model from the encoder/decoder configs (or their JSONs),
    on ``device``, with seeded initial weights; ``use_decoder=False`` builds
    the encoder-only model of the discriminative evaluator; ``tp``: the
    model group whose rank's shard it keeps (a checkpoint then loads by
    slicing, :func:`load_params`)."""
    return GSTVisualDialog(config.encoder_config(), config.decoder_config(),
                           device=device, seed=seed,
                           use_decoder=use_decoder, tp=tp).eval()


def load_params(model: GSTVisualDialog, path: str) -> GSTVisualDialog:
    """Load a checkpoint file into ``model`` in place
    (:func:`gstx_torch.core.checkpoint.load_checkpoint`); returns it."""
    load_checkpoint(model, path)
    return model
