"""Shared CLI plumbing (the port of ``gstx/cli/common.py``): flag parsing
with the reference's ``-flag`` surface, tokenizer, model and checkpoint
construction, and the runtime switches.

One card: ``-data_parallel`` -1 or 1 runs; more devices, tensor
parallelism and multi-host runs wait for ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from gstx_torch.core.checkpoint import load_checkpoint
from gstx_torch.core.config import (GSTConfig, add_config_args,
                                    config_from_args)
from gstx_torch.core.device import resolve_device
from gstx_torch.data.tokenizer import BertTokenizer
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models.encdec import GSTVisualDialog

MULTI_DEVICE = ("runs on one device; multi-GPU and multi-host runs are "
                "ROADMAP queue 1 item 9")


def _check_choice(name, value, choices):
    if value not in choices:
        raise SystemExit(
            f"error: -{name} must be one of {list(choices)}, got {value!r}")


def default_device(device=None):
    """The device an entry point runs on: ``device`` when given, else
    ``cpu`` when ``GSTX_PLATFORM=cpu`` (the JAX CLIs' subprocess seam,
    ``gstx/cli/common.py:30-45``), else ``cuda``, which raises without a
    card."""
    if device is None:
        device = "cpu" if os.environ.get("GSTX_PLATFORM") == "cpu" \
            else "cuda"
    return resolve_device(device)


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


def apply_runtime_flags(config: GSTConfig):
    """Refuse what one card cannot run, and set the fused FFN /
    projection-LayerNorm kernels' switch from ``-use_pallas``.  The
    attention and decode kernels stay off, as the JAX CLIs leave them."""
    if config.distributed:
        raise SystemExit(f"error: -distributed: the port {MULTI_DEVICE}")
    if config.data_parallel not in (-1, 1):
        raise SystemExit(f"error: -data_parallel {config.data_parallel}: "
                         f"the port {MULTI_DEVICE}")
    if config.model_parallel > 1:
        raise SystemExit(f"error: -model_parallel {config.model_parallel}: "
                         f"the port {MULTI_DEVICE}")
    kffn.enable(config.use_pallas)


def build_tokenizer(config: GSTConfig) -> BertTokenizer:
    return BertTokenizer(vocab_path=config.vocab_path)


def build_model(config: GSTConfig, device="cuda", seed: int = 0,
                use_decoder: bool = True) -> GSTVisualDialog:
    """The port's model from the encoder/decoder configs (or their JSONs),
    on ``device``, with seeded initial weights; ``use_decoder=False`` builds
    the encoder-only model of the discriminative evaluator."""
    return GSTVisualDialog(config.encoder_config(), config.decoder_config(),
                           device=device, seed=seed,
                           use_decoder=use_decoder).eval()


def load_params(model: GSTVisualDialog, path: str) -> GSTVisualDialog:
    """Load a checkpoint file into ``model`` in place
    (:func:`gstx_torch.core.checkpoint.load_checkpoint`); returns it."""
    load_checkpoint(model, path)
    return model


def pad_batch_rows(batch, multiple: int):
    """Pad a numpy batch dict's leading axis up to a multiple (the port's
    copy of ``gstx/core/mesh.py:329``).  Padded rows repeat row 0 and are
    dropped by the caller through the returned valid count."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    batch = {k: np.concatenate([np.asarray(v),
                                np.repeat(np.asarray(v)[:1], pad, axis=0)])
             for k, v in batch.items()}
    return batch, n
