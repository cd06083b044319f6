"""CLI: the adversarial robustness evaluation, the port of
``gstx/cli/evaluate_gen_attack.py`` (reference ``evaluate_gen_attack.py``):

    python -m gstx_torch.cli.evaluate_gen_attack -mode vd_eval_val \\
        -attack fgsm|random_token|coreference -start_path model.ckpt \\
        -save_path out/ [-mlm_path pytorch_model.bin] ...

The generative ranking evaluation of ``gstx_torch.cli.evaluate_gen`` under
an attack (:mod:`gstx_torch.eval.attack_eval`): FGSM (epsilon 1.0) on the
region features of the dense-annotated round; coreference synonym
substitution there, with the counter-fitted similarity files when present
and the dependency JSON ``-visdial_processed_val_coref_dependency``;
random_token refill of the masked history by the independent masked LM of
``-mlm_path`` (a Hugging Face BERT state dict), or by the dialog model's own
MLM head when the flag is empty.  Batches of one dialog (v1.0; v0.9's 25
are refused by the loop, as the reference asserts).  Metrics go to
``performance_log.txt`` (or ``-save_name``).

Devices, ranks, the bf16 precast, ``-use_pallas`` and ``-trace_dir`` (a
trace of the evaluation loop and its spans) as in
:mod:`gstx_torch.cli.evaluate_gen`; the attacker is cast with the victim.
"""

from __future__ import annotations

import json
import os
import pickle
import pprint

import numpy as np

from gstx_torch.cli.common import (apply_runtime_flags, build_model,
                                   build_tokenizer, default_device,
                                   load_params, parse_config,
                                   primary_process_only)
from gstx_torch.core import mesh, profiling
from gstx_torch.core.logging import Logger
from gstx_torch.data.loader import DataLoader
from gstx_torch.data.visdial import VisdialGenDataset
from gstx_torch.eval.attack_eval import evaluate_attack
from gstx_torch.eval.attacks import TextAttack, make_mlm_fill
from gstx_torch.models.encdec import precast_


def _text_attack(config, tokenizer, model, dev):
    """The TextAttack of the random_token and coreference attacks."""
    cos_sim = idx2word = word2idx = None
    if os.path.exists(config.cos_sim_counter_fitting):
        cos_sim = np.load(config.cos_sim_counter_fitting)
        with open(config.cos_sim_idx2word, "rb") as f:
            idx2word = pickle.load(f)
        with open(config.cos_sim_word2idx, "rb") as f:
            word2idx = pickle.load(f)
    if config.mlm_path:
        # the independent attacker (reference text_attack.py:19-27)
        from gstx_torch.models.mlm import (load_mlm_attacker,
                                           make_standalone_mlm_fill)

        attacker = load_mlm_attacker(config.mlm_path, device=dev)
        if config.dtype == "bfloat16":
            precast_(attacker)
        mlm_fill = make_standalone_mlm_fill(attacker)
    else:
        mlm_fill = make_mlm_fill(model)
    return TextAttack(tokenizer, cos_sim, idx2word, word2idx,
                      mlm_fill=mlm_fill, max_seq_len=config.max_seq_len)


def main(argv=None, max_batches=None, device=None, stats_out=None):
    """``max_batches``: stop after that many eval batches.  ``device``: see
    :func:`gstx_torch.cli.common.default_device`.  ``stats_out``: see
    :func:`gstx_torch.eval.attack_eval.evaluate_attack`.  Returns the
    metrics (in a multi-process run, on rank 0; None on the others)."""
    config = parse_config(argv, "gstx_torch attack evaluation")
    if config.mode != "vd_eval_val":
        raise SystemExit(f"error: -mode {config.mode}: the attack "
                         "evaluation runs vd_eval_val")
    if not config.start_path:
        raise SystemExit("error: -start_path is required")
    dev = default_device(device)
    pprint.pprint(config)
    apply_runtime_flags(config, dev)
    dp, tp = axes = mesh.make_layout(config.data_parallel,
                                     config.model_parallel, dev,
                                     every_rank=False)
    if not axes.spans and not primary_process_only():
        return None
    primary = mesh.process_index() == 0
    os.makedirs(config.save_path, exist_ok=True)

    tokenizer = build_tokenizer(config)
    dataset = VisdialGenDataset(config, tokenizer, mode="vd_eval_val")
    # the dataset masks history tokens with mask_prob under this attack
    dataset.attack_mode = config.attack == "random_token"
    model = load_params(build_model(config, device=dev, tp=tp),
                        config.start_path)
    if config.dtype == "bfloat16":
        precast_(model)
    text_attack = coref_dependency = None
    if config.attack in ("random_token", "coreference"):
        text_attack = _text_attack(config, tokenizer, model, dev)
    if config.attack == "coreference":
        with open(config.visdial_processed_val_coref_dependency) as f:
            coref_dependency = json.load(f)

    # batch 1 for v1.0 (evaluate_gen_attack.py:378)
    loader = DataLoader(dataset, shuffle=False, drop_last=False,
                        batch_size=1 if config.vd_version == "1.0" else 25,
                        num_workers=config.num_workers)

    def batches():
        for i, b in enumerate(loader.epoch(0)):
            if max_batches is not None and i >= max_batches:
                return
            yield b

    logger = Logger(os.path.join(
        config.save_path, config.save_name or "performance_log.txt")) \
        if primary else None
    try:
        with profiling.trace(config.trace_dir):
            return evaluate_attack(
                model, batches(), config, coref_dependency=coref_dependency,
                text_attack=text_attack, chunk_size=config.num_options,
                logger=logger, stats_out=stats_out, dp=dp)
    finally:
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
