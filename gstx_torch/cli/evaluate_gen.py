"""CLI: generative ranking evaluation, the port of
``gstx/cli/evaluate_gen.py`` (reference ``evaluate_gen.py``).

Ranks the candidate answers of every round by teacher-forced
log-likelihood and reports R@1/5/10, mean rank, MRR and (VisDial v1.0)
NDCG into ``performance_log.txt`` (``-mode vd_eval_val``), or writes the
EvalAI ranks file ``predictions.txt`` (``-mode vd_eval_test``):

    python -m gstx_torch.cli.evaluate_gen -mode vd_eval_val \\
        -start_path model.ckpt -save_path out/ ...

It runs on ``cuda`` unless ``main`` is given ``device="cpu"`` or the
environment sets ``GSTX_PLATFORM=cpu``; without a card it raises.  The
model is built, loaded and (``-dtype bfloat16``) cast to bf16 once; the
fused FFN / projection-LayerNorm kernels follow ``-use_pallas``.  Under
``-distributed`` across N ranks (``python -m torch.distributed.run
--nproc_per_node N -m gstx_torch.cli.evaluate_gen ... -distributed``) the
chunks' rows split over the first ``-data_parallel`` ranks (-1: all;
:func:`gstx_torch.core.mesh.make_layout`) and rank 0 writes the
log and the predictions; with ``-data_parallel 1`` rank 0 evaluates alone.
With ``-model_parallel M`` the ranks form ``-data_parallel`` replicas of
M shards (``dp x M`` ranks): the rows split over the replicas and each
model group computes its rows together.
"""

from __future__ import annotations

import json
import os
import pprint

from gstx_torch.cli.common import (apply_runtime_flags, build_model,
                                   build_tokenizer, default_device,
                                   load_params, parse_config,
                                   primary_process_only)
from gstx_torch.core import mesh
from gstx_torch.core.logging import Logger
from gstx_torch.data.loader import DataLoader
from gstx_torch.data.visdial import VisdialGenDataset
from gstx_torch.eval.rank_gen import evaluate_gen
from gstx_torch.models.encdec import precast_


def parse_eval_config(argv, description):
    """The evaluators' flags and the checks both make before any work."""
    config = parse_config(argv, description)
    if config.mode not in ("vd_eval_val", "vd_eval_test"):
        raise SystemExit(f"error: -mode {config.mode}: evaluation runs "
                         "vd_eval_val or vd_eval_test")
    if not config.start_path:
        raise SystemExit("error: -start_path is required")
    return config


def run_evaluation(config, dev, dataset_cls, evaluator, use_decoder,
                   max_batches, chunk_size, stats_out):
    """Build the dataset and the model, run ``evaluator`` over the eval
    batches (20 images for v1.0, 25 for v0.9: ``evaluate_gen.py:151``) and
    write the log, and in test mode ``predictions.txt``.  Returns the
    evaluator's result; in a multi-process run, on rank 0 only (None on
    the others)."""
    apply_runtime_flags(config, dev, enc_only=not use_decoder)
    dp, tp = axes = mesh.make_layout(config.data_parallel,
                                     config.model_parallel, dev,
                                     every_rank=False)
    if not axes.spans and not primary_process_only():
        return None
    primary = mesh.process_index() == 0
    os.makedirs(config.save_path, exist_ok=True)
    eval_batch_size = 20 if config.vd_version == "1.0" else 25

    dataset = dataset_cls(config, build_tokenizer(config), mode=config.mode)
    model = load_params(build_model(config, device=dev,
                                    use_decoder=use_decoder, tp=tp),
                        config.start_path)
    if config.dtype == "bfloat16":
        precast_(model)
    loader = DataLoader(dataset, batch_size=eval_batch_size, shuffle=False,
                        drop_last=False, num_workers=config.num_workers)

    def batches():
        for i, b in enumerate(loader.epoch(0)):
            if max_batches is not None and i >= max_batches:
                return
            yield b

    logger = Logger(os.path.join(
        config.save_path, config.save_name or "performance_log.txt")) \
        if primary else None
    try:
        result = evaluator(model, batches(), mode=config.mode,
                           vd_version=config.vd_version,
                           chunk_size=chunk_size, logger=logger,
                           stats_out=stats_out, dp=dp)
    finally:
        if logger is not None:
            logger.close()
    if primary and config.mode == "vd_eval_test":
        # the reference crashes here on an undefined name
        # (evaluate_gen.py:191 'parsed'); fixed, not replicated
        with open(os.path.join(config.save_path, "predictions.txt"),
                  "w") as f:
            json.dump(result, f)
    return result


def main(argv=None, max_batches=None, chunk_size=500, device=None,
         stats_out=None):
    """``device``: see :func:`gstx_torch.cli.common.default_device`.
    ``stats_out``, a dict, receives the batch loop's counts and wall time
    (:func:`gstx_torch.eval.rank_gen.rank_candidates`)."""
    config = parse_eval_config(argv, "gstx_torch generative evaluation")
    dev = default_device(device)
    pprint.pprint(config)
    return run_evaluation(config, dev, VisdialGenDataset, evaluate_gen,
                          True, max_batches, chunk_size, stats_out)


if __name__ == "__main__":
    main()
