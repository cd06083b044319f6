"""CLI: generative training (teacher / questioner / student), the port of
``gstx/cli/train_gen.py`` (reference ``train_gen.py``), with its flags:

    python -m gstx_torch.cli.train_gen -mode vd_train -model enc_dec_a ...
    python -m gstx_torch.cli.train_gen -mode cc12m_train -chunk 30 -iter 1 \\
        -select_data ...

It runs on ``cuda`` unless ``main`` is given ``device="cpu"`` or the
environment sets ``GSTX_PLATFORM=cpu``; without a card it raises.
``-dtype bfloat16`` computes in bf16 over f32 parameters and optimizer
state; ``-use_pallas`` sets the fused FFN / projection-LayerNorm kernels'
switch (they run where no dropout is active); ``-trace_dir`` writes a
trace of the loop and its spans (``trace.json``, ``spans.json``).  The
checkpoints (``{mode}_{chunk}_{epoch}.ckpt``, ``{mode}_step.ckpt`` under ``-save_every_steps``, ``final.ckpt``) and the
log (``log_{mode}.txt``, ``metrics.jsonl``) go to ``-save_path``.

Data parallel over N ranks, a card each (rank 0 writes the log and the
checkpoints; ``-data_parallel`` is -1 or N; ``-batch_size`` is global):

    python -m torch.distributed.run --nproc_per_node N \
        -m gstx_torch.cli.train_gen ... -distributed

Tensor parallel (``-model_parallel M``; N = data_parallel x M ranks, rank
``d * M + m`` holding shard ``m`` of replica ``d``): the batch splits over
the replicas and each model group computes its rows together; the
checkpoints hold full tensors, which load at any degree and in one
process.  On the CPU:

    GSTX_PLATFORM=cpu python -m torch.distributed.run --nproc_per_node 2 \
        -m gstx_torch.cli.train_gen ... -distributed -model_parallel 2
"""

from __future__ import annotations

import pprint

from gstx_torch.cli.common import (apply_runtime_flags, build_tokenizer,
                                   default_device, parse_config)
from gstx_torch.train.train_gen import train_gen


def main(argv=None, max_steps=None, device=None, stats_out=None):
    """``max_steps``: stop after that many steps of this run.  ``device``:
    see :func:`gstx_torch.cli.common.default_device`.  ``stats_out``: see
    :func:`gstx_torch.train.train_gen.train_gen`.  Returns (model,
    optimizer)."""
    config = parse_config(argv, "gstx_torch generative training")
    dev = default_device(device)
    pprint.pprint(config)
    if config.mode not in ("vd_train", "cc12m_train"):
        raise SystemExit(f"error: -mode {config.mode}: generative training "
                         "runs vd_train or cc12m_train")
    if config.model not in ("enc_dec_a", "enc_dec_q"):
        raise SystemExit(f"error: -model {config.model}: generative "
                         "training trains enc_dec_a or enc_dec_q")
    apply_runtime_flags(config, dev)

    tokenizer = build_tokenizer(config)
    if config.mode == "vd_train":
        from gstx_torch.data.visdial import VisdialGenDataset

        dataset = VisdialGenDataset(config, tokenizer, mode="vd_train")
    else:
        from gstx_torch.data.cc12m import load_cc12m_chunks

        dataset = load_cc12m_chunks(config, tokenizer)
    num_iter_epoch = max(1, len(dataset) // config.batch_size)
    return train_gen(config, dataset, num_iter_epoch, max_steps=max_steps,
                     device=dev, stats_out=stats_out)


if __name__ == "__main__":
    main()
