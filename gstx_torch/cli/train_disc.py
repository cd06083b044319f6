"""CLI: discriminative training, the port of ``gstx/cli/train_disc.py``
(reference ``train_disc.py``), with its flags:

    python -m gstx_torch.cli.train_disc -mode vd_train -model enc_only_a \\
        -start_path teacher.ckpt ... [-train_dense]

The encoder-only model, the three-loss objective (masked LM, masked
regions, soft NSP), warmup 10,000 steps; ``-train_dense`` finetunes on the
dense pseudo-labels.  ``-start_path`` warm-starts from an encoder-only or a
full (encoder-decoder) checkpoint, whose encoder part is taken (the
reference's special case, ``train_disc.py:203-210``); with ``-continue`` a
checkpoint of this trainer resumes its optimizer and step.

It runs on ``cuda`` unless ``main`` is given ``device="cpu"`` or the
environment sets ``GSTX_PLATFORM=cpu``; without a card it raises.
``-dtype bfloat16`` computes in bf16 over f32 parameters;
``-use_pallas`` sets the fused FFN / projection-LayerNorm kernels' switch
(they run where no dropout is active); ``-trace_dir`` writes a trace of the
loop and its spans (``trace.json``, ``spans.json``).  The checkpoints
(``vd_train_disc_{epoch}.ckpt`` at each epoch boundary, ``vd_train_disc_step.ckpt`` under ``-save_every_steps``) and the
log (``log_disc.txt``, ``metrics.jsonl``) go to ``-save_path``.  Data
parallel over the ranks of ``-distributed``, and tensor parallel under
``-model_parallel`` (the data x model layout), as
:mod:`gstx_torch.cli.train_gen`.
"""

from __future__ import annotations

import pprint

from gstx_torch.cli.common import (apply_runtime_flags, build_tokenizer,
                                   default_device, parse_config)
from gstx_torch.data.visdial import VisdialDiscDataset
from gstx_torch.train.train_disc import train_disc


def main(argv=None, max_steps=None, device=None, stats_out=None):
    """``max_steps``: stop after that many steps of this run.  ``device``:
    see :func:`gstx_torch.cli.common.default_device`.  ``stats_out``: see
    :func:`gstx_torch.train.train_disc.train_disc`.  Returns (model,
    optimizer)."""
    config = parse_config(argv, "gstx_torch discriminative training")
    dev = default_device(device)
    pprint.pprint(config)
    if config.mode != "vd_train":
        raise SystemExit(f"error: -mode {config.mode}: discriminative "
                         "training runs vd_train")
    if config.model != "enc_only_a":
        raise SystemExit(f"error: -model {config.model}: discriminative "
                         "training trains enc_only_a")
    apply_runtime_flags(config, dev, enc_only=True)
    dataset = VisdialDiscDataset(config, build_tokenizer(config),
                                 mode="vd_train")
    return train_disc(config, dataset, max_steps=max_steps, device=dev,
                      stats_out=stats_out)


if __name__ == "__main__":
    main()
