"""CLI: discriminative ranking evaluation, the port of
``gstx/cli/evaluate_disc.py`` (reference ``evaluate_disc.py``).

A candidate's score is the NSP softmax probability of the is-next class
of the encoder-only model (``-model enc_only_a``, loaded from an
encoder-only checkpoint):

    python -m gstx_torch.cli.evaluate_disc -model enc_only_a \\
        -mode vd_eval_val -start_path disc.ckpt -save_path out/ ...

Flags, outputs, devices, kernels and ``-trace_dir`` (a trace of the
evaluation loop and its spans) as :mod:`gstx_torch.cli.evaluate_gen`.
"""

from __future__ import annotations

import pprint

from gstx_torch.cli.common import default_device
from gstx_torch.cli.evaluate_gen import parse_eval_config, run_evaluation
from gstx_torch.data.visdial import VisdialDiscDataset
from gstx_torch.eval.rank_disc import evaluate_disc


def main(argv=None, max_batches=None, chunk_size=200, device=None,
         stats_out=None):
    """As :func:`gstx_torch.cli.evaluate_gen.main`, with the reference's
    chunk of 200."""
    config = parse_eval_config(argv, "gstx_torch discriminative evaluation")
    if config.model != "enc_only_a":
        raise SystemExit(f"error: -model {config.model}: the "
                         "discriminative evaluator runs enc_only_a")
    dev = default_device(device)
    pprint.pprint(config)
    return run_evaluation(config, dev, VisdialDiscDataset, evaluate_disc,
                          False, max_batches, chunk_size, stats_out)


if __name__ == "__main__":
    main()
