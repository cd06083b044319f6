"""The benchmark's cells at a size the CPU holds: the configurations'
widths and depths cut (vocabulary and region features kept, so the
synthetic data is the real one), the mixes' batches, rounds and options
cut, float32 compute."""

from __future__ import annotations

import copy

from gstbench import harness

ENCODER = dict(
    hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
    intermediate_size=64, v_hidden_size=24, v_num_hidden_layers=2,
    v_num_attention_heads=4, v_intermediate_size=24, bi_hidden_size=24,
    bi_num_attention_heads=4, bi_intermediate_size=24,
    v_biattention_id=[0, 1], t_biattention_id=[2, 3])
DECODER = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64)
GEN_MIX = {"images": 8, "check": {"dialogs": 3}, "trace_batches": 2}
GEN_FLAGS = {"-batch_size": 4, "-num_dialog_rounds": 3, "-max_dec_len": 6,
             "-context_buckets": "", "-dtype": "float32", "-max_seq_len": 96,
             "-num_workers": 1}
RANK_MIX = {"dialogs": 4, "batch": 2, "rounds": 3, "options": 10,
            "pool": 50, "chunk": {"enc_only": 10, "enc_dec": 15},
            "check": {"rounds": 3}, "trace_batches": 2}
RANK_FLAGS = {"-num_options": 10, "-max_seq_len": 96, "-dtype": "float32",
              "-num_workers": 1}


def cell(name: str) -> harness.Cell:
    c = copy.deepcopy(harness.load_cell(name))
    c.config["encoder"].update(ENCODER)
    if "decoder" in c.config:
        c.config["decoder"].update(DECODER)
    gen = c.mix["driver"] == "gen"
    c.mix.update(copy.deepcopy(GEN_MIX if gen else RANK_MIX))
    c.mix["flags"].update(GEN_FLAGS if gen else RANK_FLAGS)
    return c


def run(name: str, seed: int = 3, seconds: float = 60.0, traced=False,
        **kw) -> dict:
    import time

    import torch

    # tiny products on a shared CPU: a pool of threads costs more than it
    # gives
    torch.set_num_threads(1)
    return harness.run(cell(name), seed, seconds, traced,
                       time.perf_counter(), device="cpu", **kw)
