"""``correct`` comes out false under the control and under each fault a
cell can have, at a size the CPU holds.

The control: the reference in float8 put in the program's place.  The
faults, planted in the timed path: a sampled token altered where it is
produced (generation); an answer (a score) altered where it is produced,
and half of a chunk left out with the mean of the rest in its place
(ranking).  At this size the program computes in float32, so its sound
readings are float32 rounding (under 1e-5) and the limits here are set
for that; the cells' own limits, set from chip readings at full size, are
in the traffic files.
"""

import pytest

from gstbench import harness
from gstbench.tests import tiny

LIMITS = {"topk_gap": 1e-3, "ppl_gap": 1e-4, "nsp_gap": 1e-4,
          "ll_gap": 1e-3}


def _run(name, **kw):
    import time

    import torch

    torch.set_num_threads(1)
    c = tiny.cell(name)
    c.mix["limits"] = dict(LIMITS)
    return harness.run(c, 5, 3.0, False, time.perf_counter(),
                       device="cpu", **kw)


@pytest.mark.parametrize("name", ["gen.gst_enc_dec.cc12m",
                                  "rank.vilbert_disc.val",
                                  "rank.gst_enc_dec.val"])
def test_sound_run_passes_tight_limits(name):
    out = _run(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name,kw", [
    ("gen.gst_enc_dec.cc12m", {"control": "fp8"}),
    ("gen.gst_enc_dec.cc12m", {"fault": "token"}),
    ("rank.vilbert_disc.val", {"control": "fp8"}),
    ("rank.vilbert_disc.val", {"fault": "answer"}),
    ("rank.vilbert_disc.val", {"fault": "half"}),
    ("rank.gst_enc_dec.val", {"control": "fp8"}),
    ("rank.gst_enc_dec.val", {"fault": "answer"}),
    ("rank.gst_enc_dec.val", {"fault": "half"}),
])
def test_control_and_faults_fail(name, kw):
    out = _run(name, **kw)
    assert out["attempted"] > 0
    assert out["correct"] is False, out["checks"]
