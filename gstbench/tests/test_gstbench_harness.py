"""The harness: cells, mixes, configurations and metric readers found by
name, ``BENCHMARK.json`` against the contract's shape, the result line,
the whole-batch window, the yardstick's arithmetic, and no fallback to
the CPU.

    python -m pytest gstbench/tests -q
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from gstbench import harness, peaks
from gstbench.tests import tiny

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.mix["driver"] in ("gen", "rank")
    assert c.config["encoder"]["hidden_size"] == 768
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    out = tiny.run(cell, seconds=4.0)
    assert out.pop("window")["seconds"] > 0
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0
    want = {m["name"] for m in harness.load_cell(cell).end_to_end}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


@pytest.mark.parametrize("cell", ["gen.gst_enc_dec.cc12m",
                                  "rank.vilbert_disc.val"])
def test_traced_result_line(cell):
    out = tiny.run(cell, seconds=4.0, traced=True)
    out.pop("window")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["metrics"]) <= {m["name"] for m in
                                   harness.load_cell(cell).per_layer}
    assert out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_no_whole_batch_fails(cell):
    out = tiny.run(cell, seconds=1e-4)
    assert out["attempted"] == 0 and out["correct"] is False


def test_whole_batches_only():
    c = tiny.cell("rank.vilbert_disc.val")
    out = tiny.run("rank.vilbert_disc.val", seconds=3.0)
    per_batch = c.mix["batch"] * c.mix["rounds"] * c.mix["options"]
    assert out["attempted"] % per_batch == 0
    c = tiny.cell("gen.gst_enc_dec.cc12m")
    out = tiny.run("gen.gst_enc_dec.cc12m", seconds=3.0)
    assert out["attempted"] % c.mix["flags"]["-batch_size"] == 0


def test_roofline_arithmetic_matches_the_kernel_table():
    """The bounds of the port's kernel table: 0.2345 ms for fused_ffn at
    24,576 x 768 x 3,072 (operations) and 0.0342 ms for fused_dense_ln at
    24,576 x 768 -> 768 (bytes)."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")
    m, d, f = 24576, 768, 3072
    ffn = peaks.least_seconds(
        peaks.ffn_flops(m, d, f),
        peaks.ffn_bytes(t(m, d), t(f, d), t(f, dtype=torch.float32),
                        t(d, f), t(d, dtype=torch.float32),
                        t(d, dtype=torch.float32),
                        t(d, dtype=torch.float32)))
    assert round(ffn * 1e3, 4) == 0.2345
    dln = peaks.least_seconds(
        peaks.dense_ln_flops(m, d, d),
        peaks.dense_ln_bytes(t(m, d), t(d, d), t(d, dtype=torch.float32),
                             t(m, d), t(d, dtype=torch.float32),
                             t(d, dtype=torch.float32)))
    assert round(dln * 1e3, 4) == 0.0342
    assert peaks.dense_ln_bytes(t(m, d), t(d, d), t(d), t(m, d), t(d),
                                t(d)) / peaks.PEAK_BYTES > \
        peaks.dense_ln_flops(m, d, d) / peaks.PEAK_BF16_FLOPS


def test_encoder_flops_from_shapes():
    enc = harness.load_cell("rank.vilbert_disc.val").config["encoder"]
    # one row at context 256 and 37 regions: ~76 GFLOP
    assert 74e9 < peaks.encoder_flops(enc, 256, 37) < 78e9


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(harness.NoCard):
        harness.device_for(1)
    res = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         CELLS[0], "--seed", "2147483901", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """Each cell as the benchmark's command runs it, with a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         cell, "--seed", "2147483901", "--seconds", "20", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
