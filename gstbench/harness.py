"""One run of one cell: set-up, the measured window, the reference check,
and the result line.

Everything cell-specific is found by name: ``BENCHMARK.json``'s entry
names the configuration file and the traffic mix; the mix
(``traffic/<name>.json``) names the driver (``drivers/<driver>.py``) that
reads it; each per-layer metric is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gstx")


class NoCard(RuntimeError):
    pass


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def find(entries: List[dict], name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names loaded."""
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, cell: str, bench: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if metric in bench["per_layer"]:
        moved = find(bench["end_to_end"], metric["moves"])
        return reports(moved, cell, bench)
    return True


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w = find(bench["workloads"], name)
    cfg = find(bench["configs"], w["config"])
    return Cell(
        name=name, chips=w["chips"],
        config=load_json(os.path.join(ROOT, cfg["file"])),
        mix=load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"]
                    if reports(m, name, bench)],
        per_layer=[m for m in bench["per_layer"]
                   if reports(m, name, bench)])


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "gstbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """The top-level names (whole, before the first dot) of loaded modules
    that the benchmark's process must not hold."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_for(chips: int, device=None):
    """The card the run uses; raises ``NoCard`` when there is none or too
    few.  ``device`` (tests only) names another device explicitly."""
    import torch

    if device is not None:
        return torch.device(device)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        raise NoCard(f"needs {chips} CUDA device(s); found {found}")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads."""
    cell: Cell
    window: dict          # the driver's window: seconds, units, counters
    summary: dict         # the trace's summary (trace.summarize)
    kernels: object       # trace.KernelCalls of the traced window


def run(cell: Cell, seed: int, seconds: float, traced: bool, t0: float,
        device=None, fault: Optional[str] = None,
        control: Optional[str] = None) -> dict:
    """One run; returns the result object.  ``fault`` and ``control`` are
    for the tests and the study of the limits, never for a measured run:
    ``fault`` breaks the timed path, ``control`` runs the control instead
    of the program (see the drivers)."""
    import torch

    from gstbench import trace

    dev = device_for(cell.chips, device)
    driver = importlib.import_module("gstbench.drivers." + cell.mix["driver"])
    tmp_root = os.environ.get("TMPDIR") or tempfile.gettempdir()
    with tempfile.TemporaryDirectory(dir=tmp_root,
                                     prefix="gstbench-") as tmp:
        d = driver.Run(cell.config, cell.mix, seed, dev, tmp, fault=fault,
                       control=control)
        d.setup()
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t0
        tracer = trace.Tracer(dev) if traced else None
        win = d.window(seconds, tracer)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        d.release()
        if cuda:
            torch.cuda.empty_cache()
        checks = d.check()
    bad = forbidden_modules()
    if bad:
        raise RuntimeError("the benchmark's process holds "
                           + ", ".join(bad))
    ok = win["units"] > 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics: Dict[str, dict] = {}
    if traced:
        r = Reading(cell, win, tracer.summary, tracer.kernels)
        for m in cell.per_layer:
            v = reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else \
                win["rates"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(ok), "attempted": win["units"] + win["failed"],
           "failed": win["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else dev.type,
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if traced:
        out["device"]["busy_s"] = tracer.summary["busy_s"]
        out["device"]["window_s"] = tracer.summary["window_s"]
        out["breakdown"] = trace.breakdown(tracer.summary)
    out["checks"] = checks
    out["window"] = {k: win[k] for k in ("seconds", "counters")}
    return out
