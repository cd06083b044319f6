"""Tracing: the port's counterparts of ``gstx/core/profiling.py``'s
``trace`` (line 19) and ``annotate`` (line 71), on ``torch.profiler``."""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Record a host and device trace of the block into ``trace_dir`` as a
    Chrome trace (``trace.json``, viewable in Perfetto or
    chrome://tracing); a no-op when ``trace_dir`` is empty.  The device is
    traced when a card is present.

        with trace("/tmp/gstx_trace"):
            run_batches()
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def annotate(name: str):
    """Named region of the trace (a no-op cost when no profiler runs)."""
    return torch.profiler.record_function(name)
