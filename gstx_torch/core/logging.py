"""Logs (the port's copy of ``gstx/core/logging.py``, reference
``utils/logger.py:4-35`` semantics): :class:`Logger`, a text log whose lines
go to stdout and to the file, flushed at once, and :class:`MetricsWriter`,
an append-only JSONL stream of metrics.  A rank other than 0 of a
multi-process run writes ``path.procN`` (:func:`process_log_path`), so
that the ranks never interleave appends into one file."""

from __future__ import annotations

import json
import os
import sys
import time

from gstx_torch.core.mesh import process_index


def process_log_path(path: str) -> str:
    """Per-process log path (``gstx/core/logging.py:12-28``): rank 0 keeps
    the configured name; rank N > 0 appends ``.procN`` before the
    extension.  Identity without a process group."""
    idx = process_index()
    if idx == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.proc{idx}{ext}"


class Logger:
    """write() goes to both stdout and the log file, flushed immediately;
    a rank other than 0 writes ``path.procN``."""

    def __init__(self, path: str):
        path = process_log_path(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def write(self, msg: str) -> None:
        print(msg)
        sys.stdout.flush()
        self._f.write(str(msg) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class MetricsWriter:
    """One JSON line per :meth:`log`: the step, the wall time and the
    values (``gstx/core/logging.py:52-69``); a rank other than 0 writes
    ``path.procN``."""

    def __init__(self, path: str):
        path = process_log_path(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, step: int, **values) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
