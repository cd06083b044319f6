"""Logs (the port's copy of ``gstx/core/logging.py``, reference
``utils/logger.py:4-35`` semantics): :class:`Logger`, a text log whose lines
go to stdout and to the file, flushed at once, and :class:`MetricsWriter`,
an append-only JSONL stream of metrics.  The port runs one process, so
each file is its ``path`` itself (the JAX package appends ``.procN`` for
the other processes of a multi-host run, ROADMAP queue 1 item 9)."""

from __future__ import annotations

import json
import os
import sys
import time


class Logger:
    """write() goes to both stdout and the log file, flushed immediately."""

    def __init__(self, path: str):
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
    values (``gstx/core/logging.py:52-69``)."""

    def __init__(self, path: str):
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
