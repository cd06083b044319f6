"""Text log (the port's copy of ``gstx/core/logging.py:29-50``, reference
``utils/logger.py:4-35`` semantics): each line goes to stdout and to the
file, flushed at once.  The port runs one process, so the file is ``path``
itself (the JAX package appends ``.procN`` for the other processes of a
multi-host run, ROADMAP queue 1 item 9)."""

from __future__ import annotations

import os
import sys


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
