"""Build the port's native host library (g++ only, no external deps).

The sources are the port's copies of ``gstx/native/*.cc``.  The library goes
to ``_build/<hash>/libgstx_native.so``, keyed on a hash of the sources, the
flags and the compiler, so an edit rebuilds and later calls reuse the
build.  No ``-march=native``: a checkout may be copied to another machine
with its ``_build`` directory, and a library tuned to one CPU could fault
on another.  The build writes a temporary file and renames it into place,
so processes that build at once never load half a file.

    python -m gstx_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
SO_NAME = "libgstx_native.so"
SOURCES = ("feature_store.cc", "wordpiece.cc")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _digest(gxx: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(gxx.encode())
    return h.hexdigest()[:16]


def so_path():
    """Path of the library for the current sources, or None without g++."""
    gxx = shutil.which("g++")
    return None if gxx is None else BUILD_DIR / _digest(gxx) / SO_NAME


def build(verbose: bool = False):
    """Build the library unless it exists; its path, or None when g++ is
    missing or fails."""
    out = so_path()
    if out is None:
        return None
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_so = Path(tmp) / SO_NAME
        cmd = [shutil.which("g++"), *FLAGS, "-o", str(tmp_so),
               *(str(HERE / s) for s in SOURCES)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError:
            return None
        if res.returncode != 0:
            if verbose:
                print(res.stderr, file=sys.stderr)
            return None
        os.replace(tmp_so, out)
    return out


if __name__ == "__main__":
    path = build(verbose=True)
    print(f"built {path}" if path else "build FAILED")
    sys.exit(0 if path else 1)
