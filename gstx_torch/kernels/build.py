"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface and are compiled with
``nvcc`` for ``sm_90a`` into one shared library, loaded with ``ctypes``.
The output directory is keyed on a hash of the sources and flags, so the
first call after a change rebuilds and later calls reuse the library.
Every source compiles in its own ``nvcc`` process, all started together.

Nothing here runs at import time: the CPU tests import every module, and
this machine's toolchain need not exist where they run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libgstx_kernels.so"
# -Xptxas -v: each kernel's registers, shared memory and spills land in
# build_log, which chip_smoke.py prints
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_seconds = None  # wall time of the last build in this process, or None
build_log = []  # compiler output of the last build in this process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.h")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless a build of the
    same sources and flags exists; returns its path."""
    global build_seconds
    out = BUILD_DIR / _digest() / LIB_NAME
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        build_log.clear()
        for cmd, _, proc in procs:
            text, _ = proc.communicate()
            build_log.append(text)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp_lib, out)  # atomic: a reader never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use) with every entry's
    argument and result types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gstx_dense_ln.argtypes = [ptr] * 7 + [i32, i32, i32, i32, f32, ptr]
        lib.gstx_dense_ln.restype = i32
        lib.gstx_ffn.argtypes = [ptr] * 8 + [i32, i32, i32, i32, f32, ptr]
        lib.gstx_ffn.restype = i32
        lib.gstx_ffn_sm90.argtypes = [ptr] * 8 + [i32, i32, i32, f32, ptr]
        lib.gstx_ffn_sm90.restype = i32
        lib.gstx_attention.argtypes = (
            [ptr] * 5 + [i32] * 5
            + [ctypes.POINTER(ctypes.c_longlong), f32, i32, i32, ptr])
        lib.gstx_attention.restype = i32
        lib.gstx_quant_decode_attention.argtypes = (
            [ptr] * 5 + [i32] * 4 + [ctypes.c_longlong, i32, i32, ptr])
        lib.gstx_quant_decode_attention.restype = i32
        lib.gstx_error_string.argtypes = [i32]
        lib.gstx_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str):
    """Raise if a kernel entry returned a CUDA error."""
    if code != 0:
        msg = library().gstx_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
