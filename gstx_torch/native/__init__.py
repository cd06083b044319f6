"""Native (C++) host fast paths: the GSTF feature-store reader and the
WordPiece tokenizer (the port's copies of ``gstx/native``).

The library is built with g++ on first use (:mod:`gstx_torch.native.build`).
Callers keep the pure-Python reader and tokenizer, which serve every input
the fast path declines (non-ASCII text, special tokens inside text) and a
machine without g++.  :data:`served` records which fast paths have served a
call since :func:`reset_served`.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

_lib = None
_lib_checked = False

served = {"feature_store": False, "wordpiece": False}


def reset_served():
    for k in served:
        served[k] = False


def load_library():
    """Load (building on first use) the native library; None if g++ is
    missing or the build fails."""
    global _lib, _lib_checked
    if _lib is not None:
        return _lib
    if _lib_checked:
        return None
    _lib_checked = True
    from gstx_torch.native import build

    path = build.build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))

    lib.gstf_open.restype = ctypes.c_void_p
    lib.gstf_open.argtypes = [ctypes.c_char_p]
    lib.gstf_close.argtypes = [ctypes.c_void_p]
    lib.gstf_num_items.restype = ctypes.c_long
    lib.gstf_num_items.argtypes = [ctypes.c_void_p]
    lib.gstf_feat_dim.restype = ctypes.c_int
    lib.gstf_feat_dim.argtypes = [ctypes.c_void_p]
    lib.gstf_num_classes.restype = ctypes.c_int
    lib.gstf_num_classes.argtypes = [ctypes.c_void_p]
    lib.gstf_keys.restype = ctypes.c_long
    lib.gstf_keys.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_long]
    lib.gstf_num_boxes.restype = ctypes.c_int
    lib.gstf_num_boxes.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.gstf_read.restype = ctypes.c_int
    lib.gstf_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                              f32p, f32p, f32p, f32p]

    lib.wp_load.restype = ctypes.c_void_p
    lib.wp_load.argtypes = [ctypes.c_char_p]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_vocab_size.restype = ctypes.c_int
    lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.wp_encode.restype = ctypes.c_int
    lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_int, i32p, ctypes.c_int]
    _lib = lib
    return lib


class NativeFeatureStore:
    """C++ reader with the same output contract as FeatureStoreReader."""

    def __init__(self, path: str):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.gstf_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open GSTF store: {path}")
        self.feat_dim = self._lib.gstf_feat_dim(self._h)
        self.num_classes = self._lib.gstf_num_classes(self._h)

    def __len__(self):
        return int(self._lib.gstf_num_items(self._h))

    def keys(self) -> List[int]:
        n = len(self)
        buf = (ctypes.c_longlong * n)()
        got = self._lib.gstf_keys(self._h, buf, n)
        return list(buf[:got])

    def __contains__(self, image_id) -> bool:
        return self._lib.gstf_num_boxes(self._h, int(image_id)) >= 0

    def __getitem__(self, image_id):
        image_id = int(image_id)
        n = self._lib.gstf_num_boxes(self._h, image_id)
        if n < 0:
            raise KeyError(image_id)
        total = n + 1
        feat = np.empty((total, self.feat_dim), np.float32)
        loc = np.empty((total, 5), np.float32)
        loc_ori = np.empty((total, 5), np.float32)
        cls = np.empty((total, self.num_classes), np.float32)
        got = self._lib.gstf_read(self._h, image_id, feat, loc, loc_ori, cls)
        if got != total:
            # never hand out the uninitialised buffers
            raise IOError(
                f"native gstf_read({image_id}) returned {got}, "
                f"expected {total}")
        served["feature_store"] = True
        return feat, total, loc, loc_ori, cls

    def close(self):
        if self._h:
            self._lib.gstf_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeWordPiece:
    """C++ ASCII fast path; returns None for what it declines (the caller
    falls back to the Python tokenizer)."""

    def __init__(self, vocab_path: str, max_ids: int = 4096):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.wp_load(vocab_path.encode())
        if not self._h:
            raise IOError(f"cannot load vocab: {vocab_path}")
        self._max_ids = max_ids

    def encode(self, text: str) -> Optional[List[int]]:
        # the decline test must track the Python path's never-split list
        # exactly (lazy import: the tokenizer imports this module lazily)
        from gstx_torch.data.tokenizer import _SPECIAL_TOKENS

        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        # special tokens inside text are never split (HF semantics); the
        # C++ path would split them at the brackets, so it declines
        if "[" in text and any(s in text for s in _SPECIAL_TOKENS):
            return None
        # a buffer per call: ctypes releases the GIL during the C call and
        # the loader's threads encode concurrently.  wp_encode takes the
        # length (embedded NULs are deleted, as the Python path does) and
        # returns the total id count, so a long text regrows the buffer
        buf = np.empty(self._max_ids, np.int32)
        n = self._lib.wp_encode(self._h, raw, len(raw), buf, len(buf))
        if n < 0:
            return None
        if n > len(buf):
            buf = np.empty(n, np.int32)
            n = self._lib.wp_encode(self._h, raw, len(raw), buf, len(buf))
        served["wordpiece"] = True
        return buf[:n].tolist()

    def close(self):
        if self._h:
            self._lib.wp_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
