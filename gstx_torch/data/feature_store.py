"""Packed region-feature store (the port's copy of
``gstx/data/feature_store.py``; the replacement for the reference's LMDB of pickled, base64-encoded Faster R-CNN rows,
``utils/image_features_reader.py:11-149`` / ``preprocessing/convert_to_lmdb.py``).

Design goals over LMDB+pickle+base64:
  * zero-copy reads: one mmap, fixed-stride float32 records, O(1) id lookup;
  * no per-item decode cost (the reference base64-decodes and unpickles every
    record on every access);
  * trivially shardable across data-loading hosts.

Format (GSTF v1, little-endian):
    header:  magic 'GSTF' | u32 version | u32 feat_dim | u32 num_classes |
             u64 num_items | u64 index_offset
    records: per item, contiguous float32:
             features [num_boxes, feat_dim] | boxes [num_boxes, 4] |
             cls_prob [num_boxes, num_classes]
    index:   per item: i64 image_id | u64 offset | u32 num_boxes |
             u32 image_h | u32 image_w | u32 pad

:class:`FeatureStoreReader` reproduces the reference reader's output
contract exactly (``image_features_reader.py:110-146``): a global <IMG>
token (mean feature, location [0,0,1,1,1]) is prepended, box coordinates are
normalized to [0,1] with relative area as the 5th dim, and cls_prob gets a
one-hot background row for the <IMG> token.
"""

from __future__ import annotations

import mmap
import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np

MAGIC = b"GSTF"
VERSION = 1
_HEADER = struct.Struct("<4sIIIQQ")
_INDEX_ENTRY = struct.Struct("<qQIIII")


class FeatureStoreWriter:
    def __init__(self, path: str, feat_dim: int = 2048,
                 num_classes: int = 1601):
        self.path = path
        self.feat_dim = feat_dim
        self.num_classes = num_classes
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(MAGIC, VERSION, feat_dim, num_classes, 0, 0))
        self._index: List[Tuple[int, int, int, int, int]] = []

    def add(self, image_id: int, image_h: int, image_w: int,
            features: np.ndarray, boxes: np.ndarray,
            cls_prob: np.ndarray) -> None:
        n = features.shape[0]
        assert features.shape == (n, self.feat_dim)
        assert boxes.shape == (n, 4)
        assert cls_prob.shape == (n, self.num_classes)
        offset = self._f.tell()
        self._f.write(np.ascontiguousarray(features, dtype="<f4").tobytes())
        self._f.write(np.ascontiguousarray(boxes, dtype="<f4").tobytes())
        self._f.write(np.ascontiguousarray(cls_prob, dtype="<f4").tobytes())
        self._index.append((int(image_id), offset, n, int(image_h),
                            int(image_w)))

    def close(self) -> None:
        index_offset = self._f.tell()
        for image_id, offset, n, h, w in self._index:
            self._f.write(_INDEX_ENTRY.pack(image_id, offset, n, h, w, 0))
        self._f.seek(0)
        self._f.write(_HEADER.pack(MAGIC, VERSION, self.feat_dim,
                                   self.num_classes, len(self._index),
                                   index_offset))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FeatureStoreReader:
    """mmap-backed reader with the reference reader's output contract.

    ``reader[image_id] -> (features, num_boxes, locations, locations_ori,
    cls_prob)`` where features include the prepended <IMG> mean-feature row
    (image_features_reader.py:124-146).
    """

    def __new__(cls, path: str, in_memory: bool = False,
                use_native: bool = True):
        # in_memory keeps the Python reader: NativeFeatureStore has no item
        # cache, so substituting it would silently drop the requested
        # caching (and the .path attribute)
        if use_native and not in_memory and cls is FeatureStoreReader:
            try:
                from gstx_torch.native import NativeFeatureStore, load_library

                if load_library() is not None:
                    return NativeFeatureStore(path)
            except Exception:
                pass
        return super().__new__(cls)

    def __init__(self, path: str, in_memory: bool = False,
                 use_native: bool = True):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        (magic, version, self.feat_dim, self.num_classes, num_items,
         index_offset) = _HEADER.unpack_from(self._mm, 0)
        if magic != MAGIC or version != VERSION:
            raise ValueError(f"not a GSTF v{VERSION} store: {path}")
        self._index: Dict[int, Tuple[int, int, int, int]] = {}
        self._image_ids: List[int] = []
        off = index_offset
        for _ in range(num_items):
            image_id, offset, n, h, w, _pad = _INDEX_ENTRY.unpack_from(
                self._mm, off)
            self._index[image_id] = (offset, n, h, w)
            self._image_ids.append(image_id)
            off += _INDEX_ENTRY.size
        self._cache: Dict[int, tuple] = {}
        self._in_memory = in_memory

    def keys(self) -> List[int]:
        return list(self._image_ids)

    def __len__(self) -> int:
        return len(self._image_ids)

    def __contains__(self, image_id) -> bool:
        return int(image_id) in self._index

    def _raw(self, image_id: int):
        offset, n, h, w = self._index[image_id]
        fd, nc = self.feat_dim, self.num_classes
        feats = np.frombuffer(self._mm, dtype="<f4", count=n * fd,
                              offset=offset).reshape(n, fd)
        offset += n * fd * 4
        boxes = np.frombuffer(self._mm, dtype="<f4", count=n * 4,
                              offset=offset).reshape(n, 4)
        offset += n * 4 * 4
        cls_prob = np.frombuffer(self._mm, dtype="<f4", count=n * nc,
                                 offset=offset).reshape(n, nc)
        return feats, boxes, cls_prob, n, h, w

    def __getitem__(self, image_id):
        image_id = int(image_id)
        if image_id in self._cache:
            return self._cache[image_id]
        feats, boxes, cls_prob, n, h, w = self._raw(image_id)

        # <IMG> token & normalization (image_features_reader.py:118-146)
        g_cls = np.zeros((1, self.num_classes), dtype=np.float32)
        g_cls[0, 0] = 1.0
        cls_prob_out = np.concatenate([g_cls, cls_prob], axis=0)

        g_feat = feats.sum(axis=0, keepdims=True) / n
        feats_out = np.concatenate([g_feat, feats], axis=0)
        num_boxes = n + 1

        loc = np.zeros((n, 5), dtype=np.float32)
        loc[:, :4] = boxes
        loc[:, 4] = ((loc[:, 3] - loc[:, 1]) * (loc[:, 2] - loc[:, 0])
                     / (float(w) * float(h)))
        loc_ori = loc.copy()
        loc[:, 0] /= float(w)
        loc[:, 1] /= float(h)
        loc[:, 2] /= float(w)
        loc[:, 3] /= float(h)
        g_loc = np.array([[0, 0, 1, 1, 1]], dtype=np.float32)
        loc_out = np.concatenate([g_loc, loc], axis=0)
        g_loc_ori = np.array([[0, 0, w, h, w * h]], dtype=np.float32)
        loc_ori_out = np.concatenate([g_loc_ori, loc_ori], axis=0)

        item = (feats_out, num_boxes, loc_out, loc_ori_out, cls_prob_out)
        if self._in_memory:
            self._cache[image_id] = item
        return item

    def close(self):
        self._mm.close()
        self._file.close()


def make_synthetic_store(path: str, image_ids: Iterable[int],
                         num_boxes: int = 36, feat_dim: int = 2048,
                         num_classes: int = 1601, seed: int = 0):
    """Tiny random store for tests/benchmarks (SURVEY.md §4: synthetic LMDB
    fixture equivalent)."""
    rng = np.random.RandomState(seed)
    with FeatureStoreWriter(path, feat_dim, num_classes) as w:
        for image_id in image_ids:
            feats = rng.rand(num_boxes, feat_dim).astype(np.float32)
            boxes = np.zeros((num_boxes, 4), dtype=np.float32)
            x1 = rng.rand(num_boxes) * 300
            y1 = rng.rand(num_boxes) * 300
            boxes[:, 0], boxes[:, 1] = x1, y1
            boxes[:, 2] = x1 + rng.rand(num_boxes) * 100 + 1
            boxes[:, 3] = y1 + rng.rand(num_boxes) * 100 + 1
            cls_prob = rng.rand(num_boxes, num_classes).astype(np.float32)
            cls_prob /= cls_prob.sum(-1, keepdims=True)
            w.add(image_id, 480, 640, feats, boxes, cls_prob)
