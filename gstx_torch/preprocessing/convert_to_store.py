"""Bottom-up-attention TSV -> GSTF feature store (the port of
``gstx/preprocessing/convert_to_store.py``).

Equivalent of reference ``preprocessing/convert_to_lmdb.py:31-45`` (which
pickles base64 TSV rows into LMDB): the rows are decoded once at pack
time into the mmap-able GSTF format instead of on every read.

    python -m gstx_torch.preprocessing.convert_to_store -tsv a.tsv b.tsv \\
        -out feats.store
"""

from __future__ import annotations

import argparse
import base64
import csv
import sys

import numpy as np

from gstx_torch.data.feature_store import FeatureStoreWriter

FIELDNAMES = ["image_id", "image_w", "image_h", "num_boxes", "boxes",
              "features", "cls_prob"]


def convert_tsv(tsv_paths, store_path: str, feat_dim: int = 2048,
                num_classes: int = 1601) -> int:
    csv.field_size_limit(sys.maxsize)
    count = 0
    with FeatureStoreWriter(store_path, feat_dim, num_classes) as w:
        for path in tsv_paths:
            with open(path) as f:
                reader = csv.DictReader(f, delimiter="\t",
                                        fieldnames=FIELDNAMES)
                for item in reader:
                    n = int(item["num_boxes"])
                    feats = np.frombuffer(
                        base64.b64decode(item["features"]),
                        dtype=np.float32).reshape(n, feat_dim)
                    boxes = np.frombuffer(
                        base64.b64decode(item["boxes"]),
                        dtype=np.float32).reshape(n, 4)
                    cls_prob = np.frombuffer(
                        base64.b64decode(item["cls_prob"]),
                        dtype=np.float32).reshape(n, num_classes)
                    w.add(int(item["image_id"]), int(item["image_h"]),
                          int(item["image_w"]), feats, boxes, cls_prob)
                    count += 1
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description="TSV -> GSTF store")
    p.add_argument("-tsv", nargs="+", required=True)
    p.add_argument("-out", required=True)
    p.add_argument("-feat_dim", type=int, default=2048)
    p.add_argument("-num_classes", type=int, default=1601)
    args = p.parse_args(argv)
    n = convert_tsv(args.tsv, args.out, args.feat_dim, args.num_classes)
    print(f"wrote {n} images to {args.out}")


if __name__ == "__main__":
    main()
