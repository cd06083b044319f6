"""CLIP-based in-domain filtering of CC12M images (the port of
``gstx/preprocessing/clip_filtering.py``).

Equivalent of reference ``preprocessing/clip_in_domain_filtering.py``: fit a
multivariate Gaussian over CLIP ViT-B/32 features of VisDial images
(:54-90,180-183), then score every CC12M image by log-probability under it;
a high-scoring subset is selected as in-domain.

The statistical core (:func:`cov_mean`, :func:`GaussianOOD`,
:func:`score_images`) is numpy on the host.  CLIP feature extraction
(:func:`extract_clip_features`) needs the optional ``clip`` package and
image files, and runs the visual tower on ``cuda`` unless given another
device (the JAX package's default is the CPU); any [N, D] feature matrix
works for the scoring:

    python -m gstx_torch.preprocessing.clip_filtering \\
        -in_domain_feats visdial.npy -candidate_feats cc12m.npy \\
        -candidate_ids cc12m_ids.json -out scores.json
"""

from __future__ import annotations

import argparse
import json
from typing import Iterable, Tuple

import numpy as np


def cov_mean(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Covariance (unbiased) and mean over rows of [N, D] features
    (reference cov_mean, clip_in_domain_filtering.py:54-90)."""
    x = np.asarray(features, dtype=np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    cov = xc.T @ xc / (x.shape[0] - 1)
    return cov, mean


class GaussianOOD:
    """Multivariate-normal log-prob scorer (the reference's OOD_detector,
    clip_in_domain_filtering.py:182-183)."""

    def __init__(self, features: np.ndarray, jitter: float = 1e-6):
        cov, mean = cov_mean(features)
        d = cov.shape[0]
        cov = cov + jitter * np.eye(d)
        self.mean = mean
        # cholesky for stable log-det and solves
        self.chol = np.linalg.cholesky(cov)
        self.log_det = 2.0 * np.log(np.diag(self.chol)).sum()
        self.d = d

    def log_prob(self, x: np.ndarray) -> np.ndarray:
        xc = np.asarray(x, dtype=np.float64) - self.mean
        sol = np.linalg.solve(self.chol, xc.T)  # L y = (x - mu)^T
        maha = (sol ** 2).sum(axis=0)
        return -0.5 * (maha + self.d * np.log(2 * np.pi) + self.log_det)


def score_images(in_domain_features: np.ndarray,
                 candidate_features: np.ndarray,
                 image_ids: Iterable[int]):
    scorer = GaussianOOD(in_domain_features)
    log_probs = scorer.log_prob(candidate_features)
    return [{"image_id": int(i), "log_prob": float(lp)}
            for i, lp in zip(image_ids, log_probs)]


def extract_clip_features(image_paths, device="cuda", batch_size: int = 64,
                          clip_module=None):
    """CLIP ViT-B/32 visual features over image files, batched like the
    reference's extraction loop (clip_in_domain_filtering.py:126-151):
    preprocess each image, stack into [B, C, H, W] batches, run
    ``model.visual`` on ``device`` once per batch in the visual tower's
    weight dtype, and concatenate to [N, D] float32 on the host.  Asking
    for ``cuda`` without a card raises.

    ``clip_module`` injects the (optional) ``clip`` package; by default
    the real package is imported."""
    import torch
    from PIL import Image

    from gstx_torch.core.device import resolve_device

    dev = resolve_device(device)
    if clip_module is None:
        import clip as clip_module  # optional dependency

    model, preprocess = clip_module.load("ViT-B/32", device=dev)
    visual = model.visual
    dtype = visual.conv1.weight.dtype
    feats = []
    paths = list(image_paths)
    with torch.no_grad():
        for start in range(0, len(paths), batch_size):
            imgs = []
            for p in paths[start:start + batch_size]:
                with Image.open(p) as image:
                    imgs.append(preprocess(image))
            batch = torch.stack(imgs, dim=0).to(dev, dtype)
            feats.append(visual(batch).float().cpu().numpy())
    return np.concatenate(feats, axis=0)


def main(argv=None):
    p = argparse.ArgumentParser(description="CLIP in-domain filtering")
    p.add_argument("-in_domain_feats", required=True,
                   help=".npy [N, D] features of in-domain (VisDial) images")
    p.add_argument("-candidate_feats", required=True,
                   help=".npy [M, D] features of candidate (CC12M) images")
    p.add_argument("-candidate_ids", required=True,
                   help=".npy or .json [M] image ids")
    p.add_argument("-out", required=True)
    args = p.parse_args(argv)

    in_domain = np.load(args.in_domain_feats)
    cand = np.load(args.candidate_feats)
    if args.candidate_ids.endswith(".json"):
        with open(args.candidate_ids) as f:
            ids = json.load(f)
    else:
        ids = np.load(args.candidate_ids).tolist()
    scores = score_images(in_domain, cand, ids)
    with open(args.out, "w") as f:
        json.dump(scores, f)
    print(f"wrote {len(scores)} scores to {args.out}")


if __name__ == "__main__":
    main()
