"""Counter-fitted embedding cosine-similarity matrix + vocab pickles (the
port of ``gstx/preprocessing/comp_cos_sim_mat.py``).

Equivalent of reference ``comp_cos_sim_mat.py`` (TextFooler-derived): load
word vectors, L2-normalize, dot-product matrix; also the idx<->word pickles
consumed by the coreference attack.

    python -m gstx_torch.preprocessing.comp_cos_sim_mat counter-fitted.txt \\
        -out_dir data/visdial
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def build(embedding_path: str, out_dir: str):
    # dedup words AND their embedding rows in lockstep: the matrix row
    # indexed by word2idx[w] must be w's vector (a duplicate line kept in
    # the matrix but skipped in the vocab would shift every later word's
    # row — the reference inherits exactly that desync from TextFooler's
    # two independent loading loops; counter-fitted vectors happen to have
    # no duplicates, but the invariant should not rely on that)
    words, embeddings, seen = [], [], set()
    with open(embedding_path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0] in seen:
                continue
            seen.add(parts[0])
            words.append(parts[0])
            embeddings.append([float(x) for x in parts[1:]])
    emb = np.asarray(embeddings, dtype=np.float64)
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(
        np.float32)
    product = emb @ emb.T

    idx2word, word2idx = {}, {}
    for w in words:
        idx2word[len(idx2word)] = w
        word2idx[w] = len(idx2word) - 1

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "cos_sim_counter_fitting.npy"), product)
    with open(os.path.join(out_dir, "cos_sim_idx2word.pickle"), "wb") as f:
        pickle.dump(idx2word, f, protocol=pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(out_dir, "cos_sim_word2idx.pickle"), "wb") as f:
        pickle.dump(word2idx, f, protocol=pickle.HIGHEST_PROTOCOL)
    return product, idx2word, word2idx


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("embedding_path")
    p.add_argument("-out_dir", default="data/visdial")
    args = p.parse_args(argv)
    product, idx2word, _ = build(args.embedding_path, args.out_dir)
    print(f"{product.shape} matrix, {len(idx2word)} words -> {args.out_dir}")


if __name__ == "__main__":
    main()
