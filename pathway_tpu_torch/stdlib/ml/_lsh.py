"""Random-projection LSH bucketers (reference:
python/pathway/stdlib/ml/classifiers/_lsh.py:97 — euclidean & cosine
generators).

euclidean: bucket = floor((x . R + b) / bucket_length) per AND-dimension;
cosine: bucket = sign(x . R) bits. An OR-repetition gives n_or band
hashes; each band is an n_and-dim hash tuple."""

from __future__ import annotations

import numpy as np


def generate_euclidean_lsh_bucketer(
    d: int, M: int, L: int, A: float, seed: int = 0
):
    """M = n_and, L = n_or, A = bucket_length."""
    rng = np.random.default_rng(seed)
    projections = rng.normal(size=(L, d, M)).astype(np.float64)
    offsets = rng.uniform(0, A, size=(L, M))

    def bucketer(x) -> tuple:
        x = np.asarray(x, dtype=np.float64)
        out = []
        for band in range(L):
            h = np.floor((x @ projections[band] + offsets[band]) / A)
            out.append((band,) + tuple(int(v) for v in h))
        return tuple(out)

    return bucketer


def generate_cosine_lsh_bucketer(d: int, M: int, L: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    projections = rng.normal(size=(L, d, M)).astype(np.float64)

    def bucketer(x) -> tuple:
        x = np.asarray(x, dtype=np.float64)
        out = []
        for band in range(L):
            bits = (x @ projections[band]) > 0
            out.append((band,) + tuple(int(b) for b in bits))
        return tuple(out)

    return bucketer
