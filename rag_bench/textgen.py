"""Seeded text and arrival generator: one generator for every traffic mix.

Words come from ``data/vocab.txt``, a frozen copy of the port's WordPiece
vocab asset (``pathway_tpu_torch/models/assets/wordpiece_vocab.txt``).
Whole words (ASCII letters, two or more) are drawn by a Zipf law over the
vocab's merge order, frequent first, as natural text repeats its words. A
fixed share of each text's words are multi-piece words, drawn by the same
law from a fixed list of ``MULTI`` whole words each glued to a ``##``
continuation (without the ``##``), made once from a fixed seed: WordPiece
splits each in two or more, so with the share 0.3 a text has about 1.3
pieces a word (an assumption for English text), and its multi-piece words
repeat as a language's do.

Stratified by design: a cell's texts are drawn from streams of their own,
the same for every run, and its arrival gaps are stratified quantiles; a
run's seed orders texts and gaps, and makes the weights and the index. So
every seed holds the same work, in its own order.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

MULTI = 32768
VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "vocab.txt")


class Lexicon:
    """Whole words and continuations of the frozen vocab, with the Zipf
    law's cumulative weights over each list."""

    def __init__(self, path: str = VOCAB, zipf_s: float = 1.0):
        with open(path, encoding="utf-8") as f:
            entries = [line.rstrip("\n") for line in f]
        # lowercase ASCII letters only: each whole word is one WordPiece
        # piece as it stands
        whole = [w for w in entries if len(w) > 1 and _letters(w)]
        cont = [w[2:] for w in entries
                if w.startswith("##") and len(w) > 3 and _letters(w[2:])]
        self.whole = np.array(whole, dtype=object)
        self.whole_cdf = _zipf_cdf(len(whole), zipf_s)
        cont_cdf = _zipf_cdf(len(cont), zipf_s)
        fixed = np.random.default_rng(0)
        self.multi = (self.whole[_draw(self.whole_cdf, fixed.random(MULTI))]
                      + np.array(cont, dtype=object)[_draw(cont_cdf, fixed.random(MULTI))])
        self.multi_cdf = _zipf_cdf(MULTI, zipf_s)

    def texts(self, rng: np.random.Generator, words: np.ndarray,
              glued_share: float) -> list[str]:
        """One text per entry of ``words`` (its word count), with
        ``round(glued_share * n)`` multi-piece words in each, at seeded
        places."""
        words = np.asarray(words, dtype=np.int64)
        total = int(words.sum())
        if total == 0:
            return ["" for _ in words]
        out = self.whole[_draw(self.whole_cdf, rng.random(total))]
        owner = np.repeat(np.arange(len(words)), words)
        starts = np.concatenate([[0], np.cumsum(words)[:-1]])
        # a word's rank inside its text, in a seeded order: the first
        # round(share * n) ranks of each text are glued
        order = np.lexsort((rng.random(total), owner))
        rank = np.empty(total, np.int64)
        rank[order] = np.arange(total) - np.repeat(starts, words)
        glued_n = np.floor(glued_share * words + 0.5).astype(np.int64)
        glued = rank < np.repeat(glued_n, words)
        out[glued] = self.multi[_draw(self.multi_cdf, rng.random(int(glued.sum())))]
        bounds = np.concatenate([[0], np.cumsum(words)])
        return [" ".join(out[bounds[i]:bounds[i + 1]]) for i in range(len(words))]


def _draw(cdf: np.ndarray, u: np.ndarray) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, u, side="right"), len(cdf) - 1)


def _letters(w: str) -> bool:
    return w.isascii() and w.isalpha() and w.islower()


def _zipf_cdf(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    c = np.cumsum(w)
    return c / c[-1]


@functools.lru_cache(maxsize=4)
def lexicon(zipf_s: float = 1.0) -> Lexicon:
    return Lexicon(zipf_s=zipf_s)


def _poisson_ppf(u: np.ndarray, lam: float) -> np.ndarray:
    kmax = int(lam + 12 * math.sqrt(lam) + 20)
    k = np.arange(kmax + 1)
    logp = k * math.log(lam) - lam - np.array([math.lgamma(x + 1) for x in k])
    cdf = np.cumsum(np.exp(logp))
    return np.minimum(np.searchsorted(cdf, u, side="left"), kmax)


def length_quantiles(model: dict, n: int) -> np.ndarray:
    """The ``n`` stratified quantiles (at (i + 0.5) / n) of a word-count
    model, as whole numbers, ascending:

    - ``{"dist": "shifted_poisson", "shift": s, "mean": m}``:
      s + Poisson(m - s), mean m;
    - ``{"dist": "cap_minus_exp", "cap": c, "mean": m, "min": lo}``:
      c - Exp, the exponential's mean c - m, clipped at lo.
    """
    u = (np.arange(n) + 0.5) / n
    dist = model["dist"]
    if dist == "shifted_poisson":
        s = int(model["shift"])
        return s + _poisson_ppf(u, float(model["mean"]) - s)
    if dist == "cap_minus_exp":
        cap, lo = int(model["cap"]), int(model["min"])
        gap = -(cap - float(model["mean"])) * np.log1p(-u)
        return np.clip(np.floor(cap - gap + 0.5), lo, cap).astype(np.int64)[::-1].copy()
    raise ValueError(f"unknown length model {dist!r}")


def shuffled_lengths(rng: np.random.Generator, model: dict, n: int) -> np.ndarray:
    return rng.permutation(length_quantiles(model, n))


def poisson_offsets(rng: np.random.Generator, rate: float, n: int) -> np.ndarray:
    """Due offsets in seconds of ``n`` Poisson arrivals at ``rate`` per
    second: the exponential gaps' stratified quantiles in a seeded order,
    the first request due at 0."""
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u) / rate)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's seed (any whole number)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])
