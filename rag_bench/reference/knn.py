"""The plain reference's search: exact top-k by cosine over the seeded
rows, in float32 with TF32 off, block by block of ``rag_bench/corpus.py``;
and its control, with both operands rounded to TF32 (10 mantissa bits),
the step below float32 that the port's ``precision="default"`` takes.
It imports nothing of the program and reads no state of it."""

from __future__ import annotations

import torch

from rag_bench import corpus
from rag_bench.reference.bert import fp32_matmuls


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even of float32 to TF32's 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def search(queries: torch.Tensor, seed: int, n_rows: int, k: int,
           keys: torch.Tensor | None = None, tf32: bool = False):
    """(values [Q, k], keys [Q, k]) of the exact top-k over the corpus,
    and, where ``keys`` [Q, m] is given, the scores [Q, m] of those keys
    (-inf for a key outside the corpus)."""
    q = queries.float()
    if tf32:
        q = tf32_round(q)
    Q = q.shape[0]
    best_v = torch.full((Q, k), float("-inf"), device=q.device)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=q.device)
    at = None
    if keys is not None:
        at = torch.full(keys.shape, float("-inf"), device=q.device)
    with torch.no_grad(), fp32_matmuls():
        for c in corpus.blocks(n_rows):
            x = corpus.rows(seed, c, n_rows, q.shape[1], q.device)
            if tf32:
                x = tf32_round(x)
            s = q @ x.t()
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            cat_v = torch.cat([best_v, v], 1)
            cat_i = torch.cat([best_i, i + c * corpus.BLOCK], 1)
            top = torch.topk(cat_v, k, dim=1)
            best_v, best_i = top.values, torch.gather(cat_i, 1, top.indices)
            if keys is not None:
                local = keys - c * corpus.BLOCK
                inside = (local >= 0) & (local < x.shape[0])
                got = torch.gather(s, 1, local.clamp(0, x.shape[0] - 1))
                at = torch.where(inside, got, at)
            del x, s
    return best_v, best_i, at
