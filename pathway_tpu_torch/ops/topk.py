"""Top-k primitives: masked, chunked and mergeable — the port of
``pathway_tpu/ops/topk.py``.

Scoring a query batch against a large vector shard must not materialize
the full [n_queries, capacity] score matrix; the plain version scores in
chunks and merges partial top-k results. ``chunked_topk_scores`` is also
the plain PyTorch version of the hand-written KNN kernel
(``ops/fused_knn.py``): the CPU path, and what the kernel is held against
on the card.

Ties. ``jax.lax.top_k`` breaks ties by position (lower index first);
``torch.topk`` does not promise that (``topk([1,2,2,2,0], 2)`` returns
indices ``[1, 3]`` on the CPU). Every top-k here is a stable descending
sort and a slice, which is positional.

Precision. Scores are IEEE fp32, the JAX package's
``precision="highest"``: TF32 is switched off for the product
(``torch.backends.cuda.matmul.allow_tf32 = False``), as the hand-written
kernel never uses it.

``tree_merge_topk`` (the cross-shard merge) belongs to the sharded-index
slice.
"""

from __future__ import annotations

import contextlib

import torch

NEG_INF = float("-inf")


def _topk_positional(scores: torch.Tensor, k: int):
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def masked_topk(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Top-k of `scores` [..., n] where `valid` [..., n] (bool) gates entries.

    Returns (values [..., k], indices [..., k]); invalid entries score -inf,
    so callers must treat -inf results as missing.
    """
    scores = torch.where(valid, scores, NEG_INF)
    return _topk_positional(scores, k)


def merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two partial top-k results (values desc) into one top-k.

    Ties are broken by source order (a first), which keeps the merge
    deterministic.
    """
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    top_vals, pos = _topk_positional(vals, k)
    return top_vals, torch.gather(idx, -1, pos)


_SCORES_BUDGET_BYTES = 1 << 28  # 256 MB of f32 scores per block


def auto_chunk(cap: int, n_queries: int) -> int:
    """Largest pow2 block whose [q, chunk] f32 score matrix fits the budget."""
    rows = max(8192, _SCORES_BUDGET_BYTES // (4 * max(n_queries, 1)))
    b = 8192
    while b * 2 <= rows:
        b *= 2
    return min(b, cap)


@contextlib.contextmanager
def _ieee_fp32():
    """TF32 off for the products inside; the caller's setting after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def chunked_topk_scores(
    queries: torch.Tensor,   # [q, d] f32
    database: torch.Tensor,  # [cap, d] f32
    valid: torch.Tensor,     # [cap] bool
    k: int,
    *,
    chunk: int | None = None,
    sq_norms: torch.Tensor | None = None,  # [cap] f32, for l2 metric
    metric: str = "dot",
):
    """Score queries against the database and return top-k per query.

    metric:
      - "dot": plain inner product (cos if inputs are pre-normalized)
      - "l2sq": negated squared L2 distance (so larger is better)

    The database is scanned in `chunk`-row blocks; per-block top-k results
    are merged, keeping peak memory at O(q * chunk) instead of O(q * cap).
    Returns (values [q, k] f32, indices [q, k] int32).
    """
    q = queries.shape[0]
    cap = database.shape[0]
    if chunk is None:
        chunk = auto_chunk(cap, q)
    with _ieee_fp32():
        if cap <= chunk:
            scores = _block_scores(queries, database, sq_norms, metric)
            vals, idx = masked_topk(scores, valid[None, :], k)
            return vals, idx.to(torch.int32)
        if cap % chunk:
            raise ValueError("capacity must be a multiple of chunk")
        best_vals = torch.full((q, k), NEG_INF, device=queries.device)
        best_idx = torch.zeros((q, k), dtype=torch.int32, device=queries.device)
        for base in range(0, cap, chunk):
            sl = slice(base, base + chunk)
            sq = sq_norms[sl] if sq_norms is not None else None
            scores = _block_scores(queries, database[sl], sq, metric)
            vals, idx = masked_topk(scores, valid[None, sl], k)
            best_vals, best_idx = merge_topk(
                best_vals, best_idx, vals, idx.to(torch.int32) + base, k
            )
        return best_vals, best_idx


def topk_scan_cost(
    q: int, cap: int, d: int, k: int
) -> tuple[float, float]:
    """Analytical ``(flops, device_bytes_accessed)`` of one chunked top-k
    scan: the [q, cap] score product (2·q·cap·d) plus ~3 ops per score for
    mask/compare/merge; one database read, the query tile, validity mask +
    sq_norms, and the [q, k] result pair."""
    flops = 2.0 * q * cap * d + 3.0 * q * cap
    bytes_accessed = (
        4.0 * cap * d      # database blocks, streamed once
        + 4.0 * q * d      # query tile
        + cap              # validity mask (bool)
        + 4.0 * cap        # sq_norms (l2 metric; ~free for dot)
        + 8.0 * q * k      # merged (values, indices) result
    )
    return flops, bytes_accessed


def _block_scores(queries, db_block, sq_norms_block, metric):
    scores = queries @ db_block.T
    if metric == "l2sq":
        qn = torch.sum(queries * queries, dim=-1, keepdim=True)
        scores = 2.0 * scores - qn - sq_norms_block[None, :]
    return scores
