"""Top-k primitives: masked, chunked and mergeable — the port of
``pathway_tpu/ops/topk.py``.

Scoring a query batch against a large vector shard must not materialize
the full [n_queries, capacity] score matrix; the plain version scores in
chunks and merges partial top-k results. ``chunked_topk_scores`` is also
the plain PyTorch version of the hand-written KNN kernel
(``ops/fused_knn.py``): the CPU path, and what the kernel is held against
on the card. The same merge is the reduction step of the global top-k
across index shards (``tree_merge_topk``, used by
``parallel/sharded_knn.py``).

Ties. ``jax.lax.top_k`` breaks ties by position (lower index first);
``torch.topk`` does not promise that (``topk([1,2,2,2,0], 2)`` returns
indices ``[1, 3]`` on the CPU). Every top-k here is a stable descending
sort and a slice, which is positional.

Precision. ``precision`` takes the two names the JAX package documents.
``"highest"`` scores are IEEE fp32: TF32 is switched off for the product
(``torch.backends.cuda.matmul.allow_tf32 = False``), and the hand-written
kernel sums three TF32 products (3xTF32). ``"default"`` is the fast path
for latency-bound serving: both operands rounded to TF32 (``tf32_round``,
10 fraction bits, to nearest, ties away from zero, as the kernel's
``tf32_rna`` rounds), then the same fp32 product. Every product of two
TF32 values is exact in fp32, so the kernel's one TF32 pass and this plain
version differ only in the order of their sums; a unit-vector score moves
by at most 2^-10 * sum|q_i x_i| <= 9.8e-4 from the fp32 one. The l2sq
norms stay those of the unrounded vectors. On the CPU the BLAS picks its
kernel, and so its rounding, by the product's shape; the plain product
is therefore taken one fixed-shape granule of ``GRANULE`` database rows
at a time, which scores a row the same wherever it sits (in one shard or
in any shard of a sharded index).
"""

from __future__ import annotations

import contextlib

import torch

NEG_INF = float("-inf")
# the precisions a search takes: the two the JAX package documents
PRECISIONS = ("highest", "default")


def check_precision(precision: str) -> str:
    """``precision`` if it is one of ``PRECISIONS``, else ValueError."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be 'highest' (fp32 scores) or 'default' (TF32 "
            f"operands, ~1e-3 score error), got {precision!r}"
        )
    return precision


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 fraction bits; to nearest, ties away
    from zero) by integer ops on its bits, as the kernel's ``tf32_rna``
    does: add half an ulp of TF32 to the magnitude bits, clear the 13 bits
    TF32 drops. An f32 tensor of those values."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


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


def to_device_after(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``. Between two cards the copy is ordered after
    the work queued on ``t``'s card: an event recorded on that card's
    current stream, waited on by ``device``'s current stream."""
    if t.device == device:
        return t
    if t.device.type == "cuda" and device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(device).wait_event(ev)
        return t.to(device, non_blocking=True)
    return t.to(device)


def merge_pair(vals_a, idx_a, vals_b, idx_b, k: int):
    """One two-list merge on ``vals_a``'s device, ``a`` first on ties: the
    hand-written merge kernel on CUDA (``fused_knn.topk_merge`` over the
    two lists in order), the plain ``merge_topk`` on the CPU."""
    dev = vals_a.device
    vals_b, idx_b = to_device_after(vals_b, dev), to_device_after(idx_b, dev)
    if dev.type == "cuda":
        from pathway_tpu_torch.ops.fused_knn import topk_merge

        return topk_merge(
            torch.stack([vals_a, vals_b]), torch.stack([idx_a, idx_b]), k
        )
    return merge_topk(vals_a, idx_a, vals_b, idx_b, k)


def tree_merge_topk(vals, idx, k: int):
    """Global top-k of a power-of-two list of per-shard partials (values
    desc, ``[q, k']`` each, in shard order) by recursive doubling: round
    ``step`` merges the partials of ranks ``r`` and ``r + step`` on
    rank ``r``'s device, the lower rank first, so ties resolve in shard
    order like the gather merge. It is the reduction of the JAX package's
    butterfly (every rank there ends with this same answer): log2(n)
    rounds of two-list merges. Returns (values [q, k], indices [q, k])
    on the first partial's device."""
    n = len(vals)
    if n == 0 or n & (n - 1):
        raise ValueError(f"tree_merge_topk needs a power-of-two list, got {n}")
    vals, idx = list(vals), list(idx)
    step = 1
    while step < n:
        for r in range(0, n, 2 * step):
            vals[r], idx[r] = merge_pair(
                vals[r], idx[r], vals[r + step], idx[r + step], k
            )
        step *= 2
    return vals[0], idx[0]


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
    precision: str = "highest",
):
    """Score queries against the database and return top-k per query.

    metric:
      - "dot": plain inner product (cos if inputs are pre-normalized)
      - "l2sq": negated squared L2 distance (so larger is better)

    precision: "highest" = fp32 scores; "default" = the product of the
    TF32-rounded operands (the plain version of the kernel's one-pass
    instance), ~1e-3 score error on unit vectors.

    The database is scanned in `chunk`-row blocks; per-block top-k results
    are merged, keeping peak memory at O(q * chunk) instead of O(q * cap).
    Returns (values [q, k] f32, indices [q, k] int32).
    """
    check_precision(precision)
    q = queries.shape[0]
    cap = database.shape[0]
    if chunk is None:
        chunk = auto_chunk(cap, q)
    with _ieee_fp32():
        if cap <= chunk:
            scores = _block_scores(queries, database, sq_norms, metric, precision)
            vals, idx = masked_topk(scores, valid[None, :], k)
            return vals, idx.to(torch.int32)
        if cap % chunk:
            raise ValueError("capacity must be a multiple of chunk")
        best_vals = torch.full((q, k), NEG_INF, device=queries.device)
        best_idx = torch.zeros((q, k), dtype=torch.int32, device=queries.device)
        for base in range(0, cap, chunk):
            sl = slice(base, base + chunk)
            sq = sq_norms[sl] if sq_norms is not None else None
            scores = _block_scores(queries, database[sl], sq, metric, precision)
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


GRANULE = 256  # database rows per CPU product, one fixed shape


def _dot_scores(queries, db):
    """``queries @ db.T``; on the CPU one ``[q, GRANULE]`` product per
    granule of rows, the last one padded with zero rows, so a row's score
    does not depend on how many rows it is scored with."""
    if db.device.type != "cpu":
        return queries @ db.T
    n = db.shape[0]
    out = queries.new_empty((queries.shape[0], n + (-n % GRANULE)))
    for base in range(0, n, GRANULE):
        blk = db[base:base + GRANULE]
        if blk.shape[0] < GRANULE:
            blk = torch.cat([blk, blk.new_zeros((GRANULE - blk.shape[0], blk.shape[1]))])
        out[:, base:base + GRANULE] = queries @ blk.T
    return out[:, :n]


def _block_scores(queries, db_block, sq_norms_block, metric,
                  precision="highest"):
    if precision == "default":
        scores = _dot_scores(tf32_round(queries), tf32_round(db_block))
    else:
        scores = _dot_scores(queries, db_block)
    if metric == "l2sq":
        qn = torch.sum(queries * queries, dim=-1, keepdim=True)
        scores = 2.0 * scores - qn - sq_norms_block[None, :]
    return scores
