"""The KNN pair's large-k path against the JAX package: plans whose merge
takes more than 32,768 candidates a query (the one-CTA merge's old cap on
the partial pass), in the plain form the CPU runs, and the sharded gather
merge in one step over 16 shards.

Data. Integer vectors (entries in [-4, 4], d = 32) score exactly in f32
in any order of summation, so the scores of the two packages are equal
and ties are many and exact: ids must be equal (ties to the lower slot)
and values equal within rtol 1e-6. Normal vectors are held at rtol 1e-5,
with ids equal wherever the JAX score stands clear of its neighbours by
1e-4 (f32 products summed in another order).

The run merge on the card takes runs that do not increase: a property
test holds every caller's runs to that (the plain partial's splits, the
shards' lists and the two lists ``merge_pair`` takes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pathway_tpu.ops.topk import chunked_topk_scores as jax_chunked
from pathway_tpu.ops.topk import merge_topk as jax_merge_topk
from pathway_tpu_torch.ops import fused_knn, topk
from pathway_tpu_torch.parallel import sharded_knn as sk

CAP, DIM = 65536, 32


def _data(seed, q, integer=True, metric="dot", cap=CAP, d=DIM):
    rng = np.random.default_rng(seed)
    if integer:
        db = rng.integers(-4, 5, size=(cap, d)).astype(np.float32)
        queries = rng.integers(-4, 5, size=(q, d)).astype(np.float32)
    else:
        db = rng.normal(size=(cap, d)).astype(np.float32)
        queries = rng.normal(size=(q, d)).astype(np.float32)
    valid = rng.random(cap) > 0.1
    # an exact tie at the top of query 0 across split edges (for l2sq the
    # query itself, at distance 0)
    for s in (3, 2047, 2048, cap // 2, cap - 1):
        db[s] = queries[0] * (1.0 if metric == "l2sq" else 4.0)
        valid[s] = True
    return db, queries, valid


def _clear(want_v, k, gap_min):
    """Positions of the first k whose JAX score stands clear of both
    neighbours by more than ``gap_min``."""
    gap = want_v[:, :-1] - want_v[:, 1:]
    inf = np.full((want_v.shape[0], 1), np.inf, np.float32)
    left = np.concatenate([inf, gap[:, : k - 1]], 1)
    right = np.concatenate([gap, inf], 1)[:, :k]
    return np.minimum(left, right) > gap_min


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("metric", ["dot", "l2sq"])
@pytest.mark.parametrize("rows,k", [(2048, 2048), (8192, 8192)])
def test_split_and_merge_past_the_old_cap_match_jax_chunked(rows, k, metric, integer):
    """32 splits of 2,048 at k = 2048 and 8 splits of 8,192 at k = 8192:
    65,536 merge candidates a query, twice the old cap."""
    db, queries, valid = _data(rows + k, 3, integer, metric)
    sq = (db * db).sum(-1)
    splits = CAP // rows
    assert splits * k > 32768
    want_v, want_i = jax_chunked(
        jnp.asarray(queries), jnp.asarray(db), jnp.asarray(valid), k + 1,
        sq_norms=jnp.asarray(sq), metric=metric,
    )
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    args = (torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid))
    part_v, part_i = fused_knn.knn_partial_plain(
        *args, k, rows, sq_norms=torch.from_numpy(sq), metric=metric)
    assert part_v.shape == (splits, 3, k)
    got_v, got_i = fused_knn.topk_merge_plain(part_v, part_i, k)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    if integer:
        np.testing.assert_array_equal(got_i, want_i[:, :k])
        np.testing.assert_allclose(got_v, want_v[:, :k], rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got_v, want_v[:, :k], rtol=1e-5, atol=1e-5)
        clear = _clear(want_v, k, 1e-4)
        np.testing.assert_array_equal(got_i[clear], want_i[:, :k][clear])
    # the deliberate tie resolves lower slot first
    assert got_i[0, :5].tolist() == [3, 2047, 2048, CAP // 2, CAP - 1]


def _jax_gather(vals, idx, k):
    """The JAX package's gather merge (parallel/sharded_knn.py, the
    all-gather branch): ``lax.top_k`` over the shards' lists laid end to
    end in shard order."""
    av = jnp.concatenate([jnp.asarray(v.numpy()) for v in vals], -1)
    ai = jnp.concatenate([jnp.asarray(i.numpy()) for i in idx], -1)
    best_v, pos = jax.lax.top_k(av, k)
    return np.asarray(best_v), np.asarray(jnp.take_along_axis(ai, pos, axis=-1))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k", [10, 1024, 4096])
def test_gather_merge_over_16_shards_matches_jax(k, integer):
    """Each of 16 shards answers its 4,096 rows (the plain scan), then
    one gather merge: 16 * k candidates a query (65,536 at k = 4096)."""
    db, queries, valid = _data(k, 4, integer)
    n, local = 16, CAP // 16
    vals, idx = [], []
    for s in range(n):
        sl = slice(s * local, (s + 1) * local)
        v, i = topk.chunked_topk_scores(
            torch.from_numpy(queries), torch.from_numpy(db[sl]),
            torch.from_numpy(valid[sl]), k)
        vals.append(v)
        idx.append(i + s * local)
    got_v, got_i = sk.gather_merge_topk(vals, idx, k)
    want_v, want_i = _jax_gather(vals, idx, k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    # and the same answer as one scan of the whole index
    one_v, one_i = topk.chunked_topk_scores(
        torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid), k)
    if integer:
        assert torch.equal(got_i, one_i) and torch.equal(got_v, one_v)


@pytest.mark.parametrize("q,k", [(1, 8192), (32, 1024), (256, 1024), (256, 8192)])
def test_plan_without_the_cap_fills_the_card_within_the_byte_budget(q, k):
    """The planner at cap 2^20 on 132 SMs: one wave, at least 100 CTAs
    wherever the budget allows one split a SM, the partial pass's bytes
    within ``_SEARCH_BYTES``, and the splits lowered only by the budget
    (Q = 256 at k = 8192 would take 1.67 GB at 33)."""
    rows, splits = fused_knn.plan_splits(q, 1 << 20, k, 132)
    tiles = -(-q // fused_knn.plan_tile(q, k).n)
    assert rows % 256 == 0 and (splits - 1) * rows < 1 << 20 <= splits * rows
    assert tiles * splits <= 132
    assert fused_knn.partial_bytes(q, k, splits) <= fused_knn._SEARCH_BYTES
    full = 132 // tiles
    if fused_knn.partial_bytes(q, k, full) <= fused_knn._SEARCH_BYTES:
        assert tiles * splits >= 100
    else:
        assert fused_knn.partial_bytes(q, k, splits + 1) > fused_knn._SEARCH_BYTES
    # no CTAs share a split where the splits fill the card or the budget
    # binds; the merge that follows: the run merge past the crossover
    assert fused_knn.plan_parts(q, splits, rows, k, 132) == 1
    assert fused_knn.merge_design(splits, k, k) == "runs"


@pytest.mark.parametrize("cap,q,k,parts", [
    (16384, 1, 10, 2), (4096, 1, 8192, 2), (1 << 18, 1, 8192, 1), (65536, 256, 8192, 1),
])
def test_parts_only_where_the_splits_are_few(cap, q, k, parts):
    """CTAs share a split only where an index too small for a 256-row
    split a SM leaves SMs idle, with no cap of parts * k, and within the
    byte budget."""
    rows, splits = fused_knn.plan_splits(q, cap, k, 132)
    assert fused_knn.plan_parts(q, splits, rows, k, 132) == parts
    assert fused_knn.partial_bytes(q, k, splits, parts) <= fused_knn._SEARCH_BYTES
    if parts > 1:
        assert rows == 256 and parts * k <= 8 * 8192


@pytest.mark.parametrize("splits,kp,k,want", [
    (128, 10, 10, "block"), (33, 10, 10, "block"), (4, 10, 10, "block"),
    (128, 16, 16, "block"), (2, 256, 256, "block"), (128, 24, 24, "runs"),
    (2, 1024, 1024, "runs"), (33, 64, 64, "runs"), (128, 8192, 8192, "runs"),
])
def test_merge_design_by_size(splits, kp, k, want):
    """The one-CTA merge up to 2,048 candidates a query and k up to 256
    (the main path's k = 10 merges at every Q, a 4-shard gather at k =
    10), the run merge past either (a tree merge's step at k = 1024)."""
    assert fused_knn.merge_design(splits, kp, k) == want


def _non_increasing(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return bool((v[..., 1:] <= v[..., :-1]).all())


@settings(max_examples=25, deadline=None, database=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    local=st.integers(1, 200),
    q=st.integers(1, 4),
    k=st.integers(1, 300),
    rows=st.sampled_from([256, 512]),
    n_shards=st.sampled_from([2, 4]),
    metric=st.sampled_from(["dot", "l2sq"]),
    integer=st.booleans(),
)
def test_every_merge_callers_runs_are_non_increasing(seed, local, q, k, rows, n_shards,
                                                     metric, integer):
    """The run merge's precondition, at every caller: the plain partial's
    splits, each shard's list (padded to k as the gather pads it), and
    ``merge_pair``'s two lists in every round of a tree merge, whose
    answer equals the JAX package's ``merge_topk`` at two shards."""
    rng = np.random.default_rng(seed)
    cap = n_shards * local
    if integer:
        db = rng.integers(-3, 4, size=(cap, 8)).astype(np.float32)
        queries = rng.integers(-3, 4, size=(q, 8)).astype(np.float32)
    else:
        db = rng.normal(size=(cap, 8)).astype(np.float32)
        queries = rng.normal(size=(q, 8)).astype(np.float32)
    valid = torch.from_numpy(rng.random(cap) > 0.3)
    qt, dbt = torch.from_numpy(queries), torch.from_numpy(db)
    sq = (dbt * dbt).sum(-1)
    part_v, _ = fused_knn.knn_partial_plain(qt, dbt, valid, k, rows, sq_norms=sq,
                                            metric=metric)
    assert _non_increasing(part_v)
    vals, idx = [], []
    for s in range(n_shards):
        sl = slice(s * local, (s + 1) * local)
        v, i = topk.chunked_topk_scores(qt, dbt[sl], valid[sl], min(k, local),
                                        sq_norms=sq[sl], metric=metric)
        v, i = sk._pad_to(v, i + s * local, k)
        assert _non_increasing(v)
        vals.append(v)
        idx.append(i)
    seen = []

    def recording(va, ia, vb, ib, kk):
        seen.append((va, vb))
        return topk.merge_topk(va, ia, vb, ib, kk)

    orig = topk.merge_pair
    topk.merge_pair = recording
    try:
        got_v, got_i = topk.tree_merge_topk(vals, idx, k)
    finally:
        topk.merge_pair = orig
    assert len(seen) == n_shards - 1
    assert all(_non_increasing(a) and _non_increasing(b) for a, b in seen)
    assert _non_increasing(got_v)
    if n_shards == 2:
        want_v, want_i = jax_merge_topk(
            jnp.asarray(vals[0].numpy()), jnp.asarray(idx[0].numpy()),
            jnp.asarray(vals[1].numpy()), jnp.asarray(idx[1].numpy()), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("k", [1, 32, 33, 1024, 1025, 2049, 8192])
@pytest.mark.parametrize("q", [1, 8, 9, 32, 64, 256])
def test_every_plans_ring_holds_the_end_sort(q, k, precision):
    """The end's sort borrows the ring: every tile the planner picks holds
    its bytes (none for k <= 32, eight warps' padded areas of 1,024 keys
    above), within the block's shared memory."""
    tile = fused_knn.plan_tile(q, k, precision)
    ring = tile.stages * (128 + fused_knn._query_parts(tile.passes) * tile.n) * 128
    assert fused_knn.sort_bytes(k) == (0 if k <= 32 else 8 * 8 * (1024 + 32))
    assert ring >= fused_knn.sort_bytes(k)
    assert fused_knn.partial_smem(tile.n, tile.stages, k, tile.smem_buffers,
                                  tile.passes) <= fused_knn._SMEM_MAX


def test_a_plan_whose_ring_cannot_hold_the_sort_raises(monkeypatch):
    monkeypatch.setattr(fused_knn, "_SORT_BYTES", 1 << 20)
    fused_knn.plan_tile.cache_clear()
    try:
        with pytest.raises(ValueError, match="cannot hold the sort"):
            fused_knn.plan_tile(1, 33)
        assert fused_knn.plan_tile(1, 32).n == 8  # k <= 32 sorts in registers
    finally:
        fused_knn.plan_tile.cache_clear()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k,rows", [(1024, 256), (2049, 768), (8192, 2048)])
def test_splits_with_fewer_live_rows_than_k_match_jax_chunked(k, rows, integer):
    """Splits of fewer rows than k, a ragged last one, and one whose rows
    are all invalid: each split's list holds its live candidates (the rows
    it has, at most k), non-increasing, then missing entries (-inf, a slot
    in range): the network the kernel sorts has pow2(live) keys, not
    pow2(k). The
    merge of the splits equals the JAX package's scan of the whole index:
    values everywhere, ids wherever the JAX value is finite (and clear of
    its neighbours by 1e-4 for normal vectors)."""
    rng = np.random.default_rng(k + rows)
    cap, q = 4 * rows + rows // 2, 3
    if integer:
        db = rng.integers(-4, 5, size=(cap, DIM)).astype(np.float32)
        queries = rng.integers(-4, 5, size=(q, DIM)).astype(np.float32)
    else:
        db = rng.normal(size=(cap, DIM)).astype(np.float32)
        queries = rng.normal(size=(q, DIM)).astype(np.float32)
    valid = rng.random(cap) > 0.1
    valid[rows:2 * rows] = False  # the second split has no live row
    part_v, part_i = fused_knn.knn_partial_plain(
        torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid), k, rows)
    assert part_v.shape == (5, q, k)
    for s in range(5):
        live = min(k, int(valid[s * rows:(s + 1) * rows].sum()))
        v, i = part_v[s], part_i[s]
        assert bool(torch.isfinite(v[:, :live]).all()) and not torch.isfinite(v[:, live:]).any()
        assert bool(((i >= 0) & (i < cap)).all()) and _non_increasing(v)
    got_v, got_i = fused_knn.topk_merge_plain(part_v, part_i, k)
    want_v, want_i = jax_chunked(jnp.asarray(queries), jnp.asarray(db), jnp.asarray(valid),
                                 k + 1)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    fin = np.isfinite(want_v[:, :k])
    assert int(fin.sum(-1).max()) == min(k, int(valid.sum()))
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_allclose(got_v[fin], want_v[:, :k][fin], rtol=1e-5, atol=1e-5)
    ids = fin if integer else fin & _clear(want_v, k, 1e-4)
    np.testing.assert_array_equal(got_i[ids], want_i[:, :k][ids])
