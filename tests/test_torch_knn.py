"""The PyTorch KNN path against the JAX package: the plain version of the
hand-written kernel against the Pallas kernel (interpret mode) and the
XLA scan, the kernel's split-and-merge decomposition in its plain form,
and ``KnnShard`` against the JAX shard.

Tolerances: slots exact (the inputs are chosen so that every tie is exact
and broken to the lower slot); scores rtol 1e-5 / atol 1e-5, the f32
rounding of a product summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import KnnShard as JaxShard
from pathway_tpu.ops import merge_topk as jax_merge_topk
from pathway_tpu.ops.pallas_knn import pallas_knn_cost, pallas_topk_scores
from pathway_tpu.ops.topk import auto_chunk as jax_auto_chunk
from pathway_tpu.ops.topk import chunked_topk_scores as jax_chunked
from pathway_tpu.ops.topk import topk_scan_cost as jax_scan_cost
from pathway_tpu_torch.ops import KnnShard, Metric, fused_knn, topk


def _db(seed, cap, d, q, ties=True):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(cap, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    valid = rng.random(cap) > 0.1
    if ties:
        # an exact three-way tie at the top of query 0, across blocks
        for s in (3, cap // 2 + 1, cap - 2):
            db[s] = queries[0] * 4.0
            valid[s] = True
    return db, queries, valid


CASES = [  # (seed, cap, d, q, k, block)
    (0, 256, 8, 4, 5, 64),
    (1, 512, 16, 7, 10, 128),
    (2, 1024, 32, 3, 1, 256),
    (3, 2048, 64, 9, 17, 1024),
    (7, 512, 16, 3, 129, 256),  # k above the 128 the kernel once capped
]


@pytest.mark.parametrize("seed,cap,d,q,k,block", CASES)
def test_plain_kernel_matches_pallas_interpret(seed, cap, d, q, k, block):
    db, queries, valid = _db(seed, cap, d, q)
    mask = np.where(valid, 0.0, -np.inf).astype(np.float32)
    want_v, want_i = pallas_topk_scores(
        jnp.asarray(queries), jnp.asarray(db), jnp.asarray(mask),
        k=k, block=block, interpret=True,
    )
    args = (torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid))
    for got_v, got_i in (
        fused_knn.fused_topk_scores(*args, k),
        topk.chunked_topk_scores(*args, k, chunk=block),
    ):
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5)
    # the deliberate tie resolves lower slot first
    assert got_i[0, :3].tolist() == [3, cap // 2 + 1, cap - 2][:k]


@pytest.mark.parametrize("metric", ["dot", "l2sq"])
@pytest.mark.parametrize("chunk", [None, 64, 256])
def test_chunked_matches_jax_chunked(metric, chunk):
    db, queries, valid = _db(4, 512, 16, 6)
    sq = (db * db).sum(-1)
    want_v, want_i = jax_chunked(
        jnp.asarray(queries), jnp.asarray(db), jnp.asarray(valid), 8,
        chunk=chunk, sq_norms=jnp.asarray(sq), metric=metric,
    )
    got_v, got_i = topk.chunked_topk_scores(
        torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid),
        8, chunk=chunk, sq_norms=torch.from_numpy(sq), metric=metric,
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_sm", [1, 3, 132])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("metric", ["dot", "l2sq"])
def test_split_and_merge_plain_matches_scan(n_sm, k, metric):
    """The kernel's two passes in plain form — per-split top-k, then a
    merge in split order — give the same slots as one scan, ties too."""
    db, queries, valid = _db(5, 4096, 8, 40)
    sq = torch.from_numpy((db * db).sum(-1))
    args = (torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid))
    rows, splits = fused_knn.plan_splits(40, 4096, k, n_sm)
    assert rows % 256 == 0 and (splits - 1) * rows < 4096 <= splits * rows
    assert splits * k <= fused_knn._MERGE_MAX
    part_v, part_i = fused_knn.knn_partial(*args, k, rows, sq_norms=sq, metric=metric)
    assert part_v.shape == (splits, 40, k)
    got_v, got_i = fused_knn.topk_merge(part_v, part_i, k)
    want_v, want_i = topk.chunked_topk_scores(*args, k, sq_norms=sq, metric=metric)
    assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)


@pytest.mark.parametrize("metric", ["dot", "l2sq"])
@pytest.mark.parametrize("k", [300, 1024])
def test_large_k_matches_jax_chunked(metric, k):
    db, queries, valid = _db(8, 2048, 16, 5)
    sq = (db * db).sum(-1)
    want_v, want_i = jax_chunked(
        jnp.asarray(queries), jnp.asarray(db), jnp.asarray(valid), k,
        sq_norms=jnp.asarray(sq), metric=metric,
    )
    got_v, got_i = fused_knn.fused_topk_scores(
        torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid), k,
        sq_norms=torch.from_numpy(sq), metric=metric,
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,k", [(4096, 200), (256, 300), (256, 1024)])
def test_split_and_merge_plain_one_split_and_past_old_limit(rows, k):
    """The kernel pair's plain form at one split (the partial is the
    answer) and at splits * k above the old 4096 merge limit."""
    db, queries, valid = _db(9, 4096, 8, 6)
    args = (torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid))
    part_v, part_i = fused_knn.knn_partial_plain(*args, k, rows)
    splits = part_v.shape[0]
    assert splits == 4096 // rows and (splits == 1 or splits * k > 4096)
    got_v, got_i = fused_knn.topk_merge_plain(part_v, part_i, k)
    want_v, want_i = topk.chunked_topk_scores(*args, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)
    if splits == 1:
        assert torch.equal(part_i[0], want_i) and torch.equal(part_v[0], want_v)


@pytest.mark.parametrize("q,k", [(1, 10), (32, 10), (256, 10), (32, 1024), (1, 8192), (129, 129)])
def test_plan_fits_shared_memory_and_one_merge_block(q, k):
    qt, qpc = fused_knn.plan_tile(q, k)
    assert qt in fused_knn._TILES and 1 <= qpc <= qt
    assert fused_knn.partial_smem(qt, qpc, k) <= fused_knn._SMEM_MAX
    rows, splits = fused_knn.plan_splits(q, 1 << 20, k, 132)
    assert splits * k <= fused_knn._MERGE_MAX and rows % 256 == 0


def test_short_split_pads_missing_entries():
    db, queries, valid = _db(6, 300, 8, 2, ties=False)
    args = (torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid))
    part_v, part_i = fused_knn.knn_partial(*args, 64, 256)  # last split: 44 rows
    assert part_v.shape == (2, 2, 64)
    assert torch.isinf(part_v[1, :, -1]).all() and (part_i[1, :, -1] == 0).all()
    v, i = fused_knn.topk_merge(part_v, part_i, 64)
    want_v, want_i = topk.chunked_topk_scores(*args, 64)
    assert torch.equal(i, want_i) and torch.equal(v, want_v)


def test_kernel_limits_raise():
    q = torch.zeros(2, 8)
    db = torch.zeros(256, 8)
    valid = torch.ones(256, dtype=torch.bool)
    for k in (0, 8193):
        with pytest.raises(ValueError, match="k <= 8192"):
            fused_knn.fused_topk_scores(q, db, valid, k)
    with pytest.raises(ValueError, match="metric"):
        fused_knn.fused_topk_scores(q, db, valid, 3, metric="cos")
    with pytest.raises(ValueError, match="sq_norms"):
        fused_knn.fused_topk_scores(q, db, valid, 3, metric="l2sq")


def test_merge_topk_matches_jax():
    va = np.array([[9.0, 5.0, 5.0], [1.0, 1.0, 0.0]], np.float32)
    ia = np.array([[0, 1, 2], [7, 8, 9]], np.int32)
    vb = np.array([[7.0, 5.0, 4.0], [1.0, 1.0, 1.0]], np.float32)
    ib = np.array([[10, 11, 12], [3, 4, 5]], np.int32)
    want_v, want_i = jax_merge_topk(va, ia, vb, ib, 4)
    got_v, got_i = topk.merge_topk(*map(torch.from_numpy, (va, ia, vb, ib)), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[1].tolist() == [7, 8, 3, 4]  # ties: source a first


def test_masked_topk_ties_are_positional():
    scores = torch.tensor([[1.0, 2.0, 2.0, 2.0, 0.0]])
    v, i = topk.masked_topk(scores, torch.ones_like(scores, dtype=torch.bool), 2)
    assert i.tolist() == [[1, 2]] and v.tolist() == [[2.0, 2.0]]
    valid = torch.tensor([[True, False, True, True, True]])
    assert topk.masked_topk(scores, valid, 3)[1].tolist() == [[2, 3, 0]]


@pytest.mark.parametrize("q,cap", [(1, 128), (8, 1 << 14), (256, 1 << 20), (3000, 1 << 22)])
def test_cost_models_and_chunk_match(q, cap):
    assert fused_knn.fused_knn_cost(q, cap, 384, 10, 1024) == pallas_knn_cost(
        q, cap, 384, 10, 1024
    )
    assert topk.topk_scan_cost(q, cap, 384, 10) == jax_scan_cost(q, cap, 384, 10)
    assert topk.auto_chunk(cap, q) == jax_auto_chunk(cap, q)


# -- KnnShard against the JAX shard --------------------------------------------


def _both(dim, metric, **kw):
    return JaxShard(dim, metric, **kw), KnnShard(dim, metric, device="cpu", **kw)


def _same(got, want):
    assert [[k for k, _ in r] for r in got] == [[k for k, _ in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            [s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-5
        )


def _scenario(name, rng, d):
    """A sequence of (op, args) on a shard; every op is applied to both."""
    db = rng.normal(size=(600, d)).astype(np.float32)
    ops = [("add", (list(range(200)), db[:200]))]
    if name == "remove_upsert":
        ops += [
            ("remove", ([3, 4, 150, 999],)),
            ("add", ([5, 1000], db[[3, 201]])),   # upsert + a new key
            ("remove", ([7],)),
        ]
    elif name == "growth":
        for start in range(200, 600, 100):        # 128 -> 256 -> 512 -> 1024
            ops.append(("add", (list(range(start, start + 100)), db[start:start + 100])))
    elif name == "slot_reuse":
        ops += [
            ("remove", (list(range(0, 200, 2)),)),
            ("add", (list(range(2000, 2100)), db[200:300])),  # reuses freed slots
        ]
    return ops, db


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
@pytest.mark.parametrize("scenario", ["remove_upsert", "growth", "slot_reuse"])
@pytest.mark.parametrize("k", [1, 5, 40, 200])
def test_knn_shard_matches_jax(metric, scenario, k):
    rng = np.random.default_rng(sum(map(ord, metric + scenario)))
    d = 16
    ops, db = _scenario(scenario, rng, d)
    jx, pt = _both(d, metric)
    for op, args in ops:
        getattr(jx, op)(*args)
        getattr(pt, op)(*args)
    assert jx.capacity == pt.capacity and len(jx) == len(pt)
    assert jx.key_to_slot == pt.key_to_slot
    assert jx.remove_epoch == pt.remove_epoch
    np.testing.assert_array_equal(jx.slot_freed_epoch, pt.slot_freed_epoch)
    np.testing.assert_array_equal(np.asarray(jx.valid), pt.valid.numpy())
    np.testing.assert_allclose(np.asarray(jx.vectors), pt.vectors.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jx.sq_norms), pt.sq_norms.numpy(), atol=1e-5)
    queries = np.concatenate([db[:3], rng.normal(size=(5, d)).astype(np.float32)])
    _same(pt.search(queries, k), jx.search(queries, k))


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_k_larger_than_live_rows(metric):
    jx, pt = _both(4, metric)
    vecs = np.eye(4, dtype=np.float32)[:3]
    jx.add(["a", "b", "c"], vecs)
    pt.add(["a", "b", "c"], vecs)
    q = np.eye(4, dtype=np.float32)[:2]
    got = pt.search(q, 50)
    _same(got, jx.search(q, 50))
    assert len(got[0]) == 3 and got[0][0][0] == "a"


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_key_seq_tie_break_matches_jax(metric):
    """Equal scores order by insertion sequence, not by slot: key "late"
    reuses a low slot but was inserted last, so it ranks after its equals."""
    v = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
    other = np.array([[0.0, 1.0, 0.0, 0.0]], np.float32)
    jx, pt = _both(4, metric)
    for shard in (jx, pt):
        shard.add(["gone"], other)               # slot 0
        shard.add(["x", "y"], np.repeat(v, 2, 0))  # slots 1, 2
        shard.remove(["gone"])
        shard.add(["late"], v)                   # slot 0 again, newest key
    assert pt.key_to_slot["late"] == 0
    got = pt.search(v, 3)
    _same(got, jx.search(v, 3))
    assert [k for k, _ in got[0]] == ["x", "y", "late"]


def test_search_accepts_tensors_and_checks_dimension():
    pt = KnnShard(4, Metric.DOT, device="cpu")
    pt.add(["a"], torch.eye(4)[:1])
    assert pt.search(torch.eye(4)[0], 1)[0][0][0] == "a"
    with pytest.raises(ValueError, match="dimension"):
        pt.add(["b"], np.ones((1, 5), np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        pt.add(["b", "c"], np.ones((1, 4), np.float32))
    assert KnnShard(4, device="cpu").search(np.ones((2, 4), np.float32), 3) == [[], []]
