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
from pathway_tpu_torch.internals.device import PLANE, knn_search_bucket
from pathway_tpu_torch.internals.flight import FlightRecorder
from pathway_tpu_torch.internals.monitoring import ProberStats
from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder
from pathway_tpu_torch.ops import (
    IngestPipeline,
    KnnShard,
    Metric,
    QueryEngine,
    fused_knn,
    knn,
    topk,
)
from pathway_tpu_torch.parallel import ShardedKnnIndex, make_mesh, sharded_knn


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
    # one wave, the partial pass's bytes within the budget
    tiles = -(-40 // fused_knn.plan_tile(40, k).n)
    assert tiles * splits <= max(n_sm, tiles)
    assert fused_knn.partial_bytes(40, k, splits) <= fused_knn._SEARCH_BYTES
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
    tile = fused_knn.plan_tile(q, k)
    assert tile.n in fused_knn._TILES and tile.n >= min(q, fused_knn._TILES[-1])
    assert fused_knn._MIN_STAGES <= tile.stages <= fused_knn._MAX_STAGES
    assert fused_knn.partial_smem(tile.n, tile.stages, k, tile.smem_buffers) <= fused_knn._SMEM_MAX
    # a buffer takes the k best plus one more tile; the ring holds one
    # warp's final sort of k keys
    assert fused_knn.capacity(k) >= k + fused_knn._TM
    assert tile.stages * (fused_knn._TM + 2 * tile.n) * 128 >= 8 * k
    rows, splits = fused_knn.plan_splits(q, 1 << 20, k, 132)
    assert rows % fused_knn._TN == 0
    assert (splits - 1) * rows < 1 << 20 <= splits * rows
    assert fused_knn.partial_bytes(q, k, splits) <= fused_knn._SEARCH_BYTES
    # about one CTA per SM at every k (no cap of splits * k), never more
    # than one wave
    tiles = -(-q // tile.n)
    assert tiles * splits <= max(132, tiles)
    assert tiles * splits >= 100
    if (q, k) == (32, 1024):  # one query tile: the index is read once per split
        assert tile.n == 32 and splits == 128


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


# -- the prefix a search scans: rows in use ------------------------------------


def _full_scan(shard, fn):
    """``fn()`` with the shard's mark at its capacity: the search then
    scans the whole buffer, as before the mark existed."""
    mark = shard.rows_used
    shard.rows_used = shard.capacity
    try:
        return fn()
    finally:
        shard.rows_used = mark


def _prefix_steps(pt, jx, enc, rng):
    """Every writer of a shard in a seeded order, applied to the port's
    shard and the JAX shard alike; yields after each step."""
    d = pt.dimension

    def rows(n):
        return rng.normal(size=(n, d)).astype(np.float32)

    def both(op, *args):
        getattr(pt, op)(*args)
        getattr(jx, op)(*args)

    both("add", list(range(200)), rows(200))  # 128 -> 256 slots
    yield "add"
    both("remove", list(range(0, 200, 3)))
    yield "remove"
    both("add", list(range(0, 60, 2)) + [1000, 1001], rows(32))  # upserts, freed slots
    yield "upsert"
    both("add", list(range(2000, 2400)), rows(400))  # 256 -> 1024 slots
    yield "growth"
    keys = [f"doc{i}" for i in range(24)]
    texts = [f"document {i} about topic {i % 5} and item {i * 7 % 11}" for i in range(24)]
    assert IngestPipeline(enc, pt, device="cpu").run(
        [(keys[:12], texts[:12]), (keys[12:], texts[12:])]) == 24
    jx.add(keys, pt.vectors[[pt.key_to_slot[k] for k in keys]].numpy())
    yield "ingest"
    both("remove", list(range(2000, 2400, 2)) + keys[::5])
    yield "remove"
    pt.load_state(pt.snapshot_state())
    jx.load_state(jx.snapshot_state())
    assert pt.rows_used == len(pt)
    yield "restore"
    both("add", [5000, 5001], rows(2))
    yield "add after restore"


@pytest.mark.parametrize("k", [10, 300])
@pytest.mark.parametrize("chunk", [None, 512])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("metric", ["cos", "dot"])
def test_prefix_scan_answers_as_the_full_buffer(metric, precision, chunk, k):
    """After each writer of the shard (add, remove, upsert, growth, the
    fused ingest chain, a restore): no valid slot lies past the rows in
    use, and the prefix scan answers as the plain scan of the whole
    buffer and, at "highest", as the JAX shard (``test_torch_precision``
    holds "default" to it by its own bound). With ``chunk`` 512 the prefix
    (768 rows after growth) is not a whole number of blocks."""
    rng = np.random.default_rng(sum(map(ord, metric + precision)) + k)
    enc = SentenceEncoder(EncoderConfig.tiny(), device="cpu", batch_size=16)
    kw = dict(chunk=chunk, precision=precision)
    pt = KnnShard(enc.embed_dim, metric, device="cpu", **kw)
    jx = JaxShard(enc.embed_dim, metric, chunk=chunk)
    texts = ["topic 3 and item 5", "document 7", "nothing related at all"]
    for step in _prefix_steps(pt, jx, enc, rng):
        u = pt.rows_in_use()
        assert u == knn.scan_rows(pt.rows_used, pt.capacity), step
        assert max(pt.slot_to_key) < pt.rows_used <= u <= pt.capacity, step
        assert not pt.valid[u:].any(), step
        assert pt.key_to_slot == jx.key_to_slot, step
        q = np.concatenate([pt.vectors[:2].numpy(),
                            rng.normal(size=(4, pt.dimension)).astype(np.float32)])
        # the raw scan: values and slots of every live entry bit-equal
        qt = torch.from_numpy(q)
        if metric == "cos":
            qt = knn._normalize(qt)
        k_eff = knn_search_bucket(len(q), pt.capacity, k, chunk)[2]
        got_v, got_i = pt.topk(qt, k_eff, "dot")
        want_v, want_i = topk.chunked_topk_scores(
            qt, pt.vectors, pt.valid, k_eff, chunk=chunk, precision=precision)
        assert got_v.shape == want_v.shape == (len(q), k_eff), step
        live = torch.isfinite(want_v)
        assert torch.equal(torch.isfinite(got_v), live), step
        assert torch.equal(got_v[live], want_v[live]), step
        assert torch.equal(got_i[live], want_i[live]), step
        got = pt.search(q, k)
        assert got == _full_scan(pt, lambda: pt.search(q, k)), step
        if precision == "highest":
            _same(got, jx.search(q, k))
        engine = QueryEngine(enc, pt, k=k, device="cpu")
        served = engine.query(texts)
        assert served == _full_scan(pt, lambda: engine.query(texts)), step
        assert [len(r) for r in served] == [min(k, k_eff, len(pt))] * len(texts)


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_search_is_handed_the_rounded_mark(metric, monkeypatch):
    """``search_topk`` is given views of the first ``rows_in_use()`` rows
    of the three buffers (the mark rounded up to 256-row granules, at
    least one granule), and the whole buffer once the slots are all
    handed out; ``knn.launch`` names the same rows."""
    seen = []
    inner = knn.search_topk

    def spy(queries, vectors, valid, sq_norms, *args):
        seen.append((vectors.shape[0], valid.shape[0], sq_norms.shape[0],
                     vectors.data_ptr() == pt.vectors.data_ptr(),
                     sq_norms.data_ptr() == pt.sq_norms.data_ptr()))
        return inner(queries, vectors, valid, sq_norms, *args)

    monkeypatch.setattr(knn, "search_topk", spy)
    rng = np.random.default_rng(3)
    pt = KnnShard(8, metric, capacity=1024, device="cpu")
    q = rng.normal(size=(2, 8)).astype(np.float32)

    def scanned():
        seen.clear()
        pt.search(q, 5)
        (rows, *more), = seen
        assert more == [rows, rows, True, True]
        return rows

    pt.add([0], rng.normal(size=(1, 8)).astype(np.float32))
    assert (pt.rows_used, scanned()) == (1, 256)
    pt.add(list(range(1, 300)), rng.normal(size=(299, 8)).astype(np.float32))
    assert (pt.rows_used, scanned()) == (300, 512)
    pt.remove(list(range(150, 300)))  # the mark never falls
    assert (pt.rows_used, scanned()) == (300, 512)
    pt.add(list(range(1000, 1100)), rng.normal(size=(100, 8)).astype(np.float32))
    assert (pt.rows_used, scanned()) == (300, 512)  # freed slots refilled first
    pt.add(list(range(2000, 2774)), rng.normal(size=(774, 8)).astype(np.float32))
    assert (pt.rows_used, scanned()) == (1024, 1024)
    pt.add(["grown"], rng.normal(size=(1, 8)).astype(np.float32))
    assert (pt.capacity, pt.rows_used, scanned()) == (2048, 1025, 1280)

    enc = SentenceEncoder(EncoderConfig.tiny(), device="cpu", batch_size=4)
    small = KnnShard(enc.embed_dim, "cos", capacity=4096, device="cpu")
    small.add(list(range(10)), rng.normal(size=(10, enc.embed_dim)).astype(np.float32))
    rec = FlightRecorder("")
    PLANE.arm(rec, ProberStats())
    try:
        got = QueryEngine(enc, small, k=300, device="cpu").query(["a query"])
    finally:
        PLANE.disarm()
    assert len(got[0]) == 10  # k_eff 300 over a 256-row prefix
    rows = [e[-1]["rows"] for e in rec.events if e[0] == "span" and e[1] == "knn.launch"]
    assert rows == [256]


def test_sharded_rows_in_use_through_the_shared_helper():
    """``ShardedKnnIndex.rows_in_use`` answers as its own formula did,
    through ``knn.scan_rows``, across adds, removes, growth and a
    restore."""
    assert sharded_knn.scan_rows is knn.scan_rows
    rng = np.random.default_rng(11)
    idx = ShardedKnnIndex(8, make_mesh(devices=["cpu"] * 4, axes=("dp",)))

    def before(index):
        return [min(index.local_cap, -(-max(u, 1) // 256) * 256) for u in index.rows_used]

    seen = [before(idx) == idx.rows_in_use() == [min(idx.local_cap, 256)] * 4]
    for n in (5, 300, 1500, 40):
        idx.add([f"{n}-{i}" for i in range(n)], rng.normal(size=(n, 8)).astype(np.float32))
        seen.append(before(idx) == idx.rows_in_use())
        idx.remove([f"{n}-{i}" for i in range(0, n, 3)])
        seen.append(before(idx) == idx.rows_in_use())
    idx.load_state(idx.snapshot_state())
    seen.append(before(idx) == idx.rows_in_use())
    assert all(seen) and max(idx.rows_in_use()) > 256
