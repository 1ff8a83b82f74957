"""The search options the JAX package takes and the port takes too:
``chunk`` and ``precision`` on ``KnnShard``, ``ShardedKnnIndex``,
``QueryEngine``, ``chunked_topk_scores`` and ``sharded_topk``, and
``stage_h2d`` on ``IngestPipeline``. Both packages run in one process on
numpy data made from a seed.

Tolerances. At ``precision="highest"`` ids are equal and scores within
1e-5 (fp32 products summed in another order). At ``"default"`` the port
scores the TF32-rounded operands: each operand is within 2^-11 of itself
relatively, so a score moves by at most 2^-10·Σ|q_i x_i| (plus 2^-22 of
the same sum for the product of the two roundings) from the fp32 score,
which is what the JAX package computes at either precision on the CPU
(XLA's CPU product is f32 at "default" too). Scores are held within
2^-10·Σ|q_i x_i| + 3e-5 of the JAX package's (twice that for l2sq, whose
score is 2·q·x - |q|^2 - |x|^2), and ids equal wherever the JAX score
stands clear of its neighbours by twice that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import KnnShard as JaxShard
from pathway_tpu.ops.topk import chunked_topk_scores as jax_chunked
from pathway_tpu_torch.analysis import device_plan as tdp
from pathway_tpu_torch.internals.device import PLANE
from pathway_tpu_torch.ops import KnnShard, fused_knn, topk
from pathway_tpu_torch.ops.topk import chunked_topk_scores, tf32_round
from pathway_tpu_torch.parallel import ShardedKnnIndex, make_mesh
from pathway_tpu_torch.parallel import sharded_knn as sk

CPU = "cpu"
SLACK = 3e-5


@pytest.fixture(autouse=True)
def _plane_off():
    PLANE.disarm()
    yield
    PLANE.disarm()


def _data(seed, cap, d, q, unit=True):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(cap, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    if unit:
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    valid = rng.random(cap) > 0.1
    return db, queries, valid


def _tol(queries, db, idx, metric):
    """2^-10·Σ|q_i x_i| + 3e-5 for each (query, hit) of ``idx`` [Q, k];
    twice that for l2sq."""
    rows = db[np.clip(idx, 0, len(db) - 1)]                       # [Q, k, d]
    t = 2.0 ** -10 * np.abs(queries[:, None, :] * rows).sum(-1) + SLACK
    return 2.0 * t if metric == "l2sq" else t


def _hold(got_v, got_i, want_v, want_i, tol):
    """Scores within ``tol``; ids equal wherever the wanted score stands
    clear of both neighbours by twice ``tol``."""
    fin = np.isfinite(want_v)
    assert np.array_equal(np.isfinite(got_v), fin)
    assert (np.abs(got_v - want_v)[fin] <= tol[fin]).all(), np.abs(got_v - want_v)[fin].max()
    gap = want_v[:, :-1] - want_v[:, 1:]
    inf = np.full((want_v.shape[0], 1), np.inf)
    left, right = np.concatenate([inf, gap], 1), np.concatenate([gap, inf], 1)
    clear = (np.minimum(left, right) > 2.0 * tol) & fin
    assert np.array_equal(got_i[clear], want_i[clear])


def _hits_hold(got, want, queries, vec_of, metric):
    """Per-query (key, score) lists under ``_hold``'s rules; ``vec_of``
    maps a key to its stored row."""
    assert [len(g) for g in got] == [len(w) for w in want]
    for qi, (g, w) in enumerate(zip(got, want)):
        if not w:
            continue
        keys = [k for k, _ in w]
        rows = np.stack([vec_of(k) for k in keys])
        tol = 2.0 ** -10 * np.abs(queries[qi] * rows).sum(-1) + SLACK
        tol = 2.0 * tol if metric == "l2sq" else tol
        ws, gs = np.array([s for _, s in w]), np.array([s for _, s in g])
        assert (np.abs(gs - ws) <= tol).all(), np.abs(gs - ws).max()
        gap = np.abs(np.diff(ws))
        clear = np.minimum(np.r_[np.inf, gap], np.r_[gap, np.inf]) > 2.0 * tol
        assert [k for (k, _), c in zip(g, clear) if c] == [k for k, c in zip(keys, clear) if c]


# -- the rounding -------------------------------------------------------------


def test_tf32_round_is_the_kernels_integer_rounding():
    """``tf32_round`` is ``(u + 0x1000) & 0xffffe000`` on the f32 bits (the
    kernel's ``tf32_rna``): to nearest, ties away from zero, over normal,
    subnormal, signed-zero, halfway and infinite values."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32),
        (rng.normal(size=256) * 1e-39).astype(np.float32),  # subnormal
        np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
                  np.finfo(np.float32).max], np.float32),
        # exactly halfway between two TF32 values: away from zero
        np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11], np.float32),
    ])
    u = x.view(np.uint32)
    want = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[-3] == np.float32(1 + 2.0 ** -10) and got[-2] == -got[-3]
    assert got[-1] == np.float32(1 + 2.0 ** -9)
    # ten fraction bits: every rounded value is a TF32 value
    assert not (tf32_round(torch.from_numpy(x)).view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("metric", ["dot", "l2sq"])
@pytest.mark.parametrize("chunk", [None, 256])
def test_default_is_highest_on_tf32_rounded_operands(metric, chunk):
    """Bit for bit: the dot product of "default" is "highest"'s on the
    rounded queries and rows; the l2sq form keeps the unrounded norms."""
    db, queries, valid = _data(1, 1024, 64, 7, unit=False)
    q, x, m = torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid)
    sq = (x * x).sum(-1)
    got_v, got_i = chunked_topk_scores(q, x, m, 10, chunk=chunk, sq_norms=sq,
                                       metric=metric, precision="default")
    if metric == "dot":
        want_v, want_i = chunked_topk_scores(tf32_round(q), tf32_round(x), m, 10,
                                             chunk=chunk, precision="highest")
    else:
        scores = (2.0 * topk._dot_scores(tf32_round(q), tf32_round(x))
                  - (q * q).sum(-1, keepdim=True) - sq[None, :])
        want_v, want_i = topk.masked_topk(scores, m[None, :], 10)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i.to(torch.int32))
    # and the kernel's plain partials are the same scan, split by split
    pv, pi = fused_knn.knn_partial(q, x, m, 10, 256, sq_norms=sq, metric=metric,
                                   precision="default")
    wv, wi = fused_knn.knn_partial_plain(q, x, m, 10, 256, sq_norms=sq,
                                         metric=metric, precision="default")
    assert torch.equal(pv, wv) and torch.equal(pi, wi)


@pytest.mark.parametrize("bad", ["high", "bfloat16", "HIGHEST", None])
def test_other_precisions_raise_naming_both(bad):
    q, x = torch.zeros(2, 8), torch.zeros(256, 8)
    m = torch.ones(256, dtype=torch.bool)
    calls = [
        lambda: KnnShard(8, device=CPU, precision=bad),
        lambda: ShardedKnnIndex(8, make_mesh(devices=[CPU] * 2, axes=("dp",)), precision=bad),
        lambda: chunked_topk_scores(q, x, m, 3, precision=bad),
        lambda: fused_knn.fused_topk_scores(q, x, m, 3, precision=bad),
        lambda: sk.sharded_topk(q, [x], [m], 3, precision=bad),
        lambda: tdp.WorkloadSpec(precision=bad),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="'highest'.*'default'"):
            call()


# -- the plain scan against the JAX package -----------------------------------


@pytest.mark.parametrize("metric", ["dot", "l2sq"])
@pytest.mark.parametrize("d,q,k", [(64, 1, 1), (384, 7, 10), (64, 33, 129)])
def test_chunked_default_matches_jax_default(metric, d, q, k):
    db, queries, valid = _data(2 + d + q, 4096, d, q)
    sq = (db * db).sum(-1)
    want_v, want_i = jax_chunked(
        jnp.asarray(queries), jnp.asarray(db), jnp.asarray(valid), k + 1,
        chunk=1024, sq_norms=jnp.asarray(sq), metric=metric, precision="default",
    )
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    got_v, got_i = chunked_topk_scores(
        torch.from_numpy(queries), torch.from_numpy(db), torch.from_numpy(valid),
        k + 1, chunk=1024, sq_norms=torch.from_numpy(sq), metric=metric,
        precision="default",
    )
    _hold(got_v.numpy()[:, :k], got_i.numpy()[:, :k], want_v[:, :k], want_i[:, :k],
          _tol(queries, db, want_i[:, :k], metric))
    # the JAX package's CPU product is f32 at "default" as at "highest"
    hv, hi = jax_chunked(
        jnp.asarray(queries), jnp.asarray(db), jnp.asarray(valid), k + 1,
        chunk=1024, sq_norms=jnp.asarray(sq), metric=metric, precision="highest",
    )
    np.testing.assert_array_equal(np.asarray(hi), want_i)
    # the bound is not vacuous: "default" moved the scores
    assert not np.array_equal(got_v.numpy(), want_v)


# -- KnnShard ------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_knn_shard_chunk_caps_k_as_jax_does(metric):
    """``KnnShard(chunk=64).search(k=100)`` gives 64 hits a query in both
    packages, the same ones."""
    db, queries, _ = _data(3, 300, 64, 7, unit=False)
    keys = [f"d{i}" for i in range(len(db))]
    jax_shard = JaxShard(64, metric, chunk=64)
    port = KnnShard(64, metric, chunk=64, device=CPU)
    for shard in (jax_shard, port):
        shard.add(keys, db)
        shard.remove(keys[::9])
    assert port.chunk == jax_shard.chunk == 64
    got, want = port.search(queries, 100), jax_shard.search(queries, 100)
    assert [len(r) for r in got] == [len(r) for r in want] == [64] * 7
    assert [[k for k, _ in r] for r in got] == [[k for k, _ in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-5)
    # without a chunk, k is capped by the capacity alone
    plain = KnnShard(64, metric, device=CPU)
    plain.add(keys, db)
    assert [len(r) for r in plain.search(queries, 100)] == [100] * 7


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
@pytest.mark.parametrize("k", [1, 10, 129])
def test_knn_shard_default_matches_jax_default(metric, k):
    db, queries, _ = _data(4 + k, 2000, 384, 33, unit=False)
    keys = [f"d{i}" for i in range(len(db))]
    jax_shard = JaxShard(384, metric, precision="default")
    port = KnnShard(384, metric, precision="default", device=CPU)
    for shard in (jax_shard, port):
        shard.add(keys, db)
        shard.remove(keys[::7])
    assert port.precision == jax_shard.precision == "default"
    stored = {key: port.vectors[slot].numpy() for key, slot in port.key_to_slot.items()}
    q = queries / np.linalg.norm(queries, axis=1, keepdims=True) if metric == "cos" else queries
    _hits_hold(port.search(queries, k), jax_shard.search(queries, k), q,
               stored.__getitem__, "l2sq" if metric == "l2sq" else "dot")


# -- QueryEngine ----------------------------------------------------------------


def test_query_engine_takes_chunk_and_precision_from_the_shard():
    import dataclasses

    import jax

    from pathway_tpu.models.encoder import EncoderConfig as JaxConfig
    from pathway_tpu.models.encoder import SentenceEncoder as JaxEncoder
    from pathway_tpu.ops import QueryEngine as JaxEngine
    from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder, flax_params_to_torch
    from pathway_tpu_torch.ops import QueryEngine

    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)
    je = JaxEncoder(jcfg, seed=0, batch_size=16)
    te = SentenceEncoder(
        tcfg, params=flax_params_to_torch(jax.tree_util.tree_map(np.asarray, je.params), tcfg),
        batch_size=16, device=CPU,
    )
    docs = [f"document {i} on topic {i % 5} with item {i * 7 % 23}" for i in range(200)]
    keys = [f"k{i}" for i in range(len(docs))]
    embs = np.asarray(je.encode(docs))
    for chunk, precision, k in ((64, "highest", 100), (None, "default", 12), (64, "default", 80)):
        jshard = JaxShard(je.embed_dim, "cos", chunk=chunk, precision=precision)
        tshard = KnnShard(te.embed_dim, "cos", chunk=chunk, precision=precision, device=CPU)
        for shard in (jshard, tshard):
            shard.add(keys, embs)
        jeng, teng = JaxEngine(je, jshard, k=k), QueryEngine(te, tshard, k=k, device=CPU)
        assert teng.k_eff == jeng.k_eff == min(k, chunk or k)
        queries = docs[::17]
        want, got = jeng.query(queries), teng.query(queries)
        qv = np.asarray(je.encode(queries))
        rows = dict(zip(keys, embs))
        _hits_hold(got, want, qv, rows.__getitem__, "dot")


# -- ShardedKnnIndex and sharded_topk -----------------------------------------


def _jax_mesh(n):
    import jax

    from pathway_tpu.parallel import make_mesh as jax_make_mesh

    if len(jax.devices()) < n:
        pytest.skip("needs the virtual CPU mesh")
    return jax_make_mesh(n, axes=("dp",), shape=(n,))


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
@pytest.mark.parametrize("chunk,precision", [(64, "highest"), (None, "default"), (64, "default")])
def test_sharded_index_matches_the_jax_sharded_index(metric, chunk, precision):
    from pathway_tpu.parallel import ShardedKnnIndex as JaxSharded

    rng = np.random.default_rng(7)
    dim = 64
    port = ShardedKnnIndex(dim, make_mesh(devices=[CPU] * 4, axes=("dp",)),
                           metric=metric, chunk=chunk, precision=precision)
    ref = JaxSharded(dim, _jax_mesh(4), metric=metric, chunk=chunk, precision=precision)
    keys = [f"d{i}" for i in range(900)]
    rows = rng.normal(size=(900, dim)).astype(np.float32)
    for index in (port, ref):
        index.add(keys, rows)
        index.remove(keys[::5])
    assert (port.chunk, port.precision) == (ref.chunk, ref.precision)
    q = rng.normal(size=(7, dim)).astype(np.float32)
    got, want = port.search(q, 100), ref.search(q, 100)
    # per-shard k is min(k, local_cap, chunk): 4 shards x 64 cover k = 100
    assert [len(r) for r in got] == [len(r) for r in want] == [100] * 7
    stored = {}
    for key, slot in port.key_to_slot.items():
        s, local = divmod(slot, port.local_cap)
        stored[key] = port.vectors[s][local].numpy()
    qn = q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cos" else q
    _hits_hold(got, want, qn, stored.__getitem__, "l2sq" if metric == "l2sq" else "dot")


@pytest.mark.parametrize("merge", ["gather", "tree"])
@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_sharded_default_is_bit_identical_to_one_shard(merge, metric, monkeypatch):
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    rng = np.random.default_rng(8)
    dim = 384
    sharded = ShardedKnnIndex(dim, make_mesh(devices=[CPU] * 4, axes=("dp",)),
                              metric=metric, precision="default")
    single = KnnShard(dim, metric, precision="default", device=CPU)
    keys = list(range(1200))
    rows = rng.normal(size=(1200, dim)).astype(np.float32)
    rows[[5, 600, 1100]] = rows[42]  # an exact tie across shards (1100 is removed)
    for index in (sharded, single):
        index.add(keys, rows)
        index.remove(keys[::11])
    q = rng.normal(size=(9, dim)).astype(np.float32)
    q[0] = rows[42]
    for k in (1, 10, 129):
        assert sharded.search(q, k) == single.search(q, k)
    # the tie at the top, in insertion order
    assert [key for key, _ in single.search(q, 3)[0]] == [5, 42, 600]


@pytest.mark.parametrize("chunk,k,want_k", [(None, 50, 50), (16, 50, 50), (8, 50, 32), (16, 10, 10)])
def test_sharded_topk_chunk_caps_the_per_shard_k(chunk, k, want_k):
    """k' = min(k, n_shards * min(k, local_cap, chunk)), as the JAX
    package's ``sharded_topk`` (sharded_knn.py, per-shard ``k_l``)."""
    rng = np.random.default_rng(9)
    dbs = [torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)) for _ in range(4)]
    valids = [torch.ones(64, dtype=torch.bool) for _ in range(4)]
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    v, i = sk.sharded_topk(q, dbs, valids, k, chunk=chunk, precision="default")
    assert v.shape == i.shape == (3, want_k)
    # each shard's partial is the top k_l of its rows, then merged
    k_l = min(k, 64, chunk or 64)
    parts = [chunked_topk_scores(q, db, m, k_l, precision="default")
             for db, m in zip(dbs, valids)]
    allv = torch.cat([p[0] for p in parts], 1)
    alli = torch.cat([p[1] + 64 * s for s, p in enumerate(parts)], 1)
    wv, pos = torch.sort(allv, dim=-1, descending=True, stable=True)
    assert torch.equal(v, wv[:, :want_k])
    assert torch.equal(i, torch.gather(alli, -1, pos)[:, :want_k])


# -- the Device Doctor keys the kernel's plans by precision --------------------


def test_device_plan_buckets_carry_the_precision():
    from pathway_tpu_torch.internals.device import fused_knn_bucket

    for precision in ("highest", "default"):
        spec = tdp.WorkloadSpec(precision=precision, query_batches=(1, 8), ks=(10,))
        buckets = tdp.simulate_fused_buckets(spec, 64)
        assert buckets and {b[-1] for b in buckets} == {precision}
        assert fused_knn_bucket(1, 128, 64, 10, precision) in buckets
    # the roofline of a predicted plan: 3 TF32 passes against 1
    rates = {"bandwidth": 3.35e12, "tf32": 495e12, "fp32": 67e12}
    (hi,) = tdp.fused_bounds({(256, 1 << 20, 384, 10, "highest")}, rates)
    (lo,) = tdp.fused_bounds({(256, 1 << 20, 384, 10, "default")}, rates)
    assert hi[-1] == "operations" and lo[-1] == "bytes"
    assert hi[-2] == pytest.approx(1e3 * 3 * 2 * 256 * 2**20 * 384 / 495e12)
    assert lo[-2] == pytest.approx(1e3 * (4 * 2**20 * 384 + 4 * 256 * 384 + 2**20 + 8 * 256 * 10) / 3.35e12)
    assert tdp.fused_bounds({(1, 128, 64, 10, "default")}, None) == []
    # the FP32-only bound of the "highest" pass: the CUDA cores alone
    secs, by = fused_knn.fused_knn_bound(256, 1 << 20, 384, 10, "highest", rates,
                                         fp32_only=True)
    assert by == "operations" and secs == pytest.approx(2 * 256 * 2**20 * 384 / 67e12)
    with pytest.raises(KeyError):  # WorkloadSpec checked it: not a bucket's
        tdp.fused_bounds({(1, 128, 64, 10, "high")}, rates)


def test_searches_meet_the_predicted_precision_buckets():
    from pathway_tpu_torch.internals.monitoring import ProberStats

    seen = set(fused_knn._SEEN_BUCKETS)
    fused_knn._SEEN_BUCKETS.clear()
    stats = ProberStats()
    PLANE.arm(None, stats)
    try:
        spec = tdp.WorkloadSpec(write_batches=(64, 64), query_batches=(1, 8),
                                ks=(10,), precision="default")
        shard = KnnShard(8, "cos", precision="default", device=CPU)
        rng = np.random.default_rng(10)
        for i, b in enumerate(spec.write_batches):
            shard.add(range(64 * i, 64 * i + b), rng.normal(size=(b, 8)).astype(np.float32))
        for qb in spec.query_batches:
            for k in spec.ks:
                with shard.lock:
                    q = torch.from_numpy(rng.normal(size=(qb, 8)).astype(np.float32))
                    fused_knn.fused_topk_scores(q, shard.vectors, shard.valid, k,
                                                precision=shard.precision)
        assert fused_knn._SEEN_BUCKETS == tdp.simulate_fused_buckets(spec, 8)
    finally:
        PLANE.disarm()
        fused_knn._SEEN_BUCKETS.clear()
        fused_knn._SEEN_BUCKETS.update(seen)


# -- IngestPipeline(stage_h2d=) -------------------------------------------------


def _pipes(**kw):
    from pathway_tpu.models.encoder import EncoderConfig as JaxConfig
    from pathway_tpu.models.encoder import SentenceEncoder as JaxEncoder
    from pathway_tpu.ops.ingest import IngestPipeline as JaxPipeline
    from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder
    from pathway_tpu_torch.ops import IngestPipeline

    je = JaxEncoder(JaxConfig.tiny())
    te = SentenceEncoder(EncoderConfig.tiny(), device=CPU)
    jp = JaxPipeline(je, JaxShard(je.embed_dim, "cos"), **kw)
    tp = IngestPipeline(te, KnnShard(te.embed_dim, "cos", device=CPU), device=CPU, **kw)
    return te, jp, tp


TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
]


def test_stage_h2d_knob_off_still_correct(monkeypatch):
    """The port's mirror of the JAX package's test of the same name."""
    monkeypatch.setenv("PATHWAY_INGEST_STAGE_H2D", "0")
    enc, jp, tp = _pipes()
    assert tp.stage_h2d is False and jp.stage_h2d is False
    emb = tp.ingest(["x", "y"], TEXTS).numpy()
    np.testing.assert_array_equal(emb, enc.encode(TEXTS))
    assert tp.index.search(emb, 1)[0][0][0] == "x"


@pytest.mark.parametrize("env,arg,want", [
    (None, None, True), ("1", None, True), ("no", None, False),
    ("false", True, True), (None, False, False),
])
def test_stage_h2d_follows_the_jax_package(monkeypatch, env, arg, want):
    if env is None:
        monkeypatch.delenv("PATHWAY_INGEST_STAGE_H2D", raising=False)
    else:
        monkeypatch.setenv("PATHWAY_INGEST_STAGE_H2D", env)
    kw = {} if arg is None else {"stage_h2d": arg}
    _, jp, tp = _pipes(**kw)
    assert tp.stage_h2d is jp.stage_h2d is want
    # on the CPU nothing is staged on a side stream either way
    assert tp._copy_stream is None
