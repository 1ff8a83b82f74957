"""The PyTorch fused ingest chain and serving engine against the JAX
package, on the same converted weights at f32 (tolerance atol 1e-5: the
two forwards differ only in summation order)."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.encoder import EncoderConfig as JaxConfig
from pathway_tpu.models.encoder import SentenceEncoder as JaxEncoder
from pathway_tpu.ops import KnnShard as JaxShard
from pathway_tpu.ops import QueryEngine as JaxEngine
from pathway_tpu.ops.ingest import IngestPipeline as JaxPipeline
from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder, flax_params_to_torch
from pathway_tpu_torch.ops import IngestPipeline, KnnShard, MicroBatcher, QueryEngine

CPU = "cpu"
DOCS = [f"document number {i} about topic {i % 7} and item {i * 13 % 31}" for i in range(45)]
KEYS = [f"k{i}" for i in range(len(DOCS))]


def _batches(n=8):
    return [(KEYS[i:i + n], DOCS[i:i + n]) for i in range(0, len(DOCS), n)]


def _encoders(batch_size=16, seed=0):
    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)
    je = JaxEncoder(jcfg, seed=seed, batch_size=batch_size)
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = SentenceEncoder(
        tcfg, params=flax_params_to_torch(params, tcfg), batch_size=batch_size,
        device=CPU,
    )
    return je, te


def _mk(metric="cos", capacity=128, **kw):
    enc = SentenceEncoder(EncoderConfig.tiny(), device=CPU, batch_size=16)
    shard = KnnShard(enc.embed_dim, metric, capacity=capacity, device=CPU)
    return enc, shard, IngestPipeline(enc, shard, device=CPU, **kw)


def _keys(res):
    return [[k for k, _ in r] for r in res]


@pytest.mark.parametrize("capacity", [128, 16])  # 16 grows 128 -> ... mid-run
def test_ingest_state_matches_jax(capacity):
    je, te = _encoders()
    jshard = JaxShard(je.embed_dim, "cos", capacity=capacity)
    tshard = KnnShard(te.embed_dim, "cos", capacity=capacity, device=CPU)
    assert JaxPipeline(je, jshard).run(iter(_batches())) == len(DOCS)
    assert IngestPipeline(te, tshard, device=CPU).run(iter(_batches())) == len(DOCS)
    assert tshard.key_to_slot == jshard.key_to_slot
    assert tshard.key_seq == jshard.key_seq
    np.testing.assert_array_equal(tshard.valid.numpy(), np.asarray(jshard.valid))
    np.testing.assert_allclose(tshard.vectors.numpy(), np.asarray(jshard.vectors), atol=1e-5)
    np.testing.assert_allclose(tshard.sq_norms.numpy(), np.asarray(jshard.sq_norms), atol=1e-5)


def test_fused_chain_matches_encode_then_add():
    enc, shard, pipe = _mk()
    emb = pipe.ingest(KEYS[:5], DOCS[:5])
    want = enc.encode(DOCS[:5])
    np.testing.assert_array_equal(emb.numpy(), want)  # same forward: bit-identical
    ref = KnnShard(enc.embed_dim, "cos", capacity=shard.capacity, device=CPU)
    ref.add(KEYS[:5], want)
    assert ref.key_to_slot == shard.key_to_slot
    np.testing.assert_array_equal(ref.valid.numpy(), shard.valid.numpy())
    # add() re-normalizes unit rows: a last-ulp difference at most
    np.testing.assert_allclose(ref.vectors.numpy(), shard.vectors.numpy(), atol=1e-6)
    got, exp = shard.search(want[:2], 3), ref.search(want[:2], 3)
    assert _keys(got) == _keys(exp) and got[0][0][0] == "k0"
    assert got[0][0][1] == pytest.approx(1.0, abs=1e-5)


def test_pipelined_run_matches_serial_ingest():
    enc, shard, pipe = _mk(depth=1)
    assert pipe.run(iter(_batches(4))) == len(DOCS)
    assert pipe.rows_ingested == len(DOCS) and 0 < pipe.real_tokens < pipe.padded_tokens
    _, serial, pipe2 = _mk()
    for keys, texts in _batches(4):
        pipe2.ingest(keys, texts)
    assert serial.key_to_slot == shard.key_to_slot
    np.testing.assert_array_equal(serial.vectors.numpy(), shard.vectors.numpy())


def test_upsert_overwrites_in_place():
    enc, shard, pipe = _mk()
    pipe.ingest(["a", "b", "c"], DOCS[:3])
    slots = dict(shard.key_to_slot)
    pipe.ingest(["a", "b", "c"], DOCS[3:6])
    assert shard.key_to_slot == slots and len(shard) == 3
    got = shard.search(enc.encode(DOCS[3:4]), 1)
    assert got[0][0][0] == "a" and got[0][0][1] == pytest.approx(1.0, abs=1e-5)
    assert pipe.ingest([], []).shape == (0, enc.embed_dim)


def test_run_surfaces_producer_errors():
    _, _, pipe = _mk()

    def bad_batches():
        yield (["x"], ["fine text"])
        raise RuntimeError("source exploded")

    with pytest.raises(RuntimeError, match="source exploded"):
        pipe.run(bad_batches())


def test_run_surfaces_dispatch_errors_without_hanging():
    enc, shard, pipe = _mk(depth=1)
    calls = []
    orig = shard._write_slots

    def boom(*a, **kw):
        calls.append(1)
        raise RuntimeError("write failed")

    shard._write_slots = boom
    with pytest.raises(RuntimeError, match="write failed"):
        pipe.run(iter(_batches(2)))
    assert calls == [1]
    shard._write_slots = orig


def test_l2sq_index_rejected():
    enc = SentenceEncoder(EncoderConfig.tiny(), device=CPU)
    with pytest.raises(ValueError, match="cos/dot"):
        IngestPipeline(enc, KnnShard(enc.embed_dim, "l2sq", device=CPU), device=CPU)


def test_dimension_mismatch_rejected():
    enc = SentenceEncoder(EncoderConfig.tiny(), device=CPU)
    with pytest.raises(ValueError, match="dimension"):
        IngestPipeline(enc, KnnShard(enc.embed_dim + 1, device=CPU), device=CPU)


def test_ingest_depth_knob(monkeypatch):
    monkeypatch.setenv("PATHWAY_INGEST_DEPTH", "5")
    assert _mk()[2].depth == 5
    monkeypatch.setenv("PATHWAY_INGEST_DEPTH", "garbage")
    assert _mk()[2].depth == 2  # malformed falls back to the default
    assert _mk(depth=3)[2].depth == 3  # explicit argument beats the env


# -- serving -------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
@pytest.mark.parametrize("k", [1, 4, 60])
def test_query_engine_matches_jax(metric, k):
    je, te = _encoders()
    embs = np.asarray(je.encode(DOCS))
    jshard = JaxShard(je.embed_dim, metric)
    tshard = KnnShard(te.embed_dim, metric, device=CPU)
    jshard.add(KEYS, embs)
    tshard.add(KEYS, embs)
    jshard.remove(KEYS[10:14])
    tshard.remove(KEYS[10:14])
    queries = DOCS[::5] + ["an unrelated query about nothing"]
    want = JaxEngine(je, jshard, k=k).query(queries)
    got = QueryEngine(te, tshard, k=k, device=CPU).query(queries)
    assert _keys(got) == _keys(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-5)


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
@pytest.mark.parametrize("k", [200, 1024])
def test_query_engine_large_k_matches_jax(metric, k):
    """k above the old 128 limit: the same keys in the same order as the
    JAX engine over 45 documents and 1,200 seeded rows."""
    je, te = _encoders()
    rng = np.random.default_rng(k)
    extra = rng.normal(size=(1200, je.embed_dim)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    rows = np.concatenate([np.asarray(je.encode(DOCS)), extra])
    keys = KEYS + [f"r{i}" for i in range(len(extra))]
    jshard = JaxShard(je.embed_dim, metric)
    tshard = KnnShard(te.embed_dim, metric, device=CPU)
    for shard in (jshard, tshard):
        shard.add(keys, rows)
        shard.remove(KEYS[10:14])
    queries = DOCS[::9]
    want = JaxEngine(je, jshard, k=k).query(queries)
    got = QueryEngine(te, tshard, k=k, device=CPU).query(queries)
    assert [len(r) for r in got] == [min(k, len(tshard))] * len(queries)
    for g, w in zip(got, want):
        gs, ws = np.array([s for _, s in g]), np.array([s for _, s in w])
        np.testing.assert_allclose(gs, ws, atol=1e-5)
        # keys equal wherever the score stands 1e-5 clear of its neighbours
        # (f32 products summed in another order may swap nearer ones)
        gap = np.abs(np.diff(ws))
        clear = np.minimum(np.r_[np.inf, gap], np.r_[gap, np.inf]) > 1e-5
        assert [x for (x, _), c in zip(g, clear) if c] == [x for (x, _), c in zip(w, clear) if c]


def test_query_engine_matches_two_step():
    enc = SentenceEncoder(EncoderConfig.tiny(), batch_size=4, device=CPU)
    shard = KnnShard(enc.embed_dim, "cos", device=CPU)
    shard.add(KEYS, enc.encode(DOCS))
    engine = QueryEngine(enc, shard, k=3, device=CPU)
    queries = DOCS[:9]  # more than one encoder batch
    fused = engine.query(queries)
    two_step = shard.search(enc.encode(queries), 3)
    assert _keys(fused) == _keys(two_step)
    assert QueryEngine(enc, KnnShard(enc.embed_dim, device=CPU), device=CPU).query(["x"]) == [[]]


def test_slot_reuse_between_dispatch_and_finish_drops_hit():
    enc = SentenceEncoder(EncoderConfig.tiny(), batch_size=4, device=CPU)
    shard = KnnShard(enc.embed_dim, "cos", capacity=64, device=CPU)
    embs = enc.encode(["only document here", "another unrelated text"])
    shard.add(["old", "other"], embs)
    engine = QueryEngine(enc, shard, k=1, device=CPU)
    ticket = engine.dispatch(["only document here"])
    old_slot = shard.key_to_slot["old"]
    shard.remove(["old"])
    shard.add(["new"], embs[1:])
    assert shard.key_to_slot["new"] == old_slot
    assert all(k != "new" for k, _ in engine.finish(ticket)[0])
    hits = engine.query(["another unrelated text"])[0]
    assert hits and hits[0][0] in ("new", "other")


def test_microbatcher_answers_concurrent_threads():
    enc = SentenceEncoder(EncoderConfig.tiny(), batch_size=8, device=CPU)
    shard = KnnShard(enc.embed_dim, "cos", device=CPU)
    shard.add(KEYS, enc.encode(DOCS))
    engine = QueryEngine(enc, shard, k=3, device=CPU)
    want = dict(zip(DOCS, engine.query(DOCS)))
    mb = MicroBatcher(engine, max_wait_ms=5.0)
    results, errors = {}, []

    def client(c):
        try:
            for text in DOCS[c::6]:
                results[text] = mb.query(text, timeout=60)
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    mb.close()
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(results) == len(DOCS)
    for text in DOCS:
        assert _keys([results[text]]) == _keys([want[text]])
        assert results[text][0][0] == KEYS[DOCS.index(text)]
    with pytest.raises(RuntimeError, match="closed"):
        mb.query("late")


def test_update_while_serving_consistency():
    enc = SentenceEncoder(EncoderConfig.tiny(), batch_size=8, device=CPU)
    shard = KnnShard(enc.embed_dim, "cos", capacity=1024, device=CPU)
    rng = np.random.default_rng(3)
    shard.add(list(range(256)), rng.normal(size=(256, enc.embed_dim)).astype(np.float32))
    engine = QueryEngine(enc, shard, k=4, device=CPU)
    stop = threading.Event()
    errors = []

    def updater():
        nk = 1000
        try:
            while not stop.is_set():
                keys = list(range(nk, nk + 16))
                shard.add(keys, rng.normal(size=(16, enc.embed_dim)).astype(np.float32))
                shard.remove(keys[:8])
                nk += 16
        except Exception as exc:
            errors.append(exc)

    def querier():
        try:
            for i in range(15):
                for key, score in engine.query([f"query number {i}"])[0]:
                    assert isinstance(key, int) and np.isfinite(score)
        except Exception as exc:
            errors.append(exc)

    ut = threading.Thread(target=updater)
    qs = [threading.Thread(target=querier) for _ in range(3)]
    ut.start()
    for q in qs:
        q.start()
    for q in qs:
        q.join(timeout=120)
    stop.set()
    ut.join(timeout=30)
    assert not errors, errors
    assert not ut.is_alive() and not any(q.is_alive() for q in qs)
