"""Snapshots and restore of the port's device index, on the CPU.

The battery of tests/test_device_faults.py (restore parity, quiet epochs,
chain folding and retirement, broken chains, inline fallback, N→M
re-shard) and tests/test_persistence.py's adapter round trip, against the
port's ``KnnShard`` and ``ShardedKnnIndex`` (eight CPU shards): an index
restored from its epoch-aligned snapshot answers every query
bit-identical (ids AND float scores, no tolerance) to the uninterrupted
index, the manifest is layout-free (a sharded cut restores into a single
shard and the other way round), and re-sharding 2→3 and 3→2 loses and
duplicates nothing.

Then the port against the JAX package: the same operations cut and
restored in both give the same ids, scores within atol 1e-5 (f32 in both,
summed in another order); and one engine-level run of a persisted
streaming vector store (``pw.io.fs.read`` → ``VectorStoreServer`` →
``pw.run(persistence_config=...OPERATOR_PERSISTING)``) with the seeded
tiny encoder, 40 documents then 8 more, in subprocesses with their own
deadlines: the restart embeds only the new documents, and its answers
equal the JAX package's on the same files (ids equal, distances within
1e-5). The REST gateway keys a restarted run's requests apart from the
rows of the previous run's requests that the restored state still holds.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from pathway_tpu_torch.internals import faults
from pathway_tpu_torch.internals.device import PLANE
from pathway_tpu_torch.ops.knn import KnnShard
from pathway_tpu_torch.parallel import ShardedKnnIndex, make_mesh
from pathway_tpu_torch.parallel.procgroup import shard_hash
from pathway_tpu_torch.parallel.protocol import shard_owner
from pathway_tpu_torch.persistence import Backend, Config, PersistenceManager
from pathway_tpu_torch.persistence import index_snapshot as isnap
from pathway_tpu_torch.persistence.reshard import keep_fn

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_plane():
    faults.clear_plan()
    PLANE.disarm()
    yield
    faults.clear_plan()
    PLANE.disarm()


@pytest.fixture
def pm(tmp_path):
    return PersistenceManager(
        Config(backend=Backend.filesystem(str(tmp_path / "pstore")))
    )


@pytest.fixture
def mesh8():
    return make_mesh(devices=["cpu"] * 8, axes=("dp",), shape=(8,))


def _single(dim, metric="cos"):
    return KnnShard(dim, metric, device="cpu")


def _assert_bit_identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # exact tuple equality: ids AND float scores, no tolerance
        assert g == w


def _snap(idx, pm, tag, rank=0, world=1):
    with isnap.cut(pm, tag, rank=rank, world=world):
        return idx.snapshot_state()


def _restore(idx, pm, state, rank=0, world=1):
    with isnap.cut(pm, 0, rank=rank, world=world):
        return idx.load_state(state)


def _interleave(idx, ref, rng, dim):
    """The sharded parity battery's insert/delete/query interleavings,
    applied to BOTH indexes; yields after each mutation batch so the
    caller can snapshot/restore at every intermediate state."""
    def both(op, *args):
        getattr(idx, op)(*args)
        getattr(ref, op)(*args)

    a = rng.normal(size=(60, dim)).astype(np.float32)
    both("add", [f"a{i}" for i in range(60)], a)
    yield
    both("remove", [f"a{i}" for i in range(0, 60, 3)])
    yield
    # re-add some removed keys with NEW vectors (fresh insertion seq)
    b = rng.normal(size=(10, dim)).astype(np.float32)
    both("add", [f"a{i * 3}" for i in range(10)], b)
    yield
    # upsert live keys in place
    c = rng.normal(size=(5, dim)).astype(np.float32)
    both("add", [f"a{i}" for i in range(1, 6)], c)
    yield


def test_dirty_tracking_is_exclusive_per_key():
    idx = _single(4)
    rng = np.random.default_rng(0)
    idx.add(["a", "b", "c"], rng.normal(size=(3, 4)).astype(np.float32))
    assert list(idx._dirty) == ["a", "b", "c"] and not idx._dirty_removed
    idx.remove(["b", "zz"])
    assert list(idx._dirty) == ["a", "c"] and list(idx._dirty_removed) == ["b"]
    idx.add(["b"], rng.normal(size=(1, 4)).astype(np.float32))
    assert "b" in idx._dirty and not idx._dirty_removed
    assert idx.snapshot_name.startswith("knn")


def test_single_shard_restore_parity_over_interleavings(pm):
    rng = np.random.default_rng(21)
    dim = 8
    idx, ref = _single(dim), _single(dim)
    q = rng.normal(size=(4, dim)).astype(np.float32)
    for tag, _ in enumerate(_interleave(idx, ref, rng, dim), start=1):
        state = _snap(idx, pm, tag)
        assert state.get("__index_segments__")
        fresh = _single(dim)
        _restore(fresh, pm, state)
        _assert_bit_identical(fresh.search(q, 7), ref.search(q, 7))
        _assert_bit_identical(idx.search(q, 7), ref.search(q, 7))
    # post-restore inserts mint the SAME sequences the uninterrupted run
    # would: parity survives continued mutation on the restored index
    fresh = _single(dim)
    _restore(fresh, pm, _snap(idx, pm, 99))
    d = rng.normal(size=(6, dim)).astype(np.float32)
    for target in (fresh, idx, ref):
        target.add([f"z{i}" for i in range(6)], d)
        target.remove(["a2", "z1"])
    _assert_bit_identical(fresh.search(q, 9), ref.search(q, 9))
    _assert_bit_identical(idx.search(q, 9), ref.search(q, 9))
    assert fresh.key_seq == ref.key_seq


@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_sharded_restore_parity_both_merges(pm, mesh8, merge, monkeypatch):
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    rng = np.random.default_rng(22)
    dim = 8
    idx = ShardedKnnIndex(dim, mesh8)
    ref = _single(dim)
    q = rng.normal(size=(4, dim)).astype(np.float32)
    for tag, _ in enumerate(_interleave(idx, ref, rng, dim), start=1):
        state = _snap(idx, pm, tag)
        fresh = ShardedKnnIndex(dim, mesh8)
        _restore(fresh, pm, state)
        _assert_bit_identical(fresh.search(q, 7), ref.search(q, 7))
        # cross-type restore: the manifest is layout-free, so the same
        # committed state rebuilds a single shard bit-identically
        single = _single(dim)
        _restore(single, pm, state)
        _assert_bit_identical(single.search(q, 7), ref.search(q, 7))


@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_single_cut_restores_into_a_sharded_index(pm, mesh8, merge, monkeypatch):
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    rng = np.random.default_rng(28)
    dim = 8
    idx, ref = _single(dim), _single(dim)
    q = rng.normal(size=(4, dim)).astype(np.float32)
    for tag, _ in enumerate(_interleave(idx, ref, rng, dim), start=1):
        state = _snap(idx, pm, tag)
        sharded = ShardedKnnIndex(dim, mesh8)
        _restore(sharded, pm, state)
        _assert_bit_identical(sharded.search(q, 7), ref.search(q, 7))
        assert sharded.key_seq == ref.key_seq
        for key, slot in sharded.key_to_slot.items():
            assert slot // sharded.local_cap == sharded.owner_shard(key)


def test_double_restore_is_idempotent(pm):
    rng = np.random.default_rng(23)
    idx = _single(8)
    db = rng.normal(size=(40, 8)).astype(np.float32)
    idx.add(list(range(40)), db)
    idx.remove(list(range(0, 40, 5)))
    state = _snap(idx, pm, 1)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    want = idx.search(q, 6)
    fresh = _single(8)
    _restore(fresh, pm, state)
    _assert_bit_identical(fresh.search(q, 6), want)
    _restore(fresh, pm, state)  # restore is a rebuild, not an append
    assert len(fresh) == len(idx)
    _assert_bit_identical(fresh.search(q, 6), want)


def test_quiet_epoch_writes_no_segment_o1_metadata(pm):
    rng = np.random.default_rng(24)
    idx = _single(8)
    idx.add(list(range(30)), rng.normal(size=(30, 8)).astype(np.float32))
    s1 = _snap(idx, pm, 1)
    stored_after_1 = pm.list_keys("index_segment/")
    # nothing touched since the cut: the next manifest re-lists the SAME
    # chain and the store gains no object
    s2 = _snap(idx, pm, 2)
    assert s2["segments"] == s1["segments"]
    assert pm.list_keys("index_segment/") == stored_after_1
    # one upsert -> exactly one new delta segment with exactly one row
    idx.add([3], rng.normal(size=(1, 8)).astype(np.float32))
    s3 = _snap(idx, pm, 3)
    assert len(s3["segments"]) == len(s1["segments"]) + 1
    assert s3["segments"][-1]["rows"] == 1


def test_delta_cut_carries_only_the_dirty_rows(pm, mesh8):
    rng = np.random.default_rng(29)
    for idx in (_single(16), ShardedKnnIndex(16, mesh8)):
        idx.add(list(range(500)), rng.normal(size=(500, 16)).astype(np.float32))
        full = _snap(idx, pm, 1)["segments"][-1]
        idx.remove(list(range(5)))
        idx.add([f"n{i}" for i in range(5)], rng.normal(size=(5, 16)).astype(np.float32))
        delta = _snap(idx, pm, 2)["segments"][-1]
        assert (full["rows"], full["removes"]) == (500, 0)
        assert (delta["rows"], delta["removes"]) == (5, 5)
        assert delta["bytes"] < 0.05 * full["bytes"]


def test_chain_folds_at_cap_and_retires_with_two_cut_retention(pm, monkeypatch):
    monkeypatch.setenv("PATHWAY_INDEX_SNAPSHOT_SEGMENTS", "3")
    rng = np.random.default_rng(25)
    idx, ref = _single(8), _single(8)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    for tag in range(1, 8):
        row = rng.normal(size=(1, 8)).astype(np.float32)
        idx.add([f"k{tag}"], row)
        ref.add([f"k{tag}"], row)
        state = _snap(idx, pm, tag)
        assert len(state["segments"]) <= 3
    # retired segments are pruned two cuts later: the store holds the
    # live chain and at most two cuts' worth of retired objects
    live = {s["key"] for s in state["segments"]}
    retired = {k for r in state["retired"] for k in r}
    assert set(pm.list_keys("index_segment/")) <= live | retired
    fresh = _single(8)
    _restore(fresh, pm, state)
    _assert_bit_identical(fresh.search(q, 5), ref.search(q, 5))


def test_broken_chain_refuses_instead_of_serving_holes(pm):
    rng = np.random.default_rng(26)
    idx = _single(8)
    idx.add(list(range(10)), rng.normal(size=(10, 8)).astype(np.float32))
    state = _snap(idx, pm, 1)
    pm.delete_key(state["segments"][0]["key"])
    fresh = _single(8)
    with pytest.raises(RuntimeError, match="refusing"):
        _restore(fresh, pm, state)


def test_inline_fallback_without_cut_or_knob(pm, monkeypatch):
    rng = np.random.default_rng(27)
    idx = _single(8)
    idx.add(list(range(12)), rng.normal(size=(12, 8)).astype(np.float32))
    q = rng.normal(size=(2, 8)).astype(np.float32)
    want = idx.search(q, 4)
    # no cut armed: inline full state, restorable with no persistence
    inline = idx.snapshot_state()
    assert inline.get("__index_inline__")
    fresh = _single(8)
    fresh.load_state(inline)
    _assert_bit_identical(fresh.search(q, 4), want)
    # knob off: even an armed cut falls back to inline
    monkeypatch.setenv("PATHWAY_DEVICE_SNAPSHOT", "0")
    state = _snap(idx, pm, 1)
    assert state.get("__index_inline__")
    assert pm.list_keys("index_segment/") == []


# -- N→M re-shard: 2→3 and 3→2, bit-identical merged answers ---------------


def _reshard_envelope(parts, rank, world):
    return {"__index_reshard__": True, "parts": parts, "keep": keep_fn(rank, world)}


def _merged_answer(shards, ref, q, k):
    """Merge per-rank answers the way the exchange plane would: by
    (-score, insertion seq). The seqs come from the reference index —
    restore pins them equal on every rank."""
    hits = []
    for s in shards:
        for key, score in s.search(q[None, :], len(s) or 1)[0]:
            hits.append((key, score))
    hits.sort(key=lambda t: (-t[1], ref.key_seq[t[0]]))
    return hits[:k]


@pytest.mark.parametrize("worlds", [(2, 3), (3, 2)])
def test_reshard_rebuckets_without_loss_or_duplication(pm, worlds):
    old_world, new_world = worlds
    rng = np.random.default_rng(31)
    dim = 8
    n = 90
    keys = [f"doc{i}" for i in range(n)]
    db = rng.normal(size=(n, dim)).astype(np.float32)
    ref = _single(dim)
    ref.add(keys, db)
    ref.remove(keys[::9])
    live = [k for k in keys if k in ref.key_to_slot]

    # old world: born from a committed cut (a 1→N reshard), the way
    # rank-local shards exist in practice
    seed_state = _snap(ref, pm, 1)
    old = [_single(dim) for _ in range(old_world)]
    for r, shard in enumerate(old):
        _restore(shard, pm, _reshard_envelope([seed_state], r, old_world),
                 rank=r, world=old_world)
        assert all(shard_owner(shard_hash(k), old_world) == r
                   for k in shard.key_to_slot)
    states = [_snap(s, pm, 2, rank=r, world=old_world) for r, s in enumerate(old)]

    # new world: every rank folds ALL old chains through its keep set
    new = [_single(dim) for _ in range(new_world)]
    for r, shard in enumerate(new):
        _restore(shard, pm, _reshard_envelope(states, r, new_world),
                 rank=r, world=new_world)
    got = {}
    for r, shard in enumerate(new):
        for k in shard.key_to_slot:
            assert k not in got, f"{k} restored on ranks {got[k]} and {r}"
            got[k] = r
            assert shard_owner(shard_hash(k), new_world) == r
    assert set(got) == set(live)
    for shard in new:
        for k in shard.key_to_slot:
            assert shard.key_seq[k] == ref.key_seq[k]
    for _ in range(4):
        q = rng.normal(size=(dim,)).astype(np.float32)
        assert _merged_answer(new, ref, q, 10) == ref.search(q[None, :], 10)[0]
    # a resharded restore is rebased: the next cut writes a fresh base
    s2 = _snap(new[0], pm, 2, rank=0, world=new_world)
    assert len(s2["segments"]) == 1
    assert s2["segments"][0]["rows"] == len(new[0])


@pytest.mark.parametrize("shards", [(2, 3), (3, 2)])
def test_sharded_index_reshards_on_restore(pm, shards):
    """A cut of an N-shard index restores into an M-shard one: every key
    re-buckets through the current owner mint, answers bit-identical."""
    n_old, n_new = shards
    rng = np.random.default_rng(32)
    dim = 8
    old = ShardedKnnIndex(dim, make_mesh(devices=["cpu"] * n_old, axes=("dp",)))
    ref = _single(dim)
    for target in (old, ref):
        target.add([f"k{i}" for i in range(300)],
                   np.random.default_rng(33).normal(size=(300, dim)).astype(np.float32))
        target.remove([f"k{i}" for i in range(0, 300, 11)])
    state = _snap(old, pm, 1)
    new = ShardedKnnIndex(dim, make_mesh(devices=["cpu"] * n_new, axes=("dp",)))
    _restore(new, pm, state)
    assert len(new) == len(ref) and sum(new.shard_fill()) == len(ref)
    for key, slot in new.key_to_slot.items():
        assert slot // new.local_cap == shard_owner(shard_hash(key), n_new)
    q = rng.normal(size=(5, dim)).astype(np.float32)
    _assert_bit_identical(new.search(q, 12), ref.search(q, 12))


# -- the adapter ---------------------------------------------------------------


def test_index_adapter_snapshot_roundtrip():
    """Operator-persistence hooks on index adapters: state survives a
    snapshot/load cycle and answers stay identical."""
    from pathway_tpu_torch.stdlib.indexing.bm25 import _Bm25Adapter
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _KnnAdapter

    a = _KnnAdapter(4, "cos", device="cpu")
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(10, 4)).astype(np.float32)
    for i in range(10):
        a.add(i, vecs[i], {"i": i})
    before = a.search([(vecs[3], 2, None)])

    b = _KnnAdapter(4, "cos", device="cpu")
    b.load_state(a.snapshot_state())
    assert b.search([(vecs[3], 2, None)]) == before
    assert b.meta == a.meta

    p = _Bm25Adapter()
    p.add(1, "the quick fox", None)
    p.add(2, "lazy dog", None)
    q = _Bm25Adapter()
    q.load_state(p.snapshot_state())
    assert q.search([("fox", 2, None)]) == p.search([("fox", 2, None)])


def test_adapter_meta_rides_the_segments(pm, mesh8):
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _KnnAdapter

    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(20, 4)).astype(np.float32)
    for mesh in (None, mesh8):
        a = _KnnAdapter(4, "cos", mesh=mesh, device="cpu")
        a.add_batch([(i, vecs[i], {"lang": "en" if i % 2 else "fr"}) for i in range(20)])
        a.remove(4)
        state = _snap(a, pm, 1)
        assert state["__index_segments__"]
        b = _KnnAdapter(4, "cos", device="cpu")
        _restore(b, pm, state)
        assert b.meta == a.meta
        query = [(vecs[7], 3, lambda m: m["lang"] == "en")]
        assert b.search(query) == a.search(query)


# -- the port against the JAX package ------------------------------------------


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        ws = [s for _, s in w]
        np.testing.assert_allclose([s for _, s in g], ws, rtol=0, atol=TOL)
        for j, ((gk, _), (wk, _)) in enumerate(zip(g, w)):
            left = ws[j - 1] - ws[j] if j else np.inf
            right = ws[j] - ws[j + 1] if j + 1 < len(ws) else np.inf
            if min(left, right) > TOL:
                assert gk == wk


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_cut_and_restore_match_the_jax_package(tmp_path, mesh8, kind):
    import jax

    from pathway_tpu.ops.knn import KnnShard as JaxShard
    from pathway_tpu.parallel import ShardedKnnIndex as JaxSharded
    from pathway_tpu.parallel import make_mesh as jax_make_mesh
    from pathway_tpu.persistence import Backend as JBackend
    from pathway_tpu.persistence import Config as JConfig
    from pathway_tpu.persistence import PersistenceManager as JPM
    from pathway_tpu.persistence import index_snapshot as jisnap

    dim = 8
    jpm = JPM(JConfig(backend=JBackend.filesystem(str(tmp_path / "jax"))))
    ppm = PersistenceManager(Config(backend=Backend.filesystem(str(tmp_path / "port"))))
    if kind == "single":
        make_port = lambda: _single(dim)  # noqa: E731
        make_jax = lambda: JaxShard(dim, "cos")  # noqa: E731
    else:
        if len(jax.devices()) < 8:
            pytest.skip("needs the virtual 8-device CPU mesh")
        jmesh = jax_make_mesh(8, axes=("dp",), shape=(8,))
        make_port = lambda: ShardedKnnIndex(dim, mesh8)  # noqa: E731
        make_jax = lambda: JaxSharded(dim, jmesh)  # noqa: E731
    port, jx = make_port(), make_jax()
    rng = np.random.default_rng(40)
    q = rng.normal(size=(4, dim)).astype(np.float32)
    for tag, _ in enumerate(_interleave(port, jx, rng, dim), start=1):
        with isnap.cut(ppm, tag):
            pstate = port.snapshot_state()
        with jisnap.cut(jpm, tag):
            jstate = jx.snapshot_state()
        assert [(s["rows"], s["removes"]) for s in pstate["segments"]] == [
            (s["rows"], s["removes"]) for s in jstate["segments"]
        ]
        assert pstate["next_seq"] == jstate["next_seq"]
        fresh_p, fresh_j = make_port(), make_jax()
        with isnap.cut(ppm, 0):
            fresh_p.load_state(pstate)
        with jisnap.cut(jpm, 0):
            fresh_j.load_state(jstate)
        _close(fresh_p.search(q, 7), fresh_j.search(q, 7))
        assert fresh_p.key_seq == fresh_j.key_seq


# -- engine level: a persisted streaming vector store, restarted ---------------

TINY = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp=128, max_len=64)
QUERIES = ["document 3 about topic", "notes on rivers and mountains", "document 44"]

# One run of a persisted streaming vector store in its own process:
#   child.py PACKAGE DOCS STORE OUT N_FILES PARAMS
# serves /v1/statistics and /v1/retrieve on a free port, waits until the
# statistics count N_FILES, retrieves QUERIES, writes what it saw to OUT
# and ends the process (a streaming pw.run serves until then).
CHILD = r'''
import dataclasses, importlib, json, os, pickle, socket, sys, threading, time
pkg, folder, pdir, out, n_files, params_path = sys.argv[1:7]
n_files = int(n_files)
TINY, QUERIES = json.loads(os.environ["CHILD_CONFIG"])
pw = importlib.import_module(pkg)
enc_mod = importlib.import_module(f"{pkg}.models.encoder")
if pkg == "pathway_tpu_torch":
    import torch
    from pathway_tpu_torch.models import convert
    cfg = dataclasses.replace(enc_mod.EncoderConfig(**TINY), dtype=torch.float32)
    with open(params_path, "rb") as f:
        params = convert.flax_params_to_torch(pickle.load(f), cfg)
    enc = enc_mod.SentenceEncoder(cfg, params=params, device="cpu")
    index_params = {"device": "cpu"}
else:
    import jax.numpy as jnp
    cfg = dataclasses.replace(enc_mod.EncoderConfig(**TINY), dtype=jnp.float32)
    enc = enc_mod.SentenceEncoder(cfg, seed=0)
    index_params = {}
embedded = []
encode = enc.encode
def counting_encode(texts, *a, **kw):
    embedded.extend(texts)
    return encode(texts, *a, **kw)
enc.encode = counting_encode
mods = {m: importlib.import_module(f"{pkg}.{m}") for m in (
    "xpacks.llm.embedders", "xpacks.llm.vector_store",
    "xpacks.llm.question_answering", "xpacks.llm.mocks",
    "stdlib.indexing.nearest_neighbors")}
nn = mods["stdlib.indexing.nearest_neighbors"]
added = []
add_batch = nn._KnnAdapter.add_batch
def counting_add_batch(self, rows):
    added.extend(k for k, _, _ in rows)
    return add_batch(self, rows)
nn._KnnAdapter.add_batch = counting_add_batch
qa = mods["xpacks.llm.question_answering"]
docs = pw.io.fs.read(folder, format="binary", with_metadata=True,
                     mode="streaming", autocommit_duration_ms=50)
store = mods["xpacks.llm.vector_store"].VectorStoreServer(
    docs, embedder=mods["xpacks.llm.embedders"].SentenceTransformerEmbedder(encoder=enc),
    index_params=index_params)
rag = qa.BaseRAGQuestionAnswerer(
    llm=mods["xpacks.llm.mocks"].IdentityMockChat(), indexer=store, search_topk=3)
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
rag.build_server(host="127.0.0.1", port=port)
config = pw.persistence.Config(backend=pw.persistence.Backend.filesystem(pdir),
                               persistence_mode="OPERATOR_PERSISTING")
errors = []
def run():
    try:
        pw.run(persistence_config=config)
    except BaseException as e:
        errors.append(repr(e))
threading.Thread(target=run, daemon=True).start()
client = qa.RAGClient(host="127.0.0.1", port=port, timeout=30)
count = 0
while not errors and count < n_files:
    try:
        count = int(client.statistics().get("file_count") or 0)
    except OSError:
        time.sleep(0.1)
        continue
    time.sleep(0.1)
answers = []
if not errors:
    for q in QUERIES:
        res = client.retrieve(q, k=3)
        answers.append([(os.path.basename(r["metadata"]["path"]), r["dist"]) for r in res])
    client.statistics()  # the engine has stepped past the last cut
with open(out, "w") as f:
    json.dump({"count": count, "added": added, "embedded": embedded,
               "answers": answers, "errors": errors}, f, default=str)
sys.stdout.flush()
os._exit(0)
'''


def _write_docs(folder, lo, hi):
    os.makedirs(folder, exist_ok=True)
    for i in range(lo, hi):
        text = (
            f"document {i} about topic {i % 7} with words "
            + " ".join(str(j) for j in range(i % 5 + 3))
            if i < 40 else f"notes on rivers and mountains number {i}, document {i}"
        )
        with open(os.path.join(folder, f"d{i:03d}.txt"), "w") as f:
            f.write(text)


def _run_child(tmp_path, pkg, tag, n_files):
    out = tmp_path / f"{pkg}-{tag}.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "CHILD_CONFIG": json.dumps([TINY, QUERIES])}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "child.py"), pkg,
         str(tmp_path / pkg / "docs"), str(tmp_path / pkg / "store"),
         str(out), str(n_files), str(tmp_path / "params.pkl")],
        capture_output=True, text=True, timeout=180, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        res = json.load(f)
    assert not res["errors"], res["errors"]
    assert res["count"] == n_files
    return res


def test_persisted_vector_store_restarts_from_the_index_snapshot(tmp_path):
    import jax

    from pathway_tpu.models import encoder as jenc

    je = jenc.SentenceEncoder(
        dataclasses.replace(jenc.EncoderConfig(**TINY), dtype=jax.numpy.float32),
        seed=0,
    )
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, je.params), f)
    (tmp_path / "child.py").write_text(CHILD)
    runs = {}
    for pkg in ("pathway_tpu_torch", "pathway_tpu"):
        _write_docs(tmp_path / pkg / "docs", 0, 40)
        first = _run_child(tmp_path, pkg, 1, 40)
        store = tmp_path / pkg / "store"
        # the first run committed the index's segments with its cut
        assert (store / "marker" / "snapshot_commit").exists()
        segments = sorted(p.parent.parent.name for p in store.glob("index_segment/*/r0/*"))
        assert segments and all(s.startswith("knn") for s in segments)
        _write_docs(tmp_path / pkg / "docs", 40, 48)
        second = _run_child(tmp_path, pkg, 2, 48)
        runs[pkg] = (first, second)
    port1, port2 = runs["pathway_tpu_torch"]
    # every index node of the first run wrote all 40 documents; the
    # restart wrote only the 8 new ones to each, and embedded no old one
    n_indexes = len(port1["added"]) // 40
    assert n_indexes >= 1 and len(port1["added"]) == 40 * n_indexes
    assert len(port2["added"]) == 8 * n_indexes
    new_texts = {f"notes on rivers and mountains number {i}, document {i}"
                 for i in range(40, 48)}
    assert set(port2["embedded"]) - set(QUERIES) == new_texts
    for (p_first, p_second), (j_first, j_second) in [
        (runs["pathway_tpu_torch"], runs["pathway_tpu"])
    ]:
        assert len(j_second["added"]) == len(p_second["added"])
        for got, want in ((p_first, j_first), (p_second, j_second)):
            for g, w in zip(got["answers"], want["answers"], strict=True):
                assert [p for p, _ in g] == [p for p, _ in w]
                np.testing.assert_allclose([d for _, d in g], [d for _, d in w],
                                           rtol=0, atol=TOL)
    # the restart's answers reach the new documents
    assert any(p.startswith("d04") for p, _ in port2["answers"][1])


def test_rest_request_keys_stay_unique_across_runs():
    """A persisted program restores operator state that can still hold the
    rows of the previous run's last requests. The restarted server mints
    other keys for its requests, so a new request never joins one of
    those rows (a retrieve then answered with both requests' hits)."""
    from pathway_tpu_torch.internals.schema import schema_from_types
    from pathway_tpu_torch.io.http._server import PathwayWebserver, RestServerSubject

    schema = schema_from_types(query=str, k=int)

    def run_server():
        return RestServerSubject(
            PathwayWebserver(host="127.0.0.1", port=0), "/v1/retrieve", ("POST",),
            schema, True)

    first, restarted = run_server(), run_server()
    keys = [first._request_key(None) for _ in range(64)]
    assert len(set(keys)) == 64
    assert not set(keys) & {restarted._request_key(None) for _ in range(64)}
    # a request id stamped by the serving frontend keys the same row in
    # every run: a replayed request is an upsert
    assert first._request_key("r-7") == restarted._request_key("r-7")
