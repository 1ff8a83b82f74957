"""The port's sharded KNN index on eight CPU shards
(``make_mesh(devices=["cpu"] * 8)``), the counterpart of the JAX package's
virtual 8-device CPU mesh.

The battery of tests/test_sharded_parity.py, tests/test_parallel.py and
tests/test_sharded_vector_store.py against the port: for any interleaving
of inserts, deletes and queries, ``ShardedKnnIndex`` returns ids AND
scores bit-identical to a single ``KnnShard`` fed the same operations,
under both cross-shard merges (no tolerance: per-row scores do not depend
on the sharding, and equal scores order by insertion sequence on both
sides). Then the port against the JAX package's ``ShardedKnnIndex`` on
its 8-device mesh: ids equal wherever the gap to the next score exceeds
1e-5, scores within atol 1e-5 (both f32, JAX at precision="highest",
summed in another order).
"""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.internals import faults
from pathway_tpu_torch.internals.device import PLANE
from pathway_tpu_torch.ops import fused_knn
from pathway_tpu_torch.ops.knn import KnnShard
from pathway_tpu_torch.ops.topk import merge_topk, tree_merge_topk
from pathway_tpu_torch.parallel import (
    ShardedKnnIndex,
    best_factorization,
    make_mesh,
    sharded_topk,
)
from pathway_tpu_torch.parallel import sharded_knn as sk

TOL = 1e-5


@pytest.fixture
def mesh8():
    return make_mesh(devices=["cpu"] * 8, axes=("dp",), shape=(8,))


@pytest.fixture(autouse=True)
def _clean_plane():
    faults.clear_plan()
    PLANE.disarm()
    yield
    faults.clear_plan()
    PLANE.disarm()


def _pair(mesh, dim=16, metric="cos"):
    return (
        ShardedKnnIndex(dim, mesh, metric=metric),
        KnnShard(dim, metric, device="cpu"),
    )


def _assert_bit_identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # exact tuple equality: ids AND float scores, no tolerance
        assert g == w


# -- the mesh -----------------------------------------------------------------


def test_best_factorization():
    assert best_factorization(8) == (4, 2)
    assert best_factorization(1) == (1, 1)
    dp, tp = best_factorization(6)
    assert dp * tp == 6


def test_make_mesh_covers_devices():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.devices.size == 8
    assert set(mesh.axis_names) == {"dp", "tp"}
    assert mesh.shape == {"dp": 4, "tp": 2}
    # the shards of a dp-sharded structure: one device per dp row
    assert mesh.axis_devices("dp") == [torch.device("cpu")] * 4
    assert make_mesh(3, axes=("dp",), devices=["cpu"] * 8).shape == {"dp": 3}
    with pytest.raises(ValueError):
        make_mesh(4, axes=("dp",), shape=(3,), devices=["cpu"] * 4)


def test_make_mesh_defaults_to_the_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh(axes=("dp",))
    assert list(mesh.devices) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_auto_mesh_never_lays_shards_on_too_few_cards(monkeypatch):
    from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as nn

    for raw in ("", "0", "1", "x"):
        monkeypatch.setenv("PATHWAY_INDEX_SHARDS", raw)
        assert nn._auto_mesh() is None
    monkeypatch.setenv("PATHWAY_INDEX_SHARDS", "4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert nn._auto_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = nn._auto_mesh()
    assert mesh.shape == {"dp": 4}
    assert [d.index for d in mesh.devices] == [0, 1, 2, 3]


def test_adapter_builds_the_sharded_index_from_a_mesh(mesh8):
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _KnnAdapter

    ad = _KnnAdapter(4, "cos", mesh=mesh8)
    assert isinstance(ad.shard, ShardedKnnIndex)
    assert ad.device_sites() == ("knn.sharded_write", "knn.sharded_search")
    ad.add("a", np.ones(4, np.float32), {"x": 1})
    ad.add("b", -np.ones(4, np.float32), {"x": 2})
    (keys, scores), = ad.search([(np.ones(4, np.float32), 1, None)])
    assert keys == ("a",) and abs(scores[0] - 1.0) < TOL


# -- merges -------------------------------------------------------------------


def _partials(rng, n, q, k, ties=True):
    vals = [-np.sort(-rng.integers(0, 6, size=(q, k)).astype(np.float32), -1)
            for _ in range(n)]
    if not ties:
        vals = [v + rng.random((q, k)).astype(np.float32) * 1e-3 for v in vals]
        vals = [-np.sort(-v, -1) for v in vals]
    idx = [np.arange(s * k, (s + 1) * k, dtype=np.int32)[None].repeat(q, 0)
           for s in range(n)]
    return [torch.from_numpy(v) for v in vals], [torch.from_numpy(i) for i in idx]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_tree_merge_is_the_stable_shard_ordered_top_k(n):
    rng = np.random.default_rng(n)
    vals, idx = _partials(rng, n, 5, 6)
    got_v, got_i = tree_merge_topk(vals, idx, 6)
    # the gather merge: one stable sort of the lists in shard order
    av, ai = torch.cat(vals, 1), torch.cat(idx, 1)
    want_v, pos = torch.sort(av, dim=-1, descending=True, stable=True)
    assert torch.equal(got_v, want_v[:, :6])
    assert torch.equal(got_i, torch.gather(ai, 1, pos)[:, :6])
    gv, gi = sk.gather_merge_topk(vals, idx, 6)
    assert torch.equal(gv, got_v) and torch.equal(gi, got_i)


def test_tree_merge_takes_a_power_of_two():
    vals, idx = _partials(np.random.default_rng(0), 3, 2, 4)
    with pytest.raises(ValueError, match="power-of-two"):
        tree_merge_topk(vals, idx, 4)


def test_tree_merge_matches_the_jax_butterfly():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pathway_tpu.ops.topk import tree_merge_topk as jax_tree
    from pathway_tpu.parallel import make_mesh as jax_make_mesh
    from pathway_tpu.parallel._compat import compat_shard_map

    rng = np.random.default_rng(9)
    vals, idx = _partials(rng, 8, 3, 5)
    mesh = jax_make_mesh(8, axes=("dp",), shape=(8,))
    fn = compat_shard_map(
        lambda v, i: jax_tree(v[0], i[0], 5, "dp", 8),
        mesh, in_specs=(P("dp"), P("dp")), out_specs=(P(), P()),
    )
    want_v, want_i = jax.jit(fn)(
        jnp.asarray(np.stack([v.numpy() for v in vals])),
        jnp.asarray(np.stack([i.numpy() for i in idx])),
    )
    got_v, got_i = tree_merge_topk(vals, idx, 5)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_gather_merge_in_groups_keeps_shard_order(monkeypatch):
    """16 shards in one merge keep shard order: one merge call over every
    shard's list (no groups), ties to the lower shard, equal to the
    stable sort of the lists laid end to end and to the tree merge."""
    rng = np.random.default_rng(3)
    vals, idx = _partials(rng, 16, 4, 6)
    calls = []

    def counting(v, i, k):
        calls.append(tuple(v.shape))
        return fused_knn.topk_merge(v, i, k)

    monkeypatch.setattr(sk, "topk_merge", counting)
    got = sk.gather_merge_topk(vals, idx, 6)
    assert calls == [(16, 4, 6)]
    flat_v, flat_i = torch.cat(vals, -1), torch.cat(idx, -1)
    top, pos = torch.sort(flat_v, dim=-1, descending=True, stable=True)
    assert torch.equal(got[0], top[:, :6])
    assert torch.equal(got[1], torch.gather(flat_i, -1, pos[:, :6]))
    tv, ti = tree_merge_topk(vals, idx, 6)
    assert torch.equal(got[0], tv) and torch.equal(got[1], ti)


def test_merge_topk_is_the_two_list_step():
    vals, idx = _partials(np.random.default_rng(4), 2, 3, 4)
    v, i = merge_topk(vals[0], idx[0], vals[1], idx[1], 4)
    tv, ti = tree_merge_topk(vals, idx, 4)
    assert torch.equal(v, tv) and torch.equal(i, ti)


@pytest.mark.parametrize("raw,n,want", [
    ("tree", 8, "tree"), ("tree", 6, "gather"), ("gather", 8, "gather"),
    ("auto", 8, "tree"), ("auto", 3, "gather"), ("", 4, "tree"),
])
def test_merge_mode(monkeypatch, raw, n, want):
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", raw)
    assert sk._merge_mode(n) == want


@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_sharded_topk_matches_one_scan(merge):
    from pathway_tpu_torch.ops.topk import chunked_topk_scores

    rng = np.random.default_rng(5)
    db = torch.from_numpy(rng.normal(size=(8 * 64, 8)).astype(np.float32))
    valid = torch.from_numpy(rng.random(8 * 64) > 0.2)
    q = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    v, i = sharded_topk(q, list(db.split(64)), list(valid.split(64)), 20,
                        merge=merge)
    want_v, want_i = chunked_topk_scores(q, db, valid, 20)
    assert torch.equal(v, want_v) and torch.equal(i, want_i)


# -- sharded vs single shard ------------------------------------------------


@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_bulk_parity_bit_identical(mesh8, merge, monkeypatch):
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    rng = np.random.default_rng(0)
    db = rng.normal(size=(700, 16)).astype(np.float32)
    queries = rng.normal(size=(6, 16)).astype(np.float32)
    idx, ref = _pair(mesh8)
    idx.add(list(range(700)), db)
    ref.add(list(range(700)), db)
    _assert_bit_identical(idx.search(queries, 10), ref.search(queries, 10))


@pytest.mark.parametrize("metric", ["l2sq", "dot"])
@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_metric_parity_bit_identical(mesh8, merge, metric, monkeypatch):
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    rng = np.random.default_rng(8)
    db = rng.normal(size=(300, 12)).astype(np.float32)
    q = rng.normal(size=(4, 12)).astype(np.float32)
    idx, ref = _pair(mesh8, dim=12, metric=metric)
    idx.add(list(range(300)), db)
    ref.add(list(range(300)), db)
    idx.remove(list(range(0, 300, 7)))
    ref.remove(list(range(0, 300, 7)))
    _assert_bit_identical(idx.search(q, 9), ref.search(q, 9))


@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_insert_delete_query_interleavings(mesh8, merge, monkeypatch):
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    rng = np.random.default_rng(1)
    dim = 8
    idx, ref = _pair(mesh8, dim=dim)
    q = rng.normal(size=(4, dim)).astype(np.float32)

    def both(op, *args):
        getattr(idx, op)(*args)
        getattr(ref, op)(*args)

    def check(k=5):
        _assert_bit_identical(idx.search(q, k), ref.search(q, k))

    a = rng.normal(size=(60, dim)).astype(np.float32)
    both("add", [f"a{i}" for i in range(60)], a)
    check()
    both("remove", [f"a{i}" for i in range(0, 60, 3)])
    check()
    # re-add some removed keys with NEW vectors (fresh insertion seq)
    b = rng.normal(size=(10, dim)).astype(np.float32)
    both("add", [f"a{i * 3}" for i in range(10)], b)
    check()
    # upsert live keys in place
    c = rng.normal(size=(5, dim)).astype(np.float32)
    both("add", [f"a{i}" for i in range(1, 6)], c)
    check()
    both("remove", [f"a{i}" for i in range(60)])  # includes misses
    assert len(idx) == len(ref) == 0
    assert idx.search(q, 3) == ref.search(q, 3) == [[], [], [], []]


@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_deterministic_tie_break_is_insertion_order(mesh8, merge, monkeypatch):
    """Duplicate vectors score EXACTLY equal; both indexes must order
    them by insertion sequence — not by slot (which sharding scrambles)."""
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    dim = 8
    idx, ref = _pair(mesh8, dim=dim)
    base = np.ones((1, dim), np.float32)
    rng = np.random.default_rng(2)
    keys, vecs = [], []
    for i in range(30):
        if i % 3 == 0:
            keys.append(f"dup{i}")
            vecs.append(base[0])
        else:
            keys.append(f"uniq{i}")
            vecs.append(rng.normal(size=dim).astype(np.float32))
    vecs = np.stack(vecs)
    idx.add(keys, vecs)
    ref.add(keys, vecs)
    got = idx.search(base, 30)
    _assert_bit_identical(got, ref.search(base, 30))
    dup_hits = [k for k, s in got[0] if str(k).startswith("dup")]
    assert dup_hits[:10] == [f"dup{i}" for i in range(0, 30, 3)]
    # the duplicates sit on several shards
    assert len({idx.owner_shard(f"dup{i}") for i in range(0, 30, 3)}) > 1


def test_capacity_scales_across_shards_without_growth(mesh8):
    idx = ShardedKnnIndex(8, mesh8, metric="cos")
    local0 = idx.local_cap
    n = local0 * 8 // 2  # half the mesh's capacity — 4x one shard's
    rng = np.random.default_rng(3)
    idx.add(list(range(n)), rng.normal(size=(n, 8)).astype(np.float32))
    assert idx.local_cap == local0, "balanced fill must not force growth"
    fill = idx.shard_fill()
    assert sum(fill) == n
    assert all(f > 0 for f in fill), f"empty shard in {fill}"
    assert max(fill) < 2 * (n // 8), f"mint skew too high: {fill}"
    assert [v.shape[0] for v in idx.vectors] == [local0] * 8


def test_growth_remaps_slots_and_keeps_parity(mesh8):
    rng = np.random.default_rng(4)
    dim = 8
    idx, ref = _pair(mesh8, dim=dim)
    local0 = idx.local_cap
    n = local0 * 8 * 2  # every shard must double at least once
    db = rng.normal(size=(n, dim)).astype(np.float32)
    idx.add(list(range(n)), db)
    ref.add(list(range(n)), db)
    assert idx.local_cap > local0
    assert len(idx) == n and idx.capacity == 8 * idx.local_cap
    q = rng.normal(size=(3, dim)).astype(np.float32)
    _assert_bit_identical(idx.search(q, 10), ref.search(q, 10))
    # the remap kept every key→row mapping: each stored row is its own
    # exact nearest neighbor
    probe = [0, n // 2, n - 1]
    hits = idx.search(db[probe], 1)
    assert [h[0][0] for h in hits] == probe


def test_sharded_knn_matches_single_shard(mesh8):
    rng = np.random.default_rng(0)
    db = rng.normal(size=(500, 16)).astype(np.float32)
    queries = rng.normal(size=(5, 16)).astype(np.float32)
    idx = ShardedKnnIndex(16, mesh8, metric="cos")
    idx.add(list(range(500)), db)
    ref = KnnShard(16, "cos", device="cpu")
    ref.add(list(range(500)), db)
    for g, w in zip(idx.search(queries, k=3), ref.search(queries, k=3)):
        assert [k for k, _ in g] == [k for k, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5)


def test_sharded_knn_remove_and_grow(mesh8):
    rng = np.random.default_rng(1)
    db = rng.normal(size=(3000, 8)).astype(np.float32)  # forces growth
    idx = ShardedKnnIndex(8, mesh8, metric="cos")
    idx.add(list(range(3000)), db)
    assert idx.capacity >= 3000 and idx.capacity % 8 == 0
    idx.remove([42])
    res = idx.search(db[42][None, :], k=1)
    assert res[0][0][0] != 42


def test_k_beyond_live_rows_returns_everything(mesh8):
    idx = ShardedKnnIndex(4, mesh8, metric="cos")
    rng = np.random.default_rng(5)
    idx.add(list(range(10)), rng.normal(size=(10, 4)).astype(np.float32))
    hits = idx.search(rng.normal(size=(1, 4)).astype(np.float32), 50)
    assert len(hits[0]) == 10


def test_k_beyond_one_shard_keeps_parity(mesh8, monkeypatch):
    """k above a shard's rows: the per-shard partial is cut to the
    shard's rows and the merge widens back to k."""
    rng = np.random.default_rng(12)
    idx, ref = _pair(mesh8, dim=4)
    db = rng.normal(size=(600, 4)).astype(np.float32)
    idx.add(list(range(600)), db)
    ref.add(list(range(600)), db)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    for merge in ("tree", "gather"):
        monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
        _assert_bit_identical(idx.search(q, 300), ref.search(q, 300))


def test_owner_shard_is_stable_mint(mesh8):
    """Delta routing uses the SAME mint as the exchange plane: blake2b
    digest mod world — world-independent, so a re-shard re-buckets."""
    from pathway_tpu_torch.parallel.procgroup import shard_hash
    from pathway_tpu_torch.parallel.protocol import shard_owner

    idx = ShardedKnnIndex(4, mesh8, metric="cos")
    for key in ["a", 17, ("t", 3)]:
        assert idx.owner_shard(key) == shard_owner(shard_hash(key), 8)
    rng = np.random.default_rng(6)
    keys = [f"k{i}" for i in range(64)]
    idx.add(keys, rng.normal(size=(64, 4)).astype(np.float32))
    for key in keys:
        slot = idx.key_to_slot[key]
        assert slot // idx.local_cap == idx.owner_shard(key)
        # the row sits in its owner's buffer at the local slot
        s, local = divmod(slot, idx.local_cap)
        assert bool(idx.valid[s][local])


def test_owner_shard_matches_the_jax_package():
    from pathway_tpu.parallel.procgroup import shard_hash as jax_hash

    from pathway_tpu_torch.parallel.procgroup import shard_hash

    for key in ["a", 17, ("t", 3), "doc000123.txt"]:
        assert shard_hash(key) == jax_hash(key)


def test_sharded_search_device_site_effective_flops(mesh8):
    from pathway_tpu_torch.internals.monitoring import ProberStats

    rng = np.random.default_rng(7)
    idx = ShardedKnnIndex(8, mesh8, metric="cos")
    idx.add(list(range(50)), rng.normal(size=(50, 8)).astype(np.float32))
    q = rng.normal(size=(2, 8)).astype(np.float32)
    idx.search(q, 3)
    stats = ProberStats()
    PLANE.arm(None, stats)
    try:
        idx.search(q, 3)
        idx.add([999], rng.normal(size=(1, 8)).astype(np.float32))
    finally:
        PLANE.disarm()
    agg = stats.device_sites.get("knn.sharded_search")
    assert agg is not None and agg[0] == 1
    # 50 live rows in a 1024-slot mesh: effective far below padded
    assert 0 < agg[6] < agg[3]
    assert "knn.sharded_write" in stats.device_sites


def test_injected_grow_oom_refuses_growth_and_keeps_serving(mesh8):
    from pathway_tpu_torch.internals import device as devsup

    rng = np.random.default_rng(11)
    idx = ShardedKnnIndex(8, mesh8)
    first = rng.normal(size=(400, 8)).astype(np.float32)
    idx.add(list(range(400)), first)
    local = idx.local_cap
    want = idx.search(first[:2], 3)
    faults.install_plan({"rules": [
        {"point": "device.oom", "action": "raise"},
    ]})
    more = rng.normal(size=(2000, 8)).astype(np.float32)
    with pytest.raises(devsup.DeviceOom):
        idx.add(list(range(400, 2400)), more)
    # growth refused: the committed rows still serve, nothing half-done
    assert idx.local_cap == local and len(idx) == 400
    assert idx.search(first[:2], 3) == want
    faults.clear_plan()
    idx.add(list(range(400, 2400)), more)
    assert len(idx) == 2400 and idx.local_cap > local


def test_fused_knn_wrapper_runs_the_plain_version_on_the_cpu(mesh8):
    """On CPU tensors the kernel wrappers run their plain versions and
    count no launch."""
    before = dict(fused_knn.LAUNCHES)
    idx = ShardedKnnIndex(8, mesh8)
    rng = np.random.default_rng(13)
    idx.add(list(range(100)), rng.normal(size=(100, 8)).astype(np.float32))
    idx.search(rng.normal(size=(2, 8)).astype(np.float32), 4)
    assert fused_knn.LAUNCHES == before


# -- the port against the JAX package ------------------------------------------


def _jax_mesh8():
    import jax

    from pathway_tpu.parallel import make_mesh as jax_make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")
    return jax_make_mesh(8, axes=("dp",), shape=(8,))


def _assert_close_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        ws = [s for _, s in w]
        np.testing.assert_allclose([s for _, s in g], ws, rtol=0, atol=TOL)
        for j, ((gk, _), (wk, _)) in enumerate(zip(g, w)):
            left = ws[j - 1] - ws[j] if j else np.inf
            right = ws[j] - ws[j + 1] if j + 1 < len(ws) else np.inf
            if min(left, right) > TOL:
                assert gk == wk, f"rank {j}: {gk} vs {wk}"


@pytest.mark.parametrize("merge", ["tree", "gather"])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_matches_the_jax_sharded_index(mesh8, merge, metric, monkeypatch):
    from pathway_tpu.parallel import ShardedKnnIndex as JaxSharded

    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    jmesh = _jax_mesh8()
    rng = np.random.default_rng(20)
    dim = 16
    port = ShardedKnnIndex(dim, mesh8, metric=metric)
    ref = JaxSharded(dim, jmesh, metric=metric, precision="highest")
    q = rng.normal(size=(5, dim)).astype(np.float32)
    ops = [
        ("add", [f"d{i}" for i in range(1500)],
         rng.normal(size=(1500, dim)).astype(np.float32)),
        ("remove", [f"d{i}" for i in range(0, 1500, 4)]),
        ("add", [f"d{i}" for i in range(0, 400, 8)],
         rng.normal(size=(50, dim)).astype(np.float32)),
    ]
    for op, *args in ops:
        getattr(port, op)(*args)
        getattr(ref, op)(*args)
        assert len(port) == len(ref)
        assert port.local_cap == ref.local_cap
        assert port.shard_fill() == ref.shard_fill()
        _assert_close_answers(port.search(q, 12), ref.search(q, 12))


# -- the vector store on the sharded index -------------------------------------


def _answered(table):
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    captures = GraphRunner().run_tables(table)
    seen, out = set(), []
    for key, row, _, d in captures[0].updates:
        if d > 0 and key not in seen:
            seen.add(key)
            out.append(row)
    return out


def test_vector_store_with_mesh_sharded_index(mesh8):
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.mocks import DeterministicMockEmbedder
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    pw.internals.parse_graph.G.clear()
    docs = pw.debug.table_from_markdown(
        "\n".join(
            ["data | meta"]
            + [f"document number {i} about topic {i % 7} | f{i}.txt" for i in range(40)]
        )
    ).select(
        data=pw.this.data,
        _metadata=pw.apply_with_type(
            lambda p: pw.Json({"path": p, "modified_at": 1, "seen_at": 2}),
            pw.Json,
            pw.this.meta,
        ),
    )
    server = VectorStoreServer(
        docs, embedder=DeterministicMockEmbedder(dimension=16), mesh=mesh8,
    )
    assert isinstance(server.index.inner_index.make_adapter().shard, ShardedKnnIndex)
    queries = pw.debug.table_from_markdown(
        """
        query | k
        document number 13 about topic 6 | 3
        """,
        schema=VectorStoreServer.RetrieveQuerySchema,
    )
    rows = _answered(server.retrieve_query(queries))
    results = rows[0][0].value
    assert len(results) == 3
    # deterministic embedder: the exact text is its own nearest neighbor
    assert results[0]["text"] == "document number 13 about topic 6"
    assert results[0]["dist"] < 1e-5
    pw.internals.parse_graph.G.clear()


def test_sharded_index_inner_matches_unsharded(mesh8):
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnn

    rng = np.random.default_rng(0)
    vecs = {i: tuple(rng.normal(size=6)) for i in range(50)}

    def replies(mesh_arg):
        pw.internals.parse_graph.G.clear()
        docs = pw.debug.table_from_markdown(
            "\n".join(["i"] + [str(i) for i in range(50)])
        ).select(
            i=pw.this.i, emb=pw.apply_with_type(lambda i: vecs[i], tuple, pw.this.i)
        )
        queries = pw.debug.table_from_markdown("q\n1\n2").select(
            q=pw.this.q,
            emb=pw.apply_with_type(lambda q: vecs[q * 10], tuple, pw.this.q),
        )
        inner = BruteForceKnn(
            data_column=docs.emb, dimensions=6, metric="cos", mesh=mesh_arg,
            device="cpu",
        )
        res = inner.query(queries.emb, number_of_matches=3)
        captures = GraphRunner().run_tables(
            res.select(pw.this.q, reply=res["_pw_index_reply"])
        )
        out = {}
        for row in captures[0].state.rows.values():
            out[row[0]] = [mid for mid, _ in row[1]]
        pw.internals.parse_graph.G.clear()
        return out

    sharded = replies(mesh8)
    assert sharded == replies(None)
    assert sorted(sharded) == [1, 2] and all(len(v) == 3 for v in sharded.values())


def test_update_while_serving_stress(mesh8):
    """Writers add and remove while readers search: no search fails or
    returns a key that was never added, and the final state answers like
    a single shard fed the same operations."""
    import sys
    import threading

    rng = np.random.default_rng(14)
    dim = 8
    idx, ref = _pair(mesh8, dim=dim)
    batches = [
        ([f"w{b}_{i}" for i in range(40)], rng.normal(size=(40, dim)).astype(np.float32))
        for b in range(30)
    ]
    q = rng.normal(size=(3, dim)).astype(np.float32)
    known = {k for keys, _ in batches for k in keys}
    errors, stop = [], threading.Event()

    def reader():
        try:
            while not stop.is_set():
                for hits in idx.search(q, 7):
                    assert all(key in known for key, _ in hits)
        except BaseException as e:  # reported by the assertion below
            errors.append(e)

    def writer():
        try:
            for b, (keys, vecs) in enumerate(batches):
                idx.add(keys, vecs)
                if b % 3 == 2:
                    idx.remove(keys[::2])
        except BaseException as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=reader) for _ in range(6)]
        w = threading.Thread(target=writer)
        for t in readers + [w]:
            t.start()
        w.join(timeout=60)
        stop.set()
        for t in readers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not w.is_alive() and not any(t.is_alive() for t in readers)
    assert errors == []
    for b, (keys, vecs) in enumerate(batches):
        ref.add(keys, vecs)
        if b % 3 == 2:
            ref.remove(keys[::2])
    _assert_bit_identical(idx.search(q, 7), ref.search(q, 7))


def test_hits_resolved_after_a_growth_keep_their_keys(mesh8, monkeypatch):
    """A search whose readback lands after a growth laid the global slots
    out anew scans again, and names the keys it scored."""
    rng = np.random.default_rng(15)
    idx = ShardedKnnIndex(8, mesh8)
    db = rng.normal(size=(300, 8)).astype(np.float32)
    idx.add(list(range(300)), db)
    want = idx.search(db[:4], 3)
    real = sk.sharded_topk

    grown = []

    class GrowsOnReadback:
        """The values' readback runs after the lock is released: a
        writer grows the index right then (once)."""

        def __init__(self, t):
            self.t = t

        def cpu(self):
            if not grown:
                grown.append(idx.local_cap)
                idx._grow_to_local(idx.local_cap * 4)
            return self.t.cpu()

    def topk(*a, **kw):
        vals, slots = real(*a, **kw)
        return GrowsOnReadback(vals), slots

    monkeypatch.setattr(sk, "sharded_topk", topk)
    local = idx.local_cap
    got = idx.search(db[:4], 3)
    assert idx.local_cap == 4 * local
    assert got == want


def test_searches_racing_growing_adds_keep_their_keys(mesh8):
    """Readers search while a writer's adds grow the index again and
    again: every hit names a key that was added, with that key's own
    score — a slot read back under one layout is never looked up in the
    key maps of another."""
    import sys
    import threading

    rng = np.random.default_rng(16)
    dim, batch, n = 8, 64, 8 * 1024
    q = rng.normal(size=(4, dim)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    errors = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(12):
            vecs = rng.normal(size=(n, dim)).astype(np.float32)
            score = qn @ (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).T
            idx = ShardedKnnIndex(dim, mesh8)
            idx.add(list(range(batch)), vecs[:batch])
            stop = threading.Event()

            def reader():
                try:
                    while not stop.is_set():
                        for qi, hits in enumerate(idx.search(q, 256)):
                            for key, s in hits:
                                assert abs(s - score[qi, key]) < TOL, (key, s)
                except BaseException as e:  # reported by the assertion below
                    errors.append(e)

            readers = [threading.Thread(target=reader) for _ in range(4)]
            for t in readers:
                t.start()
            try:
                for b in range(batch, n, batch):
                    idx.add(list(range(b, b + batch)), vecs[b:b + batch])
            finally:
                stop.set()
                for t in readers:
                    t.join(timeout=60)
            assert not any(t.is_alive() for t in readers)
            assert idx.local_cap >= 1024
    finally:
        sys.setswitchinterval(interval)
    assert errors == []


def test_a_growth_during_the_key_lookup_waits_for_it(mesh8, monkeypatch):
    """A growing add that arrives while a search looks its slots up in
    the key maps waits until the lookup is done: the hits keep their
    keys."""
    import threading

    rng = np.random.default_rng(18)
    idx = ShardedKnnIndex(8, mesh8)
    db = rng.normal(size=(900, 8)).astype(np.float32)
    idx.add(list(range(300)), db[:300])
    want = idx.search(db[:4], 5)
    real = sk.resolve_hits
    writers = []

    def resolve(*a, **kw):
        if not writers:
            writers.append(threading.Thread(
                target=idx.add, args=(list(range(300, 900)), db[300:])))
            writers[0].start()
            writers[0].join(timeout=0.5)
        return real(*a, **kw)

    monkeypatch.setattr(sk, "resolve_hits", resolve)
    local = idx.local_cap
    got = idx.search(db[:4], 5)
    writers[0].join(timeout=60)
    assert idx.local_cap > local and len(idx) == 900
    assert got == want


@pytest.mark.parametrize("n_queries,dim", [(1, 384), (1, 64), (3, 64), (32, 384)])
@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_parity_at_shapes_where_the_cpu_product_rounds_by_shape(
    mesh8, merge, n_queries, dim, monkeypatch
):
    """The CPU BLAS rounds a row's score by the product's shape (one query
    row takes another kernel than many, and the row count picks among
    others); the plain product's fixed-shape granules keep the sharded
    index bit-identical to one shard at these shapes too."""
    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    rng = np.random.default_rng(17)
    db = rng.normal(size=(3000, dim)).astype(np.float32)
    q = rng.normal(size=(n_queries, dim)).astype(np.float32)
    idx, ref = _pair(mesh8, dim=dim)
    for index in (idx, ref):
        index.add(list(range(3000)), db)
        index.remove(list(range(0, 3000, 9)))
    _assert_bit_identical(idx.search(q, 10), ref.search(q, 10))


def test_sharded_sites_note_each_new_bucket_once(mesh8):
    """``knn.sharded_write`` / ``knn.sharded_search`` note a recompile on
    each new bucket of the shared bucket functions, as the JAX package's
    sites do; the shards' own kernel-pair site (``knn.fused``) is not
    reached on the CPU, where the plain scan runs."""
    from pathway_tpu_torch.internals.device import (
        sharded_search_bucket, sharded_write_bucket,
    )
    from pathway_tpu_torch.internals.monitoring import ProberStats

    idx, _ = _pair(mesh8)
    stats = ProberStats()
    PLANE.arm(None, stats)
    rng = np.random.default_rng(0)
    writes, searches = set(), set()
    try:
        for n in (5, 5, 9, 3000):  # 3000 rows grow the shards
            idx.add([f"{n}-{i}" for i in range(n)],
                    rng.normal(size=(n, 16)).astype(np.float32))
            writes.add(sharded_write_bucket(n, idx.capacity))
        for q, k in ((1, 5), (1, 5), (3, 5), (3, 9)):
            idx.search(rng.normal(size=(q, 16)).astype(np.float32), k)
            searches.add(sharded_search_bucket(q, idx.n_shards, idx.local_cap, k, None))
    finally:
        PLANE.disarm()
    assert stats.device_recompiles == {
        "knn.sharded_write": len(writes), "knn.sharded_search": len(searches)}
    assert len(writes) == 3 and len(searches) == 3
