"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, and the device plane's CUDA paths (records timed on CUDA
events, CUDA OOM classification). They skip where there is no CUDA device; on a machine with one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the repository's conftest prepares JAX, which this file
does not use.) Tolerances: slots exact wherever the plain gap to a
neighbouring score exceeds 1e-5, values rtol 1e-5 — the kernel's 3xTF32
products (hi·hi + hi·lo + lo·hi, each operand split into two TF32 parts)
carry fp32's accuracy and are summed in another order. Where a score is
near zero against its terms (randn rows of a few dims, the l2sq form
2s - |q|^2 - |x|^2), the value check takes the larger of rtol 1e-5 and the
3xTF32 error bound: each product is off by at most about 2^-21 of its
size (the dropped lo·lo term and the TF32 rounding residuals), so a score
is off by at most 2^-20 of the sum of its terms' sizes (2·Σ|q_d·x_d|, plus
|q|^2 + |x|^2 for l2sq), twice that for headroom on the fp32 sums; there
slots must be equal wherever the gap exceeds twice that bound.

The one-pass instance (``precision="default"``) is held against its plain
version, the fp32 product of the TF32-rounded operands: every product of
two TF32 values is exact in fp32, so the two differ only in the order of
their sums. D products summed one after another are off by at most
(D - 1)·2^-24 of the sum of their sizes. The kernel adds more: at most
16 products on one accumulator (two wgmmas at 64 queries a CTA, one at
8..32), whose 15 additions truncate (2^-23 each), then up to 3 fp32 adds
of its accumulators a stage and one a stage, (D - 1 + 30 + D/32)·2^-24 of
Σ|q_d·x_d| in all. The bound taken is (D + 32)·2^-24 of the 3xTF32
check's sum of terms (2·Σ|q_d·x_d|, which covers it), and slots equal
wherever the gap exceeds twice that.
"""

import pytest
import torch

from pathway_tpu_torch.ops import fused_knn, topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bound(q, db, pi, k, metric):
    """The 3xTF32 error bound of each plain top-k score (module docstring)."""
    rows = db[pi[:, :k].long()]                                  # [Q, k, D]
    terms = 2.0 * (q[:, None, :].abs() * rows.abs()).sum(-1)
    if metric == "l2sq":
        terms = terms + (q * q).sum(-1, keepdim=True) + (rows * rows).sum(-1)
    return 2.0 ** -20 * terms


def _bound1(q, db, pi, k, metric):
    """The one-pass instance's summation-order bound (module docstring)."""
    return 2.0 ** -4 * (q.shape[1] + 32) * _bound(q, db, pi, k, metric)


def _check(v, i, pv, pi, k, bound=None):
    torch.cuda.synchronize()
    fin = torch.isfinite(pv[:, :k])
    assert torch.equal(torch.isfinite(v), fin)
    if bound is None:
        torch.testing.assert_close(v[fin], pv[:, :k][fin], rtol=1e-5, atol=0)
    else:
        err = (v - pv[:, :k]).abs()[fin]
        tol = torch.maximum(1e-5 * pv[:, :k].abs(), bound)[fin]
        assert (err <= tol).all(), f"max err {err.max().item()}, worst excess {(err - tol).max().item()}"
    gap = pv[:, :-1] - pv[:, 1:]
    left = torch.cat([torch.full_like(gap[:, :1], float("inf")), gap[:, : k - 1]], 1)
    # two scores may swap only where their errors can bridge the gap
    need = 1e-5 if bound is None else torch.clamp(2.0 * bound, min=1e-5)
    clear = (torch.minimum(left, gap[:, :k]) > need) & fin
    assert torch.equal(i[clear], pi[:, :k][clear])


@pytest.mark.parametrize(
    "Q,N,D,k,metric",
    [
        (1, 300, 8, 128, "dot"),
        (3, 1000, 16, 5, "dot"),
        (33, 5000, 64, 17, "l2sq"),
        (70, 20000, 384, 10, "l2sq"),
        (256, 65536, 384, 10, "dot"),
    ],
)
def test_fused_topk_matches_plain(gen, Q, N, D, k, metric):
    q = torch.randn(Q, D, generator=gen, device="cuda")
    db = torch.randn(N, D, generator=gen, device="cuda")
    valid = torch.rand(N, generator=gen, device="cuda") > 0.2
    sq = (db * db).sum(-1)
    v, i = fused_knn.fused_topk_scores(q, db, valid, k, sq_norms=sq, metric=metric)
    pv, pi = topk.chunked_topk_scores(q, db, valid, min(k + 1, N), sq_norms=sq, metric=metric)
    if pv.shape[1] == k:  # no k+1-th entry: pad so every gap is defined
        pv = torch.cat([pv, torch.full_like(pv[:, :1], float("-inf"))], 1)
    _check(v, i, pv, pi, k, _bound(q, db, pi, k, metric))


def test_exact_ties_go_to_the_lower_slot(gen):
    q = torch.randn(4, 64, generator=gen, device="cuda")
    db = torch.randn(70000, 64, generator=gen, device="cuda")
    valid = torch.ones(70000, dtype=torch.bool, device="cuda")
    slots = [7, 30000, 69999]
    db[slots] = q[0] * 3.0
    v, i = fused_knn.fused_topk_scores(q, db, valid, 5)
    torch.cuda.synchronize()
    assert i[0, :3].tolist() == slots
    assert v[0, 0] == v[0, 1] == v[0, 2]


def test_partial_and_merge_match_plain(gen):
    q = torch.randn(40, 128, generator=gen, device="cuda")
    db = torch.randn(50000, 128, generator=gen, device="cuda")
    valid = torch.rand(50000, generator=gen, device="cuda") > 0.5
    pv, pi = fused_knn.knn_partial(q, db, valid, 12, 2048)
    wv, wi = fused_knn.knn_partial_plain(q, db, valid, 12, 2048)
    torch.cuda.synchronize()
    torch.testing.assert_close(pv, wv, rtol=1e-5, atol=0)
    mv, mi = fused_knn.topk_merge(pv, pi, 12)
    xv, xi = fused_knn.topk_merge_plain(pv, pi, 12)
    torch.cuda.synchronize()
    assert torch.equal(mv, xv) and torch.equal(mi, xi)


def test_missing_entries_and_limits(gen):
    q = torch.randn(2, 8, generator=gen, device="cuda")
    db = torch.randn(256, 8, generator=gen, device="cuda")
    valid = torch.zeros(256, dtype=torch.bool, device="cuda")
    valid[[5, 9]] = True
    v, i = fused_knn.fused_topk_scores(q, db, valid, 4)
    torch.cuda.synchronize()
    assert torch.isfinite(v[:, :2]).all() and torch.isinf(v[:, 2:]).all()
    assert ((i >= 0) & (i < 256)).all()
    with pytest.raises(ValueError):
        fused_knn.fused_topk_scores(q, db, valid, 8193)
    with pytest.raises(TypeError):
        fused_knn.fused_topk_scores(q.double(), db, valid, 4)
    with pytest.raises(ValueError):
        fused_knn.fused_topk_scores(q[:, :6].contiguous(), db[:, :6].contiguous(), valid, 4)


def _vs_scan(gen, Q, N, D, k, metric="dot", valid_p=0.2):
    q = torch.randn(Q, D, generator=gen, device="cuda")
    db = torch.randn(N, D, generator=gen, device="cuda")
    valid = torch.rand(N, generator=gen, device="cuda") > valid_p
    sq = (db * db).sum(-1)
    v, i = fused_knn.fused_topk_scores(q, db, valid, k, sq_norms=sq, metric=metric)
    pv, pi = topk.chunked_topk_scores(q, db, valid, min(k + 1, N), sq_norms=sq, metric=metric)
    if pv.shape[1] == k:
        pv = torch.cat([pv, torch.full_like(pv[:, :1], float("-inf"))], 1)
    assert v.shape == (Q, k) and i.shape == (Q, k)
    _check(v, i, pv, pi, k, _bound(q, db, pi, k, metric))


@pytest.mark.parametrize(
    "Q,N,k",
    [(5, 50000, 129), (9, 40000, 1024), (3, 20000, 8192), (2, 256, 200)],
)
def test_large_k_matches_plain(gen, Q, N, k):
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    _, splits = fused_knn.plan_splits(Q, N, k, n_sm)
    merges = fused_knn.LAUNCHES["topk_merge"]
    _vs_scan(gen, Q, N, 64, k)
    # one split: the partial is the answer and the merge is not launched
    assert (fused_knn.LAUNCHES["topk_merge"] == merges) == (splits == 1)


@pytest.mark.parametrize("D", [4, 36, 384])
@pytest.mark.parametrize("metric", ["dot", "l2sq"])
def test_dims_zero_filled_in_the_mma_k_step(gen, D, metric):
    _vs_scan(gen, 6, 30000, D, 10, metric)


@pytest.mark.parametrize("Q", [1, 7, 9, 129])
@pytest.mark.parametrize("k", [10, 200])
def test_masked_query_columns(gen, Q, k):
    assert fused_knn.plan_tile(Q, k)[0] in fused_knn._TILES
    _vs_scan(gen, Q, 20000, 32, k)


def test_ragged_split_tail_with_exact_tie(gen):
    q = torch.randn(3, 40, generator=gen, device="cuda")
    db = torch.randn(1300, 40, generator=gen, device="cuda")
    valid = torch.ones(1300, dtype=torch.bool, device="cuda")
    # the last split covers rows 1024..1299: a full 256-row tile, then a
    # tail tile of 20 rows from 1280; the tie straddles the two
    slots = [1279, 1280, 1299]
    db[slots] = q[0] * 3.0
    pv, pi = fused_knn.knn_partial(q, db, valid, 7, 512)
    wv, wi = fused_knn.knn_partial_plain(q, db, valid, 7, 512)
    torch.cuda.synchronize()
    torch.testing.assert_close(pv, wv, rtol=1e-5, atol=0)
    v, i = fused_knn.topk_merge(pv, pi, 7)
    torch.cuda.synchronize()
    assert i[0, :3].tolist() == slots
    assert v[0, 0] == v[0, 1] == v[0, 2]
    assert pi[2, 0, :3].tolist() == slots


@pytest.mark.parametrize("splits,kp,k", [(32, 1024, 1024), (4, 8192, 8192), (132, 10, 10)])
def test_merge_at_the_largest_plan(gen, splits, kp, k):
    Q = 3
    assert splits * kp <= fused_knn._MERGE_MAX
    # few distinct values, so that ties are many; each split's list sorted
    v = torch.randint(0, 50, (splits, Q, kp), generator=gen, device="cuda").float()
    v[:, :, -3:] = float("-inf")
    v = torch.sort(v, dim=-1, descending=True).values.contiguous()
    i = torch.randint(0, 1 << 20, (splits, Q, kp), generator=gen, device="cuda",
                      dtype=torch.int32)
    mv, mi = fused_knn.topk_merge(v, i, k)
    xv, xi = fused_knn.topk_merge_plain(v, i, k)
    torch.cuda.synchronize()
    assert torch.equal(mv, xv) and torch.equal(mi, xi)


# -- the partial kernel's edges: wgmma N padding, query tiles, the buffers ------


def _edge_case(gen, Q, N, D, k, rows=None, metric="dot", valid_p=0.2, ties=(),
               precision="highest"):
    """The partial against ``knn_partial_plain`` split by split, and the
    pair against ``chunked_topk_scores``, under the rules above (at
    ``precision``, the instance against its own plain version); ``ties``
    are slots that hold query 0 exactly (times 3 for dot: the top score)."""
    bound = _bound if precision == "highest" else _bound1
    p = {"precision": precision}
    q = torch.randn(Q, D, generator=gen, device="cuda")
    db = torch.randn(N, D, generator=gen, device="cuda")
    valid = torch.rand(N, generator=gen, device="cuda") > valid_p
    for s in ties:
        db[s] = q[0] * (1.0 if metric == "l2sq" else 3.0)
        valid[s] = True
    sq = (db * db).sum(-1)
    if rows is None:
        rows = fused_knn.plan_splits(Q, N, k, torch.cuda.get_device_properties(0).multi_processor_count)[0]
    pv, pi = fused_knn.knn_partial(q, db, valid, k, rows, sq_norms=sq, metric=metric, **p)
    wv, wi = fused_knn.knn_partial_plain(q, db, valid, k + 1, rows, sq_norms=sq,
                                         metric=metric, **p)
    assert pv.shape == (-(-N // rows), Q, k)
    for s in range(pv.shape[0]):
        _check(pv[s], pi[s], wv[s], wi[s], k, bound(q, db, wi[s], k, metric))
    v, i = fused_knn.fused_topk_scores(q, db, valid, k, sq_norms=sq, metric=metric, **p)
    pv2, pi2 = topk.chunked_topk_scores(q, db, valid, min(k + 1, N), sq_norms=sq,
                                        metric=metric, **p)
    pad = k + 1 - pv2.shape[1]  # fewer rows than k + 1: every gap defined
    pv2 = torch.nn.functional.pad(pv2, (0, pad), value=float("-inf"))
    pi2 = torch.nn.functional.pad(pi2, (0, pad), value=0)
    _check(v, i, pv2, pi2, k, bound(q, db, pi2, k, metric))
    if ties:
        assert i[0, :len(ties)].tolist() == list(ties)
        assert (v[0, :len(ties)] == v[0, 0]).all()
    return v, i


@pytest.mark.parametrize("Q", [1, 7, 8, 9, 64, 255, 256])
def test_partial_kernel_query_tile_edges(gen, Q):
    """N padding of the wgmma (Q = 1 runs as N = 8) and the query tiles'
    edges: a full instance, one query past it, four tiles of 64."""
    assert fused_knn.plan_tile(Q, 10).n >= min(Q, fused_knn._TILES[-1])
    _edge_case(gen, Q, 20000, 96, 10)


@pytest.mark.parametrize("k", [1, 10, 32, 33, 1024, 8192])
def test_partial_kernel_k_edges(gen, k):
    """One selection for every k: the register sort up to 32, the shared
    sort above, and K_MAX with its buffers in a scratch tensor."""
    _edge_case(gen, 3, 40000, 64, k)


def test_partial_kernel_ragged_split_invalid_rows_l2sq_and_tile_boundary_tie(gen):
    """A split of 5077 - 6 * 768 = 469 rows (not a multiple of the 128-row
    tile), half the rows invalid, the l2sq epilogue, and an exact tie
    across a tile boundary (rows 127 and 128) and a split boundary."""
    _edge_case(gen, 5, 5077, 40, 7, rows=768, metric="l2sq", valid_p=0.5,
               ties=(127, 128, 768, 5076))


@pytest.mark.parametrize("N,k", [(300, 1024), (1000, 8192)])
def test_partial_kernel_capacity_below_k(gen, N, k):
    """An index of fewer rows than k: every valid row comes back, the rest
    of the list is -inf with a slot in range."""
    v, i = _edge_case(gen, 2, N, 16, k)
    n_valid = torch.isfinite(v).sum(-1)
    assert (n_valid == n_valid[0]).all() and int(n_valid[0]) <= N
    assert ((i >= 0) & (i < N)).all()


# -- the one-pass instance (precision="default") on the same edges --------------


@pytest.mark.parametrize("Q", [1, 7, 8, 9, 64, 255, 256])
def test_one_pass_query_tile_edges(gen, Q):
    assert fused_knn.plan_tile(Q, 10, "default").passes == 1
    before = dict(fused_knn.LAUNCHES)
    _edge_case(gen, Q, 20000, 96, 10, precision="default")
    # the one-pass instance ran, the 3xTF32 one did not
    assert fused_knn.LAUNCHES["fused_knn_tf32"] == before["fused_knn_tf32"] + 2
    assert fused_knn.LAUNCHES["fused_knn"] == before["fused_knn"]


@pytest.mark.parametrize("k", [1, 10, 32, 33, 1024, 8192])
def test_one_pass_k_edges(gen, k):
    _edge_case(gen, 3, 40000, 64, k, precision="default")


@pytest.mark.parametrize("metric", ["dot", "l2sq"])
def test_one_pass_ragged_split_invalid_rows_and_tie_across_a_split(gen, metric):
    """A ragged last split (469 rows), half the rows invalid, and an exact
    tie across a tile boundary (rows 127 and 128) and a split boundary."""
    _edge_case(gen, 5, 5077, 40, 7, rows=768, metric=metric, valid_p=0.5,
               ties=(127, 128, 768, 5076), precision="default")


@pytest.mark.parametrize("Q", [32, 256])
def test_one_pass_at_d384_within_3e_5_of_its_plain_version(gen, Q):
    """Unit rows at the served width (d = 384): every score of the partial
    within 3e-5 of the plain version's ((383 + 42)·2^-24 = 2.53e-5 of
    Σ|q_i x_i| <= 1 at the 64-query instance's chains, the longest, which
    Q = 256 runs; Q = 32 runs the 32-query one, (383 + 28)·2^-24), slots
    equal where the plain gap exceeds 6e-5, and the instance's scores
    within 1e-3 of the 3xTF32 instance's."""
    q = torch.nn.functional.normalize(torch.randn(Q, 384, generator=gen, device="cuda"), dim=-1)
    db = torch.nn.functional.normalize(torch.randn(1 << 17, 384, generator=gen, device="cuda"), dim=-1)
    valid = torch.ones(1 << 17, dtype=torch.bool, device="cuda")
    pv, pi = fused_knn.knn_partial(q, db, valid, 10, 8192, precision="default")
    wv, wi = fused_knn.knn_partial_plain(q, db, valid, 11, 8192, precision="default")
    torch.cuda.synchronize()
    assert (pv - wv[..., :10]).abs().max().item() <= 3e-5
    gap = wv[..., :-1] - wv[..., 1:]
    left = torch.cat([torch.full_like(gap[..., :1], float("inf")), gap[..., :9]], -1)
    clear = torch.minimum(left, gap) > 6e-5
    assert torch.equal(pi[clear], wi[..., :10][clear])
    hv, _ = fused_knn.fused_topk_scores(q, db, valid, 10)
    dv, _ = fused_knn.fused_topk_scores(q, db, valid, 10, precision="default")
    torch.cuda.synchronize()
    assert (hv - dv).abs().max().item() <= 1e-3


def test_device_plane_closes_a_knn_search_record_on_cuda_events(gen):
    """An armed plane times ``knn.search`` between two CUDA events and
    delivers the record without a synchronize of its own."""
    from pathway_tpu_torch.internals import device as devplane
    from pathway_tpu_torch.internals.monitoring import ProberStats
    from pathway_tpu_torch.ops.knn import KnnShard

    shard = KnnShard(64, "cos", capacity=1 << 16)
    x = torch.randn((1 << 16, 64), generator=gen, device="cuda")
    shard.add(range(1 << 16), x)
    stats = ProberStats()
    devplane.PLANE.arm(None, stats)
    try:
        hits = shard.search(x[:4], 10)
    finally:
        devplane.PLANE.disarm()  # flushes the pending records
    assert [h[0][0] for h in hits] == [0, 1, 2, 3]
    count, wall_s, device_s = stats.device_sites["knn.search"][:3]
    assert count == 1
    assert 0.0 < device_s <= wall_s
    assert stats.device_hbm_available and stats.device_hbm_peak > 0


def test_classify_device_error_knows_cuda_oom(gen):
    from pathway_tpu_torch.internals import device as devplane

    oom = None
    try:
        torch.empty(1 << 50, dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as e:
        oom = e
    assert oom is not None
    assert devplane.classify_device_error(oom) == "oom"
    assert devplane.classify_device_error(
        torch.cuda.OutOfMemoryError("plain")
    ) == "oom"


def test_encoder_forward_replays_a_graph_equal_to_eager(gen):
    """On the card ``SentenceEncoder.forward`` replays one CUDA graph per
    padded (batch, seq) bucket; the replay gives the eager forward's
    embeddings bit for bit, on each bucket and on a repeat."""
    from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder

    graphed = SentenceEncoder(EncoderConfig.bge_small(), batch_size=64)
    eager = SentenceEncoder(EncoderConfig.bge_small(), batch_size=64)

    def eager_forward(ids, mask, **_):
        with torch.inference_mode():
            return eager.model(ids, mask)

    eager.forward = eager_forward
    texts = ["the cat sat on the mat", "dogs are loyal pets " * 12,
             "a river of light runs through the stone table " * 6]
    for batch in (texts[:1], texts, texts * 7, texts):
        assert (graphed.encode(batch) == eager.encode(batch)).all()
    assert len(graphed._graphs) >= 3


# -- the sharded index and snapshots on the card ---------------------------------


def _unit(gen, n, d):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@pytest.mark.parametrize("merge", ["tree", "gather"])
@pytest.mark.parametrize("Q,k", [(1, 10), (32, 10), (64, 1024)])
def test_sharded_matches_single_on_the_card(gen, monkeypatch, merge, Q, k):
    """Four shards on one card against one KnnShard: ids and scores
    bit-identical (the partial kernel scores a row the same wherever it
    sits), an exact three-way tie across shards ordered by key_seq, and
    the search launched the partial and the merge kernels."""
    from pathway_tpu_torch.ops.knn import KnnShard
    from pathway_tpu_torch.parallel import ShardedKnnIndex, make_mesh

    monkeypatch.setenv("PATHWAY_INDEX_MERGE", merge)
    n, d = 1 << 14, 64
    mesh = make_mesh(devices=["cuda"] * 4, axes=("dp",), shape=(4,))
    sharded, single = ShardedKnnIndex(d, mesh), KnnShard(d, "cos")
    x = _unit(gen, n, d)
    q = _unit(gen, Q, d)
    keys = [f"k{i}" for i in range(n)]
    # three keys on different shards hold query 0 itself
    ties = []
    for i, key in enumerate(keys):
        owners = {sharded.owner_shard(t) for t in ties}
        if i % 100 and sharded.owner_shard(key) not in owners:
            ties.append(key)
        if len(ties) == 3:
            break
    for t in ties:
        x[keys.index(t)] = q[0]
    for index in (sharded, single):
        for i in range(0, n, 4096):
            index.add(keys[i:i + 4096], x[i:i + 4096])
        index.remove(keys[::100])
    before = dict(fused_knn.LAUNCHES)
    got, want = sharded.search(q, k), single.search(q, k)
    assert got == want
    assert [key for key, _ in got[0][:3]] == sorted(ties, key=single.key_seq.get)
    assert fused_knn.LAUNCHES["fused_knn"] - before["fused_knn"] >= 5
    assert fused_knn.LAUNCHES["topk_merge"] > before["topk_merge"]


def test_tree_merge_runs_the_merge_kernel(gen):
    from pathway_tpu_torch.ops.topk import merge_topk, tree_merge_topk

    vals = [torch.sort(torch.randint(0, 5, (16, 32), generator=gen, device="cuda")
                       .float(), dim=-1, descending=True)[0] for _ in range(8)]
    idx = [torch.arange(32 * s, 32 * (s + 1), device="cuda", dtype=torch.int32)
           .repeat(16, 1) for s in range(8)]
    before = fused_knn.LAUNCHES["topk_merge"]
    v, i = tree_merge_topk(vals, idx, 32)
    assert fused_knn.LAUNCHES["topk_merge"] - before == 7
    cv, ci = tree_merge_topk([t.cpu() for t in vals], [t.cpu() for t in idx], 32)
    torch.cuda.synchronize()
    assert torch.equal(v.cpu(), cv) and torch.equal(i.cpu(), ci)
    mv, mi = merge_topk(vals[0].cpu(), idx[0].cpu(), vals[1].cpu(), idx[1].cpu(), 32)
    assert torch.equal(mv, merge_topk(vals[0], idx[0], vals[1], idx[1], 32)[0].cpu())


def test_snapshot_restore_on_the_card_is_bit_identical(gen, tmp_path):
    """Cut, delta cut and restore of a card-resident index, into a
    single shard and into four shards: bit-identical answers."""
    from pathway_tpu_torch.ops.knn import KnnShard
    from pathway_tpu_torch.parallel import ShardedKnnIndex, make_mesh
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceManager
    from pathway_tpu_torch.persistence import index_snapshot as isnap

    pm = PersistenceManager(Config(backend=Backend.filesystem(str(tmp_path))))
    n, d = 1 << 14, 64
    live = KnnShard(d, "cos")
    live.add(range(n), _unit(gen, n, d))
    with isnap.cut(pm, 1):
        live.snapshot_state()
    live.remove(range(0, n, 64))
    live.add(range(n, n + n // 64), _unit(gen, n // 64, d))
    with isnap.cut(pm, 2):
        state = live.snapshot_state()
    assert [s["rows"] for s in state["segments"]] == [n, n // 64]
    q = _unit(gen, 256, d)
    want = live.search(q, 10)
    mesh = make_mesh(devices=["cuda"] * 4, axes=("dp",), shape=(4,))
    for fresh in (KnnShard(d, "cos"), ShardedKnnIndex(d, mesh)):
        with isnap.cut(pm, 0):
            fresh.load_state(state)
        assert fresh.search(q, 10) == want


# -- checkpoints, supervised ingest and the recompile counter on the card ----

_SMALL = dict(vocab_size=30522, hidden=64, layers=2, heads=4, mlp=128, max_len=512)


def _write_hf_checkpoint(path, cfg, seed):
    """A checkpoint of ``cfg``'s geometry in the HF layout, written without
    ``transformers`` (the card's machine has none): the port's seeded
    weights under BERT's names. Returns them under the port's names."""
    import json
    import os
    import shutil

    from pathway_tpu_torch.models import init_params
    from pathway_tpu_torch.models.tokenizer import VOCAB_ASSET

    params = init_params(cfg, seed)
    names = {"tok_embed": "embeddings.word_embeddings",
             "pos_embed": "embeddings.position_embeddings",
             "type_embed": "embeddings.token_type_embeddings",
             "ln_embed": "embeddings.LayerNorm"}
    for i in range(cfg.layers):
        hf, pt = f"encoder.layer.{i}.", f"blocks.{i}."
        for proj in ("query", "key", "value"):
            names[pt + f"attention.{proj}"] = hf + f"attention.self.{proj}"
        names.update({pt + "attention.out": hf + "attention.output.dense",
                      pt + "ln_attn": hf + "attention.output.LayerNorm",
                      pt + "mlp_in": hf + "intermediate.dense",
                      pt + "mlp_out": hf + "output.dense",
                      pt + "ln_mlp": hf + "output.LayerNorm"})
    sd = {}
    for name, t in params.items():
        module, leaf = name.rsplit(".", 1)
        sd[f"bert.{names[module]}.{leaf}"] = t
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden,
                   "num_hidden_layers": cfg.layers, "num_attention_heads": cfg.heads,
                   "intermediate_size": cfg.mlp,
                   "max_position_embeddings": cfg.max_len}, f)
    shutil.copy(VOCAB_ASSET, os.path.join(path, "vocab.txt"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True}, f)
    return params


def test_checkpoint_loads_on_the_card(gen, tmp_path, monkeypatch):
    """``SentenceEncoder(checkpoint=dir)`` on the card: the weights bit for
    bit, read without ``transformers``, and embeddings within cosine 0.999
    of the same checkpoint on the CPU (bf16 on both)."""
    import sys

    from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder

    monkeypatch.setitem(sys.modules, "transformers", None)
    cfg = EncoderConfig(**_SMALL)
    written = _write_hf_checkpoint(str(tmp_path), cfg, seed=7)
    enc = SentenceEncoder(checkpoint=str(tmp_path))
    assert enc.device.type == "cuda" and enc.config == cfg
    loaded = enc.model.state_dict()
    assert loaded.keys() == written.keys()
    for name, t in written.items():
        assert torch.equal(loaded[name].cpu(), t), name
    cpu = SentenceEncoder(checkpoint=str(tmp_path), device="cpu")
    texts = ["the cat sat on the mat", "checkpoint weights on the card " * 9]
    a, b = enc.encode(texts), cpu.encode(texts)
    assert ((a * b).sum(-1) >= 0.999).all()


def _small_pipeline():
    from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder
    from pathway_tpu_torch.ops import IngestPipeline, KnnShard

    enc = SentenceEncoder(EncoderConfig(**_SMALL), batch_size=64)
    shard = KnnShard(enc.embed_dim, "cos", capacity=256)
    return enc, shard, IngestPipeline(enc, shard)


def test_supervised_ingest_on_the_card(gen):
    """Two transient H2D staging faults: two retries at ``ingest.fused``,
    every row equal to a fault-free ingest; a permanent fault raises."""
    from pathway_tpu_torch.internals import device as devplane
    from pathway_tpu_torch.internals import faults
    from pathway_tpu_torch.internals.monitoring import ProberStats
    from pathway_tpu_torch.ops import IngestPipeline, KnnShard

    enc, shard, pipe = _small_pipeline()
    keys = [f"d{i}" for i in range(128)]
    texts = [f"document {i} about topic {i % 7}" for i in range(128)]
    batches = [(keys[i:i + 32], texts[i:i + 32]) for i in range(0, 128, 32)]
    clean = KnnShard(enc.embed_dim, "cos", capacity=256)
    IngestPipeline(enc, clean).run(iter(batches))
    stats = ProberStats()
    faults.install_plan({"rules": [
        {"point": "device.h2d", "hits": [1, 3], "action": "raise"}]})
    devplane.PLANE.arm(None, stats)
    try:
        assert pipe.run(iter(batches)) == 128
    finally:
        devplane.PLANE.disarm()
        faults.clear_plan()
    assert stats.device_dispatch_retries.get("ingest.fused") == 2
    got = shard.vectors[[shard.key_to_slot[k] for k in keys]]
    want = clean.vectors[[clean.key_to_slot[k] for k in keys]]
    assert torch.equal(got, want)
    faults.install_plan({"rules": [
        {"point": "device.h2d", "action": "raise", "retryable": False}]})
    try:
        with pytest.raises(faults.InjectedFault):
            pipe.run(iter([(["new"], ["a new document"])]))
    finally:
        faults.clear_plan()
    assert len(shard) == 128


def test_ingest_without_staged_h2d_equals_staged_on_the_card(gen):
    """``stage_h2d=False``: no side stream and no copy event, the batch
    copied at dispatch; the embeddings and the index rows equal, bit for
    bit, those of the staged ingest (the default) of the same batches."""
    from pathway_tpu_torch.ops import IngestPipeline, KnnShard

    enc, staged_shard, staged = _small_pipeline()
    plain_shard = KnnShard(enc.embed_dim, "cos", capacity=256)
    plain = IngestPipeline(enc, plain_shard, stage_h2d=False)
    assert staged.stage_h2d and staged._copy_stream is not None
    assert not plain.stage_h2d and plain._copy_stream is None
    keys = [f"d{i}" for i in range(96)]
    texts = [f"document {i} about topic {i % 5} " * (1 + i % 4) for i in range(96)]
    batches = [(keys[i:i + 32], texts[i:i + 32]) for i in range(0, 96, 32)]
    embs = {}
    for name, pipe in (("plain", plain), ("staged", staged)):
        embs[name] = []
        for b in batches:
            st = pipe._stage(*b)
            wire, event = st[1], st[3]
            # off: host tensors and no event; on: on the card, with its event
            assert (event is None) == (name == "plain"), name
            assert {t.device.type for t in wire} == {
                "cpu" if name == "plain" else "cuda"}, name
            embs[name].append(pipe._dispatch(st).clone())
        torch.cuda.synchronize()
    for a, b in zip(embs["plain"], embs["staged"]):
        assert torch.equal(a, b)
    got = plain_shard.vectors[[plain_shard.key_to_slot[k] for k in keys]]
    want = staged_shard.vectors[[staged_shard.key_to_slot[k] for k in keys]]
    assert torch.equal(got, want)
    # and through run(), the producer thread's path
    again = KnnShard(enc.embed_dim, "cos", capacity=256)
    assert IngestPipeline(enc, again, stage_h2d=False).run(iter(batches)) == 96
    assert torch.equal(again.vectors[[again.key_to_slot[k] for k in keys]], want)


def test_recompiles_equal_the_captured_graphs(gen):
    """A new bucket at ``encoder.forward`` or ``ingest.fused`` is exactly
    one CUDA graph captured for it."""
    from pathway_tpu_torch.internals import device as devplane
    from pathway_tpu_torch.internals.monitoring import ProberStats

    enc, _, pipe = _small_pipeline()
    stats = ProberStats()
    devplane.PLANE.arm(None, stats)
    try:
        texts = ["short text", "a much longer text about many things " * 8]
        for batch in (texts[:1], texts, texts * 9, texts):
            enc.encode(batch)
        for n in (3, 3, 40):
            pipe.ingest([f"k{i}" for i in range(n)], (texts * n)[:n])
    finally:
        devplane.PLANE.disarm()
    graphs = {}
    for site, _ in enc._graphs:
        graphs[site] = graphs.get(site, 0) + 1
    assert all(g is not None for g in enc._graphs.values())
    assert graphs["encoder.forward"] >= 3 and graphs["ingest.fused"] == 2
    assert {s: stats.device_recompiles[s] for s in graphs} == graphs


# -- the Device Doctor on the card -------------------------------------------


def test_device_hbm_bytes_reads_the_card_in_a_fresh_process(gen, tmp_path):
    """In a process that has not touched the card, the doctor's budget is
    the card's own memory, not the 8 GiB fallback of a host without one."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PATHWAY_DEVICE_HBM_BYTES"}
    env["PYTHONPATH"] = repo
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch\n"
         "from pathway_tpu_torch.internals.device import device_hbm_bytes\n"
         "b = device_hbm_bytes()\n"
         "print(b, torch.cuda.get_device_properties(0).total_memory,"
         " torch.cuda.memory_allocated())"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    budget, total, allocated = map(int, out.stdout.split())
    assert budget == total != 8 * 1024**3
    assert allocated == 0


def test_device_plan_on_the_card_launches_and_allocates_nothing(gen):
    from pathway_tpu_torch.analysis.device_plan import (
        WorkloadSpec,
        analyze_device_plan,
    )
    from pathway_tpu_torch.models import EncoderConfig

    import gc

    gc.collect()  # garbage of earlier tests is not the doctor's to free
    torch.cuda.synchronize()
    before = (dict(fused_knn.LAUNCHES), torch.cuda.memory_allocated(),
              torch.cuda.memory_stats()["allocated_bytes.all.allocated"])
    report = analyze_device_plan(
        workload=WorkloadSpec(corpus_rows=1 << 20, initial_capacity=1 << 20,
                              query_batches=(1, 32, 256),
                              ingest_batches=((256, 150),) * 4),
        config=EncoderConfig.bge_small(),
    )
    torch.cuda.synchronize()
    assert (dict(fused_knn.LAUNCHES), torch.cuda.memory_allocated(),
            torch.cuda.memory_stats()["allocated_bytes.all.allocated"]) == before
    assert report.verdict == "device-clean", report.render()
    assert report.hbm["budget_bytes"] == torch.cuda.get_device_properties(0).total_memory


def test_predicted_recompiles_equal_the_captured_graphs(gen):
    """The doctor's predictions at ``encoder.forward`` and ``ingest.fused``
    for the declared batches are exactly the CUDA graphs a fresh encoder
    captures when those batches are encoded and ingested."""
    from pathway_tpu_torch.analysis.device_plan import (
        WorkloadSpec,
        analyze_device_plan,
        join_profile,
    )
    from pathway_tpu_torch.internals import device as devplane
    from pathway_tpu_torch.internals.monitoring import ProberStats

    enc, shard, pipe = _small_pipeline()
    texts = ["short text", "a much longer text about many things " * 8]
    batches = [texts[:1], texts, texts * 9, texts]
    declared = tuple((len(b), enc.tokenizer(b)[0].shape[1]) for b in batches)
    report = analyze_device_plan(
        workload=WorkloadSpec(ingest_batches=declared, batch_cap=enc.batch_size,
                              initial_capacity=shard.capacity),
        config=enc.config,
    )
    stats = ProberStats()
    devplane.PLANE.arm(None, stats)
    try:
        for i, b in enumerate(batches):
            enc.encode(b)
            pipe.ingest([f"k{i}-{j}" for j in range(len(b))], b)
    finally:
        devplane.PLANE.disarm()
    graphs = {}
    for site, _ in enc._graphs:
        graphs[site] = graphs.get(site, 0) + 1
    for site in ("encoder.forward", "ingest.fused"):
        assert graphs[site] == report.predictions[site]["recompiles"], site
        assert {b for s, b in enc._graphs if s == site} == report.predictions[site]["buckets"]
    joined = join_profile(report, {"device_recompiles": dict(stats.device_recompiles)})
    assert joined.verdict == "device-clean"


def test_capture_survives_a_dead_encoder_in_a_cycle(gen):
    """An encoder that only the cyclic collector can free (its graphs
    included) must not be collected inside another encoder's capture,
    where destroying a graph is forbidden and would fail the capture: the
    collector is held off during a capture."""
    import gc

    import numpy as np

    from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder

    dead = SentenceEncoder(EncoderConfig(**_SMALL), batch_size=8)
    dead.encode(["one text"])
    assert dead._graphs
    dead.cycle = dead
    del dead
    live = SentenceEncoder(EncoderConfig(**_SMALL), batch_size=8)
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)  # a collection at almost every allocation
    try:
        emb = live.encode(["another text, another shape bucket " * 4])
    finally:
        gc.set_threshold(*threshold)
    assert np.isfinite(emb).all() and live._graphs


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_the_card_matches_full_attention(gen, causal):
    """The ``ring`` phase's check (a): eight shards of the one card, the
    reference test's geometry in f32 with TF32 off, at 2e-5."""
    from pathway_tpu_torch.parallel import make_mesh
    from pathway_tpu_torch.parallel.ring_attention import reference_attention, ring_attention

    q, k, v = (torch.randn((2, 4, 64, 16), generator=gen, device="cuda") for _ in range(3))
    mesh = make_mesh(devices=["cuda:0"] * 8, axes=("sp",))
    out = ring_attention(q, k, v, mesh, causal=causal)
    assert out.device.type == "cuda" and out.shape == q.shape
    torch.testing.assert_close(out, reference_attention(q, k, v, causal=causal),
                               rtol=2e-5, atol=2e-5)


def test_f32_train_step_on_the_card_equals_the_cpu_step(gen):
    """The ``train`` phase's check (c) at bge-small's width and depth:
    one f32 step of 8 pairs x 32 tokens on the card and on the CPU, loss
    at rtol 1e-4 and each gradient within 1e-4 of its largest |g|."""
    import dataclasses

    import numpy as np

    from chip_smoke import grad_mismatches
    from pathway_tpu_torch.models import EncoderConfig
    from pathway_tpu_torch.parallel import create_train_state, make_mesh, make_sharded_train_step

    cfg = dataclasses.replace(EncoderConfig.bge_small(), dtype=torch.float32)
    rng = np.random.default_rng(0)
    lens = rng.integers(8, 33, size=(2, 8))
    masks = [(np.arange(32)[None, :] < n[:, None]).astype(np.int32) for n in lens]
    ids = [rng.integers(3, cfg.vocab_size, size=(8, 32)).astype(np.int32) * m for m in masks]
    batch = {"q_ids": ids[0], "q_mask": masks[0], "d_ids": ids[1], "d_mask": masks[1]}
    out = {}
    for dev in ("cuda:0", "cpu"):
        mesh = make_mesh(devices=[dev], axes=("dp", "tp"), shape=(1, 1))
        state, model, tx = create_train_state(cfg, mesh, seed=7)
        state, loss = make_sharded_train_step(model, tx, mesh)(state, batch)
        assert loss.device.type == torch.device(dev).type and state.step == 1
        out[dev] = (float(loss), {n: p.grad for n, p in model.named_parameters()})
    assert abs(out["cuda:0"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    assert grad_mismatches(out["cuda:0"][1], out["cpu"][1], 1e-4) == []


def test_bge_small_cross_encoder_on_the_card_equals_the_cpu_twin(gen):
    """The ``rerank`` phase's check 3: the bge-small cross-encoder at f32
    on the card against the same weights and tokenizer on the CPU, on 16
    pairs, within 1e-4 of the largest |score|."""
    import dataclasses

    import numpy as np

    from chip_smoke import RR_CPU_REL, make_docs, vocab_words
    from pathway_tpu_torch.models import CrossEncoder, EncoderConfig

    cfg = dataclasses.replace(EncoderConfig.bge_small(), dtype=torch.float32)
    card = CrossEncoder(cfg, seed=0)
    cpu = CrossEncoder(cfg, params={k: v.cpu() for k, v in card.model.state_dict().items()},
                       device="cpu")
    cpu.tokenizer = card.tokenizer
    docs = make_docs(vocab_words(), np.random.default_rng(0), 16)
    pairs = [(" ".join(d.split()[:12]), docs[(i + 1) % 16]) for i, d in enumerate(docs)]
    assert next(card.model.parameters()).device.type == "cuda"
    on_card, on_cpu = card.score(pairs), cpu.score(pairs)
    assert on_card.shape == on_cpu.shape == (16,) and np.std(on_cpu) > 0
    assert np.abs(on_card - on_cpu).max() <= RR_CPU_REL * np.abs(on_card).max()


def test_cross_encoder_reranker_defaults_to_the_card(gen):
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    reranker = CrossEncoderReranker()
    assert {p.device.type for p in reranker._ce.model.parameters()} == {"cuda"}
    scores = reranker.func([{"text": "a document"}, "another document"], ["a query"] * 2)
    assert len(scores) == 2 and all(s == s and abs(s) < float("inf") for s in scores)
