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

    def eager_forward(ids, mask):
        with torch.inference_mode():
            return eager.model(ids, mask)

    eager.forward = eager_forward
    texts = ["the cat sat on the mat", "dogs are loyal pets " * 12,
             "a river of light runs through the stone table " * 6]
    for batch in (texts[:1], texts, texts * 7, texts):
        assert (graphed.encode(batch) == eager.encode(batch)).all()
    assert len(graphed._graphs) >= 3
