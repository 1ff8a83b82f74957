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


def _merges():
    """Merge launches so far, of either design."""
    return fused_knn.LAUNCHES["topk_merge"] + fused_knn.LAUNCHES["topk_merge_runs"]


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
    merges = _merges()
    _vs_scan(gen, Q, N, 64, k)
    # one split: the partial is the answer and the merge is not launched
    assert (_merges() == merges) == (splits == 1)


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
    """The old cap's largest merges (splits * kp = 32768 and 1320
    candidates) by both designs, each bit-equal to the plain merge."""
    Q = 3
    # few distinct values, so that ties are many; each split's list sorted
    v = torch.randint(0, 50, (splits, Q, kp), generator=gen, device="cuda").float()
    v[:, :, -3:] = float("-inf")
    v = torch.sort(v, dim=-1, descending=True).values.contiguous()
    i = torch.randint(0, 1 << 20, (splits, Q, kp), generator=gen, device="cuda",
                      dtype=torch.int32)
    xv, xi = fused_knn.topk_merge_plain(v, i, k)
    for design in ("block", "runs"):
        mv, mi = fused_knn.topk_merge(v, i, k, design=design)
        torch.cuda.synchronize()
        assert torch.equal(mv, xv) and torch.equal(mi, xi), design


def _runs(gen, splits, Q, k):
    """[splits, Q, k] sorted runs with every hard case of the run merge:
    few distinct values (ties across runs everywhere), -inf tails (the last
    eighth of every run), a tie across the edge of runs 0 and 1 (run 0
    ends in 7s, run 1 opens with them), and -0.0 beside +0.0 (half the
    zeros negative)."""
    v = torch.randint(-3, 40, (splits, Q, k), generator=gen, device="cuda").float()
    v = torch.sort(v, dim=-1, descending=True).values
    if splits > 1:
        v[0] = v[0].clamp(min=7.0)
        v[1] = v[1].clamp(max=7.0)
        v[1, :, :3] = 7.0
    v[..., k - max(1, k // 8):] = float("-inf")
    neg = (v == 0) & (torch.rand(v.shape, generator=gen, device="cuda") < 0.5)
    v = torch.where(neg, torch.full_like(v, -0.0), v).contiguous()
    i = torch.randint(0, 1 << 20, (splits, Q, k), generator=gen, device="cuda",
                      dtype=torch.int32)
    return v, i


@pytest.mark.parametrize("Q", [1, 256])
@pytest.mark.parametrize("splits,k", [(132, 8192), (132, 1024), (2, 10)])
def test_merge_past_the_old_cap_is_bit_equal_to_plain(gen, splits, k, Q):
    """Merges of up to 132 x 8192 candidates a query (the old one-CTA cap
    was 32768) in the design the wrapper picks, bit-equal to the plain
    merge: against the card's plain merge over the same runs with -0.0 made
    +0.0 (values compared as numbers), and bit for bit against the CPU's
    plain merge for the first and last query."""
    v, i = _runs(gen, splits, Q, k)
    design = fused_knn.merge_design(splits, k, k)
    assert design == ("block" if splits * k <= fused_knn._MERGE_CROSSOVER else "runs")
    assert (splits * k > fused_knn._BLOCK_MERGE_MAX) <= (design == "runs")
    before = dict(fused_knn.LAUNCHES)
    mv, mi = fused_knn.topk_merge(v, i, k)
    name = "topk_merge" if design == "block" else "topk_merge_runs"
    assert fused_knn.LAUNCHES[name] == before[name] + 1
    xv, xi = fused_knn.topk_merge_plain(v + 0.0, i, k)
    torch.cuda.synchronize()
    assert torch.equal(mi, xi) and torch.equal(mv, xv)
    rows = [0, Q - 1]
    cv, ci = fused_knn.topk_merge_plain(v[:, rows].cpu(), i[:, rows].cpu(), k)
    assert torch.equal(mi[rows].cpu(), ci)
    assert torch.equal(mv[rows].cpu().view(torch.int32), cv.view(torch.int32))


@pytest.mark.parametrize("Q", [1, 32])
@pytest.mark.parametrize("short", [255, 64, 0])
def test_run_merge_with_a_short_run_is_bit_equal_to_plain(gen, short, Q):
    """128 runs of 2,048 live values and a 129th of ``short`` (a split's
    tail: a shard of 262,399 rows at k = 8192 plans 128 splits of 2,048
    and one of 255), the rest -inf: a short run holds the co-rank
    bracket's lower end far below the r-th value, so the windows outgrow
    shared memory until a bisection narrows them. Bit-equal to the plain
    merge."""
    S, k = 129, 8192
    v = torch.randn((S, Q, k), generator=gen, device="cuda")
    v[:, :, 2048:] = float("-inf")
    v[-1, :, short:] = float("-inf")
    v = torch.sort(v, dim=-1, descending=True).values.contiguous()
    i = torch.randint(0, 1 << 20, (S, Q, k), generator=gen, device="cuda", dtype=torch.int32)
    mv, mi = fused_knn.topk_merge(v, i, k, design="runs")
    xv, xi = fused_knn.topk_merge_plain(v, i, k)
    torch.cuda.synchronize()
    assert torch.equal(mv, xv) and torch.equal(mi, xi)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_pair_at_k_8192_past_the_old_cap(gen, precision):
    """The pair at Q = 1, k = 8192 on a 2^18-row index: about one split
    a SM (the old cap allowed 4), each split's partial against its plain
    version, the run merge, and the answer against the plain scan."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    _, splits = fused_knn.plan_splits(1, 1 << 18, 8192, n_sm)
    assert splits * 8192 > fused_knn._BLOCK_MERGE_MAX and splits >= n_sm * 3 // 4
    before = fused_knn.LAUNCHES["topk_merge_runs"]
    _edge_case(gen, 1, 1 << 18, 64, 8192, ties=(5, 1 << 17, (1 << 18) - 1),
               precision=precision)
    assert fused_knn.LAUNCHES["topk_merge_runs"] == before + 1


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
    """One selection for every k: the register sort up to 32, the warps'
    and the CTA's sorts above, and K_MAX with its buffers in a scratch
    tensor."""
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


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("metric", ["dot", "l2sq"])
@pytest.mark.parametrize("k", [10, 100, 1024])
@pytest.mark.parametrize("Q", [1, 9, 32, 256])
def test_prefix_of_the_buffer_is_bit_equal_to_the_whole(gen, Q, k, metric, precision):
    """A search of the rows in use (``KnnShard.topk``: views of the first u
    rows) against the whole buffer, every row past u invalid: values and
    slots bit-equal. u is 397 granules of 256 rows, a whole number of no
    split's rows, so the prefix ends inside a split."""
    cap, u, D = 1 << 18, 397 * 256, 384
    q = torch.randn(Q, D, generator=gen, device="cuda")
    db = torch.randn(cap, D, generator=gen, device="cuda")
    valid = torch.rand(cap, generator=gen, device="cuda") > 0.1
    valid[u:] = False
    sq = (db * db).sum(-1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, _ = fused_knn.plan_splits(Q, u, k, n_sm)
    assert u % rows
    kw = dict(metric=metric, precision=precision)
    v, i = fused_knn.fused_topk_scores(q, db[:u], valid[:u], k, sq_norms=sq[:u], **kw)
    wv, wi = fused_knn.fused_topk_scores(q, db, valid, k, sq_norms=sq, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(wv).all()
    assert torch.equal(v, wv) and torch.equal(i, wi)


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


# -- the part's end: each query's live keys sorted, by one warp or the CTA -----


def _live_case(q, db, valid, k, rows, precision="highest"):
    """The partial at ``rows`` a split against its plain version, split by
    split (the rules above): each list non-increasing, its missing entries
    -inf at slot 0 past the live ones, every slot in range."""
    bound = _bound if precision == "highest" else _bound1
    pv, pi = fused_knn.knn_partial(q, db, valid, k, rows, precision=precision)
    wv, wi = fused_knn.knn_partial_plain(q, db, valid, k + 1, rows, precision=precision)
    torch.cuda.synchronize()
    assert pv.shape == (-(-db.shape[0] // rows), q.shape[0], k)
    assert bool((pv[..., 1:] <= pv[..., :-1]).all())
    missing = ~torch.isfinite(pv)
    assert bool((pv[missing] == float("-inf")).all()) and bool((pi[missing] == 0).all())
    assert bool(((pi >= 0) & (pi < db.shape[0])).all())
    for s in range(pv.shape[0]):
        _check(pv[s], pi[s], wv[s], wi[s], k, bound(q, db, wi[s], k, "dot"))
    return pv, pi


@pytest.mark.parametrize("Q", [1, 8, 9, 32, 64])
@pytest.mark.parametrize("k", [33, 64, 257, 1024, 2047, 2048, 2049, 4096, 8192])
def test_sort_of_live_keys_by_k_and_query_tile(gen, k, Q):
    """Every size of the end's sort: one warp a query up to 1,024 live
    keys (k = 33 .. 1024: 2 to 32 keys a lane), the CTA above (2047 and
    2048 at 8 keys a thread, 2049 and 4096 at 16, 8192 at 32); a tile's
    queries one a warp (Q = 1, 8) or more (9 .. 64); two splits of twice
    k's rows (n = k, after selects) and a ragged third of a quarter
    (n below k where that is fewer than k rows)."""
    rows = 2 * -(-k // 256) * 256
    n = 2 * rows + rows // 4
    q = torch.randn(Q, 32, generator=gen, device="cuda")
    db = torch.randn(n, 32, generator=gen, device="cuda")
    valid = torch.rand(n, generator=gen, device="cuda") > 0.2
    pv, _ = _live_case(q, db, valid, k, rows)
    live = torch.isfinite(pv).sum(-1)
    assert bool((live[:2] == k).all()) and bool((live[2] == torch.clamp(
        valid[2 * rows:].sum(), max=k)).all())


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", ["index_below_k", "split_2048_at_8192", "invalid_split"])
def test_sort_of_live_keys_below_k(gen, case, precision):
    """Splits with fewer live candidates than k: an index of 700 rows at k
    = 2049; splits of 2,048 rows at k = 8192 (the sharded plan's: a
    network of 2,048 keys, not 8,192); a split whose every row is invalid
    (no live key: k missing entries)."""
    Q, d = {"index_below_k": (9, 48), "split_2048_at_8192": (8, 32),
            "invalid_split": (9, 32)}[case]
    k, rows, n = {"index_below_k": (2049, 768, 700),
                  "split_2048_at_8192": (8192, 2048, 3 * 2048 + 500),
                  "invalid_split": (4096, 2048, 3 * 2048)}[case]
    q = torch.randn(Q, d, generator=gen, device="cuda")
    db = torch.randn(n, d, generator=gen, device="cuda")
    valid = torch.rand(n, generator=gen, device="cuda") > 0.1
    if case == "invalid_split":
        valid[rows:2 * rows] = False
    pv, pi = _live_case(q, db, valid, k, rows, precision)
    live = torch.isfinite(pv).sum(-1)
    for s in range(pv.shape[0]):
        assert bool((live[s] == min(k, int(valid[s * rows:(s + 1) * rows].sum()))).all())
    if case == "invalid_split":
        assert not torch.isfinite(pv[1]).any() and not pi[1].any()


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("Q,k", [(1, 1024), (9, 2049), (1, 8192), (32, 4096)])
def test_sort_ties_across_slices_and_halves_and_signed_zeros(gen, Q, k, precision):
    """Integer vectors (entries in [-2, 2], d = 16) score exactly at both
    precisions, so ties are exact and many: every value's run of equal
    scores crosses warps' slices and the CTA's halves of the network.
    Query 0's entries are all negative and every 7th row is zero, so its
    list holds scores of zero from -0.0 (zero rows) and +0.0 (orthogonal
    rows) alike, equal as numbers. Values equal and slots equal at every
    position: ties to the lower slot."""
    rows = -(-3 * k // 2 // 256) * 256  # about 0.6 of a split's valid rows kept
    n = 2 * rows
    q = torch.randint(-2, 3, (Q, 16), generator=gen, device="cuda").float()
    q[0] = -torch.randint(1, 3, (16,), generator=gen, device="cuda").float()
    db = torch.randint(-2, 3, (n, 16), generator=gen, device="cuda").float()
    db[::7] = 0.0
    valid = torch.rand(n, generator=gen, device="cuda") > 0.05
    pv, pi = fused_knn.knn_partial(q, db, valid, k, rows, precision=precision)
    wv, wi = fused_knn.knn_partial_plain(q, db, valid, k, rows, precision=precision)
    torch.cuda.synchronize()
    assert bool((pv[:, 0] == 0).any()), "no zero score in query 0's lists"
    assert torch.equal(pv, wv) and torch.equal(pi, wi)
    v, i = fused_knn.fused_topk_scores(q, db, valid, k, precision=precision)
    sv, si = topk.chunked_topk_scores(q, db, valid, k, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(v, sv) and torch.equal(i, si)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("cap,Q,k", [(8192, 1, 1024), (8192, 9, 300), (4096, 1, 8192)])
def test_sort_after_parts_of_a_small_index(gen, cap, Q, k, precision):
    """A small index plans CTAs that share a split (parts > 1): the last
    of them gathers the parts' live keys (fewer than k: each part saw 128
    rows), sorts only those, and the pair answers as the plain scan."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, splits = fused_knn.plan_splits(Q, cap, k, n_sm)
    assert fused_knn.plan_parts(Q, splits, rows, k, n_sm) > 1
    q = torch.randn(Q, 64, generator=gen, device="cuda")
    db = torch.randn(cap, 64, generator=gen, device="cuda")
    valid = torch.rand(cap, generator=gen, device="cuda") > 0.2
    _live_case(q, db, valid, k, rows, precision)
    bound = _bound if precision == "highest" else _bound1
    v, i = fused_knn.fused_topk_scores(q, db, valid, k, precision=precision)
    pv, pi = topk.chunked_topk_scores(q, db, valid, min(k + 1, cap), precision=precision)
    pad = k + 1 - pv.shape[1]
    pv = torch.nn.functional.pad(pv, (0, pad), value=float("-inf"))
    pi = torch.nn.functional.pad(pi, (0, pad), value=0)
    _check(v, i, pv, pi, k, bound(q, db, pi, k, "dot"))


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
@pytest.mark.parametrize("Q,k", [(1, 10), (32, 10), (64, 1024), (1, 8192)])
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
    assert _merges() > before["topk_merge"] + before["topk_merge_runs"]


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
