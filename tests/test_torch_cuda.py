"""The hand-written CUDA kernels against their plain PyTorch versions on
the card. They skip where there is no CUDA device; on a machine with one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the repository's conftest prepares JAX, which this file
does not use.) Tolerances: slots exact wherever the plain gap to a
neighbouring score exceeds 1e-5, values rtol 1e-5 — the kernel sums the
same fp32 products in another order.
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


def _check(v, i, pv, pi, k):
    torch.cuda.synchronize()
    fin = torch.isfinite(pv[:, :k])
    assert torch.equal(torch.isfinite(v), fin)
    torch.testing.assert_close(v[fin], pv[:, :k][fin], rtol=1e-5, atol=0)
    gap = pv[:, :-1] - pv[:, 1:]
    left = torch.cat([torch.full_like(gap[:, :1], float("inf")), gap[:, : k - 1]], 1)
    clear = (torch.minimum(left, gap[:, :k]) > 1e-5) & fin
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
    _check(v, i, pv, pi, k)


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
        fused_knn.fused_topk_scores(q, db, valid, 129)
    with pytest.raises(TypeError):
        fused_knn.fused_topk_scores(q.double(), db, valid, 4)
    with pytest.raises(ValueError):
        fused_knn.fused_topk_scores(q[:, :6].contiguous(), db[:, :6].contiguous(), valid, 4)
