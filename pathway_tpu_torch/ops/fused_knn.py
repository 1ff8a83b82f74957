"""Fused KNN scoring on the card: matmul + running top-k, in a kernel
written by hand for Hopper (``csrc/fused_knn.cu``).

The counterpart of ``pathway_tpu/ops/pallas_knn.py``: the CUDA kernel
replaces the Pallas kernel ``_knn_kernel``, and backs ``KnnShard.search``
and ``QueryEngine`` on CUDA, where the JAX package runs the equivalent XLA
``chunked_topk_scores`` scan. It computes what ``_knn_kernel`` computes —
fp32-accurate scores (3xTF32 on the tensor cores), the valid mask as -inf,
the k best per query with ties to the lower slot — plus the l2sq epilogue
of ``ops/topk.py``, without a [Q, cap] score matrix in device memory. A
partial pass over (query tiles x database splits), then, when there is
more than one split, a merge of the splits' partials.

It takes every k the JAX index serves, 1 <= k <= 8192 (the clamp of
``internals/device.py:knn_search_bucket``). The wrapper picks the query
tile (``plan_tile``) so that the running lists and the load stages fit in
a block's shared memory, and the splits (``plan_splits``) so that one
merge block holds every candidate.

Bound on an H100 SXM: the database read, 4·cap·d bytes at 3.35 TB/s, or,
when Q is large, the lesser of 2·Q·cap·d FP32 operations at 67 TFLOP/s and
3 × 2·Q·cap·d TF32 operations at 495 TFLOP/s.

For a CPU tensor the wrapper runs the plain version, ``chunked_topk_scores``;
for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pathway_tpu_torch.internals.device import (
    PLANE as _DEVICE,
    device_site,
    fused_knn_bucket,
)
from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops.topk import chunked_topk_scores

K_MAX = 8192    # the largest k, the JAX index's clamp (csrc K_MAX)
_TN = 256       # rows per split are a multiple of this (csrc ROW_GRANULE)
_MERGE_MAX = 32768  # merge candidates per query, splits * k (csrc MERGE_MAX)
_TILES = (8, 16, 32, 64, 128)  # query-tile instances of the partial kernel
_SMEM_MAX = 232448  # shared memory one block may use on Hopper (227 KB)
# shared-memory layout of the partial kernel (csrc partial_smem_bytes)
_STAGES, _DKP = 2, 68

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"fused_knn": 0, "topk_merge": 0}
# shape buckets met by the pair's site, ``knn.fused`` (the JAX package's
# ``pallas.topk``)
_SEEN_BUCKETS: set = set()

_P = ctypes.c_void_p
_I = ctypes.c_int


def fused_knn_cost(
    q: int, cap: int, d: int, k: int, block: int
) -> tuple[float, float]:
    """Analytical ``(flops, bytes_accessed)`` of the fused scan — a copy
    of the JAX package's ``pallas_knn_cost``. FLOPs: the score product
    (2·q·cap·d) plus k selection sweeps over the [q, k+block] candidate
    tile (~3 ops per candidate per block). Bytes: the database once, the
    query tile per block, the additive mask, the [q, k] result pair."""
    nb = max(1, cap // block)
    flops = 2.0 * q * cap * d + 3.0 * k * q * (k + block) * nb
    bytes_accessed = (
        4.0 * cap * d
        + 4.0 * q * d * nb
        + 4.0 * cap
        + 8.0 * q * k
    )
    return flops, bytes_accessed


device_site(
    "knn.fused",
    cost_model=fused_knn_cost,
    dtypes=("float32", "bool", "int32"),
    where="pathway_tpu_torch/ops/fused_knn.py:fused_topk_scores",
    description="hand-written fused matmul + running top-k (partial pass "
                "and merge) over the padded vector store",
)

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_knn")
        lib.fused_knn_partial.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        ]
        lib.fused_knn_partial.restype = _I
        lib.fused_knn_merge.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P]
        lib.fused_knn_merge.restype = _I
        lib.fused_knn_partial_smem.argtypes = [_I, _I, _I]
        lib.fused_knn_partial_smem.restype = ctypes.c_longlong
        consts = [
            (lib.fused_knn_k_max, (), K_MAX),
            (lib.fused_knn_row_granule, (), _TN),
            (lib.fused_knn_merge_max, (), _MERGE_MAX),
        ] + [
            (lib.fused_knn_partial_smem, (qt, qpc, k), partial_smem(qt, qpc, k))
            for qt in _TILES for qpc, k in ((1, 1), (qt, 10), (2, 8192))
        ]
        for fn, args, want in consts:
            if not args:
                fn.restype = _I
            if fn(*args) != want:
                raise RuntimeError(
                    f"csrc/fused_knn.cu {fn.__name__}{args} disagrees with the wrapper"
                )
        _LIB = lib
    return _LIB


def _launch(dev: torch.device, fn, *args) -> int:
    """Call a launcher of the library on ``dev``'s current stream; the
    device switch is paid only when ``dev`` is not the current device."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def partial_smem(qt: int, qpc: int, k: int) -> int:
    """Shared-memory bytes of one partial-kernel block: the cp.async ring
    of database rows and query dims, the score tile, |q|^2 and the ``qpc``
    running lists of k (value, slot) pairs."""
    tn = 128 if qt >= 64 else 256
    return 4 * (_STAGES * (tn + qt) * _DKP + qt * (tn + 4) + qt) + 8 * qpc * k


@functools.lru_cache(maxsize=1024)
def plan_tile(q: int, k: int) -> tuple[int, int]:
    """(query-tile instance, queries per CTA): the smallest instance that
    covers the batch (at most 128), smaller while the lists do not fit,
    and below 8 queries per CTA — the mma's N width, the rest of the
    columns masked — for the largest k."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the fused KNN kernel takes 1 <= k <= {K_MAX}, got {k}")
    qt = next(t for t in _TILES if t >= min(max(q, 1), _TILES[-1]))
    while qt > _TILES[0] and partial_smem(qt, qt, k) > _SMEM_MAX:
        qt //= 2
    qpc = qt
    while partial_smem(qt, qpc, k) > _SMEM_MAX:
        qpc -= 1
    return qt, qpc


@functools.lru_cache(maxsize=1024)
def plan_splits(q: int, cap: int, k: int, n_sm: int) -> tuple[int, int]:
    """(rows per split, splits): about two CTAs per SM over the query
    tiles, each split a whole number of 256-row granules, and no more
    than ``_MERGE_MAX`` merge candidates per query."""
    want = _cdiv(2 * n_sm, _cdiv(q, plan_tile(q, k)[1]))
    want = max(1, min(want, _MERGE_MAX // k, _cdiv(cap, _TN)))
    rows = _cdiv(_cdiv(cap, want), _TN) * _TN
    return rows, _cdiv(cap, rows)


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, queries on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def knn_partial_plain(queries, database, valid, k, rows, *, sq_norms=None,
                      metric="dot"):
    """Plain version of the partial pass: the top-k of each ``rows``-row
    split, as ``[splits, Q, k]`` values and global slots."""
    parts = []
    for base in range(0, database.shape[0], rows):
        sl = slice(base, base + rows)
        v, i = chunked_topk_scores(
            queries, database[sl], valid[sl], k, chunk=rows,
            sq_norms=sq_norms[sl] if sq_norms is not None else None,
            metric=metric,
        )
        i = i + base
        if v.shape[1] < k:  # a split shorter than k: missing = (-inf, 0)
            pad = k - v.shape[1]
            v = torch.nn.functional.pad(v, (0, pad), value=float("-inf"))
            i = torch.nn.functional.pad(i, (0, pad), value=0)
        parts.append((v, i))
    return (
        torch.stack([v for v, _ in parts]),
        torch.stack([i for _, i in parts]),
    )


def topk_merge_plain(part_v, part_i, k):
    """Plain version of the merge: the k best of the splits' lists taken
    in split order, ties to the earlier position."""
    splits, Q, kp = part_v.shape
    vals = part_v.permute(1, 0, 2).reshape(Q, splits * kp)
    idx = part_i.permute(1, 0, 2).reshape(Q, splits * kp)
    top, pos = torch.sort(vals, dim=-1, descending=True, stable=True)
    return top[:, :k], torch.gather(idx, -1, pos[:, :k])


def knn_partial(queries, database, valid, k, rows, *, sq_norms=None,
                metric="dot"):
    """Partial pass: ``[splits, Q, k]`` top-k values and slots of each
    ``rows``-row split of the database (``rows`` a multiple of 256), the
    query tile from ``plan_tile``. A CUDA tensor launches the kernel; a
    CPU tensor runs the plain version."""
    if queries.device.type == "cpu":
        return knn_partial_plain(
            queries, database, valid, k, rows, sq_norms=sq_norms, metric=metric
        )
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    qt, qpc = plan_tile(queries.shape[0], k)
    _check("queries", queries, torch.float32, 2, dev)
    _check("database", database, torch.float32, 2, dev)
    _check("valid", valid, torch.bool, 1, dev)
    Q, D = queries.shape
    N = database.shape[0]
    if database.shape[1] != D or valid.shape[0] != N:
        raise ValueError(
            f"shapes disagree: queries {tuple(queries.shape)}, database "
            f"{tuple(database.shape)}, valid {tuple(valid.shape)}"
        )
    l2sq = metric == "l2sq"
    if l2sq:
        _check("sq_norms", sq_norms, torch.float32, 1, dev)
        if sq_norms.shape[0] != N:
            raise ValueError("sq_norms must have one entry per database row")
    if D % 4 or queries.data_ptr() % 16 or database.data_ptr() % 16:
        raise ValueError("the kernel needs d % 4 == 0 and 16-byte aligned rows")
    if rows % _TN or rows <= 0:
        raise ValueError(f"rows per split must be a positive multiple of {_TN}")
    splits = _cdiv(N, rows)
    part_v = torch.empty((splits, Q, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or N == 0:
        return part_v, part_i
    err = _launch(
        dev, _lib().fused_knn_partial,
        queries.data_ptr(), database.data_ptr(), valid.data_ptr(),
        sq_norms.data_ptr() if l2sq else None,
        Q, N, D, k, int(l2sq), rows, splits, qt, qpc,
        part_v.data_ptr(), part_i.data_ptr(),
    )
    if err:
        raise RuntimeError(f"fused_knn partial launch failed: cudaError {err}")
    LAUNCHES["fused_knn"] += 1
    return part_v, part_i


def topk_merge(part_v, part_i, k):
    """Merge pass: the k best per query of ``[splits, Q, k']`` partials,
    taken in split order. A CUDA tensor launches the kernel; a CPU tensor
    runs the plain version, and so does a meta tensor (no data: the Device
    Doctor's shape-only trace of the sharded search)."""
    if part_v.device.type in ("cpu", "meta"):
        return topk_merge_plain(part_v, part_i, k)
    dev = part_v.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check("part_v", part_v, torch.float32, 3, dev)
    _check("part_i", part_i, torch.int32, 3, dev)
    splits, Q, kp = part_v.shape
    if part_i.shape != part_v.shape or not 1 <= k <= kp:
        raise ValueError(f"cannot merge {tuple(part_v.shape)} partials to k={k}")
    if splits * kp > _MERGE_MAX:
        raise ValueError(f"at most {_MERGE_MAX} merge candidates per query")
    out_v = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or splits == 0:
        return out_v.fill_(float("-inf")), out_i.zero_()
    err = _launch(
        dev, _lib().fused_knn_merge,
        part_v.data_ptr(), part_i.data_ptr(), Q, splits, kp, k,
        out_v.data_ptr(), out_i.data_ptr(),
    )
    if err:
        raise RuntimeError(f"fused_knn merge launch failed: cudaError {err}")
    LAUNCHES["topk_merge"] += 1
    return out_v, out_i


def fused_topk_scores(
    queries: torch.Tensor,   # [Q, D] f32
    database: torch.Tensor,  # [cap, D] f32
    valid: torch.Tensor,     # [cap] bool
    k: int,
    *,
    sq_norms: torch.Tensor | None = None,  # [cap] f32, for l2sq
    metric: str = "dot",
):
    """Top-k scores per query: (values [Q, k] f32 descending,
    slots [Q, k] int32), ties to the lower slot, a missing entry -inf.

    ``metric`` is "dot" or "l2sq" (negated squared distance, from
    ``sq_norms``). Scores are fp32-accurate. ``k`` is 1..8192 on every
    device. On CUDA: the partial kernel over about two CTAs per SM, then
    the merge kernel unless the plan has one split; on the CPU: the plain
    ``chunked_topk_scores``.
    """
    if not 1 <= k <= K_MAX:
        raise ValueError(f"fused_topk_scores takes 1 <= k <= {K_MAX}, got {k}")
    if metric not in ("dot", "l2sq"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "l2sq" and sq_norms is None:
        raise ValueError("metric='l2sq' needs sq_norms")
    q, cap, d = queries.shape[0], database.shape[0], queries.shape[1]
    _DEVICE.note_bucket(_SEEN_BUCKETS, "knn.fused", fused_knn_bucket(q, cap, d, k))
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")
    # one timed dispatch record per launch pair (one attribute check when
    # the device plane is off)
    dev = _DEVICE.begin("knn.fused", queries.device) if _DEVICE.on else None
    try:
        if queries.device.type == "cpu":
            out = chunked_topk_scores(
                queries, database, valid, k, sq_norms=sq_norms, metric=metric
            )
        else:
            n_sm = torch.cuda.get_device_properties(
                queries.device).multi_processor_count
            rows, splits = plan_splits(q, cap, k, n_sm)
            part_v, part_i = knn_partial(
                queries, database, valid, k, rows, sq_norms=sq_norms,
                metric=metric,
            )
            # one split's list is already the answer
            out = ((part_v[0], part_i[0]) if splits == 1
                   else topk_merge(part_v, part_i, k))
    except BaseException:
        _DEVICE.end(dev, None, block=False)
        raise
    if dev is not None:
        flops, acc = fused_knn_cost(q, cap, d, k, _TN)
        _DEVICE.end(dev, out[0], flops=flops, bytes_accessed=acc,
                    transfer_bytes=0)
    return out
