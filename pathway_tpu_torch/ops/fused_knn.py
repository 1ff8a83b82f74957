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
``internals/device.py:knn_search_bucket``). The partial kernel is written
for Hopper: TMA copies into an mbarrier-guarded ring, 3xTF32 ``wgmma``
scores, and a batched threshold selection through per-query candidate
buffers. The wrapper picks the query tile and ring depth (``plan_tile``)
so that a block's shared memory holds the ring and, where they fit, the
buffers (else a scratch tensor holds them), the splits (``plan_splits``)
so that about one CTA runs per SM and one merge block holds every
candidate, and, where a large k caps the splits, the CTAs that share one
split's rows (``plan_parts``).

Bound on an H100 SXM: the database read, 4·cap·d bytes at 3.35 TB/s, or,
when Q is large, the lesser of 2·Q·cap·d FP32 operations at 67 TFLOP/s and
3 × 2·Q·cap·d TF32 operations at 495 TFLOP/s.

For a CPU tensor the wrapper runs the plain version, ``chunked_topk_scores``;
for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
_TILES = (8, 16, 32, 64)  # query-tile instances (wgmma N) of the partial kernel
_SMEM_MAX = 232448  # shared memory one block may use on Hopper (227 KB)
# geometry of the partial kernel (csrc TM, ROW_BYTES, MIN/MAX_STAGES,
# CONSUMER_WARPS): index rows a tile, bytes of a row's 32-dim stage, ring
# depths, consumer warps
_TM, _ROW_BYTES = 128, 128
_MIN_STAGES, _MAX_STAGES = 4, 8
_MAX_PARTS = 8  # CTAs that share a split (csrc MAX_PARTS)
_CONSUMER_WARPS = 8
_SELECT_ROOM = 4096  # shared bytes a consumer warp's selects use (csrc SELECT_ROOM)

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
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
            _P, _P, _P, _P, _P, _P,
        ]
        lib.fused_knn_partial.restype = _I
        lib.fused_knn_merge.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P]
        lib.fused_knn_merge.restype = _I
        lib.fused_knn_partial_smem.argtypes = [_I, _I, _I, _I]
        lib.fused_knn_partial_smem.restype = ctypes.c_longlong
        lib.fused_knn_capacity.argtypes = [_I]  # the int getters return c_int
        consts = [
            (lib.fused_knn_k_max, (), K_MAX),
            (lib.fused_knn_row_granule, (), _TN),
            (lib.fused_knn_merge_max, (), _MERGE_MAX),
        ] + [
            (lib.fused_knn_capacity, (k,), capacity(k)) for k in (1, 10, 200, 8192)
        ] + [
            (lib.fused_knn_partial_smem, (n, st, k, sb), partial_smem(n, st, k, bool(sb)))
            for n in _TILES for st, k, sb in ((4, 1, 1), (6, 10, 1), (8, 8192, 0))
        ]
        for fn, args, want in consts:
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


def capacity(k: int) -> int:
    """Candidates a query's buffer holds in the partial kernel: the k best,
    slack for about k more (a select runs about once per doubling of the
    rows seen) and one tile's rows, a multiple of 32."""
    return _cdiv(k + max(k, _TM) + _TM, 32) * 32


def partial_smem(n: int, stages: int, k: int, smem_buffers: bool) -> int:
    """Shared-memory bytes of one partial-kernel block: 1 KB to align the
    ring, ``stages`` stages of 128 index rows and the ``n`` queries' hi and
    lo parts (32 dims each), the mbarriers, |q|^2, the running thresholds
    and counts, each consumer warp's room for its selects, and the
    candidate buffers when they live in shared memory."""
    return (
        1024 + stages * (_TM + 2 * n) * _ROW_BYTES + 16 * _MAX_STAGES + 12 * n
        + _CONSUMER_WARPS * _SELECT_ROOM
        + (8 * n * capacity(k) if smem_buffers else 0)
    )


class Tile(NamedTuple):
    """A partial-kernel launch's geometry: ``n`` queries a CTA (the wgmma
    N, 8..64), ``stages`` ring stages, and whether the candidate buffers
    live in shared memory (else in a scratch tensor)."""
    n: int
    stages: int
    smem_buffers: bool


@functools.lru_cache(maxsize=1024)
def plan_tile(q: int, k: int) -> Tile:
    """The smallest instance that covers the batch (at most 64 queries a
    CTA); the buffers in shared memory where they fit beside a ring of 4
    stages; then the deepest ring (at most 8 stages) that fits."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the fused KNN kernel takes 1 <= k <= {K_MAX}, got {k}")
    n = next(t for t in _TILES if t >= min(max(q, 1), _TILES[-1]))
    smem_buffers = partial_smem(n, _MIN_STAGES, k, True) <= _SMEM_MAX
    stages = max(
        st for st in range(_MIN_STAGES, _MAX_STAGES + 1)
        if partial_smem(n, st, k, smem_buffers) <= _SMEM_MAX
    )
    return Tile(n, stages, smem_buffers)


@functools.lru_cache(maxsize=1024)
def plan_splits(q: int, cap: int, k: int, n_sm: int) -> tuple[int, int]:
    """(rows per split, splits): about one CTA per SM over the query tiles
    (a CTA fills its SM), each split a whole number of 256-row granules,
    and no more than ``_MERGE_MAX`` merge candidates per query."""
    want = n_sm // _cdiv(q, plan_tile(q, k).n)
    want = max(1, min(want, _MERGE_MAX // k, _cdiv(cap, _TN)))
    rows = _cdiv(_cdiv(cap, want), _TN) * _TN
    return rows, _cdiv(cap, rows)


@functools.lru_cache(maxsize=1024)
def plan_parts(q: int, splits: int, rows: int, k: int, n_sm: int) -> int:
    """CTAs that share one split's rows: where the splits leave SMs idle
    (a large k allows at most 32768 // k of them), up to that many CTAs (at
    most 8) scan a split, each a whole number of 128-row tiles, and the
    last to finish cuts their lists (``parts * k`` candidates) to the
    split's k best."""
    ctas = _cdiv(q, plan_tile(q, k).n) * splits
    return max(1, min(n_sm // ctas, _MAX_PARTS, _MERGE_MAX // k, _cdiv(rows, _TM)))


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
    tile from ``plan_tile``. A CUDA tensor launches the kernel; a
    CPU tensor runs the plain version."""
    if queries.device.type == "cpu":
        return knn_partial_plain(
            queries, database, valid, k, rows, sq_norms=sq_norms, metric=metric
        )
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tile = plan_tile(queries.shape[0], k)
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
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = plan_parts(Q, splits, rows, k, n_sm)
    groups = _cdiv(Q, tile.n) * splits
    # scratch: the queries' hi and lo parts; the candidate buffers when they
    # do not fit in shared memory; the parts' lists and arrival counts
    qs = torch.empty((2, Q, D), dtype=torch.float32, device=dev)
    buf = None if tile.smem_buffers else torch.empty(
        (groups * parts, tile.n, capacity(k)), dtype=torch.int64, device=dev)
    mbuf = arrived = None
    if parts > 1:
        mbuf = torch.empty((groups, tile.n, parts * k), dtype=torch.int64, device=dev)
        arrived = torch.zeros(groups, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _launch(
        dev, _lib().fused_knn_partial,
        queries.data_ptr(), qs.data_ptr(), database.data_ptr(), valid.data_ptr(),
        sq_norms.data_ptr() if l2sq else None,
        Q, N, D, k, int(l2sq), rows, splits, parts, tile.n, tile.stages,
        ptr(buf), ptr(mbuf), ptr(arrived), part_v.data_ptr(), part_i.data_ptr(),
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
    device. On CUDA: the partial kernel over about one CTA per SM, then
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
