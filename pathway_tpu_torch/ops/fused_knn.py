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
so that about one CTA runs per SM at every k, within a byte budget for
the partial pass's output and scratch (``_SEARCH_BYTES``), and, where a
small index leaves too few splits (each is at least 256 rows), the CTAs
that share one split's rows (``plan_parts``).

At its end a CTA sorts each query's live candidates, n of them (at most
k, and at most the rows its split saw), by a bitonic network of pow2(n)
keys, not pow2(k), and writes positions n .. k-1 as missing entries (-inf
at slot 0). The kernel has an instance for k <= 32, where one warp's
registers hold the list, and one for k > 32, where every
consumer warp sorts: a query of up to 1,024 live keys is one warp's,
in its registers, the warps side by side; a larger one is the whole
CTA's, one query after another, each warp sorting a slice in registers
before the merges across slices. The sort borrows the ring's shared
memory, which every plan's ring holds (``sort_bytes``).

The merge takes the k best of the splits' sorted lists (runs) in split
order, in one of two designs by size (``merge_design``): up to
``_MERGE_CROSSOVER`` candidates a query, one CTA a query that holds them
all in shared memory; above it, a merge of sorted runs over many CTAs
(co-ranks of each 256-rank output segment by binary searches, then each
segment placed by rank), which has no cap on the candidates.

The partial kernel has two instances by ``precision``: ``"highest"``
(3xTF32, fp32-accurate: the JAX package's ``Precision.HIGHEST``) and
``"default"`` (one TF32 pass over TF32-rounded operands: every product is
exact in fp32, so a unit-vector score is within 2^-10·Σ|q_i x_i| ≤ 9.8e-4
of the fp32 one, the JAX package's "~1e-3" budget for its fast path). The
merge never sees the product and is the same for both.

Bound on an H100 SXM (``fused_knn_bound``): the database read, 4·cap·d
bytes at 3.35 TB/s, or, when Q is large, the operations: for
``"highest"`` the lesser of 2·Q·cap·d FP32 operations at 67 TFLOP/s and
3 × 2·Q·cap·d TF32 operations at 495 TFLOP/s; for ``"default"``
2·Q·cap·d TF32 operations at 495 TFLOP/s.

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
from pathway_tpu_torch.ops.topk import check_precision, chunked_topk_scores

K_MAX = 8192    # the largest k, the JAX index's clamp (csrc K_MAX)
_TN = 256       # rows per split are a multiple of this (csrc ROW_GRANULE)
# the one-CTA merge holds at most this many candidates a query (csrc
# MERGE_MAX); the run merge places 256 ranks a CTA (csrc SEG) and takes at
# most 8192 runs (csrc RUNS_MAX)
_BLOCK_MERGE_MAX = 32768
_SEG = 256
_RUNS_MAX = 8192
# the one-CTA merge is used up to this many candidates a query and k up
# to an eighth of it: there its one launch is the faster; above either
# the run merge is (its cost grows with the candidates and its bitonic
# sort of k; PERF.md, chip_smoke.py merge_designs)
_MERGE_CROSSOVER = 2048
# device bytes a search's partial pass may allocate: its [splits, Q, k]
# output pair and the candidate buffers that do not fit in shared memory.
# One GiB holds every chip_smoke.py case at one split a SM (the largest,
# Q = 1 at k = 8192, takes 144 MB) and is two thirds of a 2^20 x 384 f32
# index; where Q * k is large it lowers the splits (Q = 256 at k = 8192:
# 21 of 33, where they would take 1.67 GB)
_SEARCH_BYTES = 1 << 30
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
# shared bytes the end's sort takes from the ring for k > 32: eight warps'
# areas of 1,024 keys and a pad a 32 (csrc SORT_BYTES)
_SORT_BYTES = 8 * _CONSUMER_WARPS * (1024 + 1024 // 32)
# TF32 passes of the partial kernel's instance for each precision (csrc
# PASSES), and the name its launches are counted under
PASSES = {"highest": 3, "default": 1}
_KERNEL = {"highest": "fused_knn", "default": "fused_knn_tf32"}

# launches of each kernel, counted where the wrapper launches it: the
# partial kernel's 3xTF32 and one-pass instances apart, and the merge's two
# designs apart (the one-CTA merge, and the run merge's pair of kernels)
LAUNCHES = {"fused_knn": 0, "fused_knn_tf32": 0, "topk_merge": 0, "topk_merge_runs": 0}
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


def fused_knn_bound(
    q: int, cap: int, d: int, k: int, precision: str, rates: dict,
    splits: int = 1, fp32_only: bool = False,
) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take for one partial pass and its output. Bytes: the database, the
    queries and the valid mask read once, the ``splits`` partial lists
    written once. Operations: the 2·q·cap·d product at the card's peak --
    for "highest" the lesser of FP32 on the CUDA cores and 3xTF32 on the
    tensor cores (FP32 alone with ``fp32_only``), for "default" one TF32
    pass. ``rates`` is ``internals.device.peak_rates``'s dict."""
    t_bytes = (4.0 * cap * d + 4.0 * q * d + cap + 8.0 * splits * q * k) / rates["bandwidth"]
    flops = 2.0 * q * cap * d
    t_fp32 = flops / rates["fp32"]
    t_ops = PASSES[precision] * flops / rates["tf32"]
    if precision == "highest":
        t_ops = t_fp32 if fp32_only else min(t_ops, t_fp32)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
            _P, _P, _P, _P, _P, _P,
        ]
        lib.fused_knn_partial.restype = _I
        lib.fused_knn_merge.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
        lib.fused_knn_merge.restype = _I
        lib.fused_knn_partial_smem.argtypes = [_I, _I, _I, _I, _I]
        lib.fused_knn_partial_smem.restype = ctypes.c_longlong
        lib.fused_knn_capacity.argtypes = [_I]  # the int getters return c_int
        lib.fused_knn_sort_bytes.argtypes = [_I]
        consts = [
            (lib.fused_knn_k_max, (), K_MAX),
            (lib.fused_knn_row_granule, (), _TN),
            (lib.fused_knn_merge_max, (), _BLOCK_MERGE_MAX),
            (lib.fused_knn_merge_segment, (), _SEG),
            (lib.fused_knn_runs_max, (), _RUNS_MAX),
        ] + [
            (lib.fused_knn_capacity, (k,), capacity(k)) for k in (1, 10, 200, 8192)
        ] + [
            (lib.fused_knn_sort_bytes, (k,), sort_bytes(k)) for k in (1, 32, 33, 8192)
        ] + [
            (lib.fused_knn_partial_smem, (n, st, k, sb, p),
             partial_smem(n, st, k, bool(sb), p))
            for n in _TILES for st, k, sb in ((4, 1, 1), (6, 10, 1), (8, 8192, 0))
            for p in PASSES.values()
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


def _query_parts(passes: int) -> int:
    """The queries' TF32 parts the instance reads: hi and lo for 3xTF32,
    hi alone for one pass (csrc query_parts)."""
    return 2 if passes == 3 else 1


def sort_bytes(k: int) -> int:
    """Shared bytes the partial kernel's end sorts in, at the start of its
    ring (free by then): none for k <= 32, whose list one warp's registers
    hold, else eight warps' padded areas of 1,024 keys, as many as the
    CTA-wide area of 8,192 keys (csrc sort_bytes)."""
    return _SORT_BYTES if k > 32 else 0


def partial_smem(n: int, stages: int, k: int, smem_buffers: bool,
                 passes: int = 3) -> int:
    """Shared-memory bytes of one partial-kernel block: 1 KB to align the
    ring, ``stages`` stages of 128 index rows and the ``n`` queries' hi and
    lo parts (hi alone with one pass; 32 dims each), the mbarriers, |q|^2,
    the running thresholds and counts, each consumer warp's room for its
    selects, and the candidate buffers when they live in shared memory."""
    return (
        1024 + stages * (_TM + _query_parts(passes) * n) * _ROW_BYTES
        + 16 * _MAX_STAGES + 12 * n
        + _CONSUMER_WARPS * _SELECT_ROOM
        + (8 * n * capacity(k) if smem_buffers else 0)
    )


class Tile(NamedTuple):
    """A partial-kernel launch's geometry: ``n`` queries a CTA (the wgmma
    N, 8..64), ``stages`` ring stages, whether the candidate buffers live
    in shared memory (else in a scratch tensor), and the instance's TF32
    ``passes`` (3 or 1)."""
    n: int
    stages: int
    smem_buffers: bool
    passes: int = 3


@functools.lru_cache(maxsize=1024)
def plan_tile(q: int, k: int, precision: str = "highest") -> Tile:
    """The smallest instance that covers the batch (at most 64 queries a
    CTA); the buffers in shared memory where they fit beside a ring of 4
    stages; then the deepest ring (at most 8 stages) that fits. A one-pass
    stage carries no lo part, so more of it fits. The ring must hold the
    end's sort (``sort_bytes``; the smallest ring, 4 one-pass stages of 8
    queries, holds 69,632 bytes against its 67,584): a plan that could not
    raises."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the fused KNN kernel takes 1 <= k <= {K_MAX}, got {k}")
    passes = PASSES[precision]
    n = next(t for t in _TILES if t >= min(max(q, 1), _TILES[-1]))
    smem_buffers = partial_smem(n, _MIN_STAGES, k, True, passes) <= _SMEM_MAX
    stages = max(
        st for st in range(_MIN_STAGES, _MAX_STAGES + 1)
        if partial_smem(n, st, k, smem_buffers, passes) <= _SMEM_MAX
    )
    ring = stages * (_TM + _query_parts(passes) * n) * _ROW_BYTES
    if ring < sort_bytes(k):  # the end's sort lies in the ring
        raise ValueError(f"a ring of {ring} bytes cannot hold the sort's "
                         f"{sort_bytes(k)} at q={q}, k={k}")
    return Tile(n, stages, smem_buffers, passes)


def partial_bytes(q: int, k: int, splits: int, parts: int = 1) -> int:
    """Device bytes the partial pass allocates for ``splits`` splits of
    ``parts`` CTAs: the ``[splits, q, k]`` output pair, where
    ``plan_tile``'s "highest" tile keeps them out of shared memory a
    candidate buffer a CTA (a "default" tile, whose stages are smaller,
    keeps them in shared memory wherever this one does), and with parts
    the lists they hand to the last of them."""
    tile = plan_tile(q, k)
    tiled = _cdiv(q, tile.n) * tile.n
    buffers = 0 if tile.smem_buffers else parts * tiled * capacity(k)
    handed = tiled * parts * k if parts > 1 else 0
    return 8 * splits * (q * k + buffers + handed)


@functools.lru_cache(maxsize=1024)
def plan_splits(q: int, cap: int, k: int, n_sm: int) -> tuple[int, int]:
    """(rows per split, splits): about one CTA per SM over the query tiles
    (a CTA fills its SM) at every k, each split a whole number of 256-row
    granules, and the partial pass's bytes (``partial_bytes``) within
    ``_SEARCH_BYTES``."""
    want = n_sm // _cdiv(q, plan_tile(q, k).n)
    want = max(1, min(want, _SEARCH_BYTES // partial_bytes(q, k, 1), _cdiv(cap, _TN)))
    rows = _cdiv(_cdiv(cap, want), _TN) * _TN
    return rows, _cdiv(cap, rows)


@functools.lru_cache(maxsize=1024)
def plan_parts(q: int, splits: int, rows: int, k: int, n_sm: int) -> int:
    """CTAs that share one split's rows: where the splits leave SMs idle
    (an index of fewer than 256 rows an SM), up to that many CTAs (at most
    8, and within ``_SEARCH_BYTES``) scan a split, each a whole number of
    128-row tiles, and the last to finish cuts their lists (``parts * k``
    candidates) to the split's k best."""
    ctas = _cdiv(q, plan_tile(q, k).n) * splits
    parts = max(1, min(n_sm // ctas, _MAX_PARTS, _cdiv(rows, _TM)))
    while parts > 1 and partial_bytes(q, k, splits, parts) > _SEARCH_BYTES:
        parts -= 1
    return parts


def merge_design(splits: int, kp: int, k: int) -> str:
    """The merge's design for the k best of ``splits`` runs of ``kp``:
    "block" (one CTA a query, its candidates in shared memory) up to
    ``_MERGE_CROSSOVER`` candidates a query and k up to an eighth of that,
    else "runs" (the merge of sorted runs over many CTAs)."""
    small = splits * kp <= _MERGE_CROSSOVER and 8 * k <= _MERGE_CROSSOVER
    return "block" if small else "runs"


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
                      metric="dot", precision="highest"):
    """Plain version of the partial pass: the top-k of each ``rows``-row
    split, as ``[splits, Q, k]`` values and global slots; at ``precision``
    "default" the product of the TF32-rounded operands."""
    parts = []
    for base in range(0, database.shape[0], rows):
        sl = slice(base, base + rows)
        v, i = chunked_topk_scores(
            queries, database[sl], valid[sl], k, chunk=rows,
            sq_norms=sq_norms[sl] if sq_norms is not None else None,
            metric=metric, precision=precision,
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
                metric="dot", precision="highest"):
    """Partial pass: ``[splits, Q, k]`` top-k values and slots of each
    ``rows``-row split of the database (``rows`` a multiple of 256), the
    tile from ``plan_tile``, the instance by ``precision`` (3xTF32 for
    "highest", one TF32 pass for "default"). Each list is non-increasing;
    past a split's n live candidates (n < k where it has fewer valid rows)
    its entries are missing: -inf with a slot in range (slot 0 from the
    kernel, which sorts only the n). A CUDA tensor launches the kernel; a
    CPU tensor runs the plain version."""
    if queries.device.type == "cpu":
        return knn_partial_plain(
            queries, database, valid, k, rows, sq_norms=sq_norms, metric=metric,
            precision=precision,
        )
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tile = plan_tile(queries.shape[0], k, precision)
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
    # scratch: the queries' hi and lo parts (hi alone with one pass); the
    # candidate buffers when they do not fit in shared memory; the parts'
    # lists and arrival counts
    qs = torch.empty((_query_parts(tile.passes), Q, D), dtype=torch.float32,
                     device=dev)
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
        tile.passes,
        ptr(buf), ptr(mbuf), ptr(arrived), part_v.data_ptr(), part_i.data_ptr(),
    )
    if err:
        raise RuntimeError(f"fused_knn partial launch failed: cudaError {err}")
    LAUNCHES[_KERNEL[precision]] += 1
    return part_v, part_i


def topk_merge(part_v, part_i, k, *, design=None):
    """Merge pass: the k best per query of ``[splits, Q, k']`` runs, taken
    in run order (ties to the earlier run, then the earlier position).
    Precondition: each run ``part_v[s, q]`` is non-increasing in value
    (-0.0 counts as +0.0), as the partial pass's splits, the shards' lists
    and ``merge_pair``'s two lists are; the run merge's answer is
    undefined otherwise. ``design`` is "block" or "runs" (None: by
    ``merge_design``). A CUDA tensor launches the kernels; a CPU tensor
    runs the plain version, and so does a meta tensor (no data: the
    Device Doctor's shape-only trace of the sharded search)."""
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
    design = design or merge_design(splits, kp, k)
    if design not in ("block", "runs"):
        raise ValueError(f"unknown merge design {design!r}")
    if design == "block" and splits * kp > _BLOCK_MERGE_MAX:
        raise ValueError(f"the one-CTA merge takes at most {_BLOCK_MERGE_MAX} "
                         f"candidates a query, got {splits * kp}")
    if design == "runs" and (splits > _RUNS_MAX or splits * kp >= 1 << 31):
        raise ValueError(f"the run merge takes at most {_RUNS_MAX} runs and "
                         f"2^31 candidates a query, got {splits} of {kp}")
    out_v = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or splits == 0:
        return out_v.fill_(float("-inf")), out_i.zero_()
    # the run merge's co-ranks: each query's cut of every run at the end of
    # each 256-rank output segment
    cuts = None if design == "block" else torch.empty(
        (Q, _cdiv(k, _SEG), splits), dtype=torch.int32, device=dev)
    err = _launch(
        dev, _lib().fused_knn_merge,
        part_v.data_ptr(), part_i.data_ptr(), Q, splits, kp, k,
        int(design == "runs"), None if cuts is None else cuts.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(),
    )
    if err:
        raise RuntimeError(f"fused_knn merge launch failed: cudaError {err}")
    LAUNCHES["topk_merge" if design == "block" else "topk_merge_runs"] += 1
    return out_v, out_i


def fused_topk_scores(
    queries: torch.Tensor,   # [Q, D] f32
    database: torch.Tensor,  # [cap, D] f32
    valid: torch.Tensor,     # [cap] bool
    k: int,
    *,
    sq_norms: torch.Tensor | None = None,  # [cap] f32, for l2sq
    metric: str = "dot",
    precision: str = "highest",
):
    """Top-k scores per query: (values [Q, k] f32 descending,
    slots [Q, k] int32), ties to the lower slot, a missing entry -inf.

    ``metric`` is "dot" or "l2sq" (negated squared distance, from
    ``sq_norms``). Scores are fp32-accurate at ``precision`` "highest"
    and the product of TF32-rounded operands at "default". ``k`` is
    1..8192 on every device. On CUDA: the partial kernel's instance for
    the precision over about one CTA per SM, then the merge kernel unless
    the plan has one split; on the CPU: the plain ``chunked_topk_scores``.
    The ``knn.fused`` dispatch record's cost counts the rows given, so a
    caller that passes the prefix of a buffer in use (``KnnShard.topk``,
    ``ShardedKnnIndex``) is charged for the rows scanned, not its capacity.
    """
    check_precision(precision)
    if not 1 <= k <= K_MAX:
        raise ValueError(f"fused_topk_scores takes 1 <= k <= {K_MAX}, got {k}")
    if metric not in ("dot", "l2sq"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "l2sq" and sq_norms is None:
        raise ValueError("metric='l2sq' needs sq_norms")
    q, cap, d = queries.shape[0], database.shape[0], queries.shape[1]
    _DEVICE.note_bucket(_SEEN_BUCKETS, "knn.fused",
                        fused_knn_bucket(q, cap, d, k, precision))
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")
    # one timed dispatch record per launch pair (one attribute check when
    # the device plane is off)
    dev = _DEVICE.begin("knn.fused", queries.device) if _DEVICE.on else None
    try:
        if queries.device.type == "cpu":
            out = chunked_topk_scores(
                queries, database, valid, k, sq_norms=sq_norms, metric=metric,
                precision=precision,
            )
        else:
            n_sm = torch.cuda.get_device_properties(
                queries.device).multi_processor_count
            rows, splits = plan_splits(q, cap, k, n_sm)
            part_v, part_i = knn_partial(
                queries, database, valid, k, rows, sq_norms=sq_norms,
                metric=metric, precision=precision,
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
