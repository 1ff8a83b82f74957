"""Device resolution, the shared shape-bucket functions, and the device
plane of the flight recorder.

The port's counterpart of ``pathway_tpu/internals/device.py``, merged with
the rule that picks the device an entry point runs on.

The host-side observability stack (flight recorder, cluster observatory)
goes dark at every device launch: an ``ExternalIndexNode`` KNN scan or an
embedder forward is one opaque slab of node self-time, with no way to tell
whether a slow node needs a kernel (device-bound) or needs the host path
fixed (device idle while the host assembles batches). Engine dispatch
sites (``ops/knn.py``, ``models/encoder.py``, the serving gateway's window
dispatch) therefore wrap every launch in a **timed dispatch record**:

* the wall span of the whole dispatch on the host clock;
* the device time between two CUDA events recorded on the launching
  stream around the launch. The record is closed without a synchronize:
  its events are read once the device has passed them (``query()``), on
  a later record or at ``flush()``, so attribution never stalls the
  launch pipeline. On the CPU the launch is synchronous and the device
  time is the host span;
* analytical FLOPs / bytes-accessed from the site's cost model;
* host<->device transfer bytes and the dispatch-queue depth at launch;
* the enclosing engine node, so device spans in the merged Perfetto trace
  correlate to their node span by dispatch id.

Records feed the flight recorder's per-rank device tracks
(``internals/flight.py note_dispatch``) and the OpenMetrics ``device_*``
families with the ``device_mfu`` / ``device_hbm_{live,peak}_bytes`` gauges
(``internals/monitoring.py``).

The plane is armed only while the runtime's profiling plane is on
(``PATHWAY_TRACE`` or a live /metrics endpoint); when off, a dispatch path
pays ONE attribute check (``PLANE.on``). Reading the card's name or its
allocator never creates a CUDA context: a pure relational run has no
device story.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time as _time
from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``). Without CUDA the caller must ask
    for the CPU by name (``device="cpu"``): an entry point never drops to
    the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pathway_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # one spelling per card, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# -- peak-rate tables --------------------------------------------------------
# NVIDIA's data-sheet peaks, dense (no sparsity), at the full power limit:
# (card-name substring, bf16 FLOP/s, TF32 FLOP/s, FP32 FLOP/s outside the
# tensor cores, HBM bytes/s). Substring-matched against the CUDA device
# name, most specific first; the SXM part names itself "NVIDIA H100 80GB
# HBM3". PATHWAY_DEVICE_PEAK_FLOPS / PATHWAY_DEVICE_PEAK_GBPS override for
# hardware the table has not met.
_PEAK_TABLE: tuple[tuple[str, float, float, float, float], ...] = (
    ("h100 pcie", 756e12, 378e12, 51e12, 2.0e12),
    ("h100", 989e12, 495e12, 67e12, 3.35e12),
)
# CPU / unknown backend: a deliberately modest estimate so CPU-lane MFU
# numbers read as a sanity signal, not hardware truth
_PEAK_FLOPS_FALLBACK = 2e11
_PEAK_BW_FALLBACK = 50e9

_HOST_BOUND_SHARE_DEFAULT = 0.35


def _env_float(name: str) -> float | None:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else None
    except ValueError:
        return None


def _env_off(name: str) -> bool:
    return str(os.environ.get(name, "1")).strip().lower() in (
        "0", "false", "no",
    )


def _cuda_live() -> bool:
    """CUDA already initialised in this process (never initialises it)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_kind() -> str:
    """The local card's name (``torch.cuda.get_device_name``) — only when
    CUDA is ALREADY initialised here; "" otherwise."""
    if not _cuda_live():
        return ""
    try:
        return torch.cuda.get_device_name()
    except RuntimeError:
        return ""


def _peak_row(kind: str):
    low = kind.lower()
    for row in _PEAK_TABLE:
        if row[0] in low:
            return row
    return None


def peak_rates(kind: str | None = None) -> dict | None:
    """The card's data-sheet peaks (``bf16``, ``tf32``, ``fp32`` FLOP/s
    and ``bandwidth`` bytes/s), or None for a card the table lacks."""
    row = _peak_row(device_kind() if kind is None else kind)
    if row is None:
        return None
    return {"bf16": row[1], "tf32": row[2], "fp32": row[3], "bandwidth": row[4]}


def peak_flops(kind: str | None = None) -> float:
    """MFU denominator: PATHWAY_DEVICE_PEAK_FLOPS, else the card's dense
    bf16 peak from the table, else the CPU fallback."""
    override = _env_float("PATHWAY_DEVICE_PEAK_FLOPS")
    if override is not None:
        return override
    row = _peak_row(device_kind() if kind is None else kind)
    return row[1] if row is not None else _PEAK_FLOPS_FALLBACK


def peak_bandwidth(kind: str | None = None) -> float:
    """Roofline ridge denominator (bytes/s): PATHWAY_DEVICE_PEAK_GBPS
    (GB/s), else the table, else the CPU fallback."""
    override = _env_float("PATHWAY_DEVICE_PEAK_GBPS")
    if override is not None:
        return override * 1e9
    row = _peak_row(device_kind() if kind is None else kind)
    return row[4] if row is not None else _PEAK_BW_FALLBACK


def host_bound_share() -> float:
    """Device-busy share of a dispatch site's wall below which the site
    reads host-bound (PATHWAY_DEVICE_HOST_BOUND_SHARE)."""
    v = _env_float("PATHWAY_DEVICE_HOST_BOUND_SHARE")
    if v is None or not (0.0 <= v <= 1.0):
        return _HOST_BOUND_SHARE_DEFAULT
    return v


def roofline_verdict(
    wall_s: float,
    device_s: float,
    flops: float,
    bytes_accessed: float,
    pk_flops: float | None = None,
    pk_bw: float | None = None,
    host_share: float | None = None,
) -> str:
    """The per-site/per-node verdict of the device plane, pure so the
    offline analyzers (analysis/profile.py, analysis/critical_path.py)
    and the live plane compute the SAME answer:

    * ``host-bound`` — the device was idle for most of the dispatch wall
      (the host was assembling batches / expanding rows): fixing this
      node means fixing the host path, not writing a kernel;
    * ``compute-bound`` — arithmetic intensity (FLOPs per device-memory
      byte) at or above the roofline ridge (peak FLOP/s over peak
      bytes/s): the tensor cores are the limiter, a faster kernel or
      lower precision is the lever;
    * ``bandwidth-bound`` — intensity below the ridge: memory traffic is
      the limiter (fuse, cache, or shrink the working set).
    """
    share = host_bound_share() if host_share is None else host_share
    if wall_s > 0 and device_s < share * wall_s:
        return "host-bound"
    if flops <= 0:
        # no modeled device arithmetic at all: whatever time this site
        # took was host work by definition
        return "host-bound"
    if bytes_accessed <= 0:
        return "compute-bound"
    pf = peak_flops() if pk_flops is None else pk_flops
    pb = peak_bandwidth() if pk_bw is None else pk_bw
    ridge = pf / max(pb, 1.0)
    return (
        "compute-bound"
        if (flops / bytes_accessed) >= ridge
        else "bandwidth-bound"
    )


def mfu(flops: float, device_s: float, pk_flops: float | None = None) -> float:
    """Model FLOPs utilization of a dispatch set: achieved FLOP/s over
    the card's peak. Callers pick which FLOPs they feed: padded FLOPs
    (what the hardware executed, bucket padding included) or effective
    FLOPs (only real rows/tokens — what ``device_mfu`` reports, with the
    padded variant kept alongside as ``device_mfu_padded``)."""
    if device_s <= 0 or flops <= 0:
        return 0.0
    return (flops / device_s) / (peak_flops() if pk_flops is None else pk_flops)


# -- device memory (absent-stat-safe) ----------------------------------------

def memory_stats() -> dict | None:
    """The caching allocator's counters (``torch.cuda.memory_stats``) in
    the plane's vocabulary: ``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved`` and ``bytes_limit`` (the card's memory). None when
    CUDA is not initialised here or the call fails — "no HBM story on
    this backend", not an error."""
    if not _cuda_live():
        return None
    try:
        ms = torch.cuda.memory_stats()
        limit = torch.cuda.get_device_properties(
            torch.cuda.current_device()
        ).total_memory
    except RuntimeError:
        return None
    return {
        "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(limit),
    }


def platform_info() -> dict | None:
    """Trace metadata: what hardware this rank measured — backend, card
    name and the peak rates the MFU/roofline numbers were computed
    against. None when CUDA never initialised in this process (a pure
    relational run, or a CPU run)."""
    if not _cuda_live():
        return None
    kind = device_kind()
    return {
        "backend": "cuda",
        "device_kind": kind,
        "peak_flops": peak_flops(kind),
        "peak_bandwidth": peak_bandwidth(kind),
    }


def nbytes_of(*arrays: Any) -> int:
    """Sum of ``nbytes`` over tensors / arrays (None / scalar leaves are
    free) — the transfer-bytes estimate dispatch sites report."""
    total = 0
    for a in arrays:
        n = getattr(a, "nbytes", None)
        if n is not None:
            try:
                total += int(n)
            except (TypeError, ValueError):
                pass
    return total


# -- device-site registry ----------------------------------------------------
# Every dispatch site declares itself here at import time: its analytical
# cost model, the dtypes its device buffers carry, which inputs it writes
# in place and where the dispatch lives.


@dataclasses.dataclass(frozen=True)
class DeviceSite:
    """One registered device-dispatch site.

    ``cost_model`` is the SAME callable the runtime site feeds into its
    dispatch records (``-> (flops, bytes_accessed)``). ``donates`` names
    the buffers the site writes in place (empty for read-only sites)."""

    name: str
    cost_model: Any
    dtypes: tuple
    where: str = ""
    donates: tuple = ()
    description: str = ""


_SITE_REGISTRY: dict[str, DeviceSite] = {}


def device_site(
    name: str,
    *,
    cost_model: Any,
    dtypes: Any,
    where: str = "",
    donates: Any = (),
    description: str = "",
) -> DeviceSite:
    """Register (or re-register — module reloads are idempotent) one
    dispatch site."""
    site = DeviceSite(
        name, cost_model, tuple(dtypes), where, tuple(donates), description
    )
    _SITE_REGISTRY[name] = site
    return site


def registered_sites() -> dict[str, DeviceSite]:
    """Snapshot of the registry (name -> DeviceSite)."""
    return dict(_SITE_REGISTRY)


# -- shared shape-bucket models ----------------------------------------------
# The bucket functions the dispatch sites pad with (``device.py:369-452``
# of the JAX package).


def batch_bucket(n: int, floor: int, cap: int) -> int:
    """Pow2 batch bucket from ``floor``, capped — the encoder's batch
    padding (models/encoder.py ``pad_batch``)."""
    b = floor
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def seq_bucket(L: int, cap: int) -> int:
    """Multiple-of-32 sequence bucket (floor 16), capped — the encoder's
    sequence padding."""
    if L <= 16:
        return 16
    return min(((L + 31) // 32) * 32, cap)


def pow2_capacity(n: int, floor: int = 128) -> int:
    """Pow2 index capacity from the 128-slot floor — KnnShard's growth
    schedule."""
    p = floor
    while p < n:
        p *= 2
    return p


def query_pad(n: int) -> int:
    """Pow2 query-batch padding from 1 — the search sites' batch set."""
    p = 1
    while p < n:
        p *= 2
    return p


def knn_search_bucket(
    n: int, capacity: int, k: int, chunk: int | None
) -> tuple:
    """Shape key of one index search: (padded query batch, capacity,
    effective k). Effective k is clamped to the scored block width."""
    k_eff = min(k, capacity, chunk or 8192)
    return (query_pad(n), capacity, k_eff)


def knn_write_bucket(nrows: int, capacity: int) -> tuple:
    """Shape key of one ``knn.write`` slot write. The row count is
    data-driven (writes are not padded)."""
    return (nrows, capacity)


def fused_knn_bucket(
    q: int, cap: int, d: int, k: int, precision: str = "highest"
) -> tuple:
    """Shape key of one launch of the fused KNN pair (``knn.fused``, the
    JAX package's ``pallas.topk``): every input dim, k and the precision,
    which picks the partial kernel's instance (3xTF32 or one TF32 pass),
    so a key never mixes the two. The pair is built once by nvcc; a new
    key is a new launch plan (query tile, splits), counted as the JAX
    package counts a new executable."""
    return (q, cap, d, k, precision)


def sharded_search_bucket(
    n: int, n_shards: int, local_cap: int, k: int, chunk: int | None
) -> tuple:
    """Shape key of one sharded index search: effective k mirrors
    ``ShardedKnnIndex.search``'s clamp (per-shard partial k capped by the
    shard's rows, merged up to the total capacity)."""
    k_eff = min(k, n_shards * min(local_cap, chunk or local_cap))
    return (query_pad(n), n_shards * local_cap, k_eff)


def sharded_write_bucket(nrows: int, capacity: int) -> tuple:
    """Shape key of one sharded index write."""
    return (nrows, capacity)


def encoder_bucket(nb: int, Lb: int, compact: bool) -> tuple:
    """Shape key of one encoder forward."""
    return (nb, Lb, bool(compact))


def ingest_bucket(nb: int, Lb: int, capacity: int, ids_dtype: str) -> tuple:
    """Shape key of one fused ingest chain (batch bucket x seq bucket x
    index capacity x wire dtype)."""
    return (nb, Lb, capacity, ids_dtype)


# -- static device-memory budget ---------------------------------------------
# The Device Doctor's footprint check (analysis/device_plan.py) holds a
# declared layout against one card's memory. PATHWAY_DEVICE_HBM_BYTES
# overrides (the CPU lever: model a card on a host without one).
_HBM_FALLBACK = 8 * 1024**3


def device_hbm_bytes() -> int:
    """One card's memory budget in bytes: ``PATHWAY_DEVICE_HBM_BYTES``
    wins; with CUDA, the card's own ``total_memory``
    (``torch.cuda.get_device_properties``; read even in a process that has
    not touched the card yet, which allocates nothing); without CUDA a
    deliberately small 8 GiB fallback, so the budget check still means
    something on a host with no card."""
    raw = os.environ.get("PATHWAY_DEVICE_HBM_BYTES", "")
    if raw.strip():
        try:
            v = int(float(raw))
            if v > 0:
                return v
        except ValueError:
            pass
    if torch.cuda.is_available():
        try:
            dev = torch.cuda.current_device()
            total = int(torch.cuda.get_device_properties(dev).total_memory)
        except RuntimeError:
            total = 0
        if total > 0:
            return total
    return _HBM_FALLBACK


def index_shard_bytes(capacity: int, dim: int, *, donated: bool = True) -> float:
    """Steady-state device bytes of one index shard's buffer triple: f32
    vectors [capacity, dim] + bool valid [capacity] + f32 sq_norms
    [capacity]. A write that is NOT in place keeps the old triple alive
    across the launch — the doctor's in-place audit bills exactly this
    doubling (``donated`` keeps the JAX package's name)."""
    steady = 4.0 * capacity * dim + 1.0 * capacity + 4.0 * capacity
    return steady if donated else 2.0 * steady


def ingest_staging_bytes(
    nb: int, Lb: int, ids_itemsize: int = 2, *, depth: int = 2
) -> float:
    """Host-to-device staging footprint of the tokenize-ahead ingest
    loop: ``depth`` in-flight batches of (ids [nb, Lb] at the wire
    itemsize + i32 lengths [nb])."""
    per = float(nb) * float(Lb) * float(ids_itemsize) + 4.0 * nb
    return float(depth) * per


def snapshot_staging_bytes(capacity: int, dim: int) -> float:
    """Worst-case staging of an index snapshot cut: one copy of the
    buffer triple in flight to the host."""
    return 4.0 * capacity * dim + 1.0 * capacity + 4.0 * capacity


# -- the plane ---------------------------------------------------------------


def _cuda_of(device: Any) -> torch.device | None:
    if device is None:
        return None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


class _Dispatch:
    """One in-flight dispatch record (``PLANE.begin`` ... ``end``)."""

    __slots__ = (
        "site", "seq", "node", "t_commit", "t0", "t_end", "depth",
        "ev0", "ev1", "host_device", "costs",
    )

    def __init__(self, site: str, seq: int, node, t_commit, t0: int,
                 depth: int, ev0):
        self.site = site
        self.seq = seq
        self.node = node
        self.t_commit = t_commit
        self.t0 = t0
        self.t_end = t0
        self.depth = depth
        self.ev0 = ev0  # CUDA event before the launch, or None
        self.ev1 = None  # CUDA event after it, once closed
        self.host_device = False  # a synchronous (CPU) launch
        self.costs = (0.0, 0.0, 0.0, 0)


class DevicePlane:
    """Process-wide device-dispatch recorder.

    Armed/disarmed by the runtime around each run (process-global like the
    native trace rings: under the emulated-rank CI lane several
    thread-ranks share it and rank 0's recorder claims the records).
    ``on`` is the ONE attribute dispatch sites check when the plane is
    off.

    A CUDA record stays pending after ``end`` until its end event has
    completed; pending records are resolved, oldest first, by later
    ``begin``/``end`` calls and by ``flush`` (which waits on the events
    and is called off the hot path: at disarm and by readers).
    """

    # memory_stats() walks the allocator — sample at most this often
    _MEM_POLL_S = 0.5

    def __init__(self):
        self.on = False
        self.recorder = None
        self.stats = None
        self._seq = 0
        self._inflight = 0
        self._lock = threading.Lock()
        self._pending: list[_Dispatch] = []
        self._node_ctx = threading.local()
        self._last_mem_poll = 0.0

    # -- lifecycle (runtime) ----------------------------------------------
    def arm(self, recorder, stats) -> None:
        """Attach this run's flight recorder (may be None: metrics-only
        runs still feed the gauges) and ProberStats. PATHWAY_DEVICE_TRACE=0
        keeps the plane off even on an armed run."""
        if _env_off("PATHWAY_DEVICE_TRACE"):
            return
        self.recorder = recorder
        self.stats = stats
        if stats is not None:
            stats.set_device_peak_flops(peak_flops())
        self._last_mem_poll = 0.0
        # a dispatch site that raised between begin() and end() in a
        # PREVIOUS run left its record open — re-zero so queue-depth
        # reporting starts honest for this run
        with self._lock:
            self._inflight = 0
            self._pending = []
        self.on = True

    def disarm(self) -> None:
        self.flush()
        self.on = False
        self.recorder = None
        self.stats = None

    # -- engine-node context (runtime step loop) --------------------------
    def set_node(self, nid: int, t_commit: int) -> None:
        self._node_ctx.v = (nid, t_commit)

    def clear_node(self) -> None:
        self._node_ctx.v = None

    def _current_node(self):
        return getattr(self._node_ctx, "v", None)

    # -- dispatch records --------------------------------------------------
    def begin(self, site: str, device: Any = None) -> _Dispatch | None:
        """Open a dispatch record (None when the plane is off — sites
        guard on ``PLANE.on`` first). ``device``: where the launch runs;
        on a CUDA device a timing event is recorded on its current
        stream before the launch."""
        if not self.on:
            return None
        self._resolve(block=False)
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._inflight += 1
            depth = self._inflight
        ctx = self._current_node()
        nid, t_commit = ctx if ctx is not None else (None, None)
        ev0 = None
        cuda = _cuda_of(device)
        if cuda is not None:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record(torch.cuda.current_stream(cuda))
        return _Dispatch(site, seq, nid, t_commit, _time.perf_counter_ns(),
                         depth, ev0)

    def enqueued(self, d: _Dispatch | None) -> None:
        """Mark the end of the launch explicitly: a CUDA record takes its
        end event here, so a readback the site makes before ``end`` is
        not counted as device time of the launch."""
        if d is not None and d.ev0 is not None and d.ev1 is None:
            d.ev1 = torch.cuda.Event(enable_timing=True)
            d.ev1.record(torch.cuda.current_stream(d.ev0.device))

    def end(
        self,
        d: _Dispatch | None,
        outputs: Any = None,
        *,
        flops: float = 0.0,
        flops_effective: float | None = None,
        bytes_accessed: float = 0.0,
        transfer_bytes: int = 0,
        block: bool = True,
        effective_share: float | None = None,
    ) -> None:
        """Close a dispatch record. A CUDA record gets its end event on
        the launching stream and is delivered once the device has passed
        it — never by a synchronize here. ``outputs=None, block=False``
        marks a host-only or failed dispatch: a wall-only record whose
        device time is honestly zero.

        ``flops`` is what the hardware executed — padded rows/tokens
        included. ``flops_effective`` (or ``effective_share`` in [0, 1])
        is the share spent on REAL rows, so bucket-padding waste is
        visible instead of inflating the MFU gauge. Defaults to
        ``flops``."""
        if d is None:
            return
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
        if flops_effective is None:
            flops_effective = (
                flops * min(max(effective_share, 0.0), 1.0)
                if effective_share is not None
                else flops
            )
        flops_effective = min(flops_effective, flops)
        d.costs = (flops, flops_effective, bytes_accessed, transfer_bytes)
        d.t_end = _time.perf_counter_ns()
        launched = block and outputs is not None
        if not launched:
            d.ev1 = None  # host-only or failed: no device span
        elif d.ev0 is not None and d.ev1 is None:
            d.ev1 = torch.cuda.Event(enable_timing=True)
            d.ev1.record(torch.cuda.current_stream(d.ev0.device))
        # a CPU launch ran inside the host span: that span is its device
        # time. Host-only and failed dispatches have no device span.
        d.host_device = d.ev0 is None and launched
        with self._lock:
            self._pending.append(d)
        self._resolve(block=False)
        self._sample_memory_throttled()

    def flush(self) -> None:
        """Deliver every pending record, waiting for the device to pass
        their end events (off the hot path: disarm, readers)."""
        self._resolve(block=True)

    def _resolve(self, *, block: bool) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    return
                d = self._pending[0]
                if d.ev1 is not None and not block and not d.ev1.query():
                    return
                self._pending.pop(0)
            self._deliver(d)

    def _deliver(self, d: _Dispatch) -> None:
        flops, flops_effective, bytes_accessed, transfer_bytes = d.costs
        host_ns = max(0, d.t_end - d.t0)
        if d.ev1 is not None:
            d.ev1.synchronize()  # returns at once unless flush() waits
            device_ns = int(d.ev0.elapsed_time(d.ev1) * 1e6)
        elif d.host_device:
            device_ns = host_ns
        else:
            device_ns = 0
        # the device span ends where the record closes: wall covers both
        # the host's enqueue and the device's share
        wall_ns = max(host_ns, device_ns)
        t_done = d.t0 + wall_ns
        t_ret = t_done - device_ns
        stats = self.stats
        if stats is not None:
            stats.on_device_dispatch(
                d.site, wall_ns / 1e9, device_ns / 1e9, flops,
                bytes_accessed, transfer_bytes, d.depth, flops_effective,
            )
        rec = self.recorder
        if rec is not None:
            rec.note_dispatch(
                d.site, d.seq, d.node, d.t_commit, d.t0, t_ret,
                t_done, flops, bytes_accessed, transfer_bytes, d.depth,
                flops_effective,
            )

    def note_recompile(self, site: str) -> None:
        """A dispatch site met a new shape bucket: on the card a new CUDA
        graph (``encoder.forward``, ``ingest.fused``) or launch plan, in
        the JAX package a fresh XLA executable. Feeds
        ``device_recompiles_total``, so a shape-bucket leak that captures
        on every batch shows on the metrics instead of only as wall
        time."""
        stats = self.stats
        if stats is not None:
            stats.on_device_recompile(site)

    def note_bucket(self, seen: set, site: str, bucket: tuple) -> None:
        """``note_recompile(site)`` the first time ``bucket`` enters the
        site's ``seen`` set."""
        with self._lock:
            if bucket in seen:
                return
            seen.add(bucket)
        self.note_recompile(site)

    # -- HBM gauges --------------------------------------------------------
    def _sample_memory_throttled(self) -> None:
        now = _time.monotonic()
        if now - self._last_mem_poll < self._MEM_POLL_S:
            return
        self._last_mem_poll = now
        self.sample_memory()

    def sample_memory(self) -> None:
        """Pull ``memory_stats()`` into the HBM gauges; without CUDA the
        gauges stay at their absent-safe zeros with ``available`` false."""
        stats = self.stats
        if stats is None:
            return
        ms = memory_stats()
        if ms is None:
            stats.set_device_memory(0, 0, available=False)
            return
        stats.set_device_memory(
            ms["bytes_in_use"], ms["peak_bytes_in_use"], available=True
        )


PLANE = DevicePlane()


# -- dispatch supervision (device fault domain) ------------------------------
# Supervised sites route their launch through :func:`supervised_dispatch`:
# failures are classified (transient / oom / permanent) and the pure
# ``protocol.device_dispatch_decide`` transition picks retry-with-backoff,
# brownout, or epoch abort — the connector ``SupervisorPolicy`` semantics
# (io/_connector.py) applied to the device plane. An optional watchdog
# deadline (``PATHWAY_DEVICE_DISPATCH_TIMEOUT_S``; 0 = off, the default —
# the hot path stays a plain call) bounds a hung dispatch well under the
# mesh op timeout.

_RETRY_BACKOFF_BASE_S = 0.05
_RETRY_BACKOFF_CAP_S = 2.0

# transient runtime failure markers: worth a bounded retry. OOM markers
# are matched FIRST — an exhausted allocator must never be retried into.
_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory",
                "oom ", "allocating ")
_TRANSIENT_MARKERS = (
    "unavailable", "deadline_exceeded", "deadline exceeded", "aborted",
    "connection reset", "temporarily", "try again", "internal: failed",
)
# a failed in-place write may have left its buffers half written — a
# retry would compute on them; classify as permanent so the epoch rolls
# back to buffers the snapshot actually holds
_PERMANENT_MARKERS = ("donated", "deleted", "invalid buffer")


class DeviceOom(RuntimeError):
    """Device memory exhaustion (``torch.cuda.OutOfMemoryError`` or an
    injected ``device.oom``): growth was refused, the index keeps serving
    at its committed capacity and the serving breaker browns out."""


class WatchdogTimeout(RuntimeError):
    """A supervised dispatch exceeded PATHWAY_DEVICE_DISPATCH_TIMEOUT_S.
    The hung launch thread is abandoned (a launch cannot be cancelled);
    the caller's epoch aborts well under the mesh op timeout backstop."""


def classify_device_error(exc: BaseException) -> str:
    """``"transient"`` | ``"oom"`` | ``"permanent"`` — the input to the
    pure ``device_dispatch_decide`` transition. Injected faults carry
    their class explicitly (``device.oom`` point -> oom, ``retryable``
    -> transient); ``torch.cuda.OutOfMemoryError`` and ``MemoryError``
    are oom; other errors classify by message markers, permanent winning
    on evidence of consumed buffers."""
    from pathway_tpu_torch.internals.faults import InjectedFault

    if isinstance(exc, WatchdogTimeout):
        return "permanent"
    if isinstance(exc, InjectedFault):
        if exc.point == "device.oom":
            return "oom"
        return "transient" if exc.retryable else "permanent"
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError, DeviceOom)):
        return "oom"
    low = f"{type(exc).__name__}: {exc}".lower()
    if any(m in low for m in _PERMANENT_MARKERS):
        return "permanent"
    if any(m in low for m in _OOM_MARKERS):
        return "oom"
    if any(m in low for m in _TRANSIENT_MARKERS):
        return "transient"
    return "permanent"


def dispatch_timeout_s() -> float:
    """Watchdog deadline for supervised dispatches; 0 disables (the
    default: unsupervised hangs still die by the mesh op timeout)."""
    v = _env_float("PATHWAY_DEVICE_DISPATCH_TIMEOUT_S")
    return v if v is not None and v > 0 else 0.0


def dispatch_retries() -> int:
    raw = os.environ.get("PATHWAY_DEVICE_RETRIES", "")
    try:
        v = int(raw) if raw.strip() else 2
    except ValueError:
        v = 2
    return max(0, v)


# serving-plane OOM listeners: the HTTP gateway registers a callback
# that flips its breaker into brownout (answers `Degraded: true` from
# the last committed index) the moment any device site reports OOM
_OOM_LISTENERS: list = []
_OOM_LOCK = threading.Lock()


def on_oom(listener) -> None:
    with _OOM_LOCK:
        if listener not in _OOM_LISTENERS:
            _OOM_LISTENERS.append(listener)


def remove_oom_listener(listener) -> None:
    with _OOM_LOCK:
        if listener in _OOM_LISTENERS:
            _OOM_LISTENERS.remove(listener)


def notify_oom(site: str) -> None:
    """Tick the oom counter and brown out every registered serving
    gateway. Listener errors are swallowed — OOM handling must never
    make the failure worse."""
    stats = PLANE.stats
    if stats is not None:
        stats.on_device_oom(site)
    with _OOM_LOCK:
        listeners = list(_OOM_LISTENERS)
    for listener in listeners:
        try:
            listener(site)
        except Exception:
            pass


def _run_with_watchdog(site: str, thunk, timeout: float):
    """Run the launch on a worker thread with a deadline. A trip
    abandons the hung thread (daemon) — the record is the
    ``device_watchdog_trips_total`` counter plus the raised
    :class:`WatchdogTimeout`, which classifies permanent so the epoch
    aborts instead of waiting out the mesh backstop."""
    box: list = []

    def worker():
        try:
            box.append(("ok", thunk()))
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            box.append(("err", e))

    t = threading.Thread(
        target=worker, name=f"device-dispatch:{site}", daemon=True
    )
    t.start()
    t.join(timeout)
    if not box:
        stats = PLANE.stats
        if stats is not None:
            stats.on_device_watchdog_trip(site)
        raise WatchdogTimeout(
            f"device dispatch at {site} exceeded the "
            f"{timeout:g}s watchdog deadline"
        )
    status, value = box[0]
    if status == "err":
        raise value
    return value


def supervised_dispatch(site: str, thunk):
    """Run one device launch under supervision: the ``device.dispatch``
    fault point fires first (with ``site=`` context), then the thunk;
    classified failures take the ``device_dispatch_decide`` verdict —
    bounded-backoff retry, OOM brownout, or abort. Idempotence contract:
    the thunk must be safe to re-run (searches are; writes are upserts)."""
    from pathway_tpu_torch.internals import faults as _faults
    from pathway_tpu_torch.parallel import protocol as _proto

    timeout = dispatch_timeout_s()
    retries = dispatch_retries()
    attempt = 0
    while True:
        try:
            _faults.fault_point("device.dispatch", site=site)
            if timeout > 0:
                return _run_with_watchdog(site, thunk, timeout)
            return thunk()
        except BaseException as exc:  # noqa: BLE001 - classified below
            kind = classify_device_error(exc)
            verdict = _proto.device_dispatch_decide(kind, attempt, retries)
            stats = PLANE.stats
            if verdict[0] == "retry":
                attempt = verdict[1]
                if stats is not None:
                    stats.on_device_dispatch_retry(site)
                _time.sleep(min(
                    _RETRY_BACKOFF_CAP_S,
                    _RETRY_BACKOFF_BASE_S * (2 ** (attempt - 1)),
                ))
                continue
            if stats is not None:
                stats.on_device_dispatch_failure(site)
            if verdict[0] == "brownout":
                notify_oom(site)
                if isinstance(exc, DeviceOom):
                    raise
                raise DeviceOom(
                    f"device dispatch at {site} hit device memory "
                    f"exhaustion: {exc!r}"
                ) from exc
            raise
