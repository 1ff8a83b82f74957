"""Device-resident brute-force KNN shard — the port of
``pathway_tpu/ops/knn.py``.

The vector store lives on the device as a padded f32 [capacity, d] tensor
with a validity mask and cached squared norms; capacity doubles on growth
(powers of two from 128); deletes are O(1) slot-free-list operations. A
search scans only the rows in use, the prefix of the buffer below the
highest slot ever handed out (``KnnShard.rows_in_use``): on CUDA in one
launch of the hand-written fused KNN kernel (``ops/fused_knn.py``), on
the CPU by the plain ``chunked_topk_scores``.

Writes are in place (``index_copy_``/indexed assignment). The JAX shard
gets the same effect by donating its buffers to the write executable.

Writes and searches are the device sites ``knn.write`` and ``knn.search``:
each launch runs under ``supervised_dispatch`` and, while the device plane
is armed, inside one timed dispatch record (``internals/device.py``).
Growth passes the ``device.oom`` fault point (site ``knn.grow``); a refused
growth leaves the index serving at its committed capacity.

Snapshots: every upsert marks its key dirty and every remove marks it
removed, so a persistence cut writes only the rows touched since the
last one (``persistence/index_snapshot.py``); a restore rewrites the
committed rows as they were stored, so scores and the ``key_seq``
tie-break come back bit-identical.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch.internals import device as _devsup
from pathway_tpu_torch.internals.device import (
    PLANE as _DEVICE,
    device_site,
    knn_search_bucket,
    knn_write_bucket,
    nbytes_of,
    pow2_capacity,
    resolve_device,
)
from pathway_tpu_torch.internals.faults import fault_point
from pathway_tpu_torch.ops.fused_knn import _TN, fused_topk_scores
from pathway_tpu_torch.ops.topk import (
    NEG_INF,
    check_precision,
    chunked_topk_scores,
    topk_scan_cost,
)

_MIN_CAPACITY = 128


class Metric(enum.Enum):
    COS = "cos"
    L2SQ = "l2sq"
    DOT = "dot"


def write_cost_model(nrows: int, d: int) -> tuple[float, float]:
    """Analytical ``(flops, bytes_accessed)`` of one slot write: the
    optional normalize + sq-norm reduction over the written rows,
    touching the rows + norms in device memory."""
    return 4.0 * nrows * d, 8.0 * nrows * d + 8.0 * nrows


device_site(
    "knn.write",
    cost_model=write_cost_model,
    dtypes=("float32", "bool", "int64"),
    where="pathway_tpu_torch/ops/knn.py:KnnShard.add",
    donates=("vectors", "valid", "sq_norms"),
    description="in-place slot write into the device buffer triple",
)

device_site(
    "knn.search",
    cost_model=topk_scan_cost,
    dtypes=("float32", "bool", "int32"),
    where="pathway_tpu_torch/ops/knn.py:KnnShard.search",
    description="fused matmul + top-k scan over the padded vector store",
)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-30)


def write_slots(vectors: torch.Tensor, valid: torch.Tensor,
                sq_norms: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                flag: bool, *, normalize: bool = False) -> None:
    """The ``knn.write`` chain: rows, validity and squared norms written
    into the buffer triple in place (``index_copy_`` / ``index_put_`` on
    the buffers themselves, never a copy of them). Module-level so the
    Device Doctor (analysis/device_plan.py) traces the same function
    ``KnnShard`` launches, as the JAX package's doctor lowers its
    ``_write_slots``."""
    rows = rows.to(torch.float32)
    if normalize:
        rows = _normalize(rows)
    vectors.index_copy_(0, idx, rows)
    valid[idx] = flag
    sq_norms.index_copy_(0, idx, torch.sum(rows * rows, dim=-1))


def scan_rows(mark: int, capacity: int) -> int:
    """The prefix of a ``capacity``-row buffer a search scans when every
    live slot lies below ``mark``: the mark rounded up to whole
    ``_TN``-row granules (the partial kernel's split granule), at least
    one granule, at most the buffer. ``KnnShard`` and each shard of
    ``ShardedKnnIndex`` take their prefix from here."""
    return min(capacity, -(-max(mark, 1) // _TN) * _TN)


def search_topk(queries: torch.Tensor, vectors: torch.Tensor,
                valid: torch.Tensor, sq_norms: torch.Tensor, k_eff: int,
                metric: str, precision: str = "highest",
                chunk: int | None = None):
    """The ``knn.search`` chain: (values, slots) of the ``k_eff`` best
    rows per query, on the buffers' device — the fused KNN kernel pair
    on CUDA (any k_eff of ``knn_search_bucket``, 1..8192; the instance
    for ``precision``), the plain chunked scan in ``chunk``-row blocks
    elsewhere (the kernel plans its own splits: ``chunk`` only caps
    ``k_eff``, as in the JAX package). ``metric`` is "dot" or "l2sq".
    The buffers may be a prefix of fewer than ``k_eff`` rows: the missing
    entries are (-inf, slot 0) on both devices, as the kernel writes them.
    Module-level for the Device Doctor, which traces the plain scan on
    meta tensors (a kernel bound through ctypes does not trace)."""
    sq = sq_norms if metric == "l2sq" else None
    if vectors.device.type == "cuda":
        return fused_topk_scores(
            queries, vectors, valid, k_eff, sq_norms=sq, metric=metric,
            precision=precision,
        )
    vals, idx = chunked_topk_scores(
        queries, vectors, valid, k_eff, chunk=chunk, sq_norms=sq,
        metric=metric, precision=precision,
    )
    short = k_eff - vals.shape[1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, short))
    return vals, idx


class KnnShard:
    """One device shard of a brute-force index: add/remove/search.

    The host side owns the key↔slot mapping; the device side only sees
    dense slots. ``device=None`` runs on the card. ``chunk`` caps a
    search's k at that many rows, as in the JAX package (and blocks the
    plain scan by it; None = the scores budget's block). ``precision`` is
    "highest" (fp32 scores) or "default" (TF32 operands: the kernel's
    one-pass instance, ~1e-3 score error on unit vectors).
    """

    def __init__(
        self,
        dimension: int,
        metric: Metric | str = Metric.COS,
        *,
        chunk: int | None = None,
        precision: str = "highest",
        capacity: int = _MIN_CAPACITY,
        device: Any = None,
    ):
        self.dimension = int(dimension)
        self.metric = Metric(metric)
        self.chunk = chunk
        self.precision = check_precision(precision)
        self.device = resolve_device(device)
        # pre-size to the expected corpus size to avoid growth copies
        self.capacity = pow2_capacity(capacity)
        self.key_to_slot: dict[Any, int] = {}
        self.slot_to_key: dict[int, Any] = {}
        # insertion-sequence mint for the deterministic tie-break: equal
        # scores order by when the key was (last) inserted, so results
        # never depend on slot layout
        self.key_seq: dict[Any, int] = {}
        self._next_seq = 0
        self.free_slots: list[int] = list(range(self.capacity - 1, -1, -1))
        # rows in use: 1 + the highest slot handed out since the buffers
        # were last rebuilt. The free list hands out its lowest fresh slot
        # first and refills freed ones first, so every live slot lies
        # below it and a search scans only that prefix (``rows_in_use``);
        # it never falls on remove and growth leaves it as it is
        self.rows_used = 0
        self.vectors = torch.zeros(
            (self.capacity, self.dimension), dtype=torch.float32, device=self.device
        )
        self.valid = torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
        self.sq_norms = torch.zeros(
            self.capacity, dtype=torch.float32, device=self.device
        )
        # serializes writers against query launches (update-while-serving):
        # writers hold it; query paths hold it across read + launch, so a
        # search is stream-ordered before the next in-place write (the
        # launch is asynchronous, so the critical section is short)
        self.lock = threading.Lock()
        # slot-reuse guard for in-flight queries: a hit resolved AFTER its
        # dispatch must not map a slot freed (and possibly reused) in
        # between to the new key. remove() stamps freed slots with a
        # monotonically increasing epoch; readers capture the epoch at
        # dispatch and drop hits whose slot was freed later.
        self.remove_epoch = 0
        self.slot_freed_epoch = np.full(self.capacity, -1, np.int64)
        # per-epoch dirty tracking for delta snapshots plus the committed
        # segment chain this index extends. _dirty/_dirty_removed are
        # insertion-ordered key sets (dicts), mutually exclusive per key:
        # a re-added key leaves the removed set, a removed key leaves the
        # dirty set.
        from pathway_tpu_torch.persistence import index_snapshot as _isnap

        self.snapshot_name = _isnap.next_index_name("knn")
        self._dirty: dict[Any, None] = {}
        self._dirty_removed: dict[Any, None] = {}
        self._segments: list[dict] = []
        self._retired: list[list[str]] = []
        # shape buckets met by the write and search sites
        self._seen_buckets: set = set()

    # device sites reachable through this index as an external-index
    # adapter
    device_sites = ("knn.write", "knn.search")

    def __len__(self) -> int:
        return len(self.key_to_slot)

    # -- mutation ---------------------------------------------------------
    def _grow_to(self, n: int) -> None:
        new_cap = pow2_capacity(n)
        if new_cap <= self.capacity:
            return
        pad = new_cap - self.capacity
        dev = self.device
        # growth is the OOM site: allocate the doubled buffers into locals
        # and commit only on success, so a refused growth leaves the index
        # serving at its committed capacity (the failing add aborts; the
        # serving breaker browns out through notify_oom)
        try:
            fault_point("device.oom", site="knn.grow")
            vectors = torch.cat(
                [self.vectors, torch.zeros((pad, self.dimension), device=dev)]
            )
            valid = torch.cat(
                [self.valid, torch.zeros(pad, dtype=torch.bool, device=dev)]
            )
            sq_norms = torch.cat([self.sq_norms, torch.zeros(pad, device=dev)])
        except BaseException as exc:
            if _devsup.classify_device_error(exc) == "oom":
                _devsup.notify_oom("knn.grow")
                raise _devsup.DeviceOom(
                    f"knn index refused growth to {new_cap} slots "
                    f"(device memory exhausted): {exc!r}"
                ) from exc
            raise
        self.vectors, self.valid, self.sq_norms = vectors, valid, sq_norms
        self.free_slots = (
            list(range(new_cap - 1, self.capacity - 1, -1)) + self.free_slots
        )
        self.slot_freed_epoch = np.concatenate(
            [self.slot_freed_epoch, np.full(pad, -1, np.int64)]
        )
        self.capacity = new_cap

    def _prepare(self, vecs) -> torch.Tensor:
        """Shape check; a tensor already on the device stays there (no
        host round trip when chaining from the encoder)."""
        if isinstance(vecs, torch.Tensor):
            vecs = vecs.to(self.device, torch.float32)
        else:
            vecs = torch.from_numpy(np.asarray(vecs, dtype=np.float32)).to(self.device)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape[-1] != self.dimension:
            raise ValueError(
                f"vector dimension {vecs.shape[-1]} != index dimension {self.dimension}"
            )
        return vecs

    def _assign_slots(self, keys: Sequence[Any]) -> np.ndarray:
        """Map keys to dense slots (upsert semantics), growing first.
        Must be called under ``self.lock`` — shared by ``add`` and the
        fused ingest chain (ops/ingest.py)."""
        self._grow_to(len(self.key_to_slot) + len(keys))
        slots = []
        for key in keys:
            slot = self.key_to_slot.get(key)
            if slot is None:
                slot = self.free_slots.pop()
                self.key_to_slot[key] = slot
                self.slot_to_key[slot] = key
                self.key_seq[key] = self._next_seq
                self._next_seq += 1
            slots.append(slot)
            # every upserted key is dirty for the next snapshot cut; this
            # also captures the fused ingest chain, which assigns slots
            # here before its encoder + write launch
            self._dirty[key] = None
            self._dirty_removed.pop(key, None)
        slots = np.asarray(slots, dtype=np.int64)
        # raised before the caller launches the write that makes these
        # slots valid, so a search ordered after that write scans them
        if len(slots):
            self.rows_used = max(self.rows_used, int(slots.max()) + 1)
        return slots

    def _write_slots(self, slots: np.ndarray, rows: torch.Tensor, valid: bool,
                     *, normalize: bool = False) -> None:
        """In-place slot write of rows, validity and squared norms. Caller
        holds ``self.lock``."""
        write_slots(
            self.vectors, self.valid, self.sq_norms,
            torch.from_numpy(slots).to(self.device), rows, valid,
            normalize=normalize,
        )

    def add(self, keys: Sequence[Any], vecs) -> None:
        """Upsert vectors; accepts numpy or tensors (a device tensor avoids
        a host round trip). Safe while queries are in flight."""
        vecs = self._prepare(vecs)
        if len(keys) != vecs.shape[0]:
            raise ValueError("keys/vectors length mismatch")
        with self.lock:
            slots = self._assign_slots(keys)
            _DEVICE.note_bucket(self._seen_buckets, "knn.write",
                                knn_write_bucket(len(slots), self.capacity))
            dev = _DEVICE.begin("knn.write", self.device) if _DEVICE.on else None
            try:
                # supervised: injected faults raise before the launch, so
                # a retry rewrites the same slots (an upsert)
                _devsup.supervised_dispatch(
                    "knn.write",
                    lambda: self._write_slots(
                        slots, vecs, True, normalize=self.metric is Metric.COS
                    ),
                )
            except BaseException:
                _DEVICE.end(dev, None, block=False)
                raise
        if dev is not None:
            flops, acc = write_cost_model(len(slots), self.dimension)
            _DEVICE.end(
                dev, self.vectors, flops=flops, bytes_accessed=acc,
                transfer_bytes=nbytes_of(vecs) + 8 * len(slots),
            )

    def remove(self, keys: Sequence[Any]) -> None:
        with self.lock:
            slots = []
            for key in keys:
                slot = self.key_to_slot.pop(key, None)
                if slot is None:
                    continue
                del self.slot_to_key[slot]
                self.key_seq.pop(key, None)
                self.free_slots.append(slot)
                slots.append(slot)
                self._dirty_removed[key] = None
                self._dirty.pop(key, None)
            if not slots:
                return
            self.remove_epoch += 1
            slots_arr = np.asarray(slots, dtype=np.int64)
            self.slot_freed_epoch[slots_arr] = self.remove_epoch
            self._write_slots(
                slots_arr,
                torch.zeros((len(slots), self.dimension), device=self.device),
                False,
            )

    # -- snapshot / restore -----------------------------------------------
    def snapshot_state(self, *, extra=None) -> dict:
        """Node state for the current persistence cut: a delta-segment
        manifest when a cut context is armed (persistence/index_snapshot),
        an inline full state otherwise. ``extra`` is an optional
        key->payload mapping that rides the segments (adapter metadata)."""
        from pathway_tpu_torch.persistence import index_snapshot as _isnap

        return _isnap.snapshot_index(self, extra=extra)

    def load_state(self, state: dict) -> dict:
        """Rebuild the device buffers and host maps from a committed
        snapshot (manifest chain or inline state) instead of re-embedding;
        returns the folded per-key extra payloads."""
        from pathway_tpu_torch.persistence import index_snapshot as _isnap

        return _isnap.restore_index(self, state)

    def _load_entries(self, entries: list) -> None:
        """Replace the whole corpus with ``[(key, seq, vector), ...]``.
        Caller holds ``self.lock``. Vectors are as committed (already
        normalized for cos), so the rewrite uses ``normalize=False``, in
        one batched ``index_copy_`` on the shard's device."""
        n = len(entries)
        self.capacity = pow2_capacity(max(n, _MIN_CAPACITY))
        self.key_to_slot = {}
        self.slot_to_key = {}
        self.key_seq = {}
        # the old corpus (and its mint position) is gone; restore_index
        # re-seats _next_seq from the snapshot so inserts after a restore
        # mint the same sequences as the uninterrupted run
        self._next_seq = 0
        self.free_slots = list(range(self.capacity - 1, -1, -1))
        self.remove_epoch = 0
        self.slot_freed_epoch = np.full(self.capacity, -1, np.int64)
        # drop the old buffers before allocating the new ones
        self.vectors = self.valid = self.sq_norms = None
        self.vectors = torch.zeros(
            (self.capacity, self.dimension), dtype=torch.float32, device=self.device
        )
        self.valid = torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
        self.sq_norms = torch.zeros(
            self.capacity, dtype=torch.float32, device=self.device
        )
        self.rows_used = n
        if not n:
            return
        # slots pop from the free list in ascending order: 0 .. n-1
        slots = np.arange(n, dtype=np.int64)
        del self.free_slots[self.capacity - n:]
        rows = np.empty((n, self.dimension), np.float32)
        for i, (key, seq, row) in enumerate(entries):
            self.key_to_slot[key] = i
            self.slot_to_key[i] = key
            self.key_seq[key] = int(seq)
            rows[i] = row
        self._write_slots(slots, torch.from_numpy(rows).to(self.device), True)

    # -- search -----------------------------------------------------------
    def rows_in_use(self) -> int:
        """The prefix of the buffer a search scans: every live slot,
        rounded up to whole ``_TN``-row granules (``scan_rows``). Caller
        holds ``self.lock``."""
        return scan_rows(self.rows_used, self.capacity)

    def topk(self, queries: torch.Tensor, k_eff: int, metric: str):
        """(values, slots) on the device for queries already on it, at
        the shard's precision, over the rows in use (every slot past them
        is invalid, so the answer is the whole buffer's): the fused kernel
        on CUDA (any k_eff of ``knn_search_bucket``, 1..8192), the plain
        chunked scan on the CPU. ``metric`` is "dot" or "l2sq". Caller
        holds ``self.lock``."""
        u = self.rows_in_use()
        return search_topk(
            queries, self.vectors[:u], self.valid[:u], self.sq_norms[:u], k_eff,
            metric, self.precision, self.chunk,
        )

    def search(self, queries, k: int) -> list[list[tuple[Any, float]]]:
        """Return per-query [(key, score)] sorted by descending score.

        Scores: cos/dot similarity, or negated squared L2 distance.
        """
        queries = self._prepare(queries)
        n = queries.shape[0]
        if n == 0 or not self.key_to_slot:
            return [[] for _ in range(n)]
        if self.metric is Metric.COS:
            queries = _normalize(queries)
        metric = "l2sq" if self.metric is Metric.L2SQ else "dot"
        queries = queries.contiguous()
        # one timed dispatch record per scan (one attribute check when the
        # plane is off); it closes after the readback, outside the lock
        dev = _DEVICE.begin("knn.search", self.device) if _DEVICE.on else None
        try:
            with self.lock:  # read + launch before the next in-place write
                bucket = knn_search_bucket(n, self.capacity, k, self.chunk)
                _DEVICE.note_bucket(self._seen_buckets, "knn.search", bucket)
                k_eff = bucket[2]
                vals, idx = _devsup.supervised_dispatch(
                    "knn.search", lambda: self.topk(queries, k_eff, metric)
                )
                _DEVICE.enqueued(dev)
                epoch = self.remove_epoch
                live_rows = len(self.key_to_slot)
                scanned = self.rows_in_use()
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        except BaseException:
            # close the record on the failure path too: an abandoned
            # record leaks queue depth
            _DEVICE.end(dev, None, block=False)
            raise
        if dev is not None:
            flops, acc = topk_scan_cost(n, scanned, self.dimension, k_eff)
            # effective FLOPs: only live rows count as useful work — the
            # freed slots and the granule's tail below the mark are waste
            flops_eff, _ = topk_scan_cost(n, live_rows, self.dimension, k_eff)
            _DEVICE.end(
                dev, vals, flops=flops, flops_effective=flops_eff,
                bytes_accessed=acc,
                transfer_bytes=nbytes_of(queries, vals, idx),
            )
        return resolve_hits(self, vals, idx, k, epoch)


def resolve_hits(index, vals, idx, k: int, epoch: int) -> list:
    """Host side of a search: per query, the ``(key, score)`` hits of the
    ``[Q, k_eff]`` values and slots read back from the device, sorted by
    descending score, equal scores by insertion sequence, cut to ``k``.
    Shared by ``KnnShard`` and ``ShardedKnnIndex``."""
    out: list[list[tuple[Any, float]]] = []
    for qi in range(vals.shape[0]):
        hits = []
        for vv, slot in zip(vals[qi], idx[qi]):
            if not np.isfinite(vv):
                continue
            slot = int(slot)
            # slot freed after our dispatch (possibly reused by a new
            # key): this hit's key mapping is gone — drop it
            if index.slot_freed_epoch[slot] > epoch:
                continue
            key = index.slot_to_key.get(slot)
            if key is None:
                continue
            hits.append((key, float(vv)))
        # deterministic tie-break over ALL k_eff candidates before
        # truncating: equal scores order by insertion sequence, so the
        # result never depends on slot layout (which a sharded index
        # lays out differently)
        hits.sort(key=lambda t: (-t[1], index.key_seq.get(t[0], 0)))
        out.append(hits[:k])
    return out
