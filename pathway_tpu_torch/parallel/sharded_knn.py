"""Mesh-sharded brute-force KNN index — the port of
``pathway_tpu/parallel/sharded_knn.py``.

Replaces the reference's broadcast-replicated external index
(src/engine/dataflow/operators/external_index.rs:95-106 — index diffs
broadcast so every worker holds a FULL copy, bounded by host RAM) with
one shard of the padded vector store per mesh device: queries go to
every shard, each shard computes a local top-k with the fused KNN kernel
(``ops/fused_knn.py``; the plain ``chunked_topk_scores`` on the CPU),
and the partials are merged into the global top-k — by one merge over
the shard-ordered lists (``gather``) or by recursive doubling
(``tree``, ``ops.topk.tree_merge_topk``), chosen by
``PATHWAY_INDEX_MERGE``. On CUDA both run the hand-written merge kernel
(``fused_knn.topk_merge``), which keeps the lower shard first on ties.

Delta routing: insert/delete deltas go to their OWNING shard by the
same stable mint the process mesh's exchange uses — ``procgroup.
shard_hash`` (blake2b-64) through ``protocol.shard_owner`` — so rows
spread evenly over the shards and a re-shard is a pure re-bucketing of
the same digests.

Write path: per delta batch, the rows are normalized (cos) on the first
shard's device, then each shard gets one in-place ``index_copy_`` of the
rows it owns, under the index lock, exactly like ``ops.knn.KnnShard``.

Devices: a mesh may name one device several times (four shards on one
card, eight on the CPU). Across distinct cards each shard's partials are
copied to the merging card after an event on the shard's stream.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch.internals import device as _devsup
from pathway_tpu_torch.internals.device import (
    PLANE as _DEVICE,
    device_site,
    nbytes_of,
    resolve_device,
    sharded_search_bucket,
    sharded_write_bucket,
)
from pathway_tpu_torch.internals.faults import fault_point
from pathway_tpu_torch.ops.fused_knn import (
    K_MAX,
    fused_topk_scores,
    topk_merge,
)
from pathway_tpu_torch.ops.knn import (
    KnnShard,
    Metric,
    _normalize,
    resolve_hits,
    scan_rows,
    write_cost_model,
)
from pathway_tpu_torch.ops.topk import (
    check_precision,
    chunked_topk_scores,
    to_device_after,
    topk_scan_cost,
    tree_merge_topk,
)
from pathway_tpu_torch.parallel.mesh import Mesh
from pathway_tpu_torch.parallel.procgroup import shard_hash
from pathway_tpu_torch.parallel.protocol import shard_owner

_MIN_LOCAL = 128


def _merge_mode(n_shards: int) -> str:
    """Resolve PATHWAY_INDEX_MERGE: 'tree' (recursive doubling) needs a
    pow2 shard count; 'auto' picks tree when the count allows it,
    'gather' is one merge over every shard's partial."""
    raw = str(os.environ.get("PATHWAY_INDEX_MERGE", "auto")).strip().lower()
    pow2 = n_shards & (n_shards - 1) == 0
    if raw == "tree":
        return "tree" if pow2 else "gather"
    if raw == "gather":
        return "gather"
    return "tree" if pow2 else "gather"


device_site(
    "knn.sharded_write",
    cost_model=write_cost_model,
    dtypes=("float32", "bool", "int64"),
    where="pathway_tpu_torch/parallel/sharded_knn.py:ShardedKnnIndex.add",
    donates=("vectors", "valid", "sq_norms"),
    description="in-place slot write into each shard's buffer triple",
)

device_site(
    "knn.sharded_search",
    cost_model=topk_scan_cost,
    dtypes=("float32", "bool", "int32"),
    where="pathway_tpu_torch/parallel/sharded_knn.py:ShardedKnnIndex.search",
    description="per-shard fused matmul + top-k with tree/gather merge "
                "over the shards",
)


def _pad_to(vals, idx, k: int):
    """Widen a [q, k'] partial to k with (-inf, 0) entries."""
    pad = k - vals.shape[-1]
    if pad <= 0:
        return vals, idx
    return (
        torch.nn.functional.pad(vals, (0, pad), value=float("-inf")),
        torch.nn.functional.pad(idx, (0, pad), value=0),
    )


def gather_merge_topk(vals, idx, k: int):
    """Global top-k of the shards' partials taken in shard order, ties to
    the lower shard: one merge kernel over the stacked lists on the first
    partial's device (the plain merge on the CPU). Each list is sorted
    (values descending), the merge's precondition."""
    dev = vals[0].device
    vals = [_pad_to(v, i, k) for v, i in zip(vals, idx)]
    v = torch.stack([to_device_after(a, dev) for a, _ in vals])
    i = torch.stack([to_device_after(b, dev) for _, b in vals])
    return topk_merge(v, i, k)


def sharded_topk(
    queries: torch.Tensor,
    databases: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    k: int,
    *,
    sq_norms: Sequence[torch.Tensor] | None = None,
    metric: str = "dot",
    merge: str = "gather",
    local_cap: int | None = None,
    chunk: int | None = None,
    precision: str = "highest",
):
    """Global top-k over a row-sharded database: shard ``s`` is
    ``databases[s]`` [rows_s, d] with ``valids[s]`` on its own device,
    and its rows are global slots ``s * local_cap + row`` (``local_cap``
    defaults to the first shard's rows; a shard may pass only the rows
    in use, a prefix of its buffer). Returns (values [q, k'], global
    slots [q, k']) on ``queries``' device, with
    k' = min(k, n_shards * k_l) and the per-shard k_l = min(k,
    local_cap, chunk) (``chunk`` None = the whole shard), as in the JAX
    package's ``sharded_topk``.

    Each shard's partial top-k is the fused KNN kernel pair on CUDA
    (``fused_topk_scores``, the instance for ``precision``) and
    ``chunked_topk_scores`` on the CPU; the partials merge by ``merge``
    ("gather" or "tree"), lower shard first on ties. ``chunk`` changes
    only k_l: a shard passes only its rows in use, which need not be a
    whole number of chunks, and its scores do not depend on the blocking."""
    check_precision(precision)
    n_shards = len(databases)
    if local_cap is None:
        local_cap = databases[0].shape[0]
    k_l = min(k, local_cap, chunk or local_cap)
    k_out = min(k, n_shards * k_l)
    vals, idx = [], []
    for s, (db, valid) in enumerate(zip(databases, valids)):
        q = to_device_after(queries, db.device)
        sq = sq_norms[s] if sq_norms is not None else None
        if db.device.type == "cuda":
            v, i = fused_topk_scores(q, db, valid, k_l, sq_norms=sq, metric=metric,
                                     precision=precision)
        else:
            v, i = chunked_topk_scores(q, db, valid, k_l, sq_norms=sq, metric=metric,
                                       precision=precision)
        vals.append(v)
        idx.append(i + s * local_cap)
    if merge == "tree" and n_shards > 1:
        # every round merges equal shapes: widen the partials first
        vals, idx = zip(*(_pad_to(v, i, k_out) for v, i in zip(vals, idx)))
        v, i = tree_merge_topk(vals, idx, k_out)
    else:
        v, i = gather_merge_topk(vals, idx, k_out)
    return to_device_after(v, queries.device), to_device_after(i, queries.device)


def sharded_write_slots(
    vectors: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    sq_norms: Sequence[torch.Tensor],
    local_cap: int,
    slots: np.ndarray,
    rows: torch.Tensor,
    flag: bool,
    *,
    normalize: bool = False,
) -> None:
    """The ``knn.sharded_write`` chain: global ``slots`` (shard * local_cap
    + local slot) written in place into each owning shard's buffer triple,
    one ``index_copy_`` per shard on the shard's device. The rows are
    normalized and their norms taken over the whole batch, as
    ``KnnShard`` does, so both indexes store the same bits. Module-level
    so the Device Doctor (analysis/device_plan.py) traces the same
    function ``ShardedKnnIndex`` launches."""
    rows = rows.to(torch.float32)
    if normalize:
        rows = _normalize(rows)
    sq = torch.sum(rows * rows, dim=-1)
    owner, local = np.divmod(slots, local_cap)
    for s in np.unique(owner):
        sel = np.flatnonzero(owner == s)
        dev = vectors[s].device
        pos = torch.from_numpy(sel).to(rows.device)
        idx = torch.from_numpy(local[sel]).to(dev)
        vectors[s].index_copy_(0, idx, to_device_after(rows[pos], dev))
        valids[s][idx] = flag
        sq_norms[s].index_copy_(0, idx, to_device_after(sq[pos], dev))


class ShardedKnnIndex:
    """Host-facing sharded index: the contract of ``ops.KnnShard``, but
    the vector store is laid out over a mesh axis, one shard per device.

    Slot layout: global slot = owner_shard * local_cap + local_slot; a
    key's owner shard is minted from its stable blake2b digest
    (``shard_owner(shard_hash(key), n_shards)``), so rows spread evenly
    and capacity scales with the mesh. Ties in query results are broken
    by insertion sequence on the host after the merge, so results are
    bit-identical to a single ``KnnShard`` fed the same operations (at
    the same ``precision``). ``chunk`` caps each shard's partial k, as in
    the JAX package; ``precision`` is "highest" or "default" as for
    ``KnnShard``.
    """

    def __init__(
        self,
        dimension: int,
        mesh: Mesh,
        *,
        metric: Metric | str = Metric.COS,
        axis: str = "dp",
        chunk: int | None = None,
        precision: str = "highest",
    ):
        self.dimension = int(dimension)
        self.mesh = mesh
        self.axis = axis
        self.metric = Metric(metric)
        self.chunk = chunk
        self.precision = check_precision(precision)
        self.devices = [resolve_device(d) for d in mesh.axis_devices(axis)]
        self.n_shards = len(self.devices)
        # writes are normalized, and merges land, on the first shard's device
        self.device = self.devices[0]
        # per-shard capacity is a power of two; total = n_shards * local
        self.local_cap = _MIN_LOCAL
        self.capacity = self.n_shards * self.local_cap
        self.key_to_slot: dict[Any, int] = {}
        self.slot_to_key: dict[int, Any] = {}
        # insertion-sequence mint for the deterministic tie-break (a
        # re-added key gets a fresh sequence — it is a new row)
        self.key_seq: dict[Any, int] = {}
        self._next_seq = 0
        self._empty_buffers()
        # writers hold it; query paths hold it across read + launch (the
        # same update-while-serving discipline as ops.knn.KnnShard)
        self.lock = threading.Lock()
        self.remove_epoch = 0
        self.slot_freed_epoch = np.full(self.capacity, -1, np.int64)
        # bumped whenever the global slots are laid out anew (a growth or
        # a restore): a search dispatched under another layout scans again
        self.layout = 0
        # dirty tracking + segment chain, same semantics as KnnShard
        from pathway_tpu_torch.persistence import index_snapshot as _isnap

        self.snapshot_name = _isnap.next_index_name("sknn")
        self._dirty: dict[Any, None] = {}
        self._dirty_removed: dict[Any, None] = {}
        self._segments: list[dict] = []
        self._retired: list[list[str]] = []
        # shape buckets met by the write and search sites
        self._seen_buckets: set = set()

    # device sites reachable through this index as an external-index
    # adapter
    device_sites = ("knn.sharded_write", "knn.sharded_search")

    def __len__(self) -> int:
        return len(self.key_to_slot)

    def _empty_buffers(self) -> None:
        """Zeroed shards at ``local_cap`` rows and their free lists of
        GLOBAL slots (shard s owns [s*local_cap, (s+1)*local_cap)):
        delta routing fills the OWNING shard."""
        local = self.local_cap
        self.vectors = self.valid = self.sq_norms = None
        self.vectors = [
            torch.zeros((local, self.dimension), dtype=torch.float32, device=d)
            for d in self.devices
        ]
        self.valid = [torch.zeros(local, dtype=torch.bool, device=d) for d in self.devices]
        self.sq_norms = [torch.zeros(local, dtype=torch.float32, device=d) for d in self.devices]
        self.free_by_shard: list[list[int]] = [
            list(range((s + 1) * local - 1, s * local - 1, -1))
            for s in range(self.n_shards)
        ]
        # rows in use per shard: a free list hands out its lowest fresh
        # slot first, so every live local slot lies below this mark and a
        # search scans only that prefix of each shard (when the shards'
        # buffers have outgrown their rows, the pow2 growth leaves up to
        # half of each empty)
        self.rows_used = [0] * self.n_shards

    # -- routing -----------------------------------------------------------
    def owner_shard(self, key) -> int:
        """The shard that owns ``key`` — the mesh's stable mint (blake2b
        digest mod world), so a re-shard is a pure re-bucketing."""
        return shard_owner(shard_hash(key), self.n_shards)

    def shard_fill(self) -> list[int]:
        """Live rows per shard."""
        fill = [0] * self.n_shards
        for slot in self.slot_to_key:
            fill[slot // self.local_cap] += 1
        return fill

    def rows_in_use(self) -> list[int]:
        """Per shard, the prefix of its buffer a search scans: every live
        local slot, rounded up to whole ``_TN``-row granules (the partial
        kernel's split granule; ``scan_rows``, as ``KnnShard``). Caller
        holds ``self.lock``."""
        return [scan_rows(u, self.local_cap) for u in self.rows_used]

    # shape check; the rows go to the first shard's device (``device``)
    _prepare = KnnShard._prepare

    # -- mutation ----------------------------------------------------------
    def _grow_to_local(self, local_needed: int) -> None:
        """Double local capacity until every shard can hold its rows.
        Global slot = shard * local_cap + local, so growth REMAPS every
        live slot on the host; each shard's rows keep their local slot."""
        local = self.local_cap
        while local < local_needed:
            local *= 2
        if local <= self.local_cap:
            return
        old_local = self.local_cap
        new_cap = self.n_shards * local
        pad = local - old_local
        # growth is the OOM site: stage into locals, commit only on
        # success — a refused growth leaves every shard serving at its
        # committed capacity while the failing add aborts
        try:
            fault_point("device.oom", site="knn.sharded_grow")
            grown = [
                (
                    torch.cat([v, v.new_zeros((pad, self.dimension))]),
                    torch.cat([m, m.new_zeros(pad)]),
                    torch.cat([sq, sq.new_zeros(pad)]),
                )
                for v, m, sq in zip(self.vectors, self.valid, self.sq_norms)
            ]
        except BaseException as exc:
            if _devsup.classify_device_error(exc) == "oom":
                _devsup.notify_oom("knn.sharded_grow")
                raise _devsup.DeviceOom(
                    f"sharded knn index refused growth to {new_cap} "
                    f"global slots (device memory exhausted): {exc!r}"
                ) from exc
            raise
        new_epoch = np.full(new_cap, -1, np.int64)
        for s in range(self.n_shards):
            new_epoch[s * local:s * local + old_local] = (
                self.slot_freed_epoch[s * old_local:(s + 1) * old_local]
            )
        remap = {}
        for old_slot, key in self.slot_to_key.items():
            s, l = divmod(old_slot, old_local)
            remap[s * local + l] = key
        new_free = []
        for s in range(self.n_shards):
            shifted = [
                s * local + (sl - s * old_local) for sl in self.free_by_shard[s]
            ]
            fresh = list(range(s * local + local - 1, s * local + old_local - 1, -1))
            new_free.append(fresh + shifted)
        self.vectors = [g[0] for g in grown]
        self.valid = [g[1] for g in grown]
        self.sq_norms = [g[2] for g in grown]
        self.slot_to_key = remap
        self.key_to_slot = {k: sl for sl, k in remap.items()}
        self.free_by_shard = new_free
        self.local_cap = local
        self.capacity = new_cap
        self.slot_freed_epoch = new_epoch
        self.layout += 1

    def _assign_slots(self, keys: Sequence[Any]) -> np.ndarray:
        """Route every key to a slot on its OWNING shard (upsert
        semantics), growing all shards when any owner is full. Must be
        called under ``self.lock``."""
        owners = {}
        pending: dict[int, int] = {}
        for key in keys:
            if key not in self.key_to_slot and key not in owners:
                s = owners[key] = self.owner_shard(key)
                pending[s] = pending.get(s, 0) + 1
        if pending:
            need = max(
                self.local_cap - len(self.free_by_shard[s]) + n
                for s, n in pending.items()
            )
            self._grow_to_local(need)
        slots = []
        for key in keys:
            slot = self.key_to_slot.get(key)
            if slot is None:
                s = owners[key]
                slot = self.free_by_shard[s].pop()
                self.rows_used[s] = max(self.rows_used[s], slot - s * self.local_cap + 1)
                self.key_to_slot[key] = slot
                self.slot_to_key[slot] = key
                self.key_seq[key] = self._next_seq
                self._next_seq += 1
            slots.append(slot)
            # upserted keys are dirty for the next snapshot cut
            self._dirty[key] = None
            self._dirty_removed.pop(key, None)
        return np.asarray(slots, np.int64)

    def _write_slots(self, slots: np.ndarray, rows: torch.Tensor, valid: bool,
                     *, normalize: bool = False) -> None:
        """In-place write of rows, validity and squared norms, one
        ``index_copy_`` per owning shard (``sharded_write_slots``). Caller
        holds ``self.lock``."""
        sharded_write_slots(
            self.vectors, self.valid, self.sq_norms, self.local_cap, slots,
            rows, valid, normalize=normalize,
        )

    def add(self, keys: Sequence[Any], vecs) -> None:
        """Upsert a batch: one in-place write per owning shard. Accepts
        numpy or tensors. Safe while queries are in flight."""
        vecs = self._prepare(vecs)
        if len(keys) != vecs.shape[0]:
            raise ValueError("keys/vectors length mismatch")
        with self.lock:
            slots = self._assign_slots(keys)
            _DEVICE.note_bucket(self._seen_buckets, "knn.sharded_write",
                                sharded_write_bucket(len(slots), self.capacity))
            dev = _DEVICE.begin("knn.sharded_write", self.device) if _DEVICE.on else None
            try:
                # supervised: injected faults raise before the launch, so
                # a retry rewrites the same slots (an upsert)
                _devsup.supervised_dispatch(
                    "knn.sharded_write",
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
                dev, self.vectors[0], flops=flops, bytes_accessed=acc,
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
                self.free_by_shard[slot // self.local_cap].append(slot)
                slots.append(slot)
                self._dirty_removed[key] = None
                self._dirty.pop(key, None)
            if not slots:
                return
            self.remove_epoch += 1
            slots_arr = np.asarray(slots, np.int64)
            self.slot_freed_epoch[slots_arr] = self.remove_epoch
            self._write_slots(
                slots_arr,
                torch.zeros((len(slots), self.dimension), device=self.device),
                False,
            )

    # -- snapshot / restore --------------------------------------------------
    def snapshot_state(self, *, extra=None) -> dict:
        """Delta-segment manifest (cut context armed) or inline full
        state — same contract as ``KnnShard.snapshot_state``."""
        from pathway_tpu_torch.persistence import index_snapshot as _isnap

        return _isnap.snapshot_index(self, extra=extra)

    def load_state(self, state: dict) -> dict:
        """Rebuild every shard from a committed snapshot; returns folded
        per-key extras. Restoring under a DIFFERENT mesh than the one that
        cut the snapshot is the N→M re-shard: ``_load_entries`` re-buckets
        every entry through the CURRENT ``owner_shard`` mint."""
        from pathway_tpu_torch.persistence import index_snapshot as _isnap

        return _isnap.restore_index(self, state)

    def _load_entries(self, entries: list) -> None:
        """Replace the corpus with ``[(key, seq, vector), ...]``, routing
        each key to its owning shard at the CURRENT ``n_shards``. Caller
        holds ``self.lock``. Rows are written as committed
        (``normalize=False``)."""
        n = len(entries)
        owners = np.fromiter(
            (self.owner_shard(key) for key, _seq, _row in entries), np.int64, n
        )
        per = np.bincount(owners, minlength=self.n_shards)
        local = _MIN_LOCAL
        while local < (per.max() if n else 0):
            local *= 2
        self.local_cap = local
        self.capacity = self.n_shards * local
        self.key_to_slot = {}
        self.slot_to_key = {}
        self.key_seq = {}
        # restore_index re-seats _next_seq from the snapshot afterwards
        self._next_seq = 0
        self.remove_epoch = 0
        self.slot_freed_epoch = np.full(self.capacity, -1, np.int64)
        self.layout += 1
        self._empty_buffers()
        if not n:
            return
        # each shard's entries take its free slots in ascending order
        local_slot = np.empty(n, np.int64)
        for s in range(self.n_shards):
            sel = owners == s
            local_slot[sel] = np.arange(per[s])
            del self.free_by_shard[s][local - per[s]:]
        self.rows_used = per.tolist()
        slots = owners * local + local_slot
        rows = np.empty((n, self.dimension), np.float32)
        for i, (key, seq, row) in enumerate(entries):
            slot = int(slots[i])
            self.key_to_slot[key] = slot
            self.slot_to_key[slot] = key
            self.key_seq[key] = int(seq)
            rows[i] = row
        self._write_slots(slots, torch.from_numpy(rows).to(self.device), True)

    # -- search ------------------------------------------------------------
    def search(self, queries, k: int) -> list[list[tuple[Any, float]]]:
        """Per-query [(key, score)] sorted by descending score, equal
        scores by insertion sequence — bit-identical to ``KnnShard``."""
        queries = self._prepare(queries)
        n = queries.shape[0]
        if n == 0 or not self.key_to_slot:
            return [[] for _ in range(n)]
        # the same query preparation as KnnShard.search, on the same device
        if self.metric is Metric.COS:
            queries = _normalize(queries)
        metric = "l2sq" if self.metric is Metric.L2SQ else "dot"
        queries = queries.contiguous()
        merge = _merge_mode(self.n_shards)
        while True:
            dev = _DEVICE.begin("knn.sharded_search", self.device) if _DEVICE.on else None
            try:
                with self.lock:  # read + launch before the next in-place write
                    bucket = sharded_search_bucket(
                        n, self.n_shards, self.local_cap, k, self.chunk
                    )
                    _DEVICE.note_bucket(
                        self._seen_buckets, "knn.sharded_search", bucket)
                    k_eff = min(bucket[2], K_MAX)
                    used = self.rows_in_use()
                    vals, idx = _devsup.supervised_dispatch(
                        "knn.sharded_search",
                        lambda: sharded_topk(
                            queries,
                            [v[:u] for v, u in zip(self.vectors, used)],
                            [m[:u] for m, u in zip(self.valid, used)],
                            k_eff,
                            sq_norms=(
                                [sq[:u] for sq, u in zip(self.sq_norms, used)]
                                if metric == "l2sq" else None
                            ),
                            metric=metric, merge=merge, local_cap=self.local_cap,
                            chunk=self.chunk, precision=self.precision,
                        ),
                    )
                    _DEVICE.enqueued(dev)
                    epoch = self.remove_epoch
                    layout = self.layout
                    live_rows = len(self.key_to_slot)
                    capacity = self.capacity
                vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            except BaseException:
                _DEVICE.end(dev, None, block=False)
                raise
            if dev is not None:
                flops, acc = topk_scan_cost(n, capacity, self.dimension, k_eff)
                flops_eff, _ = topk_scan_cost(n, live_rows, self.dimension, k_eff)
                _DEVICE.end(
                    dev, vals, flops=flops, flops_effective=flops_eff,
                    bytes_accessed=acc,
                    transfer_bytes=nbytes_of(queries, vals, idx),
                )
            # the slots are read back against the key maps of the layout
            # they were scanned under: a growth or a restore since the
            # dispatch gave every global slot another meaning, so scan again
            with self.lock:
                if self.layout == layout:
                    return resolve_hits(self, vals, idx, k, epoch)
