"""Device-resident brute-force KNN shard — the port of
``pathway_tpu/ops/knn.py``.

The vector store lives on the device as a padded f32 [capacity, d] tensor
with a validity mask and cached squared norms; capacity doubles on growth
(powers of two from 128); deletes are O(1) slot-free-list operations. On
CUDA a search is one launch of the hand-written fused KNN kernel
(``ops/fused_knn.py``); on the CPU it is the plain ``chunked_topk_scores``.

Writes are in place (``index_copy_``/indexed assignment). The JAX shard
gets the same effect by donating its buffers to the write executable.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch.internals.device import (
    knn_search_bucket,
    pow2_capacity,
    resolve_device,
)
from pathway_tpu_torch.ops.fused_knn import fused_topk_scores
from pathway_tpu_torch.ops.topk import chunked_topk_scores

_MIN_CAPACITY = 128


class Metric(enum.Enum):
    COS = "cos"
    L2SQ = "l2sq"
    DOT = "dot"


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-30)


class KnnShard:
    """One device shard of a brute-force index: add/remove/search.

    The host side owns the key↔slot mapping; the device side only sees
    dense slots. ``device=None`` runs on the card.
    """

    def __init__(
        self,
        dimension: int,
        metric: Metric | str = Metric.COS,
        *,
        capacity: int = _MIN_CAPACITY,
        device: Any = None,
    ):
        self.dimension = int(dimension)
        self.metric = Metric(metric)
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

    def __len__(self) -> int:
        return len(self.key_to_slot)

    # -- mutation ---------------------------------------------------------
    def _grow_to(self, n: int) -> None:
        new_cap = pow2_capacity(n)
        if new_cap <= self.capacity:
            return
        pad = new_cap - self.capacity
        dev = self.device
        self.vectors = torch.cat(
            [self.vectors, torch.zeros((pad, self.dimension), device=dev)]
        )
        self.valid = torch.cat(
            [self.valid, torch.zeros(pad, dtype=torch.bool, device=dev)]
        )
        self.sq_norms = torch.cat([self.sq_norms, torch.zeros(pad, device=dev)])
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
        return np.asarray(slots, dtype=np.int64)

    def _write_slots(self, slots: np.ndarray, rows: torch.Tensor, valid: bool,
                     *, normalize: bool = False) -> None:
        """In-place slot write of rows, validity and squared norms. Caller
        holds ``self.lock``."""
        idx = torch.from_numpy(slots).to(self.device)
        rows = rows.to(torch.float32)
        if normalize:
            rows = _normalize(rows)
        self.vectors.index_copy_(0, idx, rows)
        self.valid[idx] = valid
        self.sq_norms.index_copy_(0, idx, torch.sum(rows * rows, dim=-1))

    def add(self, keys: Sequence[Any], vecs) -> None:
        """Upsert vectors; accepts numpy or tensors (a device tensor avoids
        a host round trip). Safe while queries are in flight."""
        vecs = self._prepare(vecs)
        if len(keys) != vecs.shape[0]:
            raise ValueError("keys/vectors length mismatch")
        with self.lock:
            slots = self._assign_slots(keys)
            self._write_slots(
                slots, vecs, True, normalize=self.metric is Metric.COS
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

    # -- search -----------------------------------------------------------
    def topk(self, queries: torch.Tensor, k_eff: int, metric: str):
        """(values, slots) on the device for queries already on it:
        the fused kernel on CUDA (any k_eff of ``knn_search_bucket``,
        1..8192), the plain chunked scan on the CPU. ``metric`` is "dot" or "l2sq". Caller holds
        ``self.lock``."""
        sq = self.sq_norms if metric == "l2sq" else None
        if self.device.type == "cuda":
            return fused_topk_scores(
                queries, self.vectors, self.valid, k_eff, sq_norms=sq,
                metric=metric,
            )
        return chunked_topk_scores(
            queries, self.vectors, self.valid, k_eff, sq_norms=sq, metric=metric
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
        with self.lock:  # read + launch before the next in-place write
            _, _, k_eff = knn_search_bucket(n, self.capacity, k, None)
            vals, idx = self.topk(queries.contiguous(), k_eff, metric)
            epoch = self.remove_epoch
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        out: list[list[tuple[Any, float]]] = []
        for qi in range(n):
            hits = []
            for vv, slot in zip(vals[qi], idx[qi]):
                if not np.isfinite(vv):
                    continue
                slot = int(slot)
                # slot freed after our dispatch (possibly reused by a new
                # key): this hit's key mapping is gone — drop it
                if self.slot_freed_epoch[slot] > epoch:
                    continue
                key = self.slot_to_key.get(slot)
                if key is None:
                    continue
                hits.append((key, float(vv)))
            # deterministic tie-break over ALL k_eff candidates before
            # truncating: equal scores order by insertion sequence, so the
            # result never depends on slot layout
            hits.sort(key=lambda t: (-t[1], self.key_seq.get(t[0], 0)))
            out.append(hits[:k])
        return out
