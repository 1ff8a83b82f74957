"""Serving-path query engine: tokenize -> encode -> top-k with one result
readback per batch — the port of ``pathway_tpu/ops/query_engine.py``.

Per-query cost is dominated by launches and the result readback, not
FLOPs, so the engine launches the encoder forward and the fused KNN
kernel (on CUDA) back to back and packs scores and slots into one f32
buffer: the host pays one device-to-host transfer per query batch. The
slots ride as the bits of their int32 values (``view``, not a conversion),
so the packing is exact at any capacity.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch.internals.device import knn_search_bucket, resolve_device
from pathway_tpu_torch.ops.knn import Metric


class QueryEngine:
    """encode+search for a SentenceEncoder + KnnShard pair.
    ``device=None`` runs on the card; the encoder and the shard must be on
    the engine's device."""

    def __init__(self, encoder, shard, *, k: int = 6, device: Any = None):
        self.device = resolve_device(device)
        if not shard.device == encoder.device == self.device:
            raise ValueError(
                f"engine on {self.device}, index on {shard.device}, "
                f"encoder on {encoder.device}"
            )
        self.encoder = encoder
        self.shard = shard
        self.k = k
        # the packed-buffer layout [vals | idx] uses THIS k_eff even if
        # the shard's capacity grows later
        self.k_eff = knn_search_bucket(1, shard.capacity, k, None)[2]
        # encoder outputs are L2-normalized, so cos == dot on the query
        # side; l2sq shards score with their cached squared norms
        self.metric = "l2sq" if shard.metric is Metric.L2SQ else "dot"

    def query(self, texts: Sequence[str]) -> list[list[tuple[Any, float]]]:
        texts = list(texts)
        if not texts or not self.shard.key_to_slot:
            return [[] for _ in texts]
        out: list[list[tuple[Any, float]]] = []
        cap = self.encoder.batch_size
        for start in range(0, len(texts), cap):
            out.extend(self.finish(self.dispatch(texts[start : start + cap])))
        return out

    def dispatch(self, texts: list[str]):
        """Phase 1: tokenize + launch the encoder and the search. Returns
        an opaque ticket without waiting for the device, so a caller can
        have several tickets in flight."""
        enc = self.encoder
        emb = enc.encode_tokens_device(*enc.tokenizer(texts))  # [n, d] unit rows
        n = emb.shape[0]
        with self.shard.lock:
            # read the buffers AND launch before the next in-place write;
            # the remove-epoch is captured under the same lock so a
            # slot-freeing remove cannot race this dispatch
            vals, idx = self.shard.topk(emb.contiguous(), self.k_eff, self.metric)
            epoch = self.shard.remove_epoch
        packed = torch.cat([vals, idx.view(torch.float32)], dim=1)
        return packed, n, epoch

    def finish(self, ticket) -> list[list[tuple[Any, float]]]:
        """Phase 2: the one device->host readback + result shaping."""
        packed, n, epoch = ticket
        k_eff = self.k_eff
        host = packed.cpu().numpy()  # the ONE readback
        vals = host[:, :k_eff]
        idx = np.ascontiguousarray(host[:, k_eff:]).view(np.int32)
        out = []
        for qi in range(n):
            hits = []
            for vv, slot in zip(vals[qi], idx[qi]):
                if not np.isfinite(vv):
                    continue
                slot = int(slot)
                # slot freed after our dispatch (possibly reused by a new
                # key): the mapping this score belongs to is gone
                if self.shard.slot_freed_epoch[slot] > epoch:
                    continue
                key = self.shard.slot_to_key.get(slot)
                if key is None:
                    continue
                hits.append((key, float(vv)))
                if len(hits) == self.k:
                    break
            out.append(hits)
        return out


class _Err:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class MicroBatcher:
    """Concurrent serving front-end: collect in-flight queries for up to
    ``max_wait_ms`` (or ``max_batch`` queries), then ONE encode+search
    dispatch and ONE packed readback for the whole group.

    Two-stage pipeline: the collector thread tokenizes + dispatches, a pool
    of readback threads waits on the device->host transfers, so several
    batches' readbacks can be in flight.
    """

    def __init__(
        self,
        engine: QueryEngine,
        *,
        max_wait_ms: float = 2.0,
        max_batch: int | None = None,
        readback_workers: int = 4,
    ):
        self.engine = engine
        # clamp to the encoder's padded batch capacity: _flush dispatches
        # one batch directly, bypassing query()'s cap-splitting
        self.max_batch = min(
            max_batch or engine.encoder.batch_size, engine.encoder.batch_size
        )
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._tickets: "queue.Queue" = queue.Queue()
        self._closed = False
        self._collector = threading.Thread(target=self._collect, daemon=True)
        self._readers = [
            threading.Thread(target=self._readback, daemon=True)
            for _ in range(max(1, readback_workers))
        ]
        self._collector.start()
        for t in self._readers:
            t.start()

    # -- client API -------------------------------------------------------
    def query(self, text: str, timeout: float | None = 30.0):
        """Blocking single-query call, safe from many threads: the query
        rides the next micro-batch. Returns [(key, score), ...]."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        slot: "queue.SimpleQueue" = queue.SimpleQueue()
        self._q.put((text, slot))
        res = slot.get(timeout=timeout)
        if isinstance(res, _Err):
            raise res.exc
        return res

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._collector.join(timeout=5)
        # fail any request that raced past the closed check after the
        # sentinel: an explicit error now beats an opaque timeout later
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].put(_Err(RuntimeError("MicroBatcher is closed")))
        for _ in self._readers:
            self._tickets.put(None)
        for t in self._readers:
            t.join(timeout=5)

    # -- pipeline stages --------------------------------------------------
    def _collect(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=rem)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch: list) -> None:
        texts = [t for t, _ in batch]
        slots = [s for _, s in batch]
        if not self.engine.shard.key_to_slot:
            for s in slots:
                s.put([])
            return
        try:
            ticket = self.engine.dispatch(texts)
        except Exception as exc:
            for s in slots:
                s.put(_Err(exc))
            return
        self._tickets.put((ticket, slots))

    def _readback(self) -> None:
        while True:
            got = self._tickets.get()
            if got is None:
                return
            ticket, slots = got
            try:
                results = self.engine.finish(ticket)
            except Exception as exc:
                for s in slots:
                    s.put(_Err(exc))
                continue
            for s, r in zip(slots, results):
                s.put(r)
