"""Serving-path query engine: tokenize -> encode -> top-k with one result
readback per batch — the port of ``pathway_tpu/ops/query_engine.py``.

Per-query cost is dominated by launches and the result readback, not
FLOPs, so the engine launches the encoder forward and the fused KNN
kernel (on CUDA) back to back and packs scores and slots into one f32
buffer: the host pays one device-to-host transfer per query batch. The
slots ride as the bits of their int32 values (``view``, not a conversion),
so the packing is exact at any capacity.

While the device plane is on with a flight recorder, the path records
host spans (``FlightRecorder.note_span``), each batch's under the batch's
number (``trace_id``), which its ``encoder.forward`` and ``knn.fused``
dispatch records carry too:

* per request: ``serve.queue_wait`` (``MicroBatcher.query``'s put until
  the collector takes it) and ``serve.handoff`` (the answer's put until
  the client's ``get`` returns), both no thread's own;
* on the collector: ``serve.idle`` (waiting for a batch's first request),
  ``serve.collect`` (the batching window; ``closed_by`` full, timeout or
  close), then ``serve.dispatch`` (``n`` queries) over
  ``serve.tokenize``, the encoder's ``encoder.pad`` / ``encoder.h2d`` /
  ``encoder.launch``, ``knn.lock_wait`` and ``knn.launch`` (``tile``: the
  partial kernel's query-tile instance on the card; ``rows``: the prefix
  of the shard's buffer the search scanned), and the device
  plane's ``plane.begin`` / ``plane.end`` of each dispatch record;
* ``serve.ticket_wait`` (a batch waiting for a readback thread), then on
  that thread ``serve.finish`` over ``serve.readback`` (the one
  device-to-host copy, which waits for the device) and ``serve.keymap``.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch.internals.device import (
    PLANE as _DEVICE,
    knn_search_bucket,
    resolve_device,
)
from pathway_tpu_torch.ops.fused_knn import plan_tile
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
        # the shard's capacity grows later; the shard's chunk caps it
        self.k_eff = knn_search_bucket(1, shard.capacity, k, shard.chunk)[2]
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
        rec = _DEVICE.recorder if _DEVICE.on else None
        if rec is not None:
            tid = _DEVICE.current_trace()
            span = rec.span_start()
        tokens = enc.tokenizer(texts)
        if rec is not None:
            rec.span_end("serve.tokenize", span, tid)
        emb = enc.encode_tokens_device(*tokens)  # [n, d] unit rows
        n = emb.shape[0]
        if rec is not None:
            span = rec.span_start()
        with self.shard.lock:
            if rec is not None:
                rec.span_end("knn.lock_wait", span, tid)
                span = rec.span_start()
            # read the buffers AND launch before the next in-place write;
            # the remove-epoch is captured under the same lock so a
            # slot-freeing remove cannot race this dispatch
            vals, idx = self.shard.topk(emb.contiguous(), self.k_eff, self.metric)
            epoch = self.shard.remove_epoch
            if rec is not None:
                rows = self.shard.rows_in_use()
        packed = torch.cat([vals, idx.view(torch.float32)], dim=1)
        if rec is not None:
            tile = (plan_tile(n, self.k_eff, self.shard.precision).n
                    if self.device.type == "cuda" else None)
            rec.span_end("knn.launch", span, tid, tile=tile, rows=rows)
        return packed, n, epoch

    def finish(self, ticket) -> list[list[tuple[Any, float]]]:
        """Phase 2: the one device->host readback + result shaping."""
        packed, n, epoch = ticket
        k_eff = self.k_eff
        rec = _DEVICE.recorder if _DEVICE.on else None
        if rec is not None:
            tid = _DEVICE.current_trace()
            span = rec.span_start()
        host = packed.cpu().numpy()  # the ONE readback
        if rec is not None:
            rec.span_end("serve.readback", span, tid)
            span = rec.span_start()
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
        if rec is not None:
            rec.span_end("serve.keymap", span, tid)
        return out


class _Err:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _Handoff:
    """An answer put for a traced request: when, and under which batch,
    so the client notes ``serve.handoff``."""

    __slots__ = ("value", "t_put", "trace_id")

    def __init__(self, value, t_put: int, trace_id):
        self.value = value
        self.t_put = t_put
        self.trace_id = trace_id


class MicroBatcher:
    """Concurrent serving front-end: collect in-flight queries for up to
    ``max_wait_ms`` (or ``max_batch`` queries), then ONE encode+search
    dispatch and ONE packed readback for the whole group.

    Two-stage pipeline: the collector thread tokenizes + dispatches, a pool
    of readback threads waits on the device->host transfers, so several
    batches' readbacks can be in flight. While traced (module docstring),
    batches are numbered from 1 in the order the collector opens them.
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
        self._batch_ids = itertools.count(1)
        self._collector = threading.Thread(
            target=self._collect, name="microbatcher-collect", daemon=True)
        self._readers = [
            threading.Thread(target=self._readback,
                             name=f"microbatcher-readback-{i}", daemon=True)
            for i in range(max(1, readback_workers))
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
        rec = _DEVICE.recorder if _DEVICE.on else None
        slot: "queue.SimpleQueue" = queue.SimpleQueue()
        # the third field: when the request was queued, 0 untraced
        self._q.put((text, slot, 0 if rec is None else time.perf_counter_ns()))
        res = slot.get(timeout=timeout)
        if rec is not None and type(res) is _Handoff:
            rec.note_span("serve.handoff", res.t_put, time.perf_counter_ns(),
                          None, res.trace_id)
            res = res.value
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
            rec = _DEVICE.recorder if _DEVICE.on else None
            idle = None if rec is None else rec.span_start()
            item = self._q.get()
            if item is None:
                return
            if rec is None:  # the plane may have been armed meanwhile
                rec = _DEVICE.recorder if _DEVICE.on else None
            bid = None
            if rec is not None:
                bid = next(self._batch_ids)
                if idle is not None:
                    rec.span_end("serve.idle", idle, bid)
                span = rec.span_start()
                self._taken(rec, item, bid)
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
                    if rec is not None:
                        rec.span_end("serve.collect", span, bid, closed_by="close")
                    self._flush(batch, rec, bid)
                    return
                if rec is not None:
                    self._taken(rec, nxt, bid)
                batch.append(nxt)
            if rec is not None:
                rec.span_end("serve.collect", span, bid, closed_by=(
                    "full" if len(batch) >= self.max_batch else "timeout"))
            self._flush(batch, rec, bid)

    @staticmethod
    def _taken(rec, item, bid) -> None:
        if item[2]:  # queued by a traced request
            rec.note_span("serve.queue_wait", item[2], time.perf_counter_ns(),
                          None, bid)

    def _flush(self, batch: list, rec, bid) -> None:
        texts = [t for t, _, _ in batch]
        slots = [s for _, s, _ in batch]
        if not self.engine.shard.key_to_slot:
            for s in slots:
                s.put([])
            return
        if rec is not None:
            _DEVICE.set_trace(bid)
            span = rec.span_start()
        try:
            ticket = self.engine.dispatch(texts)
        except Exception as exc:
            for s in slots:
                s.put(_Err(exc))
            return
        finally:
            if rec is not None:
                rec.span_end("serve.dispatch", span, bid, n=len(texts))
                _DEVICE.set_trace(None)
        if rec is None:
            self._tickets.put((ticket, slots, None, None, 0))
        else:
            self._tickets.put((ticket, slots, bid, [t for _, _, t in batch],
                               time.perf_counter_ns()))

    def _readback(self) -> None:
        while True:
            got = self._tickets.get()
            if got is None:
                return
            # queued: the batch's requests' queue times (0 untraced)
            ticket, slots, bid, queued, t_ticket = got
            rec = _DEVICE.recorder if _DEVICE.on else None
            if rec is not None and bid is not None:
                rec.note_span("serve.ticket_wait", t_ticket,
                              time.perf_counter_ns(), None, bid)
                _DEVICE.set_trace(bid)
                span = rec.span_start()
            else:
                rec = None
            try:
                results = self.engine.finish(ticket)
            except Exception as exc:
                for s in slots:
                    s.put(_Err(exc))
                continue
            finally:
                if rec is not None:
                    rec.span_end("serve.finish", span, bid)
                    _DEVICE.set_trace(None)
            if rec is None:
                for s, r in zip(slots, results):
                    s.put(r)
            else:
                for s, r, t in zip(slots, results, queued):
                    s.put(_Handoff(r, time.perf_counter_ns(), bid) if t else r)
