"""Fused ingest chain: tokenize → encode → index slot-write — the port of
``pathway_tpu/ops/ingest.py``.

* **One chain per batch**: the encoder forward, then an in-place slot
  write of the (already L2-normalized) embeddings into the KNN shard's
  device buffers, then the ``sq_norms`` update — no device→host round trip
  between encode and insert.
* **Tokenize-ahead host stage**: a producer thread tokenizes, pads and
  (on CUDA) starts the next batch's host→device copy from pinned memory
  on a side stream while the previous batch's chain runs; the compute
  stream waits on the copy's event before use. At most ``depth`` staged
  batches are in flight (``PATHWAY_INGEST_DEPTH``). ``stage_h2d=False``
  (``PATHWAY_INGEST_STAGE_H2D=0``) stages host tensors only: the batch is
  copied at dispatch, on the compute stream.
* **Supervision**: the chain is the ``ingest.fused`` device site, a timed
  dispatch record with its cost model and a launch under
  ``supervised_dispatch``. The ``device.h2d`` fault point fires while a
  batch is staged, before its copy is enqueued, and the producer restarts
  on the same batch when the classifier calls the failure transient, so a
  retried batch is staged afresh and its slots are assigned once.
* **Buckets**: each new (batch, seq, capacity, wire dtype) bucket notes a
  recompile at ``ingest.fused`` and, on the card, captures the encoder's
  CUDA graph for it.
* **Spans**: while the device plane is on with a flight recorder, ``run``
  numbers its batches (``trace_id``, carried by the ``ingest.fused``
  record too) and notes host spans: on the producer ``ingest.stage`` over
  ``ingest.tokenize``, ``ingest.pad`` and ``ingest.h2d``, then
  ``ingest.put_staged`` (blocked on a full queue: device-bound); on the
  consumer ``ingest.wait_staged`` (starved: host-bound) and
  ``ingest.dispatch`` over ``ingest.assign_slots`` (under the index
  lock).

Padded rows: the JAX chain writes them to slot ``== capacity``, which its
scatter drops (``mode="drop"``); torch has no drop mode, so only the first
``n`` rows are written.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import Any, Iterable, Sequence

import torch

from pathway_tpu_torch.analysis.eligibility import env_flag
from pathway_tpu_torch.internals import device as _devsup
from pathway_tpu_torch.internals.device import (
    PLANE as _DEVICE,
    device_site,
    ingest_bucket,
    nbytes_of,
    resolve_device,
)
from pathway_tpu_torch.internals.faults import fault_point
from pathway_tpu_torch.models.encoder import (
    SentenceEncoder,
    compact_tokens,
    expand_compact,
    forward_cost_model,
    pad_batch,
)
from pathway_tpu_torch.ops.knn import KnnShard, Metric

device_site(
    "ingest.fused",
    cost_model=forward_cost_model,
    dtypes=("int16", "int32", "float32", "bool"),
    where="pathway_tpu_torch/ops/ingest.py:IngestPipeline._dispatch",
    description="fused tokenize->encode->slot-write chain "
                "(in place in the index's device buffers)",
)


def fused_chain(forward, wire, compact: bool, n: int, write) -> torch.Tensor:
    """The ``ingest.fused`` chain on the device: the wire batch expanded
    to (ids, mask), ``forward`` (the encoder's), then ``write`` of the
    first ``n`` embeddings, the index's in-place slot write
    (``KnnShard._write_slots``, i.e. ``ops/knn.py write_slots``). Returns
    those embeddings. Module-level so the Device Doctor
    (analysis/device_plan.py) traces the same function ``IngestPipeline``
    launches, as the JAX package's doctor lowers its ``make_fused``."""
    if compact:
        ids, mask = expand_compact(*wire)
    else:
        ids, mask = wire[0].to(torch.int64), wire[1]
    emb = forward(ids, mask)[:n]
    # the encoder's rows are already unit-norm: store them as they are
    write(emb)
    return emb


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, "") or default)
        return v if v > 0 else default
    except ValueError:
        return default


class IngestPipeline:
    """Pipelined embed→index ingest over one encoder + one KNN shard.

    ``ingest(keys, texts)`` runs one batch through the fused chain;
    ``run(batches)`` drives the tokenize-ahead loop over an iterable of
    ``(keys, texts)`` batches. Not thread-safe itself (one producer, one
    dispatcher); concurrent queries against the shard remain safe — the
    chain holds the shard's writer lock across slot assignment and launch,
    as ``KnnShard.add`` does. ``device=None`` runs on the card; the encoder
    and the index must be on the pipeline's device.
    """

    site = "ingest.fused"

    def __init__(
        self,
        encoder: SentenceEncoder,
        index: KnnShard,
        *,
        depth: int | None = None,
        stage_h2d: bool | None = None,
        device: Any = None,
    ):
        self.device = resolve_device(device)
        if index.dimension != encoder.embed_dim:
            raise ValueError(
                f"index dimension {index.dimension} != encoder embed dim "
                f"{encoder.embed_dim}"
            )
        if index.metric not in (Metric.COS, Metric.DOT):
            # the chain stores L2-normalized embeddings; an L2SQ index
            # would need raw norms the encoder already collapsed to 1
            raise ValueError(
                "fused ingest supports cos/dot shards (normalized "
                f"embeddings), not {index.metric}"
            )
        if not index.device == encoder.device == self.device:
            raise ValueError(
                f"pipeline on {self.device}, index on {index.device}, "
                f"encoder on {encoder.device}"
            )
        self.encoder = encoder
        self.index = index
        self.depth = (
            depth if depth is not None
            else _env_int("PATHWAY_INGEST_DEPTH", 2)
        )
        self.stage_h2d = (
            stage_h2d if stage_h2d is not None
            else env_flag("PATHWAY_INGEST_STAGE_H2D", default=True)
        )
        # on CUDA, staged batches copy host->device on their own stream
        # (unless staging is off: then at dispatch, on the compute stream)
        self._copy_stream = (
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda" and self.stage_h2d else None
        )
        # running totals: real tokens are what the corpus contained,
        # padded tokens are what the device executed
        self.rows_ingested = 0
        self.real_tokens = 0
        self.padded_tokens = 0
        self._batch_ids = itertools.count(1)

    # -- host stage --------------------------------------------------------
    def _stage(self, keys: Sequence[Any], texts: Sequence[str], trace_id=None):
        """Tokenize + pad one batch and (on CUDA, with ``stage_h2d``)
        start its H2D copy.
        Runs on the producer thread in ``run`` — batch N+1 is staged while
        batch N's chain occupies the device. ``trace_id``: the batch's
        number in ``run`` (None outside it), carried to ``_dispatch``."""
        enc = self.encoder
        rec = _DEVICE.recorder if _DEVICE.on else None
        if rec is not None:
            stage = rec.span_start()
            span = rec.span_start()
        ids, mask = enc.tokenizer(list(texts))
        if rec is not None:
            rec.span_end("ingest.tokenize", span, trace_id)
            span = rec.span_start()
        ids_p, mask_p, n = pad_batch(
            ids, mask, enc.config.max_len, enc.batch_size
        )
        compact = compact_tokens(ids_p, mask_p, enc.config.vocab_size)
        if compact is None:
            wire = (torch.from_numpy(ids_p), torch.from_numpy(mask_p))
        else:
            wire = tuple(torch.from_numpy(a) for a in compact)
        eff_tokens = int(mask_p[:n].sum())
        if rec is not None:
            rec.span_end("ingest.pad", span, trace_id,
                         nb=ids_p.shape[0], Lb=ids_p.shape[1])
        # the injectable H2D staging failure fires per staged batch,
        # before any copy is enqueued: run()'s producer classifies it and
        # stages the same batch again
        fault_point("device.h2d", site=self.site)
        event = None
        if self._copy_stream is not None:
            if rec is not None:
                span = rec.span_start()
            # pinned source + async copy on the side stream: the device
            # pulls the next batch's tokens while it computes this one
            with torch.cuda.stream(self._copy_stream):
                wire = tuple(
                    t.pin_memory().to(self.device, non_blocking=True)
                    for t in wire
                )
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            if rec is not None:
                rec.span_end("ingest.h2d", span, trace_id)
        if rec is not None:
            rec.span_end("ingest.stage", stage, trace_id)
        return (list(keys), wire, compact is not None, event, n, eff_tokens,
                trace_id)

    # -- device stage ------------------------------------------------------
    def _dispatch(self, staged) -> torch.Tensor:
        keys, wire, compact, event, n, eff_tokens, trace_id = staged
        rec = _DEVICE.recorder if _DEVICE.on else None
        if rec is not None:
            whole = rec.span_start()
            _DEVICE.set_trace(trace_id)
        try:
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in wire:  # allocated on the copy stream, used on this one
                    t.record_stream(stream)
            wire = tuple(t.to(self.device) for t in wire)
            nb, Lb = wire[0].shape
            self.rows_ingested += n
            self.real_tokens += eff_tokens
            self.padded_tokens += nb * Lb
            index = self.index
            dev = _DEVICE.begin(self.site, self.device) if _DEVICE.on else None
            try:
                with index.lock:
                    if rec is not None:
                        span = rec.span_start()
                    slots = index._assign_slots(keys)
                    if rec is not None:
                        rec.span_end("ingest.assign_slots", span, trace_id)
                    # the wire carries uint16 ids (in int16 bits: torch has
                    # no uint16 arithmetic), the JAX package's bucket label
                    bucket = ingest_bucket(
                        nb, Lb, index.capacity, "uint16" if compact else "int32")

                    def forward(ids, mask):
                        return self.encoder.forward(
                            ids, mask, site=self.site, bucket=bucket)

                    def chain() -> torch.Tensor:
                        return fused_chain(
                            forward, wire, compact, n,
                            lambda emb: index._write_slots(slots, emb, True),
                        )

                    # injected faults raise before the launch, so a retry
                    # writes the same slots again (an upsert)
                    emb = _devsup.supervised_dispatch(self.site, chain)
            except BaseException:
                _DEVICE.end(dev, None, block=False)
                raise
            if dev is not None:
                # the forward dominates; the slot write adds the sq-norm
                # reduction and the row traffic (KnnShard.add's model)
                d = index.dimension
                flops, acc = forward_cost_model(self.encoder.config, nb, Lb)
                _DEVICE.end(
                    dev, emb, flops=flops + 4.0 * nb * d,
                    bytes_accessed=acc + 8.0 * nb * d + 8.0 * nb,
                    transfer_bytes=nbytes_of(*wire) + 8 * n,
                    effective_share=eff_tokens / float(nb * Lb),
                )
            return emb
        finally:
            if rec is not None:
                _DEVICE.set_trace(None)
                rec.span_end("ingest.dispatch", whole, trace_id)

    # -- public API --------------------------------------------------------
    def ingest(self, keys: Sequence[Any], texts: Sequence[str]) -> torch.Tensor:
        """One batch through the fused chain: tokenize (host), then
        encode + slot-write on the device. Returns the device-resident
        embeddings of the real rows."""
        if not keys:
            return torch.zeros(
                (0, self.encoder.embed_dim), dtype=torch.float32,
                device=self.device,
            )
        return self._dispatch(self._stage(keys, texts))

    def run(self, batches: Iterable[tuple[Sequence[Any], Sequence[str]]]) -> int:
        """Drive the pipelined loop: a tokenize-ahead producer thread
        stages up to ``depth`` batches while the caller's thread issues
        the fused chains. Returns the number of rows ingested, once the
        device has written them."""
        staged_q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list[BaseException] = []
        stop = threading.Event()

        def producer():
            # the connectors' SupervisorPolicy for the tokenize-ahead
            # stage: a transient fault (tokenizer I/O, the H2D copy)
            # restarts the producer on the SAME batch with bounded
            # backoff; a fault pulling from ``batches`` itself stays
            # permanent (a raised generator is dead)
            from pathway_tpu_torch.parallel import protocol as _proto
            from pathway_tpu_torch.udfs.retries import is_retryable

            retries = _devsup.dispatch_retries()
            try:
                for keys, texts in batches:
                    rec = _DEVICE.recorder if _DEVICE.on else None
                    bid = None if rec is None else next(self._batch_ids)
                    attempt = 0
                    while True:
                        if stop.is_set():
                            return
                        try:
                            staged = self._stage(keys, texts, bid)
                            break
                        except BaseException as e:
                            kind = (
                                "transient"
                                if isinstance(e, Exception) and is_retryable(e)
                                else "permanent"
                            )
                            verdict = _proto.device_dispatch_decide(
                                kind, attempt, retries
                            )
                            if verdict[0] != "retry":
                                raise
                            attempt = verdict[1]
                            stats = _DEVICE.stats
                            if stats is not None:
                                stats.on_device_dispatch_retry(self.site)
                            time.sleep(min(
                                _devsup._RETRY_BACKOFF_CAP_S,
                                _devsup._RETRY_BACKOFF_BASE_S * 2 ** (attempt - 1),
                            ))
                    if rec is None:
                        staged_q.put(staged)
                    else:
                        span = rec.span_start()
                        staged_q.put(staged)
                        rec.span_end("ingest.put_staged", span, bid)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                staged_q.put(None)

        t = threading.Thread(
            target=producer, name="ingest-tokenize-ahead", daemon=True
        )
        t.start()
        rows = 0
        try:
            while True:
                rec = _DEVICE.recorder if _DEVICE.on else None
                if rec is None:
                    staged = staged_q.get()
                else:
                    span = rec.span_start()
                    staged = staged_q.get()
                    rec.span_end("ingest.wait_staged", span,
                                 None if staged is None else staged[6])
                if staged is None:
                    break
                self._dispatch(staged)
                rows += staged[4]
        finally:
            # a failed dispatch must not leave the producer blocked on a
            # full queue
            stop.set()
            while t.is_alive():
                try:
                    staged_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return rows
