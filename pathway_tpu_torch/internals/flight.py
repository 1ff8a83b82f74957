"""Flight recorder: per-node / per-wave tracing with event-time lag
watermarks and Perfetto (Chrome-trace JSON) export.

The reference engine exports OTLP spans plus input/output latency gauges
from inside the dataflow (SURVEY: src/engine/telemetry.rs, ProberStats);
this is the equivalent attribution layer for the batch-per-timestamp
engine: always compiled, armed by the ``PATHWAY_TRACE=out.json`` knob,
near-zero overhead when disarmed (one attribute check on the step path).

What gets recorded, per rank:

* **per-node spans** from the runtime's step loop (engine/runtime.py
  ``_step_node``): node id + Plan Doctor provenance, commit timestamp,
  rows in, batch representation (columnar NativeBatch vs materialized
  tuples) and self-time — ``process()`` does not recurse into children
  (delivery only buffers), so its duration IS the node's self-time;
* **native batch timers** from the GIL-free regions of native/exec.cpp
  (monotonic clock into a preallocated per-thread ring buffer, no Py*
  calls — ``trace_ring_*``), drained between engine steps;
* **per-wave mesh events** from parallel/procgroup.py: one span per
  exchange wave, per-peer send frames with byte counts, receiver-thread
  decode spans, plus heartbeat/rollback/epoch instant marks;
* **event-time lag watermarks**: connectors stamp ingest time at flush
  (io/_connector.py), sinks report commit→emit latency — the per-output
  freshness histogram also lands on OpenMetrics
  (internals/monitoring.py ``output_lag_ms``);
* **host spans of the serve and ingest paths** (``note_span``:
  ops/query_engine.py, models/encoder.py ``encode_tokens_device``,
  ops/ingest.py), each with its wall span, the thread's CPU time over it
  (wall less CPU is off-CPU time: the GIL, lock waits, blocking copies)
  and the batch number (``trace_id``) that the batch's device dispatch
  records carry too. A span site pays one attribute check while the
  device plane is off or has no recorder.

Export: one track per rank×thread. Multi-rank runs write per-rank
partials (``<path>.r<rank>``) that rank 0 merges at shutdown — clock
offsets between ranks are sampled during the epoch's clock handshake
(runtime ``("tsync",)`` round) and RESAMPLED at every epoch commit
(per-segment offsets, so multi-minute runs don't skew late-run span
alignment as the monotonic clocks drift) so merged per-track
timestamps stay monotonic; ``parallel/supervisor.py`` re-merges as a
fallback after rollback recoveries. All timestamps are ``time.perf_counter_ns()`` /
C++ ``steady_clock`` — the same CLOCK_MONOTONIC timebase.

``python -m pathway_tpu_torch.analysis --profile trace.json`` joins the trace
back onto the plan's NBDecision verdicts (analysis/profile.py).
"""

from __future__ import annotations

import json
import os
import threading as _threading
import time as _time
from bisect import bisect_right
from typing import Any

# native ring tags (exec.cpp enum TraceTag)
NATIVE_TAGS = {
    1: "gb_apply",
    2: "join_apply",
    3: "shard_partition",
    4: "nb_encode",
    5: "nb_decode",
    6: "nb_concat",
    7: "arrow_export",  # columnar egress: capture collect + Arrow export
}

TRACE_SCHEMA_VERSION = 1

# the torch.profiler annotation the device plane emits when it is armed
# inside a profiler session: its perf_counter_ns is the recorder's
# ``clock_anchor_ns``, which places the recorder's events on the
# profiler's clock (``merge_into_profiler_trace``)
CLOCK_MARK = "pathway.clock"
# pid base of the recorder's tracks inside a profiler's trace file, clear
# of the profiler's own (the OS pid for the host, the card's index for
# its streams)
PROFILER_PID_BASE = 1_000_000


def trace_path() -> str | None:
    """The PATHWAY_TRACE knob: path of the Perfetto JSON to write."""
    return os.environ.get("PATHWAY_TRACE") or None


def ring_capacity() -> int:
    try:
        return int(os.environ.get("PATHWAY_TRACE_RING_EVENTS", "") or 65536)
    except ValueError:
        return 65536


def max_events() -> int:
    try:
        return int(
            os.environ.get("PATHWAY_TRACE_MAX_EVENTS", "") or 2_000_000
        )
    except ValueError:
        return 2_000_000


def partial_path(path: str, rank: int) -> str:
    return f"{path}.r{rank}"


class FlightRecorder:
    """Low-overhead in-memory event log for ONE rank's run.

    Hot-path contract: every ``note_*`` is one perf_counter read plus a
    tuple append (list.append is GIL-atomic, so procgroup receiver
    threads may note concurrently with the main loop). Everything
    else — metadata, Chrome-trace conversion, merging — happens once at
    shutdown.
    """

    def __init__(self, path: str, rank: int = 0, world: int = 1):
        import collections

        self.path = path
        self.rank = rank
        self.world = world
        # offset to rank 0's timebase, as SEGMENTS: (start_mono_ns,
        # offset_ns) — the epoch's clock handshake opens segment 0 and
        # every epoch commit resamples (monotonic clocks drift apart
        # over multi-minute runs; a single handshake-time offset skews
        # late-run span alignment in the merged trace). Events convert
        # with the offset that was current when they were recorded.
        self._offset_segments: list[tuple[int, int]] = [(0, 0)]
        # bounded (PATHWAY_TRACE_MAX_EVENTS): a long-running traced
        # streaming pipeline must not grow heap without limit until the
        # shutdown dump — the deque keeps the NEWEST events (the tail is
        # what a post-mortem wants) and the dump records that the head
        # was capped
        self.max_events = max_events()
        self.events: "collections.deque[tuple]" = collections.deque(
            maxlen=self.max_events
        )
        self.native_events: "collections.deque[tuple]" = collections.deque(
            maxlen=self.max_events
        )
        # events evicted at the deque's maxlen (a full-but-never-
        # overflowed deque is NOT capped — len alone can't tell)
        self.dropped = 0
        # wall/mono anchors: map monotonic event times onto wall clock
        # (OTLP span export; merge fallback when no tsync ran)
        self.wall_anchor_ns = _time.time_ns()
        self.mono_anchor_ns = _time.perf_counter_ns()
        # perf_counter_ns of the CLOCK_MARK annotation, when the device
        # plane was armed inside a torch.profiler session
        self.clock_anchor_ns: int | None = None
        self._ring_armed = False
        self.dumped = False

    @classmethod
    def from_env(cls, local_only: bool = False) -> "FlightRecorder | None":
        """Armed iff PATHWAY_TRACE names an output path. ``local_only``
        runtimes (iterate fixpoint bodies) never record — they would
        clobber the owning run's file."""
        path = trace_path()
        if path is None or local_only:
            return None
        from pathway_tpu_torch.internals.config import get_pathway_config

        c = get_pathway_config()
        return cls(path, rank=c.process_id, world=max(1, c.processes))

    # -- clock offsets ----------------------------------------------------
    # bound on retained tsync samples: one per epoch commit, so a
    # commit-per-second pipeline would otherwise grow this without limit
    # (like the event deque, the NEWEST samples matter — evicted ones
    # correspond to events the bounded deque has already dropped)
    _SEGMENT_CAP = 8192

    @property
    def clock_offset_ns(self) -> int:
        """The CURRENT offset to rank 0's timebase (latest sample)."""
        return self._offset_segments[-1][1]

    @clock_offset_ns.setter
    def clock_offset_ns(self, offset_ns: int) -> None:
        # the epoch handshake's first tsync sample, anchored at the
        # sample instant (events before it convert with this offset
        # unshifted; later samples interpolate forward from here)
        self._offset_segments = [
            (_time.perf_counter_ns(), int(offset_ns))
        ]

    def resample_clock_offset(
        self, offset_ns: int, at_ns: int | None = None
    ) -> None:
        """Record a fresh tsync sample at `at_ns` (now by default).
        Conversion interpolates LINEARLY between consecutive samples
        (constant outside them): the linear-drift model keeps
        multi-minute multi-rank traces aligned without stretching one
        stale handshake offset over the run, and — unlike a step
        function — it is continuous and monotone (|Δoffset| between
        commits is microseconds against seconds of wall, so the
        conversion slope stays ~1), so a resample can never step a
        track's converted timestamps backwards. Out-of-order samples
        are dropped to keep the list sorted."""
        at = _time.perf_counter_ns() if at_ns is None else int(at_ns)
        if at <= self._offset_segments[-1][0]:
            return
        self._offset_segments.append((at, int(offset_ns)))
        if len(self._offset_segments) > self._SEGMENT_CAP:
            # drop the second sample, keeping the first as the baseline
            # anchor for whatever pre-history the event deque retains
            del self._offset_segments[1]

    def _offset_at(self, ns: int) -> int:
        segs = self._offset_segments
        i = bisect_right(segs, (ns, float("inf"))) - 1
        if i < 0:
            return segs[0][1]
        if i + 1 >= len(segs):
            return segs[i][1]
        t0, o0 = segs[i]
        t1, o1 = segs[i + 1]
        return o0 + (o1 - o0) * (ns - t0) // (t1 - t0)

    # -- hot-path notes ---------------------------------------------------
    # (kind, ...) tuples; perf_counter_ns timestamps throughout

    def _note(self, ev: tuple) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1  # deque evicts the head on this append
        self.events.append(ev)

    def note_node(self, nid, t_commit, t0, t1, rows, nb) -> None:
        self._note(("node", nid, t_commit, t0, t1, rows, nb))

    def note_step(self, t_commit, t0, t1) -> None:
        self._note(("step", t_commit, t0, t1))

    def note_wave(self, t_commit, wave_no, t0, t1, n_nodes) -> None:
        self._note(("wave", t_commit, wave_no, t0, t1, n_nodes))

    def note_send(self, peer, t0, t1, nbytes) -> None:
        self._note(("send", peer, t0, t1, nbytes))

    def note_recv_wait(self, peer, t0, t1) -> None:
        self._note(("recvw", peer, t0, t1))

    def note_decode(self, peer, t0, t1, nbytes) -> None:
        # called from procgroup receiver threads (append is GIL-atomic)
        self._note(("decode", peer, t0, t1, nbytes))

    def note_decompress(self, peer, t0, t1, wire_bytes, raw_bytes) -> None:
        # receiver-thread sub-span of a frame decode: the
        # codec's share of the decode leg plus its byte ratio. The span
        # is synthetic-contiguous (per-segment inflations interleave
        # with segment decodes; duration is exact, placement starts at
        # the first inflation).
        self._note(("dzip", peer, t0, t1, wire_bytes, raw_bytes))

    def note_dispatch(
        self, site, seq, node, t_commit, t0, t_ret, t_done,
        flops, bytes_accessed, transfer_bytes, depth,
        flops_effective=None, trace_id=None,
    ) -> None:
        # device plane (internals/device.py): one record per
        # JAX dispatch an engine site issued — wall span [t0, t_done],
        # enqueue boundary t_ret (device time = t_done - t_ret, bounded
        # by block_until_ready), compiled-cost FLOPs/bytes, transfer
        # bytes and the dispatch-queue depth at launch. `node` is the
        # enclosing engine node (None for off-engine dispatches like the
        # gateway's window commit) — the correlation key back to the
        # node span on the engine track. flops_effective is
        # the real-row share of flops (None = fully effective) — the
        # profile's effective-MFU column rides the trace with it.
        # trace_id: the batch number of the host spans around the launch
        # (None outside a numbered batch).
        self._note(
            ("disp", site, seq, node, t_commit, t0, t_ret, t_done,
             flops, bytes_accessed, transfer_bytes, depth,
             flops if flops_effective is None else flops_effective,
             trace_id)
        )

    def note_span(self, name, t0_ns, t1_ns, cpu_ns, trace_id, **args) -> None:
        # a host span of the serve or ingest path on the calling thread:
        # cpu_ns is the thread's CPU time over [t0_ns, t1_ns], or None
        # for a span that is no thread's (a request's wait in a queue,
        # noted by whichever thread ends it)
        self._note(
            ("span", name, _threading.get_ident(), t0_ns, t1_ns, cpu_ns,
             trace_id, args)
        )

    @staticmethod
    def span_start() -> tuple[int, int]:
        """(wall ns, thread CPU ns) at a span's start; ``span_end``
        closes it. Wall is read outside CPU at both ends, so a span's
        CPU time never exceeds its wall."""
        t = _time.perf_counter_ns()
        return t, _time.thread_time_ns()

    def span_end(self, name, start, trace_id, **args) -> None:
        c = _time.thread_time_ns()
        t1 = _time.perf_counter_ns()
        self.note_span(name, start[0], t1, c - start[1], trace_id, **args)

    def note_mark(self, name: str, **args: Any) -> None:
        self._note(("mark", name, _time.perf_counter_ns(), args))

    def note_lag(self, label, t_commit, t_ns, lag_ms, rows) -> None:
        self._note(("lag", label, t_commit, t_ns, lag_ms, rows))

    # -- native ring ------------------------------------------------------
    def arm_native_ring(self) -> None:
        """Preallocate the exec.cpp per-thread rings (no-op without the
        toolchain)."""
        ex = self._pwexec()
        if ex is None or not hasattr(ex, "trace_ring_enable"):
            return
        from pathway_tpu_torch.internals.config import get_pathway_config

        try:
            ex.trace_ring_enable(
                ring_capacity(), get_pathway_config().threads + 1
            )
            self._ring_armed = True
        except Exception:
            pass

    def drain_native(self) -> None:
        """Pull buffered GIL-free batch timers out of the C rings —
        called between engine steps so long runs can't wrap the ring.
        The rings are process-global: under the emulated-rank CI lane
        (several thread-ranks per process) whichever rank drains next
        claims the buffered events, so per-rank native attribution in
        that lane is approximate; real multi-rank runs are separate
        processes and attribute exactly."""
        if not self._ring_armed:
            return
        ex = self._pwexec()
        if ex is None:
            return
        try:
            evs = ex.trace_ring_drain()
        except Exception:
            return
        if evs:
            overflow = (
                len(self.native_events) + len(evs) - self.max_events
            )
            if overflow > 0:
                self.dropped += min(overflow, len(self.native_events))
            self.native_events.extend(evs)

    def disarm_native_ring(self) -> None:
        if not self._ring_armed:
            return
        self._ring_armed = False
        ex = self._pwexec()
        if ex is not None and hasattr(ex, "trace_ring_disable"):
            try:
                ex.trace_ring_disable()
            except Exception:
                pass

    @staticmethod
    def _pwexec():
        try:
            from pathway_tpu_torch.native import get_pwexec

            return get_pwexec()
        except Exception:
            return None

    # -- metadata ---------------------------------------------------------
    def node_meta(self, scope) -> dict:
        """Per-node metadata joined onto the trace: label, declaring
        user frame (Plan Doctor provenance), and the NBDecision verdict
        — the SAME objects the executor gates its columnar paths on, so
        measured and static verdicts cannot drift."""
        meta: dict[str, dict] = {}
        if scope is None:
            return meta
        for i, node in enumerate(scope.nodes):
            ent: dict[str, Any] = {
                "label": f"{type(node).__name__}#{i}",
                "kind": type(node).__name__,
            }
            tr = getattr(node, "trace", None)
            if tr is not None:
                ent["provenance"] = (
                    f"{getattr(tr, 'filename', '?')}:"
                    f"{getattr(tr, 'lineno', '?')} in "
                    f"{getattr(tr, 'name', '?')}"
                )
            dec = getattr(node, "nb_decision", None)
            if dec is not None:
                ent["verdict"] = "fused" if getattr(dec, "ok", False) else (
                    "degraded"
                )
                blame = getattr(dec, "blame", ()) or ()
                if blame:
                    ent["blame"] = list(blame)[:4]
            if getattr(node, "device_node", False):
                # this node's process() issues JAX dispatches (engine/
                # nodes.py Node.device_node): the device plane's spans
                # correlate to it, and --profile joins its roofline
                # verdict here
                ent["device"] = True
            kind = type(node).__name__
            if kind in ("OutputNode", "CaptureNode"):
                ent["sink"] = True
                # egress verdict keyed on the CONSUMER's declared
                # capability: an Arrow-batch consumer (or a
                # CaptureNode with the columnar export door) consumes
                # NativeBatch output without row expansion. row_expanding
                # marks the sinks that pay PER-ROW Python work they could
                # avoid: a per-row on_change callback (always), a rows
                # consumer over a statically-columnar chain (every
                # C-owned batch materializes), or a doorless CaptureNode.
                # A batched rows consumer of an already-tuple chain is
                # NOT row-expanding — the rows were never columnar.
                try:
                    from pathway_tpu_torch.analysis.eligibility import (
                        sink_consumer_columnar,
                        sink_row_expands,
                    )

                    ent["egress"] = (
                        "columnar"
                        if sink_consumer_columnar(node).ok
                        else "rows"
                    )
                    if sink_row_expands(node):
                        ent["row_expanding"] = True
                except Exception:
                    ent["egress"] = "rows"
                    ent["row_expanding"] = True
            meta[str(i)] = ent
        return meta

    # -- Chrome-trace conversion ------------------------------------------
    def _us(self, ns: int) -> float:
        # ns precision in µs units = 3 decimals; rounding keeps json
        # reprs short (encode time is part of the measured run). The
        # offset applied is the tsync sample that was CURRENT when the
        # event was recorded (per-segment; resampled at epoch commits).
        return round((ns + self._offset_at(ns)) / 1000.0, 3)

    def chrome_events(self, scope=None) -> list[dict]:
        """Convert the raw event log into Chrome-trace events (ts/dur in
        microseconds, clock offset to rank 0 applied). One track per
        rank×thread: tid 0 = engine step loop, 100+w = native executor
        threads, 200+peer = receiver threads."""
        pid = self.rank
        out: list[dict] = [
            {
                "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": f"rank {pid}"},
            },
            {
                "ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
                "args": {"name": "engine"},
            },
        ]
        named_tids: set[int] = {0}

        def tid_named(tid: int, name: str) -> int:
            if tid not in named_tids:
                named_tids.add(tid)
                out.append(
                    {
                        "ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": name},
                    }
                )
            return tid

        dispatch_tids: dict[str, int] = {}
        thread_tids: dict[int, int] = {}
        wait_tids: dict[str, int] = {}
        thread_names = {t.ident: t.name for t in _threading.enumerate()}
        labels: dict[int, str] = {}
        if scope is not None:
            labels = {
                i: f"{type(n).__name__}#{i}"
                for i, n in enumerate(scope.nodes)
            }
        # snapshot first: receiver threads may still append decode notes
        # (deques raise on mutation during iteration; list(deque) is a
        # single C-level copy under the GIL)
        for ev in list(self.events):
            kind = ev[0]
            if kind == "node":
                _, nid, t_commit, t0, t1, rows, nb = ev
                out.append(
                    {
                        "name": labels.get(nid, f"node#{nid}"),
                        "cat": "node", "ph": "X", "pid": pid, "tid": 0,
                        "ts": self._us(t0),
                        "dur": _dur_us(t0, t1),
                        "args": {
                            "node": nid, "t": t_commit, "rows": rows,
                            "rep": "nb" if nb else "tuple",
                        },
                    }
                )
            elif kind == "step":
                _, t_commit, t0, t1 = ev
                out.append(
                    {
                        "name": "step", "cat": "step", "ph": "X",
                        "pid": pid, "tid": 0, "ts": self._us(t0),
                        "dur": _dur_us(t0, t1),
                        "args": {"t": t_commit},
                    }
                )
            elif kind == "wave":
                _, t_commit, wave_no, t0, t1, n_nodes = ev
                out.append(
                    {
                        "name": f"wave {wave_no}", "cat": "wave",
                        "ph": "X", "pid": pid, "tid": 0,
                        "ts": self._us(t0),
                        "dur": _dur_us(t0, t1),
                        "args": {"t": t_commit, "exchanges": n_nodes},
                    }
                )
            elif kind == "send":
                # sender-thread track: sends drain off the
                # engine loop, so their spans overlap node/wave spans —
                # a dedicated per-peer track keeps every track's spans
                # properly nested for the schema check
                _, peer, t0, t1, nbytes = ev
                tid = tid_named(300 + peer, f"send peer {peer}")
                out.append(
                    {
                        "name": f"send→{peer}", "cat": "mesh", "ph": "X",
                        "pid": pid, "tid": tid, "ts": self._us(t0),
                        "dur": _dur_us(t0, t1),
                        "args": {"bytes": nbytes, "peer": peer},
                    }
                )
            elif kind == "recvw":
                _, peer, t0, t1 = ev
                out.append(
                    {
                        "name": f"recv-wait←{peer}", "cat": "mesh",
                        "ph": "X", "pid": pid, "tid": 0,
                        "ts": self._us(t0),
                        "dur": _dur_us(t0, t1),
                        "args": {"peer": peer},
                    }
                )
            elif kind == "decode":
                _, peer, t0, t1, nbytes = ev
                tid = tid_named(200 + peer, f"recv peer {peer}")
                out.append(
                    {
                        "name": f"decode←{peer}", "cat": "mesh", "ph": "X",
                        "pid": pid, "tid": tid, "ts": self._us(t0),
                        "dur": _dur_us(t0, t1),
                        "args": {"bytes": nbytes, "peer": peer},
                    }
                )
            elif kind == "dzip":
                # decompress sub-span, nested inside its frame's decode
                # span on the same receiver track
                _, peer, t0, t1, wire_b, raw_b = ev
                tid = tid_named(200 + peer, f"recv peer {peer}")
                out.append(
                    {
                        "name": f"decompress←{peer}", "cat": "mesh",
                        "ph": "X", "pid": pid, "tid": tid,
                        "ts": self._us(t0),
                        "dur": _dur_us(t0, t1),
                        "args": {
                            "peer": peer, "bytes": wire_b, "raw": raw_b,
                        },
                    }
                )
            elif kind == "disp":
                # device dispatch span: one track per
                # dispatch SITE (tid 400+) so device work reads as its
                # own lane under the engine track in Perfetto.
                # Concurrent async dispatches legitimately overlap, so
                # cat "device" is — like "native" — a sample stream,
                # exempt from the nesting check (validate_trace).
                (_, site, seq, node, t_commit, t0, t_ret, t_done,
                 flops, bytes_acc, xfer, depth, *rest) = ev
                flops_eff = rest[0] if rest else flops
                trace_id = rest[1] if len(rest) > 1 else None
                sidx = dispatch_tids.setdefault(
                    site, 400 + len(dispatch_tids)
                )
                tid = tid_named(sidx, f"device {site}")
                out.append(
                    {
                        "name": site, "cat": "device", "ph": "X",
                        "pid": pid, "tid": tid, "ts": self._us(t0),
                        "dur": _dur_us(t0, t_done),
                        "args": {
                            "dispatch": seq,
                            "node": node,
                            "t": t_commit,
                            # block_until_ready-bounded device share of
                            # the wall span (µs); wall - device = host
                            # assembly + enqueue
                            "device_us": _dur_us(t_ret, t_done),
                            "flops": flops,
                            "flops_effective": flops_eff,
                            "bytes_accessed": bytes_acc,
                            "transfer_bytes": xfer,
                            "queue_depth": depth,
                            "trace_id": trace_id,
                        },
                    }
                )
            elif kind == "span":
                # a thread's span lands on that thread's track (500+),
                # nested like a call stack; a span that is no thread's
                # (cpu None: a request's queue wait) on one track per
                # span name (600+), cat "wait": those overlap, a sample
                # stream exempt from the nesting check like "device"
                _, name, ident, t0, t1, cpu, trace_id, args = ev
                wall = max(0, t1 - t0)
                if cpu is None:
                    tid = tid_named(
                        wait_tids.setdefault(name, 600 + len(wait_tids)),
                        f"wait {name}",
                    )
                    cat, extra = "wait", {}
                else:
                    if ident not in thread_tids:
                        thread_tids[ident] = 500 + len(thread_tids)
                    tid = tid_named(
                        thread_tids[ident],
                        thread_names.get(ident, f"thread {ident}"),
                    )
                    cat = "span"
                    extra = {"offcpu_us": _dur_us(min(cpu, wall), wall)}
                out.append(
                    {
                        "name": name, "cat": cat, "ph": "X", "pid": pid,
                        "tid": tid, "ts": self._us(t0),
                        "dur": _dur_us(t0, t1),
                        "args": {"trace_id": trace_id, **extra, **args},
                    }
                )
            elif kind == "mark":
                _, name, t_ns, args = ev
                out.append(
                    {
                        "name": name, "cat": "mark", "ph": "i",
                        "pid": pid, "tid": 0, "ts": self._us(t_ns),
                        "s": "p", "args": dict(args),
                    }
                )
            elif kind == "lag":
                _, label, t_commit, t_ns, lag_ms, rows = ev
                out.append(
                    {
                        "name": f"freshness {label}", "cat": "lag",
                        "ph": "C", "pid": pid, "tid": 0,
                        "ts": self._us(t_ns),
                        "args": {"lag_ms": round(lag_ms, 3)},
                    }
                )
        for tag, thr, t0, t1, rows in list(self.native_events):
            name = NATIVE_TAGS.get(tag, f"native{tag}")
            tid = tid_named(
                100 + thr, "native entry" if thr == 0 else f"native w{thr - 1}"
            )
            out.append(
                {
                    "name": name, "cat": "native", "ph": "X", "pid": pid,
                    "tid": tid, "ts": self._us(t0),
                    "dur": _dur_us(t0, t1),
                    "args": {"rows": rows},
                }
            )
        return out

    # -- summaries --------------------------------------------------------
    def node_aggregates(self) -> dict[int, dict]:
        """node id -> {self_s, rows, batches, nb_batches} over this
        rank's events (the profile pass re-derives the same from the
        merged file; this feeds the OTLP per-node span export)."""
        agg: dict[int, dict] = {}
        for ev in list(self.events):
            if ev[0] != "node":
                continue
            _, nid, _t, t0, t1, rows, nb = ev
            a = agg.setdefault(
                nid,
                {
                    "self_s": 0.0, "rows": 0, "batches": 0,
                    "nb_batches": 0, "first_ns": t0, "last_ns": t1,
                },
            )
            a["self_s"] += max(0, t1 - t0) / 1e9
            a["rows"] += max(0, rows)
            a["batches"] += 1
            if nb:
                a["nb_batches"] += 1
            a["first_ns"] = min(a["first_ns"], t0)
            a["last_ns"] = max(a["last_ns"], t1)
        return agg

    def otlp_node_spans(self, scope=None) -> list[dict]:
        """One aggregate span per node for the OTLP flush-on-shutdown
        path (internals/otlp.py drain): wall-clock times via the
        recorder's anchors, self-time/rows/rep as attributes."""
        wall0 = self.wall_anchor_ns - self.mono_anchor_ns
        meta = self.node_meta(scope)
        spans = []
        for nid, a in sorted(self.node_aggregates().items()):
            m = meta.get(str(nid), {})
            spans.append(
                {
                    "name": f"node.{m.get('label', nid)}",
                    "start_ns": wall0 + a["first_ns"],
                    "end_ns": wall0 + a["last_ns"],
                    "attrs": {
                        "node.id": nid,
                        "node.self_s": round(a["self_s"], 6),
                        "node.rows": a["rows"],
                        "node.batches": a["batches"],
                        "node.nb_batches": a["nb_batches"],
                        **(
                            {"node.verdict": m["verdict"]}
                            if "verdict" in m
                            else {}
                        ),
                    },
                }
            )
        return spans

    # -- dump / merge -----------------------------------------------------
    def _doc(self, scope=None) -> dict:
        # dropped counts actual head evictions — a deque that is full
        # but never overflowed is NOT capped
        capped = self.dropped > 0
        if capped:
            import logging

            logging.getLogger(__name__).warning(
                "flight recorder hit PATHWAY_TRACE_MAX_EVENTS=%d: the "
                "trace keeps only the newest events (%d dropped)",
                self.max_events, self.dropped,
            )
        # device-plane platform stamp: which
        # backend/device this rank measured, plus the peak rates its
        # MFU/roofline numbers used — None when CUDA never initialised
        # here (pure relational or CPU run)
        from pathway_tpu_torch.internals.device import platform_info

        # per-site recompile counters: the Device Doctor's
        # --profile join diffs these measured counts against its static
        # shape-bucket predictions (predicted-vs-measured drift verdict)
        recompiles: dict = {}
        stats = getattr(
            getattr(getattr(scope, "runtime", None), "stats", None),
            "device_recompiles", None,
        )
        if stats:
            recompiles = dict(stats)
        return {
            "schema": TRACE_SCHEMA_VERSION,
            "rank": self.rank,
            "world": self.world,
            "event_cap": self.max_events,
            "capped": capped,
            "dropped_events": self.dropped,
            "platform": platform_info(),
            "device_recompiles": recompiles,
            "clock_offset_ns": self.clock_offset_ns,
            "offset_segments": [
                [s, o] for s, o in self._offset_segments
            ],
            "wall_anchor_ns": self.wall_anchor_ns,
            "mono_anchor_ns": self.mono_anchor_ns,
            "clock_anchor_ns": self.clock_anchor_ns,
            "events": self.chrome_events(scope),
            "nodes": self.node_meta(scope),
        }

    def dump_partial(self, scope=None) -> str:
        """Write this rank's partial (<path>.r<rank>) — merged by rank 0
        (or the MeshSupervisor fallback) into the final file."""
        self.drain_native()
        p = partial_path(self.path, self.rank)
        doc = self._doc(scope)
        doc["partial"] = True
        _atomic_write_json(p, doc)
        self.dumped = True
        return p

    def dump(self, scope=None) -> str:
        """Single-rank export: write the final Perfetto-loadable file."""
        self.drain_native()
        doc = self._doc(scope)
        out = {
            "traceEvents": _ts_sorted(doc.pop("events")),
            "displayTimeUnit": "ms",
            "pathway": doc,
        }
        _atomic_write_json(self.path, out)
        self.dumped = True
        return self.path

    def merge(self, scope=None) -> str | None:
        """Rank 0: merge every rank's partial (own events inline) into
        the final file. Missing partials (a rank that crashed before its
        dump) are skipped — the merge records which ranks contributed."""
        return merge_trace_files(
            self.path,
            self.world,
            own_doc=self._doc(scope),
        )


def _dur_us(t0: int, t1: int) -> float:
    return round(max(0, t1 - t0) / 1000.0, 3)


def _ts_sorted(events: list[dict]) -> list[dict]:
    """Time-sort the event array (metadata records first): raw events
    append parent spans AFTER their children (the span closes when the
    parent's timer stops), and merged files interleave ranks — sorting
    by offset-shifted ts makes per-track timestamps monotonic in file
    order, which the trace-schema tests pin."""
    return sorted(events, key=lambda e: e.get("ts", -1.0))


def _atomic_write_json(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        # dumps + write, NOT json.dump: the fp variant always runs the
        # pure-Python iterencode path (44 ms for a small trace — 10% of
        # a bench run, measured), dumps uses the C encoder
        f.write(json.dumps(doc, separators=(",", ":")))
    os.replace(tmp, path)


def merge_trace_files(
    path: str, world: int, own_doc: dict | None = None
) -> str | None:
    """Merge ``<path>.r<rank>`` partials into the final Chrome-trace
    file at ``path``. ``own_doc`` supplies rank 0's events directly
    (runtime shutdown path); the supervisor fallback passes None and
    reads every rank — including 0 — from its partial file. Partials'
    events already carry their tsync clock offsets, so per-track
    timestamps stay monotonic after the merge."""
    events: list[dict] = []
    nodes: dict = {}
    ranks: list[int] = []
    meta: dict[str, Any] = {}
    for rank in range(world):
        doc = None
        if own_doc is not None and rank == own_doc.get("rank"):
            doc = own_doc
        else:
            try:
                with open(partial_path(path, rank)) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
        ranks.append(rank)
        events.extend(doc.get("events", ()))
        if not nodes:
            nodes = doc.get("nodes", {})
        meta[f"rank{rank}"] = {
            "clock_offset_ns": doc.get("clock_offset_ns", 0),
            # per-segment tsync samples (resampled at epoch commits);
            # already applied to the partial's event timestamps at
            # conversion — recorded here for post-mortems only
            "offset_segments": doc.get("offset_segments"),
            "wall_anchor_ns": doc.get("wall_anchor_ns"),
            "clock_anchor_ns": doc.get("clock_anchor_ns"),
            # what hardware this rank measured (device plane)
            "platform": doc.get("platform"),
        }
    if not ranks:
        return None
    out = {
        "traceEvents": _ts_sorted(events),
        "displayTimeUnit": "ms",
        "pathway": {
            "schema": TRACE_SCHEMA_VERSION,
            "world": world,
            "merged_ranks": ranks,
            "nodes": nodes,
            "rank_meta": meta,
        },
    }
    _atomic_write_json(path, out)
    # partials are merged in; leave them on disk only when some rank is
    # missing (a later supervisor re-merge may still want them)
    if len(ranks) == world:
        for rank in range(world):
            try:
                os.remove(partial_path(path, rank))
            except OSError:
                pass
    return path


def merge_into_profiler_trace(profiler_path: str, trace_file: str | None) -> bool:
    """Add the events of the recorder's dumped trace ``trace_file`` to the
    torch.profiler Chrome trace at ``profiler_path``, on the profiler's
    clock: the recorder's ``clock_anchor_ns`` is the perf_counter_ns of
    the profiler's ``CLOCK_MARK`` annotation, so one shift places every
    span, node span and dispatch record above the card's kernels. Their
    tracks keep their names under pids from ``PROFILER_PID_BASE``. A
    merged multi-rank trace is placed by rank 0's anchor. Returns False,
    and leaves the file as it was, when either file or the anchor is
    missing."""
    if not trace_file:
        return False
    try:
        with open(trace_file) as f:
            doc = json.load(f)
        with open(profiler_path) as f:
            prof = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    meta = doc.get("pathway", {})
    anchor = meta.get("clock_anchor_ns")
    if anchor is None:
        anchor = (meta.get("rank_meta", {}).get("rank0") or {}).get(
            "clock_anchor_ns"
        )
    events = prof.get("traceEvents", [])
    mark = next(
        (e for e in events if e.get("name") == CLOCK_MARK and "ts" in e), None
    )
    if anchor is None or mark is None:
        return False
    shift = float(mark["ts"]) - anchor / 1000.0
    for e in doc.get("traceEvents", ()):
        e = dict(e)
        e["pid"] = PROFILER_PID_BASE + int(e.get("pid", 0))
        if "ts" in e:
            e["ts"] = round(float(e["ts"]) + shift, 3)
        if e.get("ph") == "M" and e.get("name") == "process_name":
            e["args"] = {"name": f"pathway {e['args'].get('name', '')}"}
        events.append(e)
    prof["traceEvents"] = events
    _atomic_write_json(profiler_path, prof)
    return True
