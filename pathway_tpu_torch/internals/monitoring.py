"""Monitoring: ProberStats counters + live text dashboard + OpenMetrics
HTTP endpoint (reference: python/pathway/internals/monitoring.py rich TUI;
src/engine/http_server.rs:21 Prometheus endpoint at port
20000+process_id exposing input_latency_ms / output_latency_ms and
per-connector counters)."""

from __future__ import annotations

import enum
import http.server
import logging
import sys
import threading
import time
from dataclasses import dataclass, field


class MonitoringLevel(enum.Enum):
    AUTO = 0
    AUTO_ALL = 1
    NONE = 2
    IN_OUT = 3
    ALL = 4


@dataclass
class ConnectorStats:
    name: str = ""
    rows: int = 0
    batches: int = 0
    last_commit_ts: float = 0.0
    last_minibatch: int = 0
    finished: bool = False
    # supervision health (engine/runtime.py _service_connector_health):
    # in-place restarts, permanent failures, watchdog stalls, and
    # at-least-once degradations (_BACKLOG_CAP overflow, deferred flushes)
    restarts: int = 0
    errors: int = 0
    stalls: int = 0
    degraded: int = 0
    # source pacing: currently gated by the memory ladder, and
    # cumulative seconds this connector's reader has spent paced
    paused: bool = False
    paused_seconds: float = 0.0
    # rolling (timestamp, n_rows) window for the last-minute column
    recent: list = field(default_factory=list)

    def rows_last_minute(self, now: float | None = None) -> int:
        now = now or time.time()
        self.recent = [(t, n) for t, n in self.recent if now - t <= 60.0]
        return sum(n for _, n in self.recent)


# serving histograms (io/http/_server.py gateway): fixed OpenMetrics
# bucket edges. Latency buckets span sub-ms colocated responses up to
# the shed/timeout regime; occupancy buckets prove request coalescing is
# engaging (occupancy > 1 under load is the direct evidence the gateway
# batches instead of paying one commit per request).
SERVE_LATENCY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    2500.0, 5000.0, 15000.0,
)
SERVE_OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# event-time lag watermarks (flight recorder): commit→emit
# freshness per output — sub-ms fused chains up to multi-minute backlogs
LAG_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 5000.0, 30000.0, 300000.0,
)


class _Histogram:
    """Minimal cumulative-bucket histogram (OpenMetrics shape)."""

    __slots__ = ("edges", "counts", "total", "sum")

    def __init__(self, edges):
        self.edges = tuple(edges)
        self.counts = [0] * (len(self.edges) + 1)  # last = +Inf
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.total += 1
        self.sum += value
        for i, edge in enumerate(self.edges):
            if value <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def render(self, name: str, labels: str) -> list[str]:
        sep = "," if labels else ""
        lines = []
        cum = 0
        for edge, n in zip(self.edges, self.counts):
            cum += n
            le = f"{edge:g}"
            lines.append(f'{name}_bucket{{{labels}{sep}le="{le}"}} {cum}')
        cum += self.counts[-1]
        lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {cum}')
        lines.append(f"{name}_sum{{{labels}}} {self.sum:.6g}")
        lines.append(f"{name}_count{{{labels}}} {self.total}")
        return lines

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the bucket holding
        the q-th observation) — dashboard summaries, not SLO math."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        cum = 0
        for edge, n in zip(self.edges, self.counts):
            cum += n
            if cum >= target:
                return float(edge)
        return float(self.edges[-1])


@dataclass
class ServeMetrics:
    """Per-route serving gateway instrumentation (io/http/_server.py):
    request/shed/timeout counters, the request-latency histogram, and
    the batch-occupancy histogram — the direct evidence that request
    coalescing is engaging under load. The subject owns this object from
    construction; the runtime mounts it on ProberStats at add_connector
    time so the OpenMetrics endpoint serves it."""

    route: str = ""
    requests: int = 0
    shed: int = 0
    timeouts: int = 0
    commits: int = 0          # batch windows committed into the dataflow
    # serving-through-rollback instrumentation: degraded
    # answers served while the dispatch breaker is open, windows aborted
    # (uncommitted) on an epoch rollback, and the breaker's state as a
    # gauge (0 = closed, 1 = half_open, 2 = open)
    browned_out: int = 0
    windows_aborted: int = 0
    breaker_state: str = "closed"
    latency: _Histogram = field(
        default_factory=lambda: _Histogram(SERVE_LATENCY_BUCKETS_MS)
    )
    occupancy: _Histogram = field(
        default_factory=lambda: _Histogram(SERVE_OCCUPANCY_BUCKETS)
    )

    def on_request(self) -> None:
        self.requests += 1

    def on_shed(self) -> None:
        self.shed += 1

    def on_timeout(self) -> None:
        self.timeouts += 1

    def on_brownout(self) -> None:
        """One request answered degraded (last committed snapshot, no
        update-fold) instead of shed while the breaker was open."""
        self.browned_out += 1

    def on_windows_aborted(self, n: int = 1) -> None:
        """Windows whose dispatch was aborted (committing nothing) when
        the epoch rolled back — the backend half of request parking."""
        self.windows_aborted += n

    def set_breaker(self, state: str) -> None:
        self.breaker_state = state

    def on_latency_ms(self, ms: float) -> None:
        self.latency.observe(ms)

    def on_window(self, occupancy: int) -> None:
        """One batch window committed (= one dataflow timestamp, one
        fused device dispatch downstream)."""
        self.commits += 1
        self.occupancy.observe(occupancy)


@dataclass
class ProberStats:
    """reference: graph.rs:554 ProberStats — input/output frontier lag."""

    connectors: dict[str, ConnectorStats] = field(default_factory=dict)
    outputs_emitted: int = 0
    last_output_ts: float = 0.0
    started_at: float = field(default_factory=time.time)
    # readiness state exposed on /healthz: "serving" (200 ok),
    # "draining" (shutdown requested) or "recovering" (epoch restore /
    # mesh rollback in flight) — both non-serving states answer 503 so a
    # load balancer rotates traffic away during the blip
    health_state: str = "serving"
    # multi-process exchange plane (engine/runtime.py wave engine +
    # parallel/procgroup.py v2 frames): coalesced frames/bytes shipped,
    # per-node empty slices elided from the wire, non-empty batches that
    # de-optimized to the tuple path, and per-timestamp communication vs
    # computation wall time
    exchange_frames: int = 0
    exchange_bytes: int = 0
    exchange_empty_elided: int = 0
    exchange_fallbacks: int = 0
    exchange_comms_s: float = 0.0
    exchange_compute_s: float = 0.0
    # per-peer exchange breakdown: the cluster aggregator
    # relabels these with this rank's id, turning them into the
    # (rank, peer) byte matrix of the mesh. Bounded cardinality: at most
    # world-1 peers. The unlabeled totals above stay for dashboard
    # back-compat.
    exchange_peer: dict = field(default_factory=dict)  # peer -> [frames, bytes]
    # recv-wait seconds this rank spent parked on each peer inside
    # exchange waves — the straggler signal: the SLOW rank waits least,
    # everyone else's wait points at it (max-min across ranks is the
    # cluster's mesh_skew_seconds)
    exchange_recv_wait_s: float = 0.0
    exchange_peer_wait: dict = field(default_factory=dict)  # peer -> seconds
    # wave accounting: completed exchange waves and their wall seconds
    exchange_waves: int = 0
    exchange_wave_s: float = 0.0
    # fast wire: frame bytes before/after the per-blob codec
    # (procgroup._frame_send feeds BOTH paths — wave engine and the
    # generic topo-loop fallback — so a fallback run can never report a
    # phantom compression state; when the link negotiates no codec the
    # two totals advance in lockstep and the ratio reads an honest 1.0)
    exchange_raw_bytes: int = 0
    exchange_wire_bytes: int = 0
    # peer -> [raw, wire]: per-link codec effectiveness for the cluster
    # byte matrix (bounded: world-1 peers)
    exchange_comp_peer: dict = field(default_factory=dict)
    # frame accounting lock: several per-peer sender threads
    # feed the frame/byte counters concurrently; unguarded `+=` could
    # drop increments and make raw/wire diverge on an uncompressed
    # link, breaking the honest-off raw==wire contract lane 12 asserts
    _frame_lock: object = field(
        default_factory=threading.Lock, repr=False
    )
    # gather-tree depth of the exchange topology (protocol.tree_depth;
    # 0 = flat) — a gauge, set once per mesh join
    mesh_tree_depth: int = 0
    # event-loop idle: seconds the main loop spent blocked on an empty
    # connector queue (per-rank comms/compute/idle on the cluster view)
    idle_s: float = 0.0
    # cluster aggregator handle (internals/cluster.py), attached by the
    # unsupervised rank-0 runtime so the TUI dashboard can render the
    # per-rank section; None everywhere else
    cluster: object = None
    # fused-chain de-optimizations at join/groupby/select nodes: batches
    # that were statically expected columnar (analysis/eligibility.py
    # expects_native_batch) but executed on the tuple path. A permanent
    # demotion (poison / unsupported-value migration) counts exactly once
    # for the node, not once per subsequent batch. pw.analyze "fused"
    # verdicts must correspond to this staying 0.
    nb_fallbacks: int = 0
    # mesh fault tolerance (procgroup detection layer + runtime recovery
    # path): heartbeat windows a peer missed, post-recovery incarnations
    # of this rank (epoch > 0 at mesh join), epoch aborts this rank
    # initiated after detecting a peer failure, and the recovery epoch at
    # which the newest distributed snapshot cut was committed/restored
    # (gauge; -1 = never)
    mesh_heartbeats_missed: int = 0
    mesh_rank_restarts: int = 0
    mesh_rollbacks: int = 0
    mesh_last_committed_epoch: int = -1
    # serving gateway routes (io/http/_server.py): each RestServerSubject
    # owns a ServeMetrics; the runtime mounts them here at add_connector
    # time so /metrics serves every route's counters and histograms
    serve: list = field(default_factory=list)
    # flight-recorder aggregates (engine/runtime.py _step_node when
    # anything is watching): node label -> [self_s, rows, batches,
    # nb_batches] — per-node self-time/rows gauges on /metrics and the
    # dashboard's hot-nodes panel
    nodes: dict = field(default_factory=dict)
    # event-time lag watermarks: output label -> freshness histogram
    # (commit→emit ms against the connector's flush-time ingest stamp)
    lag: dict = field(default_factory=dict)
    # transactional egress: per-sink 2PC counters — segments
    # staged (sealed, invisible), finalized (externally visible after
    # the snapshot_commit marker landed), aborted (discarded at
    # recovery / epoch abort: no committed cut claimed them) and
    # recovered (finalized by a restore-time recovery scan: the crash
    # landed between the marker and the owner's local finalize) — plus
    # the per-sink epoch lag gauge: how many committed cuts the
    # external output trails the staged set by (0 = egress is current)
    sink_staged: dict = field(default_factory=dict)    # name -> units
    sink_finalized: dict = field(default_factory=dict)
    sink_aborted: dict = field(default_factory=dict)
    sink_recovered: dict = field(default_factory=dict)
    sink_lag: dict = field(default_factory=dict)       # name -> gauge
    # columnar egress: rows delivered to sinks/subscribers as
    # Arrow record batches straight off the C-owned column buffers vs
    # rows a NativeBatch expanded back into Python objects at an egress
    # node (OutputNode consolidate / CaptureNode flush). A fused egress
    # verdict (analysis/eligibility.py sink_egress_decision) must
    # correspond to rows_expanded staying flat in the steady state.
    capture_arrow_batches: int = 0
    capture_arrow_rows: int = 0
    capture_rows_expanded: int = 0
    # per-sink seconds spent encoding/staging egress output (the sink
    # side of the egress leg --profile/--critical-path report)
    sink_egress_s: dict = field(default_factory=dict)  # name -> seconds
    # device plane (internals/device.py): per-dispatch-site
    # accounting — [dispatches, wall_s, device_s, flops, bytes_accessed,
    # transfer_bytes, flops_effective, queue_depth_sum]. device_s is the
    # CUDA-event device share of each dispatch's wall span; wall - device = host
    # assembly. flops_effective is
    # the real-row share of flops — padding waste is the gap between the
    # two. queue_depth_sum over dispatches is the mean number of
    # launches queued ahead of one (the device's backlog at launch).
    # Bounded cardinality: a handful of static site names
    # (knn.search, encoder.forward, ingest.fused, serve.window, ...).
    device_sites: dict = field(default_factory=dict)
    # new shape buckets observed at dispatch sites: a shape
    # entering a site's bucket set for the first time. A recompile
    # storm (shape-bucket leak) shows here before it shows as wall time.
    device_recompiles: dict = field(default_factory=dict)
    # dispatch-queue depth observed at the most recent launch (gauge)
    device_queue_depth: int = 0
    # MFU denominator this process resolved at arm time (device-kind
    # table / PATHWAY_DEVICE_PEAK_FLOPS) — rendered so a scraped MFU is
    # auditable against the peak it was computed from
    device_peak_flops: float = 0.0
    # HBM gauges from the caching allocator (internals/device.py
    # memory_stats over torch.cuda.memory_stats), absent-safe: without
    # CUDA available stays False and the byte gauges at 0 — "no HBM
    # story", not an error
    device_hbm_live: int = 0
    device_hbm_peak: int = 0
    device_hbm_available: bool = False
    # flight-recorder ring pressure: events the
    # bounded in-memory log evicted (previously visible only in the
    # dump's dropped_events field — now a live gauge, so a capped trace
    # is observable before shutdown)
    trace_dropped_events: int = 0
    # device fault domain: dispatch-supervision and index
    # snapshot/restore accounting. Retries / failures / watchdog trips /
    # OOM refusals are keyed by dispatch site (the bounded static set);
    # restore seconds and snapshot bytes are running totals — snapshot
    # bytes scaling with corpus size instead of the epoch delta is the
    # regression the quiet-epoch test pins.
    device_dispatch_retries: dict = field(default_factory=dict)
    device_dispatch_failures: dict = field(default_factory=dict)
    device_watchdog_trips: dict = field(default_factory=dict)
    device_oom_events: dict = field(default_factory=dict)
    device_index_restore_s: float = 0.0
    device_index_snapshot_bytes: int = 0
    # filter predicates that raised during index search
    # (previously swallowed, silently dropping matching rows)
    index_filter_errors: int = 0
    # memory governance / backpressure (internals/memory.py):
    # degradation-ladder state (ok/pacing/brownout/abort), accounted
    # totals against the budget, and the per-component byte breakdown
    # (bounded cardinality: memory.COMPONENTS). budget == 0 renders the
    # gauges anyway so "governance off" is scrapeable, not invisible.
    mem_state: str = "ok"
    mem_total_bytes: int = 0
    mem_peak_bytes: int = 0
    mem_budget_bytes: int = 0
    mem_components: dict = field(default_factory=dict)
    # mem.pressure fault injections observed by the accountant (counter)
    mem_pressure_injections: int = 0

    def on_node_step(
        self, label: str, self_s: float, rows: int, nb: bool
    ) -> None:
        agg = self.nodes.get(label)
        if agg is None:
            agg = self.nodes[label] = [0.0, 0, 0, 0]
        agg[0] += self_s
        agg[1] += rows
        agg[2] += 1
        if nb:
            agg[3] += 1

    def on_output_lag(self, label: str, lag_ms: float) -> None:
        h = self.lag.get(label)
        if h is None:
            h = self.lag[label] = _Histogram(LAG_BUCKETS_MS)
        h.observe(lag_ms)

    def mount_serve_metrics(self, metrics: "ServeMetrics") -> None:
        if metrics not in self.serve:
            self.serve.append(metrics)

    def set_health_state(self, state: str) -> None:
        """serving / draining / recovering — the runtime drives this
        through protocol-visible transitions (run start, _finish,
        rollback abort, distributed restore)."""
        self.health_state = state

    def on_mesh_heartbeat_missed(self, n: int = 1) -> None:
        self.mesh_heartbeats_missed += n

    def on_mesh_rank_restart(self) -> None:
        self.mesh_rank_restarts += 1

    def on_mesh_rollback(self) -> None:
        self.mesh_rollbacks += 1

    def on_mesh_epoch_committed(self, epoch: int) -> None:
        self.mesh_last_committed_epoch = epoch

    def on_exchange_frame(self, nbytes: int, peer: int | None = None) -> None:
        with self._frame_lock:
            self._on_exchange_frame_locked(nbytes, peer)

    def _on_exchange_frame_locked(
        self, nbytes: int, peer: int | None
    ) -> None:
        self.exchange_frames += 1
        self.exchange_bytes += nbytes
        if peer is not None:
            slot = self.exchange_peer.get(peer)
            if slot is None:
                slot = self.exchange_peer[peer] = [0, 0]
            slot[0] += 1
            slot[1] += nbytes

    def on_exchange_compression(
        self, peer: int, raw_bytes: int, wire_bytes: int
    ) -> None:
        """One exchange frame's byte accounting before/after the wire
        codec (raw == wire when the link ships raw). Called from
        several sender threads concurrently — lock-guarded so no
        increment is lost and raw/wire can never diverge on an
        uncompressed link."""
        with self._frame_lock:
            self.exchange_raw_bytes += raw_bytes
            self.exchange_wire_bytes += wire_bytes
            if peer is not None:
                slot = self.exchange_comp_peer.get(peer)
                if slot is None:
                    slot = self.exchange_comp_peer[peer] = [0, 0]
                slot[0] += raw_bytes
                slot[1] += wire_bytes

    def set_tree_depth(self, depth: int) -> None:
        """Gauge: gather-tree depth of this mesh's exchange topology
        (0 = flat)."""
        self.mesh_tree_depth = depth

    def on_exchange_recv_wait(self, peer: int, seconds: float) -> None:
        """Seconds this rank blocked in a wave recv on `peer` — per-peer
        for upstream attribution, totaled for the skew derivation."""
        if seconds > 0:
            self.exchange_recv_wait_s += seconds
            self.exchange_peer_wait[peer] = (
                self.exchange_peer_wait.get(peer, 0.0) + seconds
            )

    def on_exchange_wave(self, seconds: float) -> None:
        self.exchange_waves += 1
        self.exchange_wave_s += max(0.0, seconds)

    def on_idle(self, seconds: float) -> None:
        """Main-loop wall time spent waiting on an EMPTY connector queue
        (a drain that returned work is not idle and is not counted)."""
        if seconds > 0:
            self.idle_s += seconds

    def on_exchange_elided(self, n: int) -> None:
        if n > 0:
            self.exchange_empty_elided += n

    def on_exchange_fallback(self) -> None:
        self.exchange_fallbacks += 1

    def on_nb_fallback(self) -> None:
        self.nb_fallbacks += 1

    def on_exchange_step(self, comms_s: float, compute_s: float) -> None:
        self.exchange_comms_s += comms_s
        self.exchange_compute_s += max(0.0, compute_s)

    def on_ingest(self, name: str, n_rows: int) -> None:
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.rows += n_rows
        st.batches += 1
        st.last_minibatch = n_rows
        st.last_commit_ts = time.time()
        st.recent.append((st.last_commit_ts, n_rows))
        # prune the rolling window HERE, not only in the dashboard
        # renderer — without a dashboard the list would grow per commit
        # forever on the ingest hot path
        cutoff = st.last_commit_ts - 60.0
        while st.recent and st.recent[0][0] < cutoff:
            st.recent.pop(0)

    def on_connector_finished(self, name: str) -> None:
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.finished = True

    def on_connector_restart(self, name: str) -> None:
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.restarts += 1

    def on_connector_error(self, name: str) -> None:
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.errors += 1

    def on_connector_stall(self, name: str) -> None:
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.stalls += 1

    def on_connector_degraded(self, name: str) -> None:
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.degraded += 1

    # -- memory governance / backpressure -----------------------

    def set_mem_pressure(
        self,
        state: str,
        total: int,
        peak: int,
        budget: int,
        components: dict,
        injections: int = 0,
    ) -> None:
        """Gauge snapshot from the memory accountant's latest sample
        (engine/runtime.py _service_memory)."""
        self.mem_state = state
        self.mem_total_bytes = int(total)
        self.mem_peak_bytes = int(peak)
        self.mem_budget_bytes = int(budget)
        self.mem_components = dict(components)
        self.mem_pressure_injections = int(injections)

    def on_connector_paused(self, name: str) -> None:
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.paused = True

    def on_connector_paced(self, name: str, seconds: float) -> None:
        """Accrue paced wall seconds for a STILL-paused connector — the
        governor charges each health pass's slice as it elapses, so the
        counter is live while the pause is in progress (the smoke lane
        watches it move on /metrics/cluster mid-episode)."""
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.paused_seconds += max(0.0, seconds)

    def on_connector_resumed(self, name: str, seconds: float) -> None:
        st = self.connectors.setdefault(name, ConnectorStats(name=name))
        st.paused = False
        st.paused_seconds += max(0.0, seconds)

    def on_output(self, n_rows: int) -> None:
        self.outputs_emitted += n_rows
        self.last_output_ts = time.time()

    # -- transactional egress (io/txn.py) ------------------------

    def on_sink_staged(self, name: str, n: int = 1) -> None:
        self.sink_staged[name] = self.sink_staged.get(name, 0) + n

    def on_sink_finalized(self, name: str, n: int = 1) -> None:
        self.sink_finalized[name] = self.sink_finalized.get(name, 0) + n

    def on_sink_aborted(self, name: str, n: int = 1) -> None:
        self.sink_aborted[name] = self.sink_aborted.get(name, 0) + n

    def on_sink_recovered(self, name: str, n: int = 1) -> None:
        self.sink_recovered[name] = self.sink_recovered.get(name, 0) + n

    def on_sink_epoch_lag(self, name: str, lag: int) -> None:
        self.sink_lag[name] = lag

    # -- columnar egress (io/_arrow.py) --------------------------

    def on_capture_arrow_batch(self, n_rows: int) -> None:
        self.capture_arrow_batches += 1
        self.capture_arrow_rows += n_rows

    def on_capture_rows_expanded(self, n_rows: int) -> None:
        self.capture_rows_expanded += n_rows

    def on_sink_egress_seconds(self, name: str, seconds: float) -> None:
        if seconds > 0:
            self.sink_egress_s[name] = (
                self.sink_egress_s.get(name, 0.0) + seconds
            )

    # -- device plane (internals/device.py) ----------------------

    def on_device_dispatch(
        self, site: str, wall_s: float, device_s: float, flops: float,
        bytes_accessed: float, transfer_bytes: int, depth: int,
        flops_effective: float | None = None,
    ) -> None:
        """One closed dispatch record from the device plane. Records
        arrive from several threads (gateway dispatch workers close
        serve.window records while the engine thread closes knn/encoder
        ones) — lock-guarded like the exchange-frame counters so no
        increment is lost and the MFU gauge never reads torn totals.
        ``flops_effective`` defaults to ``flops`` — an
        unpadded site is 100% effective."""
        if flops_effective is None:
            flops_effective = flops
        with self._frame_lock:
            agg = self.device_sites.get(site)
            if agg is None:
                agg = self.device_sites[site] = [
                    0, 0.0, 0.0, 0.0, 0.0, 0, 0.0, 0,
                ]
            agg[0] += 1
            agg[1] += max(0.0, wall_s)
            agg[2] += max(0.0, device_s)
            agg[3] += max(0.0, flops)
            agg[4] += max(0.0, bytes_accessed)
            agg[5] += max(0, transfer_bytes)
            agg[6] += max(0.0, min(flops_effective, flops))
            agg[7] += max(0, depth)
            self.device_queue_depth = depth

    def on_device_recompile(self, site: str) -> None:
        """A dispatch site compiled a fresh executable (new shape
        bucket). Bounded cardinality: the static site-name set."""
        with self._frame_lock:
            self.device_recompiles[site] = (
                self.device_recompiles.get(site, 0) + 1
            )

    def set_device_peak_flops(self, v: float) -> None:
        self.device_peak_flops = v

    def set_device_memory(
        self, live: int, peak: int, available: bool = True
    ) -> None:
        self.device_hbm_live = live
        self.device_hbm_peak = max(self.device_hbm_peak, peak)
        self.device_hbm_available = available

    def set_trace_dropped(self, n: int) -> None:
        self.trace_dropped_events = n

    # -- device fault domain ------------------------------------

    def on_device_dispatch_retry(self, site: str) -> None:
        """A supervised dispatch classified transient and is retrying
        with backoff (internals/device.supervised_dispatch)."""
        with self._frame_lock:
            self.device_dispatch_retries[site] = (
                self.device_dispatch_retries.get(site, 0) + 1
            )

    def on_device_dispatch_failure(self, site: str) -> None:
        """A supervised dispatch exhausted its verdict — permanent
        failure, retry budget spent, or OOM brownout."""
        with self._frame_lock:
            self.device_dispatch_failures[site] = (
                self.device_dispatch_failures.get(site, 0) + 1
            )

    def on_device_watchdog_trip(self, site: str) -> None:
        """A dispatch exceeded PATHWAY_DEVICE_DISPATCH_TIMEOUT_S and was
        abandoned by the watchdog."""
        with self._frame_lock:
            self.device_watchdog_trips[site] = (
                self.device_watchdog_trips.get(site, 0) + 1
            )

    def on_device_oom(self, site: str) -> None:
        """HBM growth refused (real RESOURCE_EXHAUSTED or injected
        device.oom) — the index keeps serving at committed capacity and
        the serving breaker browns out."""
        with self._frame_lock:
            self.device_oom_events[site] = (
                self.device_oom_events.get(site, 0) + 1
            )

    def on_index_restore_seconds(self, seconds: float) -> None:
        """One index restore-from-segments completed (the ≥10x-vs-
        rebuild path the chaos smoke pins)."""
        with self._frame_lock:
            self.device_index_restore_s += max(0.0, seconds)

    def on_index_snapshot_bytes(self, nbytes: int) -> None:
        """One delta segment written at a snapshot cut — bytes scale
        with the epoch's dirty set, not corpus size."""
        with self._frame_lock:
            self.device_index_snapshot_bytes += max(0, nbytes)

    def on_index_filter_error(self, n: int = 1) -> None:
        """Filter predicates that raised during index search; the first
        message also lands in the global error log."""
        with self._frame_lock:
            self.index_filter_errors += n

    def device_totals(self) -> tuple:
        """(dispatches, wall_s, device_s, flops, bytes_accessed,
        transfer_bytes, flops_effective) summed over sites, plus the
        resulting effective MFU (real rows only — the honest number)
        and padded MFU (what the hardware executed, bucket padding
        included) — shared by the OpenMetrics render and the TUI
        dashboard."""
        tot = [0, 0.0, 0.0, 0.0, 0.0, 0, 0.0]
        with self._frame_lock:
            aggs = [list(a) for a in self.device_sites.values()]
        for agg in aggs:
            for i in range(7):
                # older 6-element rows (a restored snapshot)
                # read as zero effective FLOPs, never as a crash
                tot[i] += agg[i] if i < len(agg) else 0.0
        mfu_eff = mfu_padded = 0.0
        if tot[2] > 0 and self.device_peak_flops > 0:
            denom = tot[2] * self.device_peak_flops
            mfu_eff = tot[6] / denom
            mfu_padded = tot[3] / denom
        return (*tot, mfu_eff, mfu_padded)

    def input_latency_ms(self) -> float:
        if not self.connectors:
            return 0.0
        newest = max(s.last_commit_ts for s in self.connectors.values())
        return max(0.0, (time.time() - newest) * 1000.0) if newest else 0.0

    def output_latency_ms(self) -> float:
        if not self.last_output_ts:
            return 0.0
        return max(0.0, (time.time() - self.last_output_ts) * 1000.0)

    def render_openmetrics(self) -> str:
        lines = [
            "# TYPE input_latency_ms gauge",
            f"input_latency_ms {self.input_latency_ms():.1f}",
            "# TYPE output_latency_ms gauge",
            f"output_latency_ms {self.output_latency_ms():.1f}",
            "# TYPE connector_rows_total counter",
        ]
        for st in self.connectors.values():
            lines.append(
                f'connector_rows_total{{connector="{st.name}"}} {st.rows}'
            )
        for metric, attr in (
            ("connector_restarts_total", "restarts"),
            ("connector_errors_total", "errors"),
            ("connector_stalls_total", "stalls"),
            ("connector_degraded_total", "degraded"),
        ):
            lines.append(f"# TYPE {metric} counter")
            for st in self.connectors.values():
                lines.append(
                    f'{metric}{{connector="{st.name}"}} {getattr(st, attr)}'
                )
        # source pacing: seconds each connector's reader spent
        # paced by the memory governor (a CURRENTLY paused connector's
        # open episode is included so the smoke can observe engagement
        # live), plus the live gate state as a 0/1 gauge
        lines.append("# TYPE connector_paused_seconds_total counter")
        for st in self.connectors.values():
            lines.append(
                f'connector_paused_seconds_total{{connector="{st.name}"}} '
                f"{st.paused_seconds:.6f}"
            )
        lines.append("# TYPE connector_paused gauge")
        for st in self.connectors.values():
            lines.append(
                f'connector_paused{{connector="{st.name}"}} '
                f"{int(st.paused)}"
            )
        lines.append("# TYPE output_rows_total counter")
        lines.append(f"output_rows_total {self.outputs_emitted}")
        for metric, val in (
            ("exchange_frames_total", self.exchange_frames),
            ("exchange_bytes_total", self.exchange_bytes),
            ("exchange_uncompressed_bytes_total", self.exchange_raw_bytes),
            ("exchange_compressed_bytes_total", self.exchange_wire_bytes),
            ("exchange_empty_elided_total", self.exchange_empty_elided),
            ("exchange_fallbacks_total", self.exchange_fallbacks),
            ("nb_fallbacks_total", self.nb_fallbacks),
        ):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {val}")
        for metric, val in (
            ("exchange_comms_seconds_total", self.exchange_comms_s),
            ("exchange_compute_seconds_total", self.exchange_compute_s),
            ("exchange_recv_wait_seconds_total", self.exchange_recv_wait_s),
            ("exchange_wave_seconds_total", self.exchange_wave_s),
            ("runtime_idle_seconds_total", self.idle_s),
        ):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {val:.6f}")
        lines.append("# TYPE exchange_waves_total counter")
        lines.append(f"exchange_waves_total {self.exchange_waves}")
        if self.exchange_peer:
            # per-peer byte matrix rows (bounded: world-1 label values);
            # the cluster aggregator adds the rank label on its side
            for metric, idx in (
                ("exchange_peer_frames_total", 0),
                ("exchange_peer_bytes_total", 1),
            ):
                lines.append(f"# TYPE {metric} counter")
                for peer in sorted(self.exchange_peer):
                    lines.append(
                        f'{metric}{{peer="{peer}"}} '
                        f"{self.exchange_peer[peer][idx]}"
                    )
        if self.exchange_comp_peer:
            # per-peer codec effectiveness, labeled like the
            # byte matrix so the cluster aggregator relabels per rank
            for metric, idx in (
                ("exchange_peer_uncompressed_bytes_total", 0),
                ("exchange_peer_compressed_bytes_total", 1),
            ):
                lines.append(f"# TYPE {metric} counter")
                for peer in sorted(self.exchange_comp_peer):
                    lines.append(
                        f'{metric}{{peer="{peer}"}} '
                        f"{self.exchange_comp_peer[peer][idx]}"
                    )
        lines.append("# TYPE mesh_tree_depth gauge")
        lines.append(f"mesh_tree_depth {self.mesh_tree_depth}")
        if self.exchange_peer_wait:
            lines.append(
                "# TYPE exchange_peer_recv_wait_seconds_total counter"
            )
            for peer in sorted(self.exchange_peer_wait):
                lines.append(
                    f'exchange_peer_recv_wait_seconds_total{{peer="{peer}"}}'
                    f" {self.exchange_peer_wait[peer]:.6f}"
                )
        for metric, val in (
            ("mesh_heartbeats_missed_total", self.mesh_heartbeats_missed),
            ("mesh_rank_restarts_total", self.mesh_rank_restarts),
            ("mesh_rollbacks_total", self.mesh_rollbacks),
        ):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {val}")
        lines.append("# TYPE mesh_last_committed_epoch gauge")
        lines.append(
            f"mesh_last_committed_epoch {self.mesh_last_committed_epoch}"
        )
        # transactional egress families (bounded cardinality: one label
        # value per sink in the program). The cluster aggregator relabels
        # these per rank, so /metrics/cluster shows the whole mesh's
        # staged/finalized balance in one view.
        for metric, store in (
            ("sink_staged_total", self.sink_staged),
            ("sink_finalized_total", self.sink_finalized),
            ("sink_aborted_total", self.sink_aborted),
            ("sink_recovered_total", self.sink_recovered),
        ):
            if store:
                lines.append(f"# TYPE {metric} counter")
                for name in sorted(store):
                    lines.append(
                        f'{metric}{{sink="{name}"}} {store[name]}'
                    )
        if self.sink_lag:
            lines.append("# TYPE sink_epoch_lag gauge")
            for name in sorted(self.sink_lag):
                lines.append(
                    f'sink_epoch_lag{{sink="{name}"}} {self.sink_lag[name]}'
                )
        # columnar egress: always rendered so the lakehouse
        # smoke can assert `capture_arrow_batches_total > 0` AND the
        # forced-row run can assert it stays 0
        for metric, val in (
            ("capture_arrow_batches_total", self.capture_arrow_batches),
            ("capture_arrow_rows_total", self.capture_arrow_rows),
            ("capture_rows_expanded_total", self.capture_rows_expanded),
        ):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {val}")
        if self.sink_egress_s:
            lines.append("# TYPE sink_egress_seconds_total counter")
            for name in sorted(self.sink_egress_s):
                lines.append(
                    f'sink_egress_seconds_total{{sink="{name}"}} '
                    f"{self.sink_egress_s[name]:.6f}"
                )
        # device plane: globals rendered ALWAYS — the smoke
        # lane asserts device_dispatch_seconds_total > 0 on a traced
        # embed+KNN run AND that a relational run honestly reads 0
        (n_disp, wall_s, dev_s, flops, bytes_acc, xfer, flops_eff,
         mfu, mfu_padded) = self.device_totals()
        for metric, val, fmt in (
            ("device_dispatches_total", n_disp, "{}"),
            ("device_dispatch_seconds_total", dev_s, "{:.6f}"),
            ("device_wall_seconds_total", wall_s, "{:.6f}"),
            ("device_flops_total", flops, "{:.6g}"),
            ("device_flops_effective_total", flops_eff, "{:.6g}"),
            ("device_transfer_bytes_total", xfer, "{}"),
            ("device_recompiles_total",
             sum(self.device_recompiles.values()), "{}"),
        ):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} " + fmt.format(val))
        for metric, val, fmt in (
            # device_mfu is EFFECTIVE (real rows); the padded variant —
            # what the hardware executed, bucket padding included — is
            # kept alongside so padding waste is auditable
            ("device_mfu", mfu, "{:.6f}"),
            ("device_mfu_padded", mfu_padded, "{:.6f}"),
            ("device_queue_depth", self.device_queue_depth, "{}"),
            ("device_hbm_live_bytes", self.device_hbm_live, "{}"),
            ("device_hbm_peak_bytes", self.device_hbm_peak, "{}"),
            ("device_hbm_stats_available",
             int(self.device_hbm_available), "{}"),
            ("device_peak_flops", self.device_peak_flops, "{:.6g}"),
            ("trace_dropped_events_total", self.trace_dropped_events,
             "{}"),
        ):
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} " + fmt.format(val))
        if self.device_sites:
            # per-site breakdown (bounded: static site-name set)
            for metric, idx, fmt in (
                ("device_site_dispatches_total", 0, "{}"),
                ("device_site_dispatch_seconds_total", 2, "{:.6f}"),
                ("device_site_wall_seconds_total", 1, "{:.6f}"),
                ("device_site_flops_total", 3, "{:.6g}"),
                ("device_site_flops_effective_total", 6, "{:.6g}"),
                ("device_site_queue_depth_total", 7, "{}"),
            ):
                lines.append(f"# TYPE {metric} counter")
                for site in sorted(self.device_sites):
                    agg = self.device_sites[site]
                    val = agg[idx] if idx < len(agg) else 0.0
                    lines.append(
                        f'{metric}{{site="{site}"}} ' + fmt.format(val)
                    )
        if self.device_recompiles:
            lines.append("# TYPE device_site_recompiles_total counter")
            for site in sorted(self.device_recompiles):
                lines.append(
                    f'device_site_recompiles_total{{site="{site}"}} '
                    f"{self.device_recompiles[site]}"
                )
        # device fault domain: supervision + index snapshot
        # counters, rendered ALWAYS like the other device globals — a
        # healthy run honestly reads 0 everywhere
        for metric, val, fmt in (
            ("device_dispatch_retries_total",
             sum(self.device_dispatch_retries.values()), "{}"),
            ("device_dispatch_failures_total",
             sum(self.device_dispatch_failures.values()), "{}"),
            ("device_watchdog_trips_total",
             sum(self.device_watchdog_trips.values()), "{}"),
            ("device_oom_events_total",
             sum(self.device_oom_events.values()), "{}"),
            ("device_index_restore_seconds_total",
             self.device_index_restore_s, "{:.6f}"),
            ("device_index_snapshot_bytes_total",
             self.device_index_snapshot_bytes, "{}"),
            ("index_filter_errors_total", self.index_filter_errors, "{}"),
        ):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} " + fmt.format(val))
        for metric, per_site in (
            ("device_site_dispatch_retries_total",
             self.device_dispatch_retries),
            ("device_site_dispatch_failures_total",
             self.device_dispatch_failures),
            ("device_site_watchdog_trips_total", self.device_watchdog_trips),
            ("device_site_oom_events_total", self.device_oom_events),
        ):
            if per_site:
                lines.append(f"# TYPE {metric} counter")
                for site in sorted(per_site):
                    lines.append(
                        f'{metric}{{site="{site}"}} {per_site[site]}'
                    )
        # memory governance: rendered ALWAYS — budget 0 reads
        # as "governance off", not as a missing family. State is encoded
        # by its rung index on the protocol ladder (0 ok, 1 pacing,
        # 2 brownout, 3 abort) so dashboards can alert on >= 1.
        from pathway_tpu_torch.parallel.protocol import MEM_LADDER

        try:
            mem_state_n = MEM_LADDER.index(self.mem_state)
        except ValueError:
            mem_state_n = 0
        for metric, val in (
            ("mem_pressure_state", mem_state_n),
            ("mem_total_bytes", self.mem_total_bytes),
            ("mem_peak_bytes", self.mem_peak_bytes),
            ("mem_budget_bytes", self.mem_budget_bytes),
        ):
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {val}")
        lines.append("# TYPE mem_pressure_injections_total counter")
        lines.append(
            f"mem_pressure_injections_total {self.mem_pressure_injections}"
        )
        if self.mem_components:
            lines.append("# TYPE mem_component_bytes gauge")
            for comp in sorted(self.mem_components):
                lines.append(
                    f'mem_component_bytes{{component="{comp}"}} '
                    f"{self.mem_components[comp]}"
                )
        if self.nodes:
            for metric, idx, fmt in (
                ("node_self_seconds_total", 0, "{:.6f}"),
                ("node_rows_total", 1, "{}"),
                ("node_batches_total", 2, "{}"),
                ("node_nb_batches_total", 3, "{}"),
            ):
                lines.append(f"# TYPE {metric} counter")
                for label, agg in self.nodes.items():
                    lines.append(
                        f'{metric}{{node="{label}"}} '
                        + fmt.format(agg[idx])
                    )
        if self.lag:
            lines.append("# TYPE output_lag_ms histogram")
            for label, h in self.lag.items():
                lines.extend(h.render("output_lag_ms", f'output="{label}"'))
        if self.serve:
            # samples grouped under their TYPE line, per metric across
            # all routes (the OpenMetrics grouping contract)
            for metric, attr in (
                ("serve_requests_total", "requests"),
                ("serve_shed_total", "shed"),
                ("serve_timeouts_total", "timeouts"),
                ("serve_window_commits_total", "commits"),
                ("serve_browned_out_total", "browned_out"),
                ("serve_windows_aborted_total", "windows_aborted"),
            ):
                lines.append(f"# TYPE {metric} counter")
                for sm in self.serve:
                    lines.append(
                        f'{metric}{{route="{sm.route}"}} {getattr(sm, attr)}'
                    )
            lines.append("# TYPE serve_breaker_state gauge")
            for sm in self.serve:
                level = {"closed": 0, "half_open": 1, "open": 2}.get(
                    sm.breaker_state, 0
                )
                lines.append(
                    f'serve_breaker_state{{route="{sm.route}"}} {level}'
                )
            for metric, attr in (
                ("serve_request_latency_ms", "latency"),
                ("serve_batch_occupancy", "occupancy"),
            ):
                lines.append(f"# TYPE {metric} histogram")
                for sm in self.serve:
                    lines.extend(
                        getattr(sm, attr).render(
                            metric, f'route="{sm.route}"'
                        )
                    )
        return "\n".join(lines) + "\n"

    def render_text(self) -> str:
        up = time.time() - self.started_at
        rows = [f"uptime {up:6.1f}s  outputs {self.outputs_emitted}"]
        for st in self.connectors.values():
            line = f"  {st.name:<30} rows={st.rows:<8} batches={st.batches}"
            health = []
            if st.restarts:
                health.append(f"restarts={st.restarts}")
            if st.errors:
                health.append(f"errors={st.errors}")
            if st.stalls:
                health.append(f"stalls={st.stalls}")
            if st.degraded:
                health.append(f"degraded={st.degraded}")
            if health:
                line += "  " + " ".join(health)
            rows.append(line)
        return "\n".join(rows)


def start_http_server(stats: ProberStats, port: int) -> threading.Thread:
    """OpenMetrics endpoint (reference: http_server.rs — port
    20000 + process_id)."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                # liveness probe: flat 200, no metric rendering — k8s
                # probes must stay cheap and never 500 on a metrics bug,
                # and a 503 here during a rollback would make kubelet
                # KILL the pod mid-recovery (readiness lives on /readyz)
                body = b"ok\n"
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path == "/readyz":
                # readiness probe: state-aware — draining/recovering
                # answer 503 with the state name so a load balancer
                # rotates traffic away for exactly the rollback blip
                state = getattr(stats, "health_state", "serving")
                body = (
                    b"ok\n" if state == "serving"
                    else f"{state}\n".encode()
                )
                self.send_response(200 if state == "serving" else 503)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            body = stats.render_openmetrics().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            # BaseHTTPRequestHandler's default writes one stderr line
            # per request — a 5s Prometheus scrape interval would bury
            # the pipeline's real logs
            pass

    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


class _LogGraveyard(logging.Handler):
    """Ring buffer of recent log records for the dashboard's LOGS panel
    (reference: monitoring.py ConsolePrintingToBuffer/LogsOutput)."""

    def __init__(self, capacity: int = 50):
        super().__init__()
        self.capacity = capacity
        self.records: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.records.append(self.format(record))
        except Exception:
            return
        if len(self.records) > self.capacity:
            self.records = self.records[-self.capacity :]


def render_dashboard(stats: ProberStats, graveyard=None):
    """One rich renderable frame of the live dashboard (reference:
    python/pathway/internals/monitoring.py:273-class TUI — per-connector
    rows with minibatch / last-minute / total columns, the input/output
    latency table, and the log graveyard)."""
    from rich import box
    from rich.console import Group
    from rich.panel import Panel
    from rich.table import Table

    now = time.time()
    conn = Table(box=box.SIMPLE, title="connectors")
    conn.add_column("connector", justify="left")
    conn.add_column("last minibatch", justify="right")
    conn.add_column("last minute", justify="right")
    conn.add_column("since start", justify="right")
    conn.add_column("health", justify="right")
    for st in stats.connectors.values():
        issues = st.restarts + st.errors + st.stalls + st.degraded
        health = "ok" if not issues else (
            f"r{st.restarts} e{st.errors} s{st.stalls} d{st.degraded}"
        )
        if st.paused:
            # memory governor has this source's reader gated
            health = f"paced {st.paused_seconds:.0f}s | {health}"
        elif st.paused_seconds > 0:
            health = f"paced∑{st.paused_seconds:.0f}s | {health}"
        conn.add_row(
            st.name,
            "finished" if st.finished else str(st.last_minibatch),
            str(st.rows_last_minute(now)),
            str(st.rows),
            health,
        )

    lat = Table(box=box.SIMPLE, title="latency [ms]")
    lat.add_column("operator")
    lat.add_column("latency", justify="right")
    lat.add_row("input", f"{stats.input_latency_ms():.0f}")
    lat.add_row("output", f"{stats.output_latency_ms():.0f}")
    lat.add_row("rows emitted", str(stats.outputs_emitted))
    # event-time lag line (flight recorder watermarks): worst-output
    # freshness, so one glance says how stale downstream consumers are
    if stats.lag:
        worst = max(stats.lag.items(), key=lambda kv: kv[1].quantile(0.5))
        label, h = worst
        lat.add_row(
            f"event-time lag ({label})",
            f"p50≤{h.quantile(0.5):g} p95≤{h.quantile(0.95):g}",
        )

    # whole-pipeline panel: exchange, mesh, fused-chain and serving
    # families — one screen covers ingest → exchange → compute → serve
    pipe = Table(box=box.SIMPLE, title="pipeline")
    pipe.add_column("counter", justify="left")
    pipe.add_column("value", justify="right")
    if stats.exchange_frames or stats.exchange_bytes:
        pipe.add_row(
            "exchange frames/bytes",
            f"{stats.exchange_frames}/{stats.exchange_bytes}",
        )
        pipe.add_row(
            "exchange elided/fallbacks",
            f"{stats.exchange_empty_elided}/{stats.exchange_fallbacks}",
        )
        pipe.add_row(
            "comms/compute [s]",
            f"{stats.exchange_comms_s:.2f}/{stats.exchange_compute_s:.2f}",
        )
        # wire codec line: raw vs shipped bytes and the
        # resulting ratio — "compression helped/hurt" at a glance
        if stats.exchange_wire_bytes:
            ratio = stats.exchange_raw_bytes / stats.exchange_wire_bytes
            pipe.add_row(
                "exchange raw/wire bytes",
                f"{stats.exchange_raw_bytes}/{stats.exchange_wire_bytes}"
                f" ({ratio:.2f}x)",
            )
    if stats.mesh_tree_depth:
        pipe.add_row("gather tree depth", str(stats.mesh_tree_depth))
    pipe.add_row("nb_fallbacks", str(stats.nb_fallbacks))
    # columnar egress: arrow-delivered vs row-expanded at the
    # sinks — "did the fused chain reach the edge" at a glance
    if stats.capture_arrow_batches or stats.capture_rows_expanded:
        pipe.add_row(
            "egress arrow batches/rows | expanded",
            f"{stats.capture_arrow_batches}/{stats.capture_arrow_rows}"
            f" | {stats.capture_rows_expanded}",
        )
    # device plane: dispatches, device-vs-wall seconds, MFU
    # and the HBM gauges — "is the accelerator the limiter" at a glance
    if stats.device_sites:
        (n_disp, wall_s, dev_s, _f, _b, _x, _fe,
         mfu, mfu_padded) = stats.device_totals()
        pipe.add_row(
            "device dispatches (dev/wall s)",
            f"{n_disp} ({dev_s:.2f}/{wall_s:.2f})",
        )
        pipe.add_row(
            "device MFU (eff/padded)", f"{mfu:.3f}/{mfu_padded:.3f}"
        )
        if stats.device_recompiles:
            pipe.add_row(
                "device recompiles",
                str(sum(stats.device_recompiles.values())),
            )
        if stats.device_hbm_available:
            pipe.add_row(
                "device HBM live/peak [MB]",
                f"{stats.device_hbm_live // 2**20}"
                f"/{stats.device_hbm_peak // 2**20}",
            )
    # memory governance: ladder state + accounted bytes vs the
    # budget — "is backpressure engaged and how close to the ceiling" at
    # a glance. Shown only when a budget is set (governance on).
    if stats.mem_budget_bytes:
        pipe.add_row(
            "memory ladder",
            f"{stats.mem_state} "
            f"({stats.mem_total_bytes // 2**20}"
            f"/{stats.mem_budget_bytes // 2**20} MB, "
            f"peak {stats.mem_peak_bytes // 2**20})",
        )
    # device fault domain: retries/failures/watchdog/OOM at
    # a glance — shown whenever supervision recorded anything
    retries = sum(stats.device_dispatch_retries.values())
    failures = sum(stats.device_dispatch_failures.values())
    trips = sum(stats.device_watchdog_trips.values())
    ooms = sum(stats.device_oom_events.values())
    if retries or failures or trips or ooms:
        pipe.add_row(
            "device retries/failures/watchdog/oom",
            f"{retries}/{failures}/{trips}/{ooms}",
        )
    if stats.device_index_restore_s or stats.device_index_snapshot_bytes:
        pipe.add_row(
            "index snapshot bytes | restore s",
            f"{stats.device_index_snapshot_bytes}"
            f" | {stats.device_index_restore_s:.2f}",
        )
    if stats.index_filter_errors:
        pipe.add_row("index filter errors", str(stats.index_filter_errors))
    if (
        stats.mesh_heartbeats_missed
        or stats.mesh_rank_restarts
        or stats.mesh_rollbacks
        or stats.mesh_last_committed_epoch >= 0
    ):
        pipe.add_row(
            "mesh hb-missed/restarts/rollbacks",
            f"{stats.mesh_heartbeats_missed}/{stats.mesh_rank_restarts}"
            f"/{stats.mesh_rollbacks}",
        )
        pipe.add_row(
            "mesh committed epoch", str(stats.mesh_last_committed_epoch)
        )
    # transactional egress: one row per sink — the 2PC
    # balance (staged vs finalized) plus the epoch-lag gauge, so a
    # glance says whether committed output is keeping up with cuts
    for name in sorted(
        set(stats.sink_staged) | set(stats.sink_finalized)
        | set(stats.sink_lag)
    ):
        pipe.add_row(
            f"sink {name} staged/final/lag",
            f"{stats.sink_staged.get(name, 0)}"
            f"/{stats.sink_finalized.get(name, 0)}"
            f"/{stats.sink_lag.get(name, 0)}",
        )
    for sm in stats.serve:
        pipe.add_row(
            f"serve {sm.route} req/shed/timeout",
            f"{sm.requests}/{sm.shed}/{sm.timeouts}",
        )
        pipe.add_row(
            f"serve {sm.route} windows (occ p50)",
            f"{sm.commits} ({sm.occupancy.quantile(0.5):g})",
        )
    if stats.nodes:
        top = sorted(
            stats.nodes.items(), key=lambda kv: kv[1][0], reverse=True
        )[:3]
        for label, agg in top:
            pipe.add_row(
                f"hot {label}",
                f"{agg[0]:.2f}s / {agg[1]} rows",
            )

    parts = [conn, lat, pipe]
    # cluster section: when the cluster aggregator is
    # attached (unsupervised rank 0 with PATHWAY_CLUSTER_METRICS_PORT),
    # one row per scraped rank — where each rank's wall-clock went —
    # plus the derived skew/efficiency gauges
    summary = None
    if stats.cluster is not None:
        try:
            summary = stats.cluster.summary()
        except Exception:
            summary = None
    if summary and summary.get("ranks"):
        clus = Table(box=box.SIMPLE, title="cluster")
        clus.add_column("rank", justify="right")
        clus.add_column("rows", justify="right")
        clus.add_column("comms [s]", justify="right")
        clus.add_column("compute [s]", justify="right")
        clus.add_column("idle [s]", justify="right")
        clus.add_column("recv-wait [s]", justify="right")
        for rank in sorted(summary["ranks"]):
            r = summary["ranks"][rank]
            clus.add_row(
                str(rank),
                str(int(r.get("rows", 0))),
                f"{r.get('comms_s', 0.0):.2f}",
                f"{r.get('compute_s', 0.0):.2f}",
                f"{r.get('idle_s', 0.0):.2f}",
                f"{r.get('recv_wait_s', 0.0):.2f}",
            )
        derived = []
        if summary.get("skew_s") is not None:
            derived.append(f"skew {summary['skew_s']:.3f}s")
        if summary.get("rows_per_s") is not None:
            derived.append(f"{summary['rows_per_s']:.0f} rows/s")
        if summary.get("efficiency") is not None:
            derived.append(f"efficiency {summary['efficiency']:.2f}")
        if derived:
            clus.add_row("", "", "", "", "", "  ".join(derived))
        parts.append(clus)
    if graveyard is not None and graveyard.records:
        parts.append(
            Panel(
                "\n".join(graveyard.records[-12:]),
                title="LOGS",
                box=box.MINIMAL,
            )
        )
    return Group(*parts)


def start_dashboard(
    stats: ProberStats, interval: float = 1.0
):
    """Live-updating terminal dashboard; returns (thread, stop_fn).
    Falls back to the plain text printer when rich is unavailable."""
    try:
        from rich.console import Console
        from rich.live import Live
    except ImportError:
        return start_monitor_printer(stats, interval), lambda: None

    graveyard = _LogGraveyard()
    graveyard.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
    logging.getLogger().addHandler(graveyard)
    stop = threading.Event()

    def loop():
        console = Console(stderr=True)
        with Live(
            render_dashboard(stats, graveyard),
            console=console,
            refresh_per_second=2,
            transient=True,
        ) as live:
            while not stop.is_set():
                stop.wait(interval)
                live.update(render_dashboard(stats, graveyard))
        logging.getLogger().removeHandler(graveyard)

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    return thread, stop.set


def start_monitor_printer(
    stats: ProberStats, interval: float = 2.0
) -> threading.Thread:
    def loop():
        while True:
            time.sleep(interval)
            print(stats.render_text(), file=sys.stderr)

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    return thread
