"""Engine runtime: the per-worker event loop.

Rebuild of the reference's main worker loop (reference: src/engine/
dataflow.rs:5595-5650 — ``loop { probers; flushers; pollers; step_or_park }``)
on the batch-per-timestamp scheduler: timestamps are processed strictly in
order; within a timestamp nodes run in topological order, which guarantees
every operator sees a consistent prefix of its inputs (the timely progress
invariant, SURVEY §2.9).

Streaming sources run on their own threads and feed a queue; the loop drains
it, stamps batches with commit timestamps (monotone, ms-resolution like the
reference's Timestamp at src/engine/timestamp.rs:140) and steps the graph.
"""

from __future__ import annotations

import heapq as _heapq
import queue
import threading
import time as _time
from typing import Any, Callable

from pathway_tpu_torch.engine.nodes import Node, SourceNode
from pathway_tpu_torch.engine.scope import Scope
from pathway_tpu_torch.engine.stream import Delta, is_native_batch
from pathway_tpu_torch.internals import device as _device
from pathway_tpu_torch.internals import faults as _faults

# the mesh protocol's decisions (wave partition, quiesce guard, leg
# elision, frontier agreement, commit walk) are NOT implemented here:
# they live in parallel/protocol.py as pure transition functions that
# this runtime drives through and analysis/meshcheck.py exhaustively
# model-checks — one shared table, so checker and engine cannot drift
# (pinned by tests/test_meshcheck.py, like the NBDecision objects of
# the Plan Doctor)
from pathway_tpu_torch.parallel import protocol as _proto


# stats of the most recently finished Runtime in this process (set by
# _finish): the bench scaling lanes read per-rank exchange counters off
# it after pw.run() returns. In the emulated-rank lane each thread-rank
# overwrites it in finish order — single-rank-per-process harnesses
# (the real-fork scaling lanes) are the intended consumers.
LAST_RUN_STATS = None


class _Connector:
    def __init__(self, node: SourceNode, subject, parser):
        self.node = node
        self.subject = subject
        self.parser = parser
        self.finished = False
        self.thread: threading.Thread | None = None
        self.force_flush = lambda: None  # set by run_connector_thread
        # supervision plumbing (io/_connector.py): permanent failure,
        # watchdog heartbeat, and the scan state the runtime restored at
        # startup (the restart rollback target until the subject
        # publishes a fresher one)
        self.failure: Exception | None = None
        self.last_activity = _time.monotonic()
        self.restored_state = None
        self.watchdog_timeout: float | None = None
        self._stalled = False
        self._stall_episodes = 0
        self._flush_failures = 0
        self._flush_dead = False
        # source pacing: the driver blocks emit() on the gate
        # while cleared; the runtime's pacing pass drives it through the
        # pure protocol transitions pace_decide/pace_resume. rows/bytes
        # counters are single-writer monotonic pairs: _put moves on the
        # subject thread (io/_connector.py account_put), _drained on the
        # main loop as entries are accepted — the difference is the
        # ENGINE-DRAINABLE queued backlog the pacing signal reads.
        self.pausable = True
        self.pace_gate = threading.Event()
        self.pace_gate.set()
        self.paused = False
        self._paused_since: float | None = None
        self.paused_seconds = 0.0
        self.rows_put = 0
        self.bytes_put = 0
        self.rows_drained = 0
        self.bytes_drained = 0


class Runtime:
    def __init__(
        self,
        terminate_on_error: bool = True,
        persistence=None,
        with_http_server: bool = False,
        monitoring_level=None,
        local_only: bool = False,
        validate_env: bool = True,
    ):
        # startup knob gate: reject unknown / out-of-range PATHWAY_* env
        # vars (typos were silently ignored before) — registry + escape
        # hatch in analysis/knobs.py; memoized per env snapshot.
        # validate_env=False is for the analyzer's scratch lowering: it
        # REPORTS knob findings as diagnostics instead of raising.
        if validate_env:
            from pathway_tpu_torch.analysis.knobs import enforce_environment

            enforce_environment()
        # local_only: never join the process mesh even when
        # PATHWAY_PROCESSES>1 — used by throwaway inner runtimes (the
        # iterate fixpoint body) that run a complete local subgraph
        self.local_only = local_only
        # set by the emulated-rank CI lane (graph_runner._with_companions):
        # ranks are threads of ONE process sharing connector subject
        # objects, so every source reads on rank 0 only
        self._lane_emulated = False
        self.scope = Scope(self)
        self.pending_times: dict[int, set[int]] = {}  # time -> set of node ids
        # min-heap over pending timestamps: the scheduler pops times in
        # order without rescanning the dict (min() over a dict of T
        # pending commits made the loop O(T^2) under bursty ingest)
        self._time_heap: list[int] = []
        self.static_data: list[tuple[SourceNode, list[Delta]]] = []
        self.connectors: list[_Connector] = []
        self.event_queue: "queue.Queue[tuple[_Connector, list[Delta] | None]]" = (
            queue.Queue()
        )
        self.clock = 0
        self.terminate_on_error = terminate_on_error
        self.persistence = persistence
        self.with_http_server = with_http_server
        self.monitoring_level = monitoring_level
        self.error: Exception | None = None
        self._async_loop = None
        self.current_trace = None
        # per-row data errors (reference: ErrorLog, dataflow.rs:551;
        # Graph::error_log graph.rs:983): rows poison to Error values and
        # the message lands in the global error-log table
        self.error_log_node = None
        self._error_log_seq = 0
        self._error_log_seen: set = set()
        self._operator_subject_states: dict = {}
        # connector-health notices from supervisor threads, drained by the
        # main loop into monitoring counters + the error-log table (the
        # threads must never touch engine state directly)
        self._connector_notices: "queue.SimpleQueue" = queue.SimpleQueue()
        # stateful connectors with engine-accepted rows not yet claimed by
        # their published scan state (blocks operator snapshots)
        self._uncovered: set[str] = set()
        self._last_snapshot = 0.0
        from pathway_tpu_torch.internals.monitoring import ProberStats

        self.stats = ProberStats()
        # flight recorder (internals/flight.py): armed by PATHWAY_TRACE,
        # None otherwise. _prof additionally turns on the cheap per-node
        # self-time/rows aggregation that feeds the OpenMetrics node
        # gauges whenever anything is watching (recorder or /metrics).
        from pathway_tpu_torch.internals.flight import FlightRecorder

        self.recorder = FlightRecorder.from_env(local_only=local_only)
        self._prof = self.recorder is not None or with_http_server
        self._node_labels: list[str] | None = None
        # event-time lag watermarks: commit timestamp -> earliest ingest
        # stamp (perf_counter_ns at connector flush); sinks report
        # commit→emit freshness against it (note_output_emit)
        self._ingest_ns: dict[int, int] = {}
        self.trace_summary: dict | None = None
        # multi-process (PATHWAY_PROCESSES>1): TCP mesh + lockstep state
        self._procgroup = None
        # gather-tree fanout, resolved lazily against the
        # mesh's world size through protocol.tree_fanout (None = not yet)
        self._tree_fanout: int | None = None
        self._lockstep_seq = 0
        self._reach_masks: list[int] | None = None
        # rank bitmask of the current timestamp's frontier contributors
        # (set around _step_time by the lockstep loop; None = unknown,
        # every wave keeps the full mesh)
        self._exchange_contrib: int | None = None
        self._planned_ok: bool | None = None  # planned-walk eligibility
        self._upstream_masks: list[int] | None = None
        # standalone cluster metrics aggregator (unsupervised rank 0
        # with PATHWAY_CLUSTER_METRICS_PORT set; internals/cluster.py)
        self._cluster_agg = None
        # transactional egress (io/txn.py): whether the 2PC
        # sinks are epoch-aligned this run (OPERATOR_PERSISTING +
        # PATHWAY_SINK_TXN), and the last BSP round number (the final
        # clean-shutdown cut tags past it)
        self._txn_operator = False
        self._bsp_round_no = 0
        # memory governance (internals/memory.py): the
        # accountant is created per run in _start_monitoring (never for
        # local_only throwaway runtimes — an inner iterate body must not
        # clobber the owning runtime's installed accountant) and stepped
        # by the pacing pass in _service_connector_health
        self.memory = None
        self._mem_store_probe_t = 0.0
        self._mem_store_bytes = 0
        self._mem_abort_reported = False

    # -- multi-process plane ----------------------------------------------
    @property
    def distributed(self) -> bool:
        if self.local_only:
            return False
        from pathway_tpu_torch.internals.config import get_pathway_config

        return get_pathway_config().processes > 1

    @property
    def procgroup(self):
        if self._procgroup is None:
            from pathway_tpu_torch.internals.config import get_pathway_config
            from pathway_tpu_torch.parallel.procgroup import ProcessGroup

            c = get_pathway_config()
            self._procgroup = ProcessGroup(
                c.process_id, c.processes, c.first_port,
                # emulated-lane ranks share one process: if a peer thread
                # dies before the mesh forms, fail fast instead of the
                # full multi-host connect window
                timeout=15.0 if self._lane_emulated else 60.0,
            )
            # mesh health lands on this rank's OpenMetrics endpoint
            # (heartbeat misses are counted by procgroup's own threads)
            self._procgroup.stats = self.stats
            # mesh events (decode spans, heartbeat marks) ride the same
            # recorder; procgroup guards every note on it being set
            self._procgroup.recorder = self.recorder
            if self.recorder is not None:
                self.recorder.note_mark(
                    "mesh_join",
                    rank=self._procgroup.rank,
                    world=self._procgroup.world,
                    epoch=self._procgroup.epoch,
                )
            if self._procgroup.epoch > 0:
                # this incarnation exists because a supervisor rolled the
                # mesh back: count the restart on the recovery path
                self.stats.on_mesh_rank_restart()
            # gather-tree topology gauge: depth 0 = flat
            # (_procgroup is already assigned, so the shared resolver
            # cannot re-enter this property)
            self.stats.set_tree_depth(
                _proto.tree_depth(
                    self._procgroup.world, self._gather_tree_fanout()
                )
            )
        return self._procgroup

    def _exchange_reach_masks(self) -> list[int]:
        """node_id -> bitmask (over scope.exchange_nodes indices) of
        exchange boundaries reachable downstream of that node, computed
        once over the static graph in reverse topological order. Lets the
        lockstep protocol mark only exchanges that can possibly carry
        data at a timestamp instead of every boundary at every time."""
        nodes = self.scope.nodes
        if self._reach_masks is not None and len(self._reach_masks) == len(nodes):
            return self._reach_masks
        xidx = {
            id(xn): i for i, xn in enumerate(self.scope.exchange_nodes)
        }
        masks = [0] * len(nodes)
        for node in reversed(nodes):  # registration order is topological
            m = xidx.get(id(node))
            mask = 0 if m is None else (1 << m)
            for child, _port in node.downstream:
                mask |= masks[child.node_id]
            masks[node.node_id] = mask
        self._reach_masks = masks
        return masks

    def _exchange_upstream_masks(self) -> list[int]:
        """node_id -> bitmask of exchange boundaries UPSTREAM of that
        node (the node consumes their output, possibly transitively).
        The wave quiesce must not step a node while any of its upstream
        exchanges is still waiting for its rendezvous — its inputs are
        incomplete until that boundary delivers."""
        nodes = self.scope.nodes
        if self._upstream_masks is not None and len(
            self._upstream_masks
        ) == len(nodes):
            return self._upstream_masks
        xidx = {
            id(xn): i for i, xn in enumerate(self.scope.exchange_nodes)
        }
        umasks = [0] * len(nodes)
        for node in nodes:  # registration order is topological
            mask = 0
            for inp in node.inputs:
                m = xidx.get(id(inp))
                mask |= umasks[inp.node_id] | (
                    0 if m is None else (1 << m)
                )
            umasks[node.node_id] = mask
        self._upstream_masks = umasks
        return umasks

    def _step_lockstep(self, bound: int | None = None) -> int:
        """Step globally-agreed timestamps in order until no rank has
        pending work (<= bound). One control round-trip per timestamp: the
        rank-0 master takes the min over every rank's frontier, so all
        ranks step the same times in the same order. Each frontier entry
        carries the union of downstream-reachable exchange masks of its
        pending nodes; every rank marks exactly the masked ExchangeNodes
        pending at the agreed time, so all ranks join the same all-to-alls
        — including boundaries where only ANOTHER rank holds rows."""
        pg = self.procgroup
        masks = self._exchange_reach_masks()
        stepped = 0
        while True:
            self._lockstep_seq += 1
            seq = self._lockstep_seq
            mine = None
            if self.pending_times:
                m = self._min_pending()
                if bound is None or m <= bound:
                    xmask = 0
                    for nid in self.pending_times.get(m, ()):
                        xmask |= masks[nid]
                    mine = (m, xmask)
            if pg.rank == 0:
                fronts = pg.gather0(("f", seq), mine)
                # frontier agreement is a protocol decision: the shared
                # transition table (parallel/protocol.py) computes it, so
                # the model checker explores the identical agreement
                plan = _proto.lockstep_plan(fronts)
                pg.bcast0(("f2", seq), plan)
            else:
                pg.gather0(("f", seq), mine)
                plan = pg.bcast0(("f2", seq))
            if plan is None:
                return stepped
            t, xmask, contrib = plan
            for i, xn in enumerate(self.scope.exchange_nodes):
                if (xmask >> i) & 1:
                    self.mark_pending(t, xn)
            # contributor mask: only these ranks held pending work at t
            # when the plan was agreed, so only they can feed the FIRST
            # exchange wave — everyone else's wave-1 frames are elided
            # (engine invariant: wave-1 input derives from local pending
            # state only; later waves may cascade received data)
            self._exchange_contrib = contrib
            try:
                self._step_time(t)
            finally:
                self._exchange_contrib = None
            stepped += 1

    # -- wiring ----------------------------------------------------------
    def add_static_data(self, node: SourceNode, deltas: list[Delta]) -> None:
        # distinct keys all inserting once are net form already: marking
        # the batch spares the source node a full (key,row) re-hash — a
        # key-set check is an order of magnitude cheaper (debug tables and
        # program-embedded rows hit this; duplicate/retracting data takes
        # the consolidating path)
        if deltas and all(d[2] == 1 for d in deltas):
            keys = {d[0] for d in deltas}
            if len(keys) == len(deltas):
                from pathway_tpu_torch.engine.stream import ConsolidatedList

                deltas = ConsolidatedList(deltas)
        self.static_data.append((node, deltas))

    def add_connector(self, node: SourceNode, subject, parser, name=None) -> None:
        conn = _Connector(node, subject, parser)
        conn.name = name or f"connector_{len(self.connectors)}"
        self.connectors.append(conn)
        # serving subjects (io/http/_server.py gateway) carry their own
        # ServeMetrics from construction; mounting it here puts the
        # request/shed/timeout counters and the latency/batch-occupancy
        # histograms on this run's OpenMetrics endpoint
        serve_metrics = getattr(subject, "serve_metrics", None)
        if serve_metrics is not None:
            self.stats.mount_serve_metrics(serve_metrics)

    def mark_pending(self, time: int, node: Node) -> None:
        slot = self.pending_times.get(time)
        if slot is None:
            slot = set()
            self.pending_times[time] = slot
            _heapq.heappush(self._time_heap, time)
        slot.add(node.node_id)

    def _min_pending(self) -> int:
        heap = self._time_heap
        pending = self.pending_times
        while heap and heap[0] not in pending:
            _heapq.heappop(heap)  # lazily drop already-stepped times
        return heap[0]

    @property
    def async_loop(self):
        if self._async_loop is None:
            import asyncio

            self._async_loop = asyncio.new_event_loop()
        return self._async_loop

    # -- stepping ---------------------------------------------------------
    def _deliver(self, node: Node, time: int, deltas: list[Delta]) -> None:
        for child, port in node.downstream:
            child.accept(time, port, deltas)

    def _node_label(self, nid: int) -> str:
        labels = self._node_labels
        if labels is None or len(labels) != len(self.scope.nodes):
            labels = self._node_labels = [
                f"{type(n).__name__}#{i}"
                for i, n in enumerate(self.scope.nodes)
            ]
        return labels[nid]

    def note_output_emit(self, node, time: int, rows: int) -> None:
        """Sink-side half of the event-time lag watermark: freshness =
        emit time minus the commit's earliest connector ingest stamp.
        Lands on the OpenMetrics output_lag_ms histogram (and the trace
        as a Perfetto counter track when the recorder is armed)."""
        ing = self._ingest_ns.get(time)
        if ing is None:
            return
        now = _time.perf_counter_ns()
        lag_ms = max(0.0, (now - ing) / 1e6)
        label = self._node_label(node.node_id)
        self.stats.on_output_lag(label, lag_ms)
        rec = self.recorder
        if rec is not None:
            rec.note_lag(label, time, now, lag_ms, rows)

    def _note_ingest(self, t: int, conn) -> None:
        """Adopt the connector's flush-time ingest stamp for commit `t`
        (io/_connector.py appends one per queue entry); a commit with no
        stamp (journal replay, static injection) freshens from engine
        admission instead."""
        try:
            ns = conn._ingest_ns.popleft()
        except (AttributeError, IndexError):
            ns = _time.perf_counter_ns()
        prev = self._ingest_ns.get(t)
        if prev is None or ns < prev:
            self._ingest_ns[t] = ns

    def _step_node(self, time: int, nid: int) -> None:
        node = self.scope.nodes[nid]
        batches = node.take(time)
        if not self._prof:
            self._process_node(node, time, batches)
            return
        rows = 0
        for b in batches:
            try:
                rows += len(b)
            except TypeError:
                pass
        nb = bool(batches) and is_native_batch(batches[0])
        # device-plane node context: dispatches issued inside process()
        # (KNN scans, embedder forwards) stamp this node id into their
        # records — the correlation key between the trace's device
        # tracks and this node's span (internals/device.py)
        dev = _device.PLANE.on
        if dev:
            _device.PLANE.set_node(nid, time)
        t0 = _time.perf_counter_ns()
        try:
            self._process_node(node, time, batches)
        finally:
            if dev:
                _device.PLANE.clear_node()
        t1 = _time.perf_counter_ns()
        self.stats.on_node_step(
            self._node_label(nid), (t1 - t0) / 1e9, rows, nb
        )
        rec = self.recorder
        if rec is not None:
            rec.note_node(nid, time, t0, t1, rows, nb)

    def _process_node(self, node: Node, time: int, batches) -> None:
        try:
            out = node.process(time, batches)
        except Exception as exc:
            from pathway_tpu_torch.analysis.eligibility import NBStrictError
            from pathway_tpu_torch.internals.api import EngineErrorWithTrace

            if node.trace is not None and not isinstance(
                exc, (EngineErrorWithTrace, NBStrictError)
            ):
                # NBStrictError already carries the node's provenance +
                # fusion blame; wrapping would bury the diagnostic
                raise EngineErrorWithTrace(
                    exc,
                    f"{node.trace.filename}:{node.trace.lineno} "
                    f"in {node.trace.name}: {node.trace.line}",
                ) from exc
            raise
        if out:
            self._deliver(node, time, out)

    def _step_time(self, time: int) -> None:
        """Run all nodes with pending input at `time`, in topo order.

        Distributed runs first walk the timestamp's exchange boundaries
        as coalesced waves (_step_exchange_waves) — all sends for a wave
        are enqueued before any recv blocks, empty slices are elided, and
        the columnar path keeps NativeBatches columnar across the rank
        boundary — then the generic loop drains whatever remains."""
        _faults.fault_point("runtime.step")
        # straggler slot (mesh.slow, delay action): a compute-side drag
        # on this rank, once per timestamp step
        _faults.fault_point("mesh.slow", phase="step")
        nodes = self.scope.nodes
        rec = self.recorder
        t_step0 = _time.perf_counter_ns() if rec is not None else 0
        xids: list[int] = []
        if self.scope.exchange_nodes and self._procgroup is not None:
            pend = self.pending_times.get(time)
            if pend:
                xids = [
                    xn.node_id
                    for xn in self.scope.exchange_nodes
                    if xn.node_id in pend
                ]
        t_start = _time.perf_counter() if xids else 0.0
        comms_s = self._step_exchange_waves(time, xids) if xids else 0.0
        while True:
            pending_ids = self.pending_times.get(time)
            if not pending_ids:
                break
            nid = min(pending_ids)
            pending_ids.discard(nid)
            self._step_node(time, nid)
        if xids:
            self.stats.on_exchange_step(
                comms_s, _time.perf_counter() - t_start - comms_s
            )
        self.pending_times.pop(time, None)
        for node in nodes:
            node.on_time_end(time)
        self._ingest_ns.pop(time, None)
        if rec is not None:
            rec.note_step(time, t_step0, _time.perf_counter_ns())
            # keep the native ring from wrapping on long runs: pull its
            # buffered GIL-free timers after every step
            rec.drain_native()
            if rec.dropped:
                # ring pressure as a LIVE gauge —
                # previously only the shutdown dump said the trace was
                # capped
                self.stats.set_trace_dropped(rec.dropped)

    def _step_exchange_waves(self, time: int, xids: list[int]) -> float:
        """Step the timestamp's exchange boundaries as coalesced waves.

        Wave partition: of the pending exchanges, those with no OTHER
        pending exchange upstream form the next wave. The pending set is
        the lockstep-agreed exchange mask (identical on every rank) and
        upstream-ness is static reachability, so every rank derives the
        same waves in the same order — the data-plane rendezvous needs no
        extra control traffic. Before each wave, local computation
        upstream of any remaining exchange is quiesced (topo order within
        that upstream-closed set), so every wave member's input is
        complete when sliced. Returns seconds spent in the communication
        phases (slice/encode/send/recv-wait/merge) for the
        comms-vs-compute counters."""
        masks = self._exchange_reach_masks()
        umasks = self._exchange_upstream_masks()
        xi = {xn.node_id: i for i, xn in enumerate(self.scope.exchange_nodes)}
        remaining = set(xids)
        comms = 0.0
        wave_no = 0
        # wave partition + quiesce guard are protocol decisions driven
        # through the shared transition table (parallel/protocol.py) —
        # the model checker explores these exact functions
        while remaining:
            wbits = _proto.wave_bits(remaining, xi)
            # quiesce local computation feeding a remaining exchange —
            # but a node DOWNSTREAM of a remaining exchange has
            # incomplete inputs until that boundary delivers, so it must
            # wait for its wave (umask check inside quiesce_candidates)
            while True:
                pending_ids = self.pending_times.get(time)
                cand = (
                    _proto.quiesce_candidates(
                        pending_ids, remaining, masks, umasks, wbits
                    )
                    if pending_ids
                    else []
                )
                if not cand:
                    break
                nid = min(cand)
                pending_ids.discard(nid)
                self._step_node(time, nid)
            wave = _proto.wave_partition(remaining, masks, xi)
            wave_no += 1
            t0 = _time.perf_counter()
            self._run_exchange_wave(time, wave_no, wave)
            wave_s = _time.perf_counter() - t0
            comms += wave_s
            self.stats.on_exchange_wave(wave_s)
            remaining.difference_update(wave)
        return comms

    def _gather_tree_fanout(self) -> int:
        """Resolved PATHWAY_MESH_TREE_FANOUT for this mesh (0 = flat),
        through the shared protocol transition the model checker
        explores."""
        f = self._tree_fanout
        if f is None:
            import os as _os

            f = self._tree_fanout = _proto.tree_fanout(
                self.procgroup.world,
                _os.environ.get("PATHWAY_MESH_TREE_FANOUT"),
            )
        return f

    def _run_exchange_wave(self, time: int, seq, wave: list[int]) -> None:
        """One coalesced rendezvous: slice every wave exchange locally,
        ship ONE typed-columnar frame per peer carrying all their slices
        (presence header elides the empty ones), then merge received
        parts and deliver downstream in node-id order. Receiver threads
        decompress+decode incoming frames as they land and sender
        threads drain outgoing frames (procgroup), so comms overlaps
        this rank's merges and the next compute leg.

        Pure-gather waves route over the k-ary reduction tree when
        PATHWAY_MESH_TREE_FANOUT resolves one (auto at world >= 4):
        each rank first receives its tree children's frames, folds the
        relayed slices into its own parent frame (protocol.tree_relay),
        and rank 0 — the only rank that delivers — ingests fanout
        frames per wave instead of world-1."""
        pg = self.procgroup
        nodes = self.scope.nodes
        stats = self.stats
        rec = self.recorder
        t_wave0 = _time.perf_counter_ns() if rec is not None else 0
        pend = self.pending_times.get(time)
        prepared = []
        for nid in wave:
            if pend is not None:
                pend.discard(nid)
            node = nodes[nid]
            batches = node.take(time)
            own, sends = node._slice(batches[0])
            prepared.append((nid, own, sends))
        tag = ("xw", time, seq)
        # kill slot: rank dies with its slices prepared but its wave
        # frames not (fully) shipped — peers must detect the loss and
        # abort the epoch instead of deadlocking in their wave recvs
        _faults.fault_point("mesh.rank_kill", phase="wave_send")
        # straggler slot (mesh.slow, delay action): stalling here holds
        # THIS rank's frames back, so every peer's recv-wait attributes
        # to it — the deterministic straggler the scaling lanes inject
        _faults.fault_point("mesh.slow", phase="wave_send")
        # gather-mode nodes route to rank 0 only, so for a pure-gather
        # wave the sender set is static: non-zero ranks never receive and
        # rank 0 never sends — those all-to-all legs are elided entirely
        # (no frame at all), not just shipped empty. Any hash/broadcast
        # member keeps the full mesh (every peer may hold routable rows).
        gather_only = all(
            nodes[nid].mode == "gather" for nid in wave
        )
        # wave 1 feeds on local pending state only, which the lockstep
        # plan already named: ranks outside the contributor mask hold
        # provably empty inputs, so their send legs vanish entirely.
        # Which legs exist is a protocol decision (wave_send_targets /
        # wave_recv_sources mirror each other exactly — an asymmetry is
        # a deadlock, which is why the model checker owns the predicate)
        contrib = self._exchange_contrib if seq == 1 else None
        fanout = self._gather_tree_fanout()
        use_tree = gather_only and fanout >= 2 and pg.world > 2
        targets = _proto.wave_send_targets(
            pg.world, pg.rank, gather_only, contrib, fanout
        )
        sources = _proto.wave_recv_sources(
            pg.world, pg.rank, gather_only, contrib, fanout
        )
        if not use_tree:
            # tree legs are topology, not emptiness — only flat waves
            # count absent legs as elided
            stats.on_exchange_elided(pg.world - 1 - len(targets))
        enc_cache = pg.make_enc_cache()
        received: dict[int, list] = {nid: [] for nid, _o, _s in prepared}
        relay: list = []
        wave_dl = pg.op_deadline()  # one deadline for the whole wave

        def _recv_from(peer: int, recv_tag=None) -> None:
            # always timed (not only under the recorder): per-peer
            # recv-wait feeds the cluster plane's straggler attribution
            # and the mesh_skew_seconds derivation on /metrics
            t_recv0 = _time.perf_counter_ns()
            for nid, part in pg.recv(
                peer, tag if recv_tag is None else recv_tag,
                deadline=wave_dl,
            ):
                if nid not in received:
                    raise RuntimeError(
                        f"rank {pg.rank}: exchange wave desync — peer "
                        f"{peer} sent node {nid} outside wave {wave} at "
                        f"time {time}"
                    )
                if use_tree and pg.rank != 0:
                    # interior tree rank: these slices are in transit to
                    # rank 0 — fold them into our parent frame below
                    relay.append((nid, part))
                else:
                    received[nid].append(part)
            t_recv1 = _time.perf_counter_ns()
            stats.on_exchange_recv_wait(peer, (t_recv1 - t_recv0) / 1e9)
            if rec is not None:
                rec.note_recv_wait(peer, t_recv0, t_recv1)

        if use_tree:
            # tree gather: children first (their frames carry the
            # subtree's slices), then ONE frame up to the parent with
            # own + relayed slices — recv-before-send is deadlock-free
            # here because tree edges form a DAG toward rank 0. Frames
            # whose DESTINATION is an interior rank ride the relay tag
            # ("xwr", ...): the receiver keeps their segments as wire
            # bytes (procgroup.RawSegment) and forwards them verbatim —
            # no decompress / typed decode / re-encode on the way up,
            # so a slice inflates exactly once, at rank 0
            relay_tag = ("xwr",) + tag[1:]
            for peer in sources:
                _recv_from(
                    peer, relay_tag if pg.rank != 0 else tag
                )
            if targets:
                own_entries = [
                    (nid, ent)
                    for nid, _own, sends in prepared
                    if (ent := sends.get(0)) is not None
                ]
                parent = targets[0]
                # route_dest=0: every tree-wave slice terminates at
                # rank 0 and is relayed verbatim past the next hop, so
                # compression must target rank 0's advertised codecs
                pg.send_exchange(
                    parent,
                    tag if parent == 0 else relay_tag,
                    _proto.tree_relay(own_entries, relay),
                    enc_cache,
                    route_dest=0,
                )
        else:
            for peer in targets:
                entries = []
                for nid, _own, sends in prepared:
                    ent = sends.get(peer)
                    if ent is not None:
                        entries.append((nid, ent))
                # frame/byte/compression accounting + the recorder's
                # send span land inside procgroup (sender threads ship
                # asynchronously; the engine only enqueues)
                pg.send_exchange(peer, tag, entries, enc_cache)
            for peer in sources:
                _recv_from(peer)
        for nid, own, _sends in prepared:
            node = nodes[nid]
            out = node.finish_exchange(own, received[nid])
            if out:
                self._deliver(node, time, out)
        if rec is not None:
            rec.note_wave(
                time, seq, t_wave0, _time.perf_counter_ns(), len(wave)
            )

    def _finish(self) -> None:
        # readiness: inputs are closed, the pipeline is flushing its tail
        # — /healthz flips to draining so load balancers rotate away
        self.stats.set_health_state("draining")
        if self.memory is not None:
            # release any still-paced readers (their threads may outlive
            # the loop as daemons) and retire this run's accountant
            from pathway_tpu_torch.internals import memory as _memory

            for conn in self.connectors:
                conn.pace_gate.set()
            if _memory.current() is self.memory:
                _memory.install(None)
        # stop the live dashboard first: its loop removes the log handler
        # and releases stderr (running it past the run garbles later runs)
        stop = getattr(self, "_dashboard_stop", None)
        if stop is not None:
            self._dashboard_stop = None
            stop()
        # phase 1: input closure — buffers flush their held rows, which
        # must still flow through the graph before on_end callbacks fire.
        # Loop until quiescent: an upstream buffer's flush may land inside
        # a DOWNSTREAM buffer that then needs its own closure flush.
        if self.distributed:
            pg = self.procgroup
            for i in range(len(self.scope.nodes) + 1):
                for node in self.scope.nodes:
                    node.on_input_closed()
                stepped = self._step_lockstep(None)
                # closure must repeat while ANY rank still produced work
                flags = pg.gather0(("fin", i), stepped > 0)
                more = pg.bcast0(
                    ("fin2", i), any(flags) if pg.rank == 0 else None
                )
                if not more:
                    break
        else:
            for _ in range(len(self.scope.nodes) + 1):
                for node in self.scope.nodes:
                    node.on_input_closed()
                if not self.pending_times:
                    break
                while self.pending_times:
                    self._step_time(self._min_pending())
        # clean-shutdown 2PC cut: the closure flush above pushed the
        # stream's tail into the sinks' staging — commit it through one
        # final snapshot + marker + finalize before on_end fires, so the
        # tail never finalizes outside a marker (io/txn.py)
        self._txn_final_cut()
        for node in self.scope.nodes:
            node.on_end()
        # final HBM sample + trace-ring pressure before the recorder
        # detaches: the shutdown scrape / merged trace must carry the
        # run's peak, not whatever the last throttled poll saw
        if _device.PLANE.stats is self.stats:
            _device.PLANE.sample_memory()
        if self.recorder is not None:
            self.stats.set_trace_dropped(self.recorder.dropped)
            self._finalize_trace()
        if _device.PLANE.stats is self.stats:
            _device.PLANE.disarm()
        if self._procgroup is not None:
            self._procgroup.close()
            self._procgroup = None
        if self._async_loop is not None:
            self._async_loop.close()
            self._async_loop = None
        if self._cluster_agg is not None:
            # one last scrape so the shutdown snapshot (skew, totals) is
            # complete, then release the /metrics/cluster listener
            try:
                self._cluster_agg.stop(final_scrape=True)
            except Exception:
                pass
            self._cluster_agg = None
        # post-run stats handle for harnesses (scripts/bench_relational
        # scaling lanes read per-rank recv-wait/comms off it after
        # pw.run() returns; module-level because the Runtime itself is
        # not reachable through the public API)
        global LAST_RUN_STATS
        LAST_RUN_STATS = self.stats

    def _finalize_trace(self) -> None:
        """Shutdown half of the flight recorder: dump this rank's trace,
        rendezvous the mesh so rank 0 merges after every partial is on
        disk, and leave the per-node OTLP span export for the graph
        runner's telemetry drain. Runs once (the recorder detaches) and
        never takes the pipeline down."""
        rec, self.recorder = self.recorder, None
        if rec is None or rec.dumped:
            return
        try:
            rec.drain_native()
            rec.disarm_native_ring()
            pg = self._procgroup
            path = None
            if rec.world > 1:
                rec.dump_partial(self.scope)
                if pg is not None:
                    # all partials durable before rank 0 merges
                    pg.gather0(("tracewr",), True)
                    if pg.rank == 0:
                        path = rec.merge(self.scope)
                    pg.bcast0(("tracewr2",), path if pg.rank == 0 else None)
                elif rec.rank == 0:
                    # no mesh formed (static local run under a
                    # multi-process config): merge whatever exists
                    path = rec.merge(self.scope)
            else:
                path = rec.dump(self.scope)
            self.trace_summary = {
                "path": path,
                "node_spans": rec.otlp_node_spans(self.scope),
            }
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "flight-recorder trace export failed", exc_info=True
            )

    def _abort_trace(self, exc: BaseException) -> None:
        """Epoch-abort half: mark the rollback and flush this rank's
        partial so post-mortem traces survive the supervised exit (the
        supervisor's fallback merge picks the partials up)."""
        if _device.PLANE.stats is self.stats:
            _device.PLANE.disarm()
        rec, self.recorder = self.recorder, None
        if rec is None or rec.dumped:
            return
        try:
            rec.note_mark("rollback", error=repr(exc))
            rec.drain_native()
            rec.disarm_native_ring()
            if rec.world > 1:
                rec.dump_partial(self.scope)
            else:
                rec.dump(self.scope)
        except Exception:
            pass

    def _trace_clock_sync(self, pg) -> None:
        """Sample cross-rank clock offsets during the epoch's clock
        handshake: rank 0 broadcasts its monotonic-ns reading, every
        peer records the offset onto its own timebase, and the trace
        CONVERSION shifts each rank's events by it. Loopback meshes see
        sub-ms skew (send latency); the knob is shared by every rank,
        so all of them join this round or none do."""
        rec = self.recorder
        if rec is None:
            return
        if pg.rank == 0:
            pg.bcast0(("tsync",), _time.perf_counter_ns())
            rec.clock_offset_ns = 0
        else:
            remote = pg.bcast0(("tsync",))
            rec.clock_offset_ns = remote - _time.perf_counter_ns()

    def _trace_clock_resample(self, pg, tag) -> None:
        """Re-sample the tsync offset at an epoch commit:
        monotonic clocks drift apart over multi-minute runs,
        so a single handshake-time offset skews late-run span alignment
        in the merged trace. Each resample opens a NEW offset segment on
        the recorder — events convert with the offset that was current
        when they were recorded (per-segment application,
        internals/flight.py). Same all-or-none contract as the
        handshake round: PATHWAY_TRACE is shared by every rank."""
        rec = self.recorder
        if rec is None:
            return
        if pg.rank == 0:
            pg.bcast0(("tsync", tag), _time.perf_counter_ns())
            rec.resample_clock_offset(0)
        else:
            remote = pg.bcast0(("tsync", tag))
            rec.resample_clock_offset(remote - _time.perf_counter_ns())

    # -- transactional egress (io/txn.py) -------------------------
    # The 2PC sink lifecycle the runtime drives: arm at run start,
    # recover at restore (before any new data flows), precommit inside
    # every snapshot cut BEFORE the marker moves, finalize after the
    # marker (and, on a mesh, the snapshot barrier) landed, and one
    # FINAL cut at clean shutdown so the tail of the stream commits
    # through the same two phases instead of bypassing them.

    def mesh_epoch(self) -> int:
        """The mesh recovery epoch this process runs at: the formed
        procgroup's epoch, else the PATHWAY_MESH_EPOCH env the
        supervisor stamps into respawns (0 outside supervised meshes).
        ONE parse, shared by the delivery-envelope mint
        (engine/nodes.py OutputNode) and the txn-sink arming."""
        pg = self._procgroup
        if pg is not None:
            return pg.epoch
        import os as _os

        try:
            return int(_os.environ.get("PATHWAY_MESH_EPOCH", "0") or 0)
        except ValueError:
            return 0

    def _arm_txn_sinks(self, operator_mode: bool) -> None:
        sinks = self.scope.txn_sinks
        if not sinks:
            self._txn_operator = False
            return
        from pathway_tpu_torch.internals.config import get_pathway_config
        from pathway_tpu_torch.io.txn import txn_enabled

        c = get_pathway_config()
        if self._lane_emulated:
            # emulated thread-ranks share ONE sink object per program
            # (the write() call built it once); only the rank-0 runtime
            # may arm/drive it, and it sees a world of 1 — exactly like
            # the shared connector subjects. Non-zero thread-ranks keep
            # _txn_operator (the final-cut branch is COLLECTIVE — every
            # rank must join its snapshot round) but never drive sinks.
            if c.process_id != 0:
                self._txn_operator = operator_mode and txn_enabled()
                self._txn_driver = False
                return
            txn = operator_mode and txn_enabled()
            lineage = self._txn_lineage_local() if txn else None
            for sink in sinks:
                sink.arm(
                    stats=self.stats, txn=txn, rank=0, world=1, epoch=0,
                    lineage=lineage,
                )
            self._txn_operator = txn
            self._txn_driver = True
            return
        pg = self._procgroup
        epoch = self.mesh_epoch()
        txn = operator_mode and txn_enabled()
        world = 1 if self.local_only else max(1, c.processes)
        rank = 0 if self.local_only else c.process_id
        lineage = None
        if txn:
            if pg is not None:
                # one lineage id per persistence store, agreed by the
                # mesh: rank 0 reads-or-mints the marker, peers adopt it
                lineage = pg.bcast0(
                    ("sinklin",),
                    self._txn_lineage_local() if pg.rank == 0 else None,
                )
            else:
                lineage = self._txn_lineage_local()
        for sink in sinks:
            sink.arm(
                stats=self.stats, txn=txn, rank=rank, world=world,
                epoch=epoch, lineage=lineage,
            )
        self._txn_operator = txn
        self._txn_driver = True

    def _txn_lineage_local(self) -> str:
        """The persistence store's egress lineage id: minted once on the
        store's first run, restored thereafter. Scopes the Delta txn
        dedup record — snapshot tags restart at 1 whenever the
        persistence directory is cleared, and an unscoped dedup would
        let a kept lake's old txn actions mask (and silently drop) the
        new lineage's first cuts."""
        import uuid as _uuid

        lin = self.persistence.read_marker("sink_lineage")
        if lin is None:
            lin = _uuid.uuid4().hex[:16]
            self.persistence.write_marker("sink_lineage", lin)
        return lin

    def _txn_precommit(self, tag: int) -> None:
        if not getattr(self, "_txn_driver", True):
            return
        for sink in self.scope.txn_sinks:
            sink.precommit(tag)

    def _txn_finalize(self, tag: int) -> None:
        if not getattr(self, "_txn_driver", True):
            return
        for sink in self.scope.txn_sinks:
            sink.finalize(tag)

    def _txn_recover(self, marker_tag, world: int) -> None:
        if not getattr(self, "_txn_driver", True):
            return
        for sink in self.scope.txn_sinks:
            sink.recover(marker_tag, world)

    def _index_cut(self, tag: int, rank: int = 0, world: int = 1):
        """Arm the device-index snapshot cut around a node
        state_dict/load_state pass: HBM-resident indexes write/read
        their delta segments through the same persistence store, under
        the same (tag, world) the snapshot marker commits — so index
        segments become visible exactly when the mesh's cut does."""
        from pathway_tpu_torch.persistence import index_snapshot as _isnap

        return _isnap.cut(
            self.persistence, tag, rank=rank, world=world, stats=self.stats
        )

    def _txn_final_cut(self) -> None:
        """Clean-shutdown half of the 2PC egress: one FINAL snapshot cut
        (snapshot + marker + finalize) covering the stream's tail, taken
        after input closure flushed every buffered row through the graph
        but before ``on_end`` fires. Without it the tail would have to
        finalize outside any marker — exactly the window the protocol
        exists to close. Collective on a mesh: every rank takes the same
        branch (the sink list and mode flags are lowering-deterministic),
        so the snapshot collectives line up."""
        if not self._txn_operator or not self.scope.txn_sinks:
            return
        pg = self._procgroup
        if pg is not None:
            self._save_operator_snapshot_distributed(
                pg, self._bsp_round_no + 1
            )
            return
        tag = getattr(self, "_snap_tag_base", 0) + 1
        self._snap_tag_base = tag
        with self._index_cut(tag):
            node_states = [node.state_dict() for node in self.scope.nodes]
        self.persistence.save_operator_snapshot(
            node_states,
            dict(self._operator_subject_states),
            [node.name() for node in self.scope.nodes],
            key=f"operator_snapshot/r0/{tag}",
        )
        self._txn_precommit(tag)
        self.persistence.write_marker("snapshot_commit", (tag, 1))
        prev = getattr(self, "_snap_prev_tag", None)
        self.persistence.prune_operator_snapshots(
            "operator_snapshot/r0/",
            {tag} if prev is None else {tag, prev},
        )
        self._snap_prev_tag = tag
        self._txn_finalize(tag)

    def _inject_static(self) -> None:
        t = self._next_time()
        if self.static_data:
            # static rows freshen from injection: commit→emit still
            # yields a meaningful watermark for program-embedded data
            self._ingest_ns.setdefault(t, _time.perf_counter_ns())
        for node, deltas in self.static_data:
            if deltas:
                node.accept(t, 0, deltas)
            else:
                if t not in self.pending_times:
                    self.pending_times[t] = set()
                    _heapq.heappush(self._time_heap, t)

    def _next_time(self) -> int:
        now_ms = int(_time.time() * 1000)
        self.clock = max(self.clock + 2, now_ms - (now_ms % 2))  # even: system time
        return self.clock

    # -- run modes --------------------------------------------------------
    def run_static(self) -> None:
        # static runs have no snapshot cuts: txn sinks finalize per
        # commit timestamp (from-scratch semantics), counters attached
        self._arm_txn_sinks(False)
        if self.distributed:
            # static rows are the PROGRAM's data, identical in every
            # process: rank 0 injects, exchanges shard the work. Every
            # rank adopts rank 0's clock so locally minted times (error
            # log at clock+1) stay globally ordered.
            if self.procgroup.rank == 0:
                self._inject_static()
            self.clock = self.procgroup.bcast0(("clk",), self.clock)
            self._trace_clock_sync(self.procgroup)
            self._step_lockstep(None)
            self._finish()
            return
        self._inject_static()
        while self.pending_times:  # nodes may emit at later times (buffers)
            t = self._min_pending()
            self._step_time(t)
        self._finish()

    def run(self) -> None:
        if self.recorder is not None:
            self.recorder.arm_native_ring()
        # device plane: armed alongside the profiling plane
        # (PATHWAY_TRACE or a live /metrics endpoint) so engine dispatch
        # sites (ops/knn, encoder, gateway) record per-dispatch device
        # time, FLOPs and transfer bytes. Process-global like the native
        # rings — the emulated-rank lane shares it (approximate there,
        # exact on real meshes); local_only inner runtimes never arm.
        if self._prof and not self.local_only:
            _device.PLANE.arm(self.recorder, self.stats)
        try:
            if not self.connectors:
                self.run_static()
                return
            if self.distributed:
                self._run_streaming_distributed()
                return
            self._run_streaming()
        except BaseException as exc:
            # a failing rank must not leave peers blocked in a collective:
            # closing the mesh surfaces ConnectionError everywhere
            pg = self._procgroup
            if pg is not None:
                # epoch abort: in-flight frames of the dead epoch are
                # drained and discarded — never delivered to the engine —
                # before the links come down. No goodbye frame: this rank
                # is dying of an exception, and peers must classify the
                # loss as a failure, not a clean shutdown.
                try:
                    pg.drain()
                except Exception:
                    pass
                pg.close(goodbye=False)
                self._procgroup = None
            if self._is_mesh_error(exc):
                # mesh_rollbacks_total counts epoch aborts this rank
                # initiated after detecting a mesh failure — incremented
                # here (not only in the supervised exit path) so
                # embedded/unsupervised runs whose stats object outlives
                # the abort still observe it
                self.stats.on_mesh_rollback()
                # serving plane: abort queued windows (they must commit
                # NOTHING) and flip /healthz to recovering BEFORE the
                # trace flush so the park marks land in the partial
                self._park_serving_for_rollback()
                # egress plane: discard the dying epoch's un-pre-
                # committed staged output (recovery would discard it
                # anyway; this reclaims it early and counts the abort)
                if self.scope.txn_sinks:
                    from pathway_tpu_torch.io._connector import (
                        abort_sinks_for_rollback,
                    )

                    abort_sinks_for_rollback(self.scope.txn_sinks)
                # flush this rank's trace partial with the rollback mark
                # before the supervised exit discards the process
                self._abort_trace(exc)
                self._maybe_exit_for_rollback(exc)
            raise
        finally:
            # the plane is process-global: a NON-mesh failure (UDF
            # exception, data error under terminate_on_error) must not
            # leave it armed with the dead run's recorder/stats — later
            # out-of-engine dispatches (a still-alive gateway worker, a
            # notebook cell) would keep paying block_until_ready and
            # write into a detached recorder. Idempotent with the
            # _finish/_abort_trace disarms.
            if _device.PLANE.stats is self.stats:
                _device.PLANE.disarm()

    def _park_serving_for_rollback(self) -> None:
        """Serving half of the epoch abort: every gateway
        subject aborts its queued-but-undispatched batch windows — their
        members evicted, so nothing of them commits — and readiness
        flips to ``recovering``. The requests themselves are parked at
        the epoch-survivable frontend (io/http/_frontend.py), which
        holds the real client futures and replays them into epoch+1;
        this side only guarantees the dying epoch cannot half-commit a
        window on the way down."""
        self.stats.set_health_state("recovering")
        for conn in self.connectors:
            abort = getattr(
                conn.subject, "abort_windows_for_rollback", None
            )
            if abort is None:
                continue
            try:
                n = abort()
            except Exception:
                continue
            if n and self.recorder is not None:
                self.recorder.note_mark(
                    "serve_park",
                    route=getattr(conn.subject, "route", "?"),
                    windows_aborted=n,
                )

    @staticmethod
    def _is_mesh_error(exc: BaseException) -> bool:
        """The single classification of mesh-originated failures (peer
        crashed, timed out, or went away) — shared by the rollback
        counter and the supervised-exit decision so the two can never
        desynchronize."""
        from pathway_tpu_torch.parallel.procgroup import (
            MeshPeerFailure,
            MeshPeerGone,
            MeshTimeout,
        )

        return isinstance(exc, (MeshPeerFailure, MeshPeerGone, MeshTimeout))

    def _maybe_exit_for_rollback(self, exc: BaseException) -> None:
        """Supervised-mesh epoch abort epilogue (caller has already
        classified ``exc`` as mesh-originated via ``_is_mesh_error``):
        when a mesh supervisor owns this rank (PATHWAY_MESH_SUPERVISED),
        exit with MESH_RESTART_EXIT_CODE so the supervisor rolls the
        whole rank set back to the last committed snapshot at epoch+1.
        Non-mesh failures (program bugs, connector failures under
        terminate_on_error) never reach here and propagate normally —
        the supervisor still restarts on the nonzero exit, but the
        traceback and code tell the two apart. Never fires in the
        emulated-rank lane: those "ranks" are threads of the test
        process, and os._exit would kill the host."""
        import os as _os

        if self._lane_emulated or not _os.environ.get(
            "PATHWAY_MESH_SUPERVISED"
        ):
            return
        import logging

        logging.getLogger(__name__).warning(
            "mesh failure detected; aborting the epoch and requesting a "
            "rollback restart: %s", exc
        )
        from pathway_tpu_torch.io._connector import close_subjects_for_rollback
        from pathway_tpu_torch.parallel.supervisor import MESH_RESTART_EXIT_CODE

        close_subjects_for_rollback(self.connectors)
        _os._exit(MESH_RESTART_EXIT_CODE)

    @staticmethod
    def _cluster_metrics_port() -> int | None:
        """PATHWAY_CLUSTER_METRICS_PORT: where the merged
        /metrics/cluster view is served (by the MeshSupervisor when one
        owns the rank set, by rank 0 itself otherwise). None = off."""
        from pathway_tpu_torch.internals.cluster import metrics_port_from_env

        return metrics_port_from_env()

    def _start_monitoring(self, printer: bool = True) -> None:
        import os as _os

        from pathway_tpu_torch.internals.config import get_pathway_config

        c = get_pathway_config()
        if not self.local_only:
            # memory governance: fresh accountant per run —
            # a restore/rollback therefore starts the ladder at "ok" and
            # re-derives any paced state from real post-restore bytes
            from pathway_tpu_torch.internals import memory as _memory

            self.memory = _memory.MemoryAccountant()
            _memory.install(self.memory)
            self.stats.set_mem_pressure(
                self.memory.state, 0, 0, self.memory.budget_bytes, {}
            )
        cluster_port = (
            self._cluster_metrics_port() if not self.local_only else None
        )
        if self.with_http_server or (
            cluster_port is not None and self.distributed
        ):
            # reference: metrics at port 20000 + process_id
            # (http_server.rs). The cluster knob implies the per-rank
            # endpoint: the aggregator has nothing to scrape otherwise.
            from pathway_tpu_torch.internals.monitoring import start_http_server

            start_http_server(self.stats, 20000 + c.process_id)
        if (
            cluster_port is not None
            and self.distributed
            and c.process_id == 0
            and not _os.environ.get("PATHWAY_MESH_SUPERVISED")
        ):
            # standalone cluster aggregation: no supervisor
            # owns the rank set, so rank 0 hosts the merged
            # /metrics/cluster view for this run's lifetime and the TUI
            # dashboard gets its per-rank section
            from pathway_tpu_torch.internals.cluster import (
                ClusterMetricsAggregator,
            )

            self._cluster_agg = ClusterMetricsAggregator.from_env(
                cluster_port, world=c.processes
            )
            self._cluster_agg.start()
            self.stats.cluster = self._cluster_agg
        if self.monitoring_level is not None and printer:
            from pathway_tpu_torch.internals.monitoring import (
                MonitoringLevel,
                start_dashboard,
            )

            if self.monitoring_level not in (
                MonitoringLevel.NONE,
                MonitoringLevel.AUTO,
            ):
                # rich live dashboard (reference: monitoring.py TUI);
                # falls back to the text printer without rich
                _thread, self._dashboard_stop = start_dashboard(self.stats)

    def _drain_event_queue(self, timeout: float) -> list:
        """One bounded wait, then drain everything queued."""
        entries = []
        t0 = _time.perf_counter()
        try:
            entries.append(self.event_queue.get(timeout=timeout))
        except queue.Empty:
            # the bounded wait expired with nothing queued: pure idle
            # (runtime_idle_seconds_total — the third leg of the cluster
            # view's per-rank comms/compute/idle split; a drain that
            # returned work is engine time, not idle)
            self.stats.on_idle(_time.perf_counter() - t0)
        while True:
            try:
                entries.append(self.event_queue.get_nowait())
            except queue.Empty:
                break
        return entries

    def _run_streaming(self) -> None:
        from pathway_tpu_torch.io._connector import run_connector_thread

        self._start_monitoring()
        # arm BEFORE static injection: rows staged by it live in the
        # current incarnation's open staging and survive the recovery
        # scan below (dead incarnations' open staging does not)
        self._arm_txn_sinks(
            self.persistence is not None
            and self.persistence.mode == "OPERATOR_PERSISTING"
        )
        self._inject_static()
        while self.pending_times:
            t = self._min_pending()
            self._step_time(t)

        if self.persistence is not None:
            # restore/replay window: not yet serving traffic
            self.stats.set_health_state("recovering")
        if self.persistence is not None and self.persistence.mode == "OPERATOR_PERSISTING":
            # operator-state snapshots (reference: OperatorPersisting,
            # operator_snapshot.rs): restore every stateful node's state at
            # the last commit cut and seek subjects — no input replay.
            # A snapshot_commit marker means the cut is RANK-SCOPED (a
            # mesh run, or this path's own dual-write below) — restore
            # through the re-shard reader at world 1, which is how a
            # shrink-to-one-rank rescale lands here
            marker = self.persistence.read_marker("snapshot_commit")
            if marker is not None:
                if isinstance(marker, tuple):
                    tag, snap_world = marker
                else:
                    # legacy bare marker: only ever written by an
                    # N-rank mesh — discover the true world from the
                    # rank-scoped snapshot keys (decoding it as world 1
                    # would silently drop every other rank's shard)
                    tag = marker
                    snap_world = self._discover_snapshot_world(tag)
                self._snap_tag_base = tag
                self._snap_prev_tag = tag
                # same restore-window kill slot the distributed path
                # exposes: on a shrink-to-1 THIS is the re-shard window,
                # and checker traces must land in it
                _faults.fault_point("mesh.rank_kill", phase="restore")
                live = list(self.connectors)
                node_states, subject_states = self._load_resharded_cut(
                    tag, snap_world, 0, 1, live
                )
                # index restores read their segment chains through the
                # same cut the marker committed
                with self._index_cut(tag):
                    for node, st in zip(self.scope.nodes, node_states):
                        if st:
                            node.load_state(st)
                self._operator_subject_states.update(subject_states)
                for conn in live:
                    self._restore_conn_state(
                        conn, subject_states.get(conn.name)
                    )
                # sink recovery AFTER the engine cut is restored: pending
                # staged egress at-or-below the cut finalizes, the rest
                # is discarded (the restored engine re-emits it)
                self._txn_recover(tag, 1)
                snap = None
            else:
                snap = self.persistence.load_operator_snapshot()
                if snap is None:
                    # genuine from-scratch start: stale staging AND
                    # stale finalized output are discarded (everything
                    # will be re-emitted). A legacy flat snapshot
                    # (marker-less store from an older build) instead
                    # keeps the sink's durable state, matching the
                    # operator-persistence contract that restores never
                    # re-notify sinks.
                    self._txn_recover(None, 1)
            if snap is not None:
                node_states, subject_states, fingerprint = snap
                current = [node.name() for node in self.scope.nodes]
                if fingerprint != current:
                    raise RuntimeError(
                        "operator snapshot does not match this pipeline's "
                        "graph shape — the program changed since the "
                        f"snapshot was taken (stored {len(fingerprint)} "
                        f"nodes, current {len(current)}); clear the "
                        "persistence directory or revert the pipeline"
                    )
                for node, state in zip(self.scope.nodes, node_states):
                    if state:
                        node.load_state(state)
                # idle connectors must keep their restored positions in the
                # NEXT snapshot too, or a second restart rereads them
                self._operator_subject_states.update(subject_states)
                for conn in self.connectors:
                    self._restore_conn_state(
                        conn, subject_states.get(conn.name)
                    )
        elif self.persistence is not None:
            # replay journaled input (reference: Entry::Snapshot path,
            # connectors/mod.rs:101-130) — each journaled commit becomes a
            # fresh timestamp in arrival order, then subjects seek to their
            # stored scan state before going live
            for conn in self.connectors:
                journal = self.persistence.load_journal(conn.name)
                last_state = None
                for _orig_time, deltas, entry_state in journal:
                    if deltas:
                        t = self._next_time()
                        conn.node.accept(t, 0, deltas)
                        while self.pending_times and self._min_pending() <= self.clock + 1:
                            self._step_time(self._min_pending())
                    if entry_state is not None:
                        last_state = entry_state
                # states are embedded in journal entries (atomic with the
                # rows they claim); the standalone state file is the
                # pre-embedding fallback
                self._restore_conn_state(
                    conn,
                    last_state
                    if last_state is not None
                    else self.persistence.load_subject_state(conn.name),
                )

        self.stats.set_health_state("serving")
        for conn in self.connectors:
            self._arm_watchdog(conn)
            # copy the creating thread's context so per-thread config
            # overlays (emulated-rank CI lane) reach the subject's thread
            import contextvars as _cv

            _ctx = _cv.copy_context()
            conn.thread = threading.Thread(
                target=_ctx.run,
                args=(run_connector_thread, conn, self.event_queue),
                daemon=True,
            )
            conn.thread.start()

        active = len(self.connectors)
        while active > 0:
            # autocommit cadence for subjects blocked in run(): flush their
            # pending rows even though no emit fired the timer
            self._cadence_flush(self.connectors)
            entries = self._drain_event_queue(0.5)
            self._service_connector_health(self.connectors)
            if not entries:
                if self.error and self.terminate_on_error:
                    raise self.error
                continue
            # every queue entry is one connector commit and gets its OWN
            # timestamp (reference: each flush advances the commit Timestamp,
            # connectors/mod.rs) — merging commits could cancel an insert
            # with a later retraction before downstream ever observed it
            operator_mode = (
                self.persistence is not None
                and self.persistence.mode == "OPERATOR_PERSISTING"
            )
            drained_subject_states: dict = {}
            saw_data = False
            for conn, deltas, state, journal_rows in entries:
                if deltas is None:
                    conn.finished = True
                    self.stats.on_connector_finished(conn.name)
                    active -= 1
                    self._release_uncovered(conn)
                    continue
                if (
                    self.persistence is not None
                    and not operator_mode
                    and journal_rows
                ):
                    # journal_rows arrive only when consistent with `state`:
                    # stateless subjects journal write-ahead at every flush;
                    # stateful subjects journal at subject commit boundaries
                    # where the captured scan state claims exactly the
                    # journaled prefix — carried in the same atomic append
                    # (see io/_connector.py)
                    self.persistence.journal_batch(
                        conn.name, self.clock, journal_rows, state
                    )
                if state is not None:
                    drained_subject_states[conn.name] = state
                    self._uncovered.discard(conn.name)
                elif (
                    deltas
                    and self.persistence is not None
                    and hasattr(conn.subject, "snapshot_state")
                ):
                    # rows accepted whose effects a stateful subject's last
                    # published state does not claim yet — an operator
                    # snapshot taken now would double-count them on restore
                    self._uncovered.add(conn.name)
                if deltas:
                    saw_data = True
                    self._account_drain(conn, deltas)
                    t = self._next_time()
                    self.stats.on_ingest(conn.name, len(deltas))
                    self._note_ingest(t, conn)
                    conn.node.accept(t, 0, deltas)
            # step strictly in time order, re-reading pending_times each
            # round: stepping may schedule NEW times (forget-immediately
            # retractions at t+1) that must run before later commits.
            # Cutoff clock+1 also flushes those retractions promptly even
            # on finish-only drains.
            while self.pending_times:
                tt = self._min_pending()
                if tt > self.clock + 1:
                    break
                self._step_time(tt)
            if operator_mode and saw_data:
                # snapshot AFTER the commit's effects are fully applied:
                # node states + source scan positions form one consistent
                # cut (reference: tracker.rs commit protocol). Rate-limited
                # by snapshot_interval_ms — full-state pickling per commit
                # is O(state); the consistent cut makes skipping safe.
                # Skipped while any stateful subject has forwarded rows its
                # published scan state does not claim yet (mid-scan timer
                # flushes) — the next subject commit clears the set.
                self._operator_subject_states.update(drained_subject_states)
                now = _time.monotonic()
                if self._uncovered:
                    pass
                elif (
                    now - self._last_snapshot
                ) * 1000.0 >= self.persistence.snapshot_interval_ms:
                    self._last_snapshot = now
                    # rank-scoped form + commit marker (world 1) — the
                    # same keyspace the mesh writes, so a later GROW
                    # rescale re-shards this cut into an N-rank mesh
                    # and a shrink-to-1 lands here symmetrically
                    #. The pre-rescale flat key is no longer
                    # written (it collides with the rank directory on
                    # fs backends); restore still falls back to it for
                    # stores from older builds.
                    tag = getattr(self, "_snap_tag_base", 0) + 1
                    self._snap_tag_base = tag
                    # index delta segments ride this cut:
                    # written durably now, committed when the marker
                    # below moves
                    with self._index_cut(tag):
                        node_states = [
                            node.state_dict() for node in self.scope.nodes
                        ]
                    fingerprint = [
                        node.name() for node in self.scope.nodes
                    ]
                    self.persistence.save_operator_snapshot(
                        node_states,
                        dict(self._operator_subject_states),
                        fingerprint,
                        key=f"operator_snapshot/r0/{tag}",
                    )
                    # 2PC egress, phase 1: freeze the staged sink set
                    # under this cut's tag BEFORE the marker moves
                    self._txn_precommit(tag)
                    self.persistence.write_marker(
                        "snapshot_commit", (tag, 1)
                    )
                    prev = getattr(self, "_snap_prev_tag", None)
                    self.persistence.prune_operator_snapshots(
                        "operator_snapshot/r0/",
                        {tag} if prev is None else {tag, prev},
                    )
                    self._snap_prev_tag = tag
                    # phase 2: the marker is durable — staged output
                    # at-or-below the tag becomes externally visible
                    self._txn_finalize(tag)
            if self.error and self.terminate_on_error:
                raise self.error
        # late notices (final flush failures, demotions) still deserve
        # error-log rows before the graph closes
        self._service_connector_health(self.connectors)
        while self.pending_times:
            t = self._min_pending()
            self._step_time(t)
        for conn in self.connectors:
            if conn.thread is not None:
                conn.thread.join(timeout=5)
        self._finish()

    # -- multi-process persistence (reference: tracker.rs:47,160-193 — the
    # commit tracker is per-worker with a global consistent cut: a
    # snapshot timestamp only advances when every worker durably wrote it)

    def _pname(self, conn_name: str) -> str:
        """Rank-scoped persistence name: every rank journals its own
        connectors under its own keyspace on the shared backend (the same
        program runs on every rank, so unscoped names would collide)."""
        from pathway_tpu_torch.internals.config import get_pathway_config

        return f"r{get_pathway_config().process_id}/{conn_name}"

    def _planned_walk_eligible(self) -> bool:
        """True when every commit timestamp's work is confined to that
        timestamp: no node that can emit at a FUTURE time has an exchange
        boundary downstream. Then a BSP round's timestamps can be walked
        from the shared plan with zero per-timestamp control round-trips
        — the only remaining synchronization is the data-plane waves
        themselves. ForgetImmediatelyNode (t+1 retractions) and the
        error-log source (rows minted at clock+1 on whichever rank hits a
        data error) are the streaming-time future emitters; either one
        reaching an exchange forces the negotiated frontier."""
        if self._planned_ok is not None:
            return self._planned_ok
        masks = self._exchange_reach_masks()
        from pathway_tpu_torch.engine.nodes import ForgetImmediatelyNode

        ok = not (
            self.error_log_node is not None
            and masks[self.error_log_node.node_id]
        )
        if ok:
            ok = not any(
                isinstance(node, ForgetImmediatelyNode)
                and masks[node.node_id]
                for node in self.scope.nodes
            )
        self._planned_ok = ok
        return ok

    def _bsp_inject_commits(self, pg, commits, done_local, tag) -> bool:
        """One BSP ingest round: gather per-rank commit counts (plus each
        commit's source exchange mask), let the rank-0 clock master
        assign globally ordered times (rank-major), inject, and step.
        Eligible graphs walk the round's timestamps straight off the
        shared plan — every rank knows every commit's time, owner and
        exchange mask, so no per-timestamp frontier negotiation happens
        and a rank whose peer owns the commit doesn't even send wave-1
        frames (contributor elision). The trailing negotiated loop picks
        up stragglers and confirms quiescence. Returns alldone (= every
        rank reported done and no rank contributed a commit)."""
        masks = self._exchange_reach_masks()
        my_masks = [masks[conn.node.node_id] for conn, _ in commits]
        if pg.rank == 0:
            info = pg.gather0(tag, (len(commits), done_local, my_masks))
            counts = [c for c, _, _ in info]
            alldone = all(d for _, d, _ in info)
            xmasks = [m for _, _, m in info]
            base = self._next_time() if sum(counts) else self.clock
            base, counts, alldone, xmasks = pg.bcast0(
                (tag[0] + "2", tag[1]), (base, counts, alldone, xmasks)
            )
        else:
            pg.gather0(tag, (len(commits), done_local, my_masks))
            base, counts, alldone, xmasks = pg.bcast0(
                (tag[0] + "2", tag[1])
            )
        total = sum(counts)
        my_off = sum(counts[: pg.rank])
        for i, (conn, deltas) in enumerate(commits):
            t = _proto.commit_time(base, my_off + i)
            self.stats.on_ingest(conn.name, len(deltas))
            self._note_ingest(t, conn)
            conn.node.accept(t, 0, deltas)
        if total:
            self.clock = max(self.clock, _proto.commit_time(base, total - 1))
        if total and self._planned_walk_eligible():
            # the planned walk IS the shared commit_plan transition: every
            # rank derives the same (time, xmask, owner) sequence from the
            # gathered round info with zero further control traffic
            plan = _proto.commit_plan(base, counts, xmasks)
            for t, xmask, contrib in plan:
                # rank-private stragglers (no exchange downstream) keep
                # local time order; anything masked waits for the
                # negotiated loop (impossible on eligible graphs)
                while self.pending_times:
                    m = self._min_pending()
                    if m >= t or any(
                        masks[nid] for nid in self.pending_times[m]
                    ):
                        break
                    self._step_time(m)
                for i, xn in enumerate(self.scope.exchange_nodes):
                    if (xmask >> i) & 1:
                        self.mark_pending(t, xn)
                self._exchange_contrib = contrib
                try:
                    self._step_time(t)
                finally:
                    self._exchange_contrib = None
        self._step_lockstep(self.clock + 1)
        return alldone and total == 0

    def _replay_journals_distributed(self, pg, live) -> None:
        """Input-journal restore across the mesh: every rank replays its
        own rank-scoped journals, one entry per connector per BSP round,
        so exchanges re-shard the replayed rows exactly like live ingest.
        Cross-rank interleaving need not match the original run — every
        commit gets its own fresh timestamp and the dataflow is
        deterministic per commit order on each connector, which the
        per-rank journal preserves."""
        if pg.rank == 0:
            # rescale guard: input journals are rank-scoped,
            # so ANY world change breaks them — a shrink orphans the
            # departed ranks' journaled rows, a grow re-partitions
            # partition-aware reads so new ranks re-read keys the old
            # ranks already journaled (duplicates). The first run
            # stamps its world in a marker; every later run must match.
            # Refuse loudly; OPERATOR_PERSISTING is the rescale path.
            jworld = self.persistence.read_marker("journal_world")
            if jworld is None:
                self.persistence.write_marker("journal_world", pg.world)
            elif jworld != pg.world:
                raise RuntimeError(
                    f"input journals were written by a {jworld}-rank "
                    f"mesh but this one has {pg.world} ranks — "
                    "PERSISTING mode journals are rank-scoped and "
                    "cannot be re-partitioned; rescale requires "
                    "OPERATOR_PERSISTING (or clear the persistence "
                    "directory)"
                )
            # pre-marker stores: the key layout still exposes a shrink
            for key in self.persistence.list_keys("journal/r"):
                try:
                    r = int(key[len("journal/r"):].split("/")[0])
                except ValueError:
                    continue
                if r >= pg.world:
                    raise RuntimeError(
                        f"journaled input for rank {r} exists but this "
                        f"mesh has only {pg.world} ranks — PERSISTING "
                        "mode journals are rank-scoped and cannot be "
                        "re-partitioned; rescale requires "
                        "OPERATOR_PERSISTING"
                    )
        cursors = []
        for conn in live:
            entries = self.persistence.load_journal(self._pname(conn.name))
            last_state = None
            for _t, _d, s in entries:
                if s is not None:
                    last_state = s
            state = (
                last_state
                if last_state is not None
                else self.persistence.load_subject_state(
                    self._pname(conn.name)
                )
            )
            cursors.append((conn, entries, state))
        idx = 0
        round_no = 0
        while True:
            round_no += 1
            commits = []
            for conn, entries, _state in cursors:
                if idx < len(entries) and entries[idx][1]:
                    commits.append((conn, entries[idx][1]))
            done_local = all(idx + 1 >= len(e) for _, e, _ in cursors)
            alldone = self._bsp_inject_commits(
                pg, commits, done_local, ("jr", round_no)
            )
            idx += 1
            if alldone:
                break
        for conn, _entries, state in cursors:
            self._restore_conn_state(conn, state)

    def _restore_operator_snapshot_distributed(self, pg, live) -> None:
        """All-or-nothing rank-local snapshot restore: rank 0 reads the
        commit marker (written only after every rank acked a snapshot
        tag), every rank loads its own snapshot at that tag, and restore
        is skipped entirely unless every rank has a matching, fingerprint-
        compatible snapshot.

        Elastic mesh: the marker also records the WORLD SIZE
        of the cut. When it differs from this mesh's world the restore
        is a RESCALE — every rank reads ALL old ranks' snapshots and
        re-buckets the committed entries through the stable shard mint
        at the new world size (persistence/reshard.py; the kept sets
        form a partition, so no delta is lost or duplicated — the
        property ``--mesh --rescale`` model-checks)."""
        marker = (
            self.persistence.read_marker("snapshot_commit")
            if pg.rank == 0
            else None
        )
        marker = pg.bcast0(("snaptag",), marker)
        if isinstance(marker, tuple):
            tag, snap_world = marker
        else:  # pre-rescale marker format: a bare tag, same world
            tag, snap_world = marker, pg.world
        if tag is not None:
            # tags stay monotone across restarts: live-loop rounds restart
            # at 1, so new tags build on the restored one — pruning and
            # marker ordering remain correct over kill/restart cycles
            self._snap_tag_base = tag
            # the restored tag is a committed cut other ranks may still be
            # reading: the next save's prune must retain it (two-tag
            # retention window)
            self._snap_prev_tag = tag
        if tag is None:
            # from-scratch start: discard stale staged egress (and stale
            # finalized output — everything will be re-emitted)
            self._txn_recover(None, pg.world)
            return
        # kill slot: rank dies mid-restore, after the marker tag was
        # agreed — peers abort, and the NEXT rollback must still find
        # every rank's snapshot at this tag intact (for a rescale
        # restore this slot IS the re-shard window: a kill here must
        # leave the old-world snapshots untouched for the retry)
        _faults.fault_point("mesh.rank_kill", phase="restore")
        if snap_world != pg.world:
            self._restore_resharded(pg, live, tag, snap_world)
            # sink recovery at the NEW world: pending staged partitions
            # of the dead world are re-owned through the shared
            # shard_owner mint, finalized at-or-below the cut
            self._txn_recover(tag, pg.world)
            return
        snap = self.persistence.load_operator_snapshot(
            key=f"operator_snapshot/r{pg.rank}/{tag}"
        )
        ok = snap is not None
        if ok:
            _states, _subjects, fingerprint = snap
            ok = fingerprint == [node.name() for node in self.scope.nodes]
        flags = pg.gather0(("snapok",), ok)
        do = pg.bcast0(("snapok2",), all(flags) if pg.rank == 0 else None)
        if not do:
            if ok is False and snap is not None:
                raise RuntimeError(
                    "operator snapshot does not match this pipeline's "
                    "graph shape — clear the persistence directory or "
                    "revert the pipeline"
                )
            self._txn_recover(None, pg.world)
            return
        node_states, subject_states, _fp = snap
        # index restores read their rank's segment chains at this cut
        with self._index_cut(tag, rank=pg.rank, world=pg.world):
            for node, state in zip(self.scope.nodes, node_states):
                if state:
                    node.load_state(state)
        self._operator_subject_states.update(subject_states)
        for conn in live:
            self._restore_conn_state(conn, subject_states.get(conn.name))
        # sink recovery AFTER the engine cut is restored: pending staged
        # egress at-or-below the cut finalizes (the crash landed between
        # the marker and the owner's local finalize), the rest discards
        self._txn_recover(tag, pg.world)
        # the committed cut this epoch resumed from (OpenMetrics gauge)
        self.stats.on_mesh_epoch_committed(pg.epoch)
        if self.recorder is not None:
            self.recorder.note_mark(
                "epoch_restore", epoch=pg.epoch, tag=tag
            )

    def _discover_snapshot_world(self, tag: int) -> int:
        """World size of a cut whose marker predates the (tag, world)
        format: legacy bare markers were only written by N-rank meshes,
        so the rank-scoped snapshot keys at the tag name the world
        (1 + highest rank present; load_world_snapshots then verifies
        the set is contiguous)."""
        top = -1
        prefix = "operator_snapshot/r"
        for key in self.persistence.list_keys(prefix):
            parts = key[len(prefix):].split("/")
            if len(parts) >= 2 and parts[1] == str(tag):
                try:
                    top = max(top, int(parts[0]))
                except ValueError:
                    continue
        if top < 0:
            raise RuntimeError(
                f"snapshot_commit marker names tag {tag} but no "
                "rank-scoped snapshot exists at that tag"
            )
        return top + 1

    def _load_resharded_cut(
        self, tag: int, old_world: int, rank: int, world: int, live
    ) -> tuple[list, dict]:
        """ONE implementation of the re-shard read shared by the mesh
        restore (`_restore_resharded`) and the single-process marker
        restore: load every old rank's snapshot at the tag, verify +
        align fingerprints (exchange boundaries appear/disappear at the
        world==1 boundary), re-bucket per-node state through the mint
        at (rank, world), and merge connector scan states. Raises
        RuntimeError on any refusal; callers own the collectives /
        load_state application around it."""
        from pathway_tpu_torch.persistence import reshard as _reshard

        fingerprint = [node.name() for node in self.scope.nodes]
        snaps = _reshard.load_world_snapshots(
            self.persistence, tag, old_world
        )
        for _states, _subjects, fp in snaps:
            if fp != snaps[0][2]:
                raise RuntimeError(
                    "old ranks' snapshots disagree on the graph "
                    "shape — the cut is inconsistent"
                )
        mapping = _reshard.align_fingerprints(snaps[0][2], fingerprint)
        node_states = [
            _reshard.reshard_node_state(
                node,
                [snap[0][mapping[i]] for snap in snaps],
                rank, world,
            )
            if mapping[i] is not None
            else None
            for i, node in enumerate(self.scope.nodes)
        ]
        subject_states = _reshard.reshard_subject_states(
            [conn.name for conn in live], snaps,
            {conn.name: conn.subject for conn in live},
        )
        return node_states, subject_states

    def _restore_resharded(self, pg, live, tag: int, old_world: int) -> None:
        """Rescale restore: the committed cut was taken at a DIFFERENT
        world size. Every rank reads all ``old_world`` rank snapshots at
        the tag and rebuilds its own state by re-bucketing the union
        through the stable shard mint at the new world
        (persistence/reshard.py) — deterministic, so all new ranks
        derive one consistent partition with no extra coordination.
        All-or-nothing like the fixed-world path: any rank failing to
        load or re-bucket vetoes the restore for everyone."""
        problem = None
        try:
            node_states, subject_states = self._load_resharded_cut(
                tag, old_world, pg.rank, pg.world, live
            )
        except RuntimeError as exc:
            problem = str(exc)
        flags = pg.gather0(("snapok",), problem is None)
        do = pg.bcast0(
            ("snapok2",),
            all(flags) if pg.rank == 0 else None,
        )
        if not do:
            if problem is not None:
                raise RuntimeError(
                    f"rescale restore ({old_world}->{pg.world} ranks, "
                    f"tag {tag}) refused: {problem}"
                )
            raise RuntimeError(
                f"rescale restore ({old_world}->{pg.world} ranks, tag "
                f"{tag}) refused by a peer rank"
            )
        # index re-shard restores fold EVERY old rank's segment chains
        # and re-bucket through the keep set
        with self._index_cut(tag, rank=pg.rank, world=pg.world):
            for node, state in zip(self.scope.nodes, node_states):
                if state:
                    node.load_state(state)
        self._operator_subject_states.update(subject_states)
        for conn in live:
            self._restore_conn_state(conn, subject_states.get(conn.name))
        self.stats.on_mesh_epoch_committed(pg.epoch)
        if self.recorder is not None:
            self.recorder.note_mark(
                "epoch_restore", epoch=pg.epoch, tag=tag,
                resharded_from=old_world,
            )

    def _save_operator_snapshot_distributed(self, pg, round_no) -> None:
        """Two-phase consistent cut: every rank writes its rank-local
        snapshot tagged with the agreed round, rank 0 collects the acks
        and only then moves the commit marker — so the marker always
        names a tag for which every rank's snapshot exists durably."""
        tag = getattr(self, "_snap_tag_base", 0) + round_no
        # index delta segments ride this rank's cut: durable
        # before the ack, committed when rank 0 moves the marker
        with self._index_cut(tag, rank=pg.rank, world=pg.world):
            node_states = [node.state_dict() for node in self.scope.nodes]
        self.persistence.save_operator_snapshot(
            node_states,
            dict(self._operator_subject_states),
            [node.name() for node in self.scope.nodes],
            key=f"operator_snapshot/r{pg.rank}/{tag}",
        )
        # 2PC egress, phase 1: every rank freezes its staged sink set
        # under this cut's tag BEFORE acking — when the marker moves,
        # the egress it commits is already durable and immutable
        self._txn_precommit(tag)
        # kill slot: rank-local snapshot durable, commit marker not yet
        # moved — the cut must NOT count as committed, and recovery must
        # roll back to the previous marker tag (staged egress of this
        # cut is then discarded, never finalized)
        _faults.fault_point("mesh.rank_kill", phase="post_snapshot")
        pg.gather0(("snapack", tag), True)
        if pg.rank == 0:
            # the marker records the cut's WORLD SIZE next to its tag
            # (one atomic write): a later restore into a different world
            # detects the mismatch and takes the re-shard path
            self.persistence.write_marker(
                "snapshot_commit", (tag, pg.world)
            )
        pg.barrier(("snapbar", tag))
        # phase 2: the marker is durable and every rank knows it —
        # staged egress at-or-below the tag becomes externally visible
        # (a rank dying before its local finalize is healed by the
        # next recovery scan: sink_recover finalizes what the marker
        # covers)
        self._txn_finalize(tag)
        self.stats.on_mesh_epoch_committed(pg.epoch)
        # re-sample cross-rank clock offsets at every commit so long
        # traced runs don't drift out of alignment (per-segment offsets)
        self._trace_clock_resample(pg, tag)
        if self.recorder is not None:
            self.recorder.note_mark(
                "epoch_commit", epoch=pg.epoch, tag=tag
            )
        # prune superseded snapshots for this rank (best-effort), but
        # retain the LAST TWO committed tags: a peer crashing between its
        # restore-read of the marker and this prune must still find the
        # snapshot it was loading on the next rollback. Stale
        # higher-numbered tags stranded by earlier crashed runs are
        # reclaimed as a side effect (they are in no keep set).
        prev = getattr(self, "_snap_prev_tag", None)
        keep = {tag} if prev is None else {tag, prev}
        self.persistence.prune_operator_snapshots(
            f"operator_snapshot/r{pg.rank}/", keep
        )
        self._snap_prev_tag = tag

    def _run_streaming_distributed(self) -> None:
        """Round-based BSP ingest for PATHWAY_PROCESSES>1 (reference: the
        timely worker loop with exchange + progress channels,
        dataflow.rs:5595). Each round: every rank drains its local
        connector commits, the rank-0 clock master assigns each commit a
        globally ordered even timestamp (rank-major within the round),
        rows enter their home rank's source nodes, and `_step_lockstep`
        walks all ranks through the global frontier so ExchangeNodes
        shard-route rows at stateful boundaries."""
        from pathway_tpu_torch.io._connector import run_connector_thread

        pg = self.procgroup
        self._start_monitoring(printer=pg.rank == 0)
        # arm BEFORE static injection (rows it stages live in the
        # current incarnation's open staging, surviving the recovery
        # scan); the arm decision is lowering-deterministic, so every
        # rank takes the same 2PC collective windows
        self._arm_txn_sinks(
            self.persistence is not None
            and self.persistence.mode == "OPERATOR_PERSISTING"
        )

        # program-embedded static rows are identical in every process:
        # rank 0 injects them once, exchanges shard the work; every rank
        # adopts rank 0's clock so locally minted times stay ordered
        if pg.rank == 0:
            self._inject_static()
        self.clock = pg.bcast0(("clk",), self.clock)
        self._trace_clock_sync(pg)
        self._step_lockstep(None)

        # a source reads on exactly one rank unless it declares itself
        # partition-aware (fs scanners shard paths; subjects can read
        # pathway_config.process_id) — reference: per-worker partitioned
        # reads, data_storage.rs:692
        live: list[_Connector] = []
        for conn in self.connectors:
            partitioned = getattr(
                conn.subject, "_distributed_partitioned", False
            ) and not self._lane_emulated
            if pg.rank != 0 and not partitioned:
                conn.finished = True
                continue
            live.append(conn)

        operator_mode = (
            self.persistence is not None
            and self.persistence.mode == "OPERATOR_PERSISTING"
        )
        if self.persistence is not None:
            # restore/replay window: not yet serving traffic
            self.stats.set_health_state("recovering")
        if operator_mode:
            self._restore_operator_snapshot_distributed(pg, live)
        elif self.persistence is not None:
            self._replay_journals_distributed(pg, live)
        self.stats.set_health_state("serving")

        for conn in live:
            self._arm_watchdog(conn)
            # copy the creating thread's context so per-thread config
            # overlays (emulated-rank CI lane) reach the subject's thread.
            # In the emulated lane every source reads on rank 0 only
            # (subjects are shared objects) — the subject must therefore
            # see a world of 1 or path-sharding scanners would silently
            # skip the shards belonging to ranks whose subjects never run.
            import contextvars as _cv

            if self._lane_emulated:
                from pathway_tpu_torch.internals.config import (
                    pop_config_overlay,
                    push_config_overlay,
                )

                tok = push_config_overlay(processes=1, process_id=0)
                try:
                    _ctx = _cv.copy_context()
                finally:
                    pop_config_overlay(tok)
            else:
                _ctx = _cv.copy_context()
            conn.thread = threading.Thread(
                target=_ctx.run,
                args=(run_connector_thread, conn, self.event_queue),
                daemon=True,
            )
            conn.thread.start()

        active = len(live)
        round_no = 0
        while True:
            round_no += 1
            self._bsp_round_no = round_no
            self._cadence_flush(live)
            # once every LOCAL connector has finished, this rank only
            # relays peers' rounds — the long drain pause would charge
            # 0.2s of pure idle to the round that concludes the run
            # (and to every shutdown-lagging rank), so drop to a short
            # poll while waiting for global alldone
            entries = self._drain_event_queue(0.2 if active else 0.02)
            self._service_connector_health(live)
            commits = []
            saw_data = False
            for conn, deltas, state, journal_rows in entries:
                if deltas is None:
                    conn.finished = True
                    self.stats.on_connector_finished(conn.name)
                    active -= 1
                    self._release_uncovered(conn)
                    continue
                if (
                    self.persistence is not None
                    and not operator_mode
                    and journal_rows
                ):
                    # write-ahead, rank-local journal (same consistency
                    # contract as the single-process path: stateless
                    # subjects journal every flush; stateful subjects at
                    # their own commit boundaries with a claiming state)
                    self.persistence.journal_batch(
                        self._pname(conn.name), self.clock, journal_rows,
                        state,
                    )
                if state is not None:
                    self._operator_subject_states[conn.name] = state
                    self._uncovered.discard(conn.name)
                elif (
                    deltas
                    and self.persistence is not None
                    and hasattr(conn.subject, "snapshot_state")
                ):
                    self._uncovered.add(conn.name)
                if deltas:
                    saw_data = True
                    self._account_drain(conn, deltas)
                    commits.append((conn, deltas))
            alldone = self._bsp_inject_commits(
                pg, commits, active == 0, ("r", round_no)
            )
            if operator_mode:
                # lockstep snapshot decision: a cut is taken only when
                # EVERY rank is ready (interval elapsed on the rank-0
                # pacer, no rank has uncovered stateful rows) and some
                # rank saw data since the last cut
                now = _time.monotonic()
                ready = not self._uncovered
                flags = pg.gather0(
                    ("snapq", round_no), (ready, saw_data)
                )
                if pg.rank == 0:
                    do = (
                        all(r for r, _ in flags)
                        and any(d for _, d in flags)
                        and (now - self._last_snapshot) * 1000.0
                        >= self.persistence.snapshot_interval_ms
                    )
                else:
                    do = None
                do = pg.bcast0(("snapq2", round_no), do)
                if do:
                    self._last_snapshot = now
                    self._save_operator_snapshot_distributed(pg, round_no)
            if self.error and self.terminate_on_error:
                raise self.error
            if alldone:
                break
        # late notices (final flush failures, demotions) still deserve
        # error-log rows before the graph closes
        self._service_connector_health(live)
        self._step_lockstep(None)
        for conn in live:
            if conn.thread is not None:
                conn.thread.join(timeout=5)
        self._finish()

    # -- connector supervision (io/_connector.py) --------------------------
    # Thread half: supervisor threads report through these (thread-safe,
    # queue-only — never engine state). Main-loop half: _service_connector_
    # health drains the notices into monitoring counters + the error-log
    # table and runs the stall watchdog.

    def report_connector_error(self, conn, exc: Exception) -> None:
        """Single door for a permanently-failed connector thread. With
        terminate_on_error the main loop raises `exc` on its next pass;
        otherwise the connector demotes to finished (its thread emits the
        finish sentinel) and the failure becomes an error-log row."""
        self._connector_notices.put(
            (
                "error",
                getattr(conn, "name", "?"),
                f"connector failed permanently: {exc!r}",
            )
        )
        if self.terminate_on_error:
            self.error = exc

    def report_connector_restart(self, conn, exc: Exception, attempt: int) -> None:
        self._connector_notices.put(
            (
                "restart",
                getattr(conn, "name", "?"),
                f"connector restart {attempt} after: {exc!r}",
            )
        )

    def report_connector_degraded(self, name: str, message: str) -> None:
        """At-least-once degradations (e.g. the _BACKLOG_CAP overflow) —
        a counter plus one error-log row, visible to headless runs."""
        self._connector_notices.put(("degraded", name, message))

    def _cadence_flush(self, conns) -> None:
        """force_flush live connectors, tolerating transient flush faults
        (rows stay pending) but refusing to livelock on a deterministic
        failure: a non-retryable exception (parse poison) or a run of
        consecutive failures aborts under terminate_on_error; otherwise
        the cadence flush is muted for that connector — its rows wait for
        the subject's next commit, which hits the same poison on the
        subject thread and demotes the connector for real (finish
        sentinel and all)."""
        for conn in conns:
            if conn.finished or conn._flush_dead:
                continue
            try:
                conn.force_flush()
                conn._flush_failures = 0
            except Exception as exc:
                from pathway_tpu_torch.io._connector import SupervisorPolicy

                conn._flush_failures += 1
                # same classification the subject-thread supervisor uses,
                # honoring the connector's retry_on override; a raising
                # user callback must not escape the main loop
                try:
                    retryable = SupervisorPolicy.for_connector(
                        conn
                    ).retryable(exc)
                except Exception as cls_exc:
                    # a broken user classifier must neither escape the
                    # main loop nor silently turn failure #1 fatal
                    from pathway_tpu_torch.udfs.retries import is_retryable

                    retryable = is_retryable(exc)
                    self.report_connector_degraded(
                        conn.name,
                        f"retry_on classifier raised {cls_exc!r}; "
                        "fell back to default classification",
                    )
                fatal = (
                    getattr(exc, "pw_parse_poison", False)
                    or not retryable
                    or conn._flush_failures >= 5
                )
                if fatal:
                    conn._flush_dead = True
                    if self.terminate_on_error:
                        self.report_connector_error(conn, exc)
                    else:
                        self.report_connector_degraded(
                            conn.name,
                            "cadence flush disabled after "
                            f"{conn._flush_failures} failures: {exc!r}; "
                            "rows pend until the subject's next commit",
                        )
                elif conn._flush_failures == 1:
                    # once per failure episode (the counter resets on
                    # success), not per ~0.5s retry — a 30s transient
                    # outage must not inflate the counter/error log 60x
                    self.report_connector_degraded(
                        conn.name, f"flush deferred: {exc!r}"
                    )

    def _service_connector_health(self, conns) -> None:
        while True:
            try:
                kind, name, msg = self._connector_notices.get_nowait()
            except queue.Empty:
                break
            if kind == "restart":
                self.stats.on_connector_restart(name)
            elif kind == "degraded":
                self.stats.on_connector_degraded(name)
            else:  # "error"; the watchdog reports stalls directly below
                self.stats.on_connector_error(name)
            self.log_data_error(f"[connector-{kind}] {msg}", key=name)
        # watchdog: a subject that stopped emitting/flushing within its
        # declared heartbeat window is stalled, not crashed — flag it once
        # per episode (it may be blocked on a dead upstream forever)
        now = _time.monotonic()
        for conn in conns:
            timeout = conn.watchdog_timeout
            if timeout is None or conn.finished:
                continue
            if conn.paused:
                # a deliberately paced subject is parked in emit() by the
                # governor, not stalled — REFRESH the heartbeat rather
                # than merely skipping the check, or the idle seconds
                # accumulated while paced would trip the watchdog the
                # instant the source resumes
                conn.last_activity = now
                continue
            idle = now - conn.last_activity
            if idle > timeout:
                if not conn._stalled:
                    conn._stalled = True
                    conn._stall_episodes += 1
                    self.stats.on_connector_stall(conn.name)
                    # episode number keeps repeat stalls distinct past
                    # log_data_error's (key, message) dedupe memo
                    self.log_data_error(
                        f"[connector-stall] no progress from {conn.name} "
                        f"within watchdog window ({timeout}s), episode "
                        f"{conn._stall_episodes}",
                        key=conn.name,
                    )
            else:
                conn._stalled = False
        self._service_memory(conns)

    # -- memory governance / backpressure -----------------------
    # internals/memory.py holds the accountant; parallel/protocol.py the
    # pure ladder + pacing transitions; analysis/meshcheck.py check_pacing
    # proves the pause/resume loop below can never deadlock against the
    # drain that unpauses it.

    def _account_drain(self, conn, deltas) -> None:
        """Main-loop side of the backlog counter pair: the batch left the
        engine queue and entered the graph. Estimated from the SAME batch
        object the subject thread accounted at put time, so the put/drain
        difference is an exact queue-depth signal."""
        if self.memory is None or not self.memory.enabled:
            return
        from pathway_tpu_torch.io._connector import _batch_nbytes

        conn.rows_drained += len(deltas)
        conn.bytes_drained += _batch_nbytes(deltas)

    def _probe_state_bytes(self) -> None:
        """Slow-cadence (~2s) byte probes: native store walks (GIL-free
        C traversals, but O(state)), capture staging and txn heaps. The
        cheap per-pass signals (backlog counters, exchange queue depths)
        are read every health pass instead."""
        from pathway_tpu_torch.engine.nodes import CaptureNode

        store = 0
        cap = 0
        for node in self.scope.nodes:
            ex = getattr(node, "_exec", None)
            if ex is not None:
                st = getattr(node, "_store", None)
                if st is not None:
                    try:
                        store += ex.store_nbytes(st)
                    except Exception:
                        pass
                jst = getattr(node, "_jstore", None)
                if jst is not None:
                    try:
                        store += ex.join_store_nbytes(jst)
                    except Exception:
                        pass
            if isinstance(node, CaptureNode) and node._pending:
                # columnar chunks buffered C-owned; flat per-row estimate
                # (rows * 64) — exact expansion would defeat the point of
                # deferring it
                for chunk in node._pending:
                    try:
                        cap += len(chunk[0]) * 64
                    except Exception:
                        cap += 1024
        txn = 0
        for sink in self.scope.txn_sinks:
            try:
                txn += sink.heap_nbytes()
            except Exception:
                pass
        acct = self.memory
        acct.set_component("store", store)
        acct.set_component("capture_pending", cap)
        acct.set_component("txn_staging", txn)

    def _service_memory(self, conns) -> None:
        """One governance cadence: refresh component bytes, take an
        accounting sample (the ``mem.pressure`` fault point), publish the
        gauges, and drive each pausable connector's gate through the
        BOUND pace transitions. Engine-drainable by construction: the
        pacing signal is the put/drain counter difference, which the main
        loop shrinks without the paused subject thread advancing."""
        acct = self.memory
        if acct is None or not acct.enabled:
            return
        backlog_bytes = 0
        backlog_rows_total = 0
        for conn in self.connectors:
            backlog_bytes += max(0, conn.bytes_put - conn.bytes_drained)
            backlog_rows_total += max(0, conn.rows_put - conn.rows_drained)
        acct.set_component("connector_backlog", backlog_bytes)
        pg = self._procgroup
        if pg is not None:
            try:
                send_b, recv_b = pg.queued_exchange_bytes()
                acct.set_component("exchange_send", send_b)
                acct.set_component("exchange_recv", recv_b)
            except Exception:
                pass
        now = _time.monotonic()
        if now - self._mem_store_probe_t >= 2.0:
            self._mem_store_probe_t = now
            self._probe_state_bytes()
        state = acct.sample()
        self.stats.set_mem_pressure(
            state,
            acct.total_bytes,
            acct.peak_bytes,
            acct.budget_bytes,
            acct.components(),
            acct.pressure_injections,
        )
        for conn in conns:
            if not conn.pausable:
                continue
            if conn.finished:
                if conn.paused:
                    # the source completed while paced (its final rows
                    # were already queued before the gate cleared) —
                    # close the episode so the gauges read honest
                    conn.paused = False
                    conn.pace_gate.set()
                    since = conn._paused_since
                    seconds = (
                        0.0 if since is None else max(0.0, now - since)
                    )
                    conn._paused_since = None
                    conn.paused_seconds += seconds
                    self.stats.on_connector_resumed(conn.name, seconds)
                continue
            qrows = max(0, conn.rows_put - conn.rows_drained)
            if not conn.paused:
                if acct._pace_decide(state, qrows, 0):
                    conn.paused = True
                    conn._paused_since = now
                    conn.pace_gate.clear()
                    self.stats.on_connector_paused(conn.name)
            else:
                # charge the elapsed slice every pass so the
                # paused-seconds counter moves WHILE the episode is open
                since = conn._paused_since
                seconds = 0.0 if since is None else max(0.0, now - since)
                conn._paused_since = now
                conn.paused_seconds += seconds
                if acct._pace_resume(state, qrows, 0):
                    conn.paused = False
                    conn.pace_gate.set()
                    conn._paused_since = None
                    self.stats.on_connector_resumed(conn.name, seconds)
                else:
                    self.stats.on_connector_paced(conn.name, seconds)
        if state == "abort" and not self._mem_abort_reported:
            # the ladder's last rung: an epoch abort through the standard
            # engine-error path (distributed ranks die and the mesh
            # recovery machinery rolls back to the last committed cut).
            # Paced readers are released first so their daemon threads
            # don't spin on a gate nobody will ever open again.
            self._mem_abort_reported = True
            for conn in self.connectors:
                conn.pace_gate.set()
            self.report_error(
                RuntimeError(
                    "memory budget exhausted: accounted bytes "
                    f"({acct.total_bytes}) held at/above the budget "
                    f"({acct.budget_bytes}) for {acct.over_streak} "
                    "consecutive samples with ingest already paced and "
                    "serving browned out — aborting the epoch "
                    "(PATHWAY_MEM_BUDGET_MB)"
                )
            )

    def _release_uncovered(self, conn) -> None:
        """A finishing connector must not block operator snapshots for
        the pipeline's remaining lifetime. Clean finishers publish a
        claiming state right before the sentinel, so this is a no-op for
        them; a demoted (failed) connector's unclaimed tail weakens its
        own recovery to at-least-once — surfaced, not silently lost."""
        if conn.name in self._uncovered:
            self._uncovered.discard(conn.name)
            self.report_connector_degraded(
                conn.name,
                "connector finished with rows not claimed by its last "
                "scan state; an operator-snapshot restore may replay "
                "them (at-least-once)",
            )

    @staticmethod
    def _restore_conn_state(conn, state) -> None:
        """Remember the restored scan state (the supervisor's rollback
        target until the subject publishes a fresher one) and seek."""
        if state is None:
            return
        conn.restored_state = state
        if hasattr(conn.subject, "seek"):
            conn.subject.seek(state)

    def _arm_watchdog(self, conn) -> None:
        pol = getattr(conn.subject, "_supervisor_policy", None)
        timeout = getattr(pol, "heartbeat_timeout_s", None)
        if timeout is None:
            timeout = getattr(conn.subject, "_watchdog_timeout_s", None)
        conn.watchdog_timeout = timeout
        conn.last_activity = _time.monotonic()

    def report_error(self, exc: Exception) -> None:
        if self.terminate_on_error:
            raise exc
        self.error = exc

    def log_data_error(self, message: str, key=None) -> None:
        if self.error_log_node is None:
            return
        # one entry per (row, message): retraction replays and upsert
        # re-evaluations re-raise the same exception and must not grow the
        # log unboundedly (bounded memo, drop-dedupe past the cap)
        ident = (key, message)
        if ident in self._error_log_seen:
            return
        if len(self._error_log_seen) < 100_000:
            self._error_log_seen.add(ident)
        from pathway_tpu_torch.internals.api import ref_scalar
        from pathway_tpu_torch.internals.config import get_pathway_config

        self._error_log_seq += 1
        # rank-qualified key: every rank mints seq 1, 2, ... — without the
        # rank the gathered entries collide and overwrite each other
        row_key = ref_scalar(
            "error_log", get_pathway_config().process_id,
            self._error_log_seq,
        )
        deltas = [(row_key, (message, repr(key)), 1)]
        # deliver at the next timestamp so the erroring batch finishes first
        t = self.clock + 1
        self.error_log_node.accept(t, 0, deltas)
