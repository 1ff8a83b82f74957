"""Connector thread driver (reference: src/connectors/mod.rs:91 Connector —
per-source thread reading into an mpsc channel drained by the main loop).

Queue protocol: each entry is ``(conn, deltas, state, journal_rows)``.
``deltas`` are the rows the engine should accept this cycle (None = source
finished). ``journal_rows`` are the rows persistence should append to the
input journal with this entry, and ``state`` the subject scan state to save
alongside. For stateful (rescannable) subjects these are only populated at
subject-driven commit boundaries, where the subject's bookkeeping is up to
date on its own thread — so the saved state claims exactly the journaled
prefix. Mid-scan timer flushes forward rows for latency but defer journaling
to the next boundary; a crash in between is recovered by rescan from the
last consistent state (same stable keys), never by double-replay.
Stateless subjects (no ``snapshot_state``) cannot rescan, so their rows are
journaled write-ahead at every flush, exactly as before.

Supervision: ``run_connector_thread`` wraps the subject in a supervisor
loop. Failures escaping ``subject.run()`` (including faults injected via
internals/faults.py) are classified by the connector's
:class:`SupervisorPolicy` — retryable ones restart the subject in place
under an exponential-backoff budget with per-connector seeded jitter:

* rescannable subjects (``snapshot_state``/``seek``) roll back to the
  last scan state published on the queue (or the state the runtime
  restored at startup). Pure-upsert subjects (``parser.is_upsert``:
  primary-keyed with deletions disabled) simply rescan — re-emitted
  primary keys retract their previous rows, so the net effect is
  exactly-once. Non-pk subjects first retract the rows they forwarded
  beyond that state (the batch-granular backlog ledger) and then rescan
  with the same stable keys, which is also net exactly-once. pk subjects
  that may see removes are rescan-unsafe both ways and restart as
  continuations. If the backlog overflowed ``_BACKLOG_CAP``, recovery
  for that span degrades to at-least-once (reported through the
  runtime).
* stateless subjects just re-run; whether re-reads duplicate is up to the
  subject (documented at-least-once). Because that is not provably
  duplicate-free, non-rescannable non-upsert subjects are NOT restarted
  by the default policy — they fail fast exactly as before unless an
  explicit ``_supervisor_policy`` opts them in.

A permanently-failed connector (budget exhausted or classified fatal)
routes its failure through ``runtime.report_connector_error()``: the
pipeline aborts when ``terminate_on_error`` is set, otherwise the
connector demotes to finished and the failure lands in the global
error-log table. The runtime's watchdog (``_watchdog_timeout_s`` on the
subject or ``heartbeat_timeout_s`` on the policy) detects stalled — not
crashed — subjects from the heartbeat every emit/flush refreshes.

Mesh rollback interplay (engine/runtime.py supervised abort path): when
a multi-rank run detects a peer crash and this rank exits to request a
rollback restart, subjects are NOT rewound in place — they are arbitrary
user code blocked in ``run()``. Instead the whole rank set restarts at
the next mesh epoch and the normal startup restore path seeks every
subject to the scan state saved in the last committed distributed
snapshot (exactly the rollback target the in-place restart uses).
:func:`close_subjects_for_rollback` gives subjects holding external
resources (consumers, file locks) one bounded ``on_stop()`` chance
before the process exits — a courtesy a hard crash does not extend.
"""

from __future__ import annotations

import os
import queue
import random
import threading
import time as _time
import zlib
from typing import Any, Callable

from pathway_tpu_torch.internals import faults as _faults

# uncommitted-row backlog above which a stateful subject's rows are
# journaled without a scan state (degrading recovery to at-least-once)
# rather than growing host memory without bound. With memory governance
# enabled (PATHWAY_MEM_BUDGET_MB; internals/memory.py) a PAUSABLE
# subject never reaches this degradation: the runtime's pacing pass
# stops the reader at the byte watermarks first, so the cap
# only fires for non-pausable subjects — and is error-logged + counted
# when it does.
_BACKLOG_CAP = 1_000_000


def _governed() -> bool:
    """Whether the memory-governance ladder is active for this runtime
    (an accountant is installed AND a budget is configured)."""
    from pathway_tpu_torch.internals import memory as _memory

    acct = _memory.current()
    return acct is not None and acct.enabled


def _batch_nbytes(batch) -> int:
    """Cheap byte estimate for one forwarded batch: sample a few rows
    (``internals/memory.py approx_nbytes``) and extrapolate — the
    accountant steps watermarks off this, it does not bill."""
    from pathway_tpu_torch.internals import memory as _memory

    try:
        n = len(batch)
    except TypeError:
        return 1024
    if n == 0:
        return 0
    sampled = 0
    taken = 0
    for row in batch:
        sampled += _memory.approx_nbytes(row)
        taken += 1
        if taken >= 8:
            break
    return (sampled // max(1, taken)) * n


class SupervisorPolicy:
    """Restart policy for a supervised connector thread.

    ``max_restarts=0`` disables in-place restart entirely (every failure
    is immediately permanent). ``retry_on`` classifies exceptions — False
    fails fast; the default honors an exception's ``retryable`` attribute
    (True when absent). ``backoff`` is a sync
    :class:`~pathway_tpu_torch.udfs.retries.RetryPolicy`; when omitted, one is
    built from ``PATHWAY_CONNECTOR_BACKOFF_MS`` (default 500) with jitter
    seeded per connector name so restart schedules replay
    deterministically. ``heartbeat_timeout_s`` arms the runtime watchdog.
    Attach to a subject as ``subject._supervisor_policy``; the default
    budget comes from ``PATHWAY_CONNECTOR_MAX_RESTARTS`` (default 3).
    """

    def __init__(
        self,
        max_restarts: int | None = None,
        backoff=None,
        retry_on: Callable[[Exception], bool] | None = None,
        heartbeat_timeout_s: float | None = None,
    ):
        if max_restarts is None:
            max_restarts = int(
                os.environ.get("PATHWAY_CONNECTOR_MAX_RESTARTS", "3") or 3
            )
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.retry_on = retry_on
        self.heartbeat_timeout_s = heartbeat_timeout_s

    @classmethod
    def for_connector(cls, conn) -> "SupervisorPolicy":
        pol = getattr(conn.subject, "_supervisor_policy", None)
        return pol if pol is not None else cls()

    def retryable(self, exc: Exception) -> bool:
        from pathway_tpu_torch.udfs.retries import is_retryable

        return is_retryable(exc, self.retry_on)

    def resolved_backoff(self, name: str):
        if self.backoff is not None:
            return self.backoff
        from pathway_tpu_torch.udfs.retries import RetryPolicy

        base = float(os.environ.get("PATHWAY_CONNECTOR_BACKOFF_MS", "500") or 500)
        return RetryPolicy(
            max_retries=self.max_restarts,
            initial_delay_ms=base,
            backoff_factor=2.0,
            jitter_ms=base * 0.25,
            max_delay_ms=30_000,
            rng=random.Random(zlib.crc32(name.encode("utf-8", "replace"))),
        )


def _runtime_of(conn):
    runtime = getattr(getattr(conn, "node", None), "scope", None)
    return getattr(runtime, "runtime", None)


def close_subjects_for_rollback(conns, deadline_s: float = 1.0) -> None:
    """Best-effort ``subject.on_stop()`` fan-out before a mesh rollback
    exit. Each on_stop runs on its own daemon thread (a subject wedged in
    teardown must not stall the rollback) and the TOTAL wait is bounded
    by ``deadline_s`` — stragglers are simply abandoned to the process
    exit, exactly as a hard crash would."""
    threads: list[threading.Thread] = []
    for conn in conns:
        on_stop = getattr(getattr(conn, "subject", None), "on_stop", None)
        if on_stop is None or getattr(conn, "finished", False):
            continue

        def _stop(fn=on_stop):
            try:
                fn()
            except Exception:
                pass  # the rank is exiting; failures here are moot

        t = threading.Thread(target=_stop, daemon=True)
        t.start()
        threads.append(t)
    deadline = _time.monotonic() + deadline_s
    for t in threads:
        t.join(max(0.0, deadline - _time.monotonic()))


def abort_sinks_for_rollback(sinks, deadline_s: float = 1.0) -> None:
    """Best-effort ``TransactionalSink.abort_for_rollback()`` fan-out
    before a mesh rollback exit — the egress sibling of
    :func:`close_subjects_for_rollback`: the dying epoch's
    un-pre-committed staged output is discarded. Recovery would discard
    it anyway (no committed cut claims it); doing it here reclaims the
    disk early and makes the abort observable on
    ``sink_aborted_total``. Same bounded-daemon-thread contract: a sink
    wedged in teardown must not stall the rollback."""
    threads: list[threading.Thread] = []
    for sink in sinks:
        abort = getattr(sink, "abort_for_rollback", None)
        if abort is None:
            continue

        def _abort(fn=abort):
            try:
                fn()
            except Exception:
                pass  # the rank is exiting; failures here are moot

        t = threading.Thread(target=_abort, daemon=True)
        t.start()
        threads.append(t)
    deadline = _time.monotonic() + deadline_s
    for t in threads:
        t.join(max(0.0, deadline - _time.monotonic()))


def _report_permanent(conn, failure: Exception) -> None:
    """Record a permanent connector failure and route it to the runtime
    (single door shared by the supervisor epilogue and the last-resort
    BaseException shell)."""
    conn.failure = failure
    report = getattr(_runtime_of(conn), "report_connector_error", None)
    if report is not None:
        report(conn, failure)


def run_connector_thread(conn, out_queue: "queue.Queue") -> None:
    """Thin shell around the supervised driver: whatever happens — even a
    failure in the supervisor prologue itself — the finish sentinel MUST
    reach the queue, or the main loop waits on this connector forever."""
    try:
        _run_supervised(conn, out_queue)
    except BaseException as exc:
        if getattr(conn, "failure", None) is None:
            _report_permanent(
                conn,
                exc
                if isinstance(exc, Exception)
                # SystemExit/KeyboardInterrupt on a connector thread is
                # still truncated input — record it, then let it propagate
                else RuntimeError(f"connector thread aborted: {exc!r}"),
            )
        if not isinstance(exc, Exception):
            raise
    finally:
        out_queue.put((conn, None, None, []))


def _stamp(conn) -> None:
    """Event-time lag watermark, connector half: stamp ingest time once
    per forwarded queue entry (perf_counter_ns, the engine's trace
    timebase). The runtime pops stamps FIFO as it drains entries and
    keys commit→emit freshness off them (engine/runtime.py
    ``_note_ingest``/``note_output_emit``); appends are GIL-atomic, so
    the subject thread needs no lock."""
    q = getattr(conn, "_ingest_ns", None)
    if q is None:
        import collections

        q = conn._ingest_ns = collections.deque()
    q.append(_time.perf_counter_ns())


def _run_supervised(conn, out_queue: "queue.Queue") -> None:
    subject = conn.subject
    parser = conn.parser
    # parse_batch defers per-message parsing to flush time so runs of
    # simple upserts go through one C call instead of a Python closure per
    # row (io/python.py attaches it; other parsers fall back to a loop)
    parse_batch = getattr(parser, "parse_batch", None)
    if parse_batch is None:

        def parse_batch(msgs):
            out: list = []
            for m in msgs:
                out.extend(parser(m))
            return out

    from pathway_tpu_torch.engine.stream import is_native_batch

    policy = SupervisorPolicy.for_connector(conn)
    conn_name = getattr(conn, "name", "?")
    pending: list = []  # raw messages, parsed at flush under `lock`
    # batches forwarded to the engine but not yet covered by a journal
    # entry (stateful subjects only); doubles as the restart-compensation
    # ledger. Holds whole batches; backlog_rows counts their rows.
    unjournaled: list = []
    backlog_rows = 0
    lock = threading.Lock()
    has_state = hasattr(subject, "snapshot_state")
    can_seek = has_state and hasattr(subject, "seek")
    runtime = _runtime_of(conn)
    # _ephemeral subjects (the REST serving gateway) opt out of input
    # journaling entirely: their rows are live requests whose futures the
    # serving frontend owns — replaying a dead epoch's journaled queries
    # at epoch+1 would double-dispatch the requests the frontend is
    # already replaying
    persisting = (
        getattr(runtime, "persistence", None) is not None
        and not getattr(subject, "_ephemeral", False)
    )
    # pure-upsert parsers (primary-keyed, deletions disabled) make rescans
    # idempotent at the engine: re-inserting a live key retracts the
    # previous row, so restart needs no compensation ledger. pk parsers
    # that may also see removes are rescan-UNSAFE both ways (a re-scanned
    # remove retracts twice; ledger negation fights the session dict), so
    # they restart as continuations only.
    is_pk = getattr(parser, "is_pk", False)
    is_upsert = getattr(parser, "is_upsert", False)
    rescan_safe = can_seek and (is_upsert or not is_pk)
    # default supervision restarts only subjects whose restart is provably
    # duplicate-free (rescannable with compensation, or upsert-idempotent);
    # anything else re-running from scratch would push duplicate rows into
    # live outputs, so it must opt in with an explicit policy
    supervised = policy.max_restarts > 0 and (
        getattr(subject, "_supervisor_policy", None) is not None
        or rescan_safe
    )
    # heartbeats exist for the runtime watchdog only: skip the per-row
    # monotonic()+store on the emit hot path when nobody is watching
    watching = (
        getattr(conn, "watchdog_timeout", None) is not None
        or policy.heartbeat_timeout_s is not None
    )
    # -- source pacing -----------------------------------------
    # Pausable subjects stop READING under memory pressure instead of
    # degrading journal guarantees: the runtime's pacing pass
    # (engine/runtime.py _service_connector_health) clears/sets the gate
    # off the pure protocol transitions pace_decide/pace_resume, and
    # emit() blocks on it BEFORE queueing the row. The REST gateway's
    # _ephemeral subject is never paused (its rows are live requests the
    # serving frontend already governs with admission + Retry-After);
    # subjects may opt out explicitly with ``_pausable = False``.
    pausable = not getattr(subject, "_ephemeral", False) and getattr(
        subject, "_pausable", True
    )
    conn.pausable = pausable
    gate = getattr(conn, "pace_gate", None)
    if gate is None:
        gate = conn.pace_gate = threading.Event()
        gate.set()  # running; the pacing pass clears it to pause
    governed = _governed()
    # put-side self-pacing: the engine's pacing pass runs once per loop
    # iteration, and one iteration can step for seconds — an unthrottled
    # in-process source could queue tens of MB between two verdicts. So
    # the SUBJECT thread also consults the same bound transitions on its
    # own emit path: once its queued-but-undrained bytes cross the high
    # watermark it parks until the main loop drains back under the low
    # one (the transitions compare magnitudes and are unit-agnostic —
    # bytes here, rows in the engine pass). Same deadlock-freedom
    # argument: the signal shrinks on the main loop only.
    _acct = None
    if governed and pausable:
        from pathway_tpu_torch.internals import memory as _memory

        _acct = _memory.current()

    def account_put(batch) -> None:
        # ENGINE-DRAINABLE backlog accounting (the pacing signal): rows/
        # bytes put on the out queue, matched by rows/bytes_drained on
        # the runtime side as the main loop accepts the entries. Two
        # monotonic single-writer counters per axis — no lock, no race —
        # and both sides estimate from the SAME batch object, so the
        # difference is exactly the queued entries. The journal ledger
        # is deliberately NOT a pacing input: it only drains at subject
        # commit boundaries, and a paused subject can never reach one —
        # pacing on it would be the self-deadlock check_pacing rules out.
        if governed and batch:
            conn.rows_put = getattr(conn, "rows_put", 0) + len(batch)
            conn.bytes_put = (
                getattr(conn, "bytes_put", 0) + _batch_nbytes(batch)
            )

    # track the forwarded-but-unclaimed backlog whenever anyone needs it:
    # persistence (journal it at the next boundary) or the supervisor
    # (negate it before a non-upsert rescan). Kept at BATCH granularity —
    # columnar NativeBatches stay columnar until a boundary journals them
    # or a restart actually needs compensation rows.
    track_backlog = has_state and (
        persisting or (supervised and rescan_safe and not is_upsert)
    )
    warned_backlog = False
    forwarded_since_boundary = 0
    # commit boundaries published so far; the supervisor uses it to reset
    # the restart budget once a restarted subject proves recovery by
    # reaching a new boundary
    boundary_seq = 0
    # the scan state restart rolls back to: the subject's own pre-run
    # position (captured before any row is forwarded, so a failure before
    # the first commit boundary still rescans exactly), refreshed by
    # every published commit state
    last_published_state = getattr(conn, "restored_state", None)
    if can_seek and last_published_state is None:
        try:
            last_published_state = subject.snapshot_state()
        except Exception as exc:
            # restart degrades to continuation for this subject: surface
            # it — the exactly-once rescan guarantee is weakened
            last_published_state = None
            report = getattr(runtime, "report_connector_degraded", None)
            if report is not None:
                report(
                    conn_name,
                    "initial snapshot_state() failed; restarts degrade "
                    f"to at-least-once continuation: {exc!r}",
                )
    # timer-based autocommit (reference: commit_duration cadence in the
    # worker poller, connectors/mod.rs): rows accumulate into one commit
    # until `autocommit_duration_ms` elapses or the subject commits
    # explicitly — this is what gives downstream batched UDFs whole
    # logical-time batches instead of row-at-a-time dribbles. The runtime's
    # main loop calls `conn.force_flush` on its own cadence so rows are not
    # stranded while the subject blocks waiting for input.
    duration_ms = getattr(subject, "_autocommit_duration_ms", None)
    last_flush = _time.monotonic()
    # hot-path fault hook, resolved once per thread (plans are installed
    # before the run starts); None keeps emit() at zero overhead
    _fp = _faults.fault_point if _faults.active_plan() is not None else None

    def heartbeat() -> None:
        if watching:
            conn.last_activity = _time.monotonic()

    def rows_of(batch):
        """Materialized (key, row, diff) view of a parsed batch — the
        journal and the restart compensation need real tuples (a columnar
        NativeBatch carries no picklable rows)."""
        return list(batch) if is_native_batch(batch) else batch

    def jrows_of(batch):
        """Journal view: empty when nothing journals (no persistence
        configured); the engine always receives the batch itself."""
        return rows_of(batch) if persisting else []

    def ledger_rows():
        """Flatten the batch-granular ledger into rows (only called at a
        journaling boundary or an actual restart — steady-state flushes
        never materialize columnar batches)."""
        return [row for b in unjournaled for row in rows_of(b)]

    def take_batch() -> list:
        """Parse and claim the currently queued messages. Caller holds
        `lock`. Appends from the subject thread are GIL-atomic, so the
        snapshot + del-prefix pair never drops a message that lands
        mid-flush — it simply stays queued for the next flush."""
        msgs = pending[:]
        if not msgs:
            return []
        del pending[: len(msgs)]
        try:
            return parse_batch(msgs)
        except Exception as exc:
            # a failing flush must not drop the claimed messages: restore
            # them (prepend — later emits kept appending). But a parse
            # failure is deterministic data poison AND may have half-
            # applied stateful parser sessions (pk live_rows) — a rescan
            # would emit retractions for rows the engine never received —
            # so classify it non-retryable: fail fast, never restart.
            pending[:0] = msgs
            try:
                exc.retryable = False
                # hard marker the supervisor honors even when a user
                # retry_on says "retry everything": rescanning after a
                # half-applied parser session corrupts multiplicities
                exc.pw_parse_poison = True
            except Exception:
                pass
            raise

    def timer_flush() -> None:
        nonlocal last_flush, warned_backlog, forwarded_since_boundary
        nonlocal backlog_rows
        # resolved dynamically (flushes are not per-row hot) so plans
        # installed mid-run still cover this point
        _faults.fault_point("connector.flush")  # pre-take_batch: loses nothing
        last_flush = _time.monotonic()
        with lock:
            batch = take_batch()
            if not batch:
                return
            # heartbeat only on real progress: the runtime's wall-clock
            # force_flush cadence would otherwise refresh last_activity
            # for a dead-blocked subject and defeat the stall watchdog
            heartbeat()
            _stamp(conn)  # one ingest stamp per forwarded entry
            forwarded_since_boundary += len(batch)
            if track_backlog:
                # the subject may be mid-scan on its own thread, so its
                # bookkeeping can lag these rows — journaling them now with
                # a concurrently captured state double-counts on restore
                # (journal replay + rescan re-emitting the same keys)
                unjournaled.append(batch)
                backlog_rows += len(batch)
                # Overload routes through pacing FIRST: with
                # memory governance active, a pausable subject that has
                # shown a commit boundary never takes the at-least-once
                # escape — its ledger is bounded by its commit cadence
                # and its byte pressure by the pacing watermarks. A
                # subject that never commits is non-pausable in the only
                # sense that matters here (pausing it could never
                # resume), so the cap remains its bounded-memory escape
                # — error-logged and counted, no longer silent.
                paceable = pausable and governed and boundary_seq > 0
                if backlog_rows > _BACKLOG_CAP and not paceable:
                    # journal stateless (at-least-once for this span)
                    # rather than grow host memory without bound
                    msg = (
                        f"connector {conn_name} emitted "
                        f"{backlog_rows} rows without a commit() "
                        "boundary; recovery degrades to at-least-once for "
                        "this span. Stateful subjects should call commit() "
                        "regularly."
                    )
                    if not warned_backlog:
                        warned_backlog = True
                        import logging

                        logging.getLogger(__name__).error(msg)
                    if runtime is not None:
                        report = getattr(
                            runtime, "report_connector_degraded", None
                        )
                        if report is not None:
                            report(conn_name, msg)
                    account_put(batch)
                    if persisting:
                        out_queue.put((conn, batch, None, ledger_rows()))
                    else:
                        out_queue.put((conn, batch, None, []))
                    unjournaled.clear()
                    backlog_rows = 0
                else:
                    account_put(batch)
                    out_queue.put((conn, batch, None, []))
            elif has_state:
                # nothing journals and restart needs no ledger (no
                # persistence + upsert-idempotent or unseekable subject)
                account_put(batch)
                out_queue.put((conn, batch, None, []))
            else:
                account_put(batch)
                out_queue.put((conn, batch, None, jrows_of(batch)))

    def commit_flush() -> None:
        # subject-driven boundary (subject.commit() / end of run()): runs on
        # the subject thread after its bookkeeping was updated, so the
        # captured state claims exactly journal ∪ backlog ∪ this batch
        nonlocal last_flush, forwarded_since_boundary, last_published_state
        nonlocal boundary_seq, backlog_rows
        _faults.fault_point("connector.flush")
        last_flush = _time.monotonic()
        heartbeat()
        with lock:
            batch = take_batch()
            if batch:
                # stamps pair 1:1 with entries that carry rows — a
                # state-only boundary ships no stamp (the runtime pops
                # one per non-empty entry, FIFO)
                _stamp(conn)
            if has_state:
                journal_rows = (
                    ledger_rows() + jrows_of(batch) if persisting else []
                )
                # publish a state even with an empty journal batch when rows
                # were forwarded since the last boundary (operator-snapshot
                # mode needs the state to cover them). `batch` enters the
                # condition directly: without persistence journal_rows is
                # always empty, but a committed batch must still reach the
                # engine
                dirty = (
                    bool(journal_rows)
                    or bool(batch)
                    or forwarded_since_boundary > 0
                )
                if not dirty:
                    return
                try:
                    state = subject.snapshot_state()
                except BaseException:
                    # snapshot failed mid-boundary: forward the parsed
                    # batch like a timer flush (no state, no journal) so
                    # its rows are neither stranded nor missing from the
                    # compensation ledger, then surface the failure — the
                    # ledger is only cleared on a successful snapshot
                    if batch:
                        forwarded_since_boundary += len(batch)
                        if track_backlog:
                            unjournaled.append(batch)
                            backlog_rows += len(batch)
                        account_put(batch)
                        out_queue.put((conn, batch, None, []))
                    raise
                last_published_state = state
                boundary_seq += 1
                unjournaled.clear()
                backlog_rows = 0
                forwarded_since_boundary = 0
                account_put(batch)
                out_queue.put((conn, batch, state, journal_rows))
            elif batch:
                account_put(batch)
                out_queue.put((conn, batch, None, jrows_of(batch)))

    def emit(message: Any) -> None:
        # list.append is GIL-atomic: no lock on the per-row producer path.
        # duration_ms None disables autocommit entirely (reference:
        # io/python/__init__.py autocommit_duration_ms=None) — rows then
        # move only at explicit subject.commit() boundaries.
        if _fp:
            _fp("connector.read")
        if pausable and not gate.is_set():
            # paced: stop READING here, before the row is
            # queued, until the runtime's pacing pass releases the gate
            # off pace_resume. Heartbeats keep flowing so the paced wait
            # is visibly alive; the watchdog additionally exempts paused
            # connectors from the stall verdict (conn.paused).
            while not gate.wait(0.2):
                heartbeat()
        if _acct is not None and _acct._pace_decide(
            _acct.state,
            conn.bytes_put - conn.bytes_drained,
            _acct.high_bytes,
        ):
            # self-paced: own out-queue bytes crossed the high watermark
            # (or the ladder already left "ok") — park before reading
            # more, resume under the low watermark for hysteresis
            while not _acct._pace_resume(
                _acct.state,
                conn.bytes_put - conn.bytes_drained,
                _acct.low_bytes,
            ):
                if _memory.current() is not _acct:
                    break  # run over — the accountant was retired
                heartbeat()
                _time.sleep(0.05)
        pending.append(message)
        if duration_ms is not None:
            now = _time.monotonic()
            if watching:
                conn.last_activity = now
            if (now - last_flush) * 1000.0 >= duration_ms:
                timer_flush()
        elif watching:
            conn.last_activity = _time.monotonic()

    def force_flush() -> None:
        # called from the runtime loop's cadence; respects the autocommit
        # window so steady sources still batch up to duration_ms
        if duration_ms is None or (
            (_time.monotonic() - last_flush) * 1000.0 < duration_ms
        ):
            return
        timer_flush()

    conn.force_flush = force_flush

    def restart_reset() -> None:
        """Roll the session back to the last published scan state before
        re-running the subject (non-upsert rescannable subjects get their
        forwarded-but-unclaimed rows retracted first — rescan then re-
        emits the same stable keys, netting exactly-once). Rescan-unsafe
        subjects (pk sessions with removes, unseekable, no rollback
        state) restart as continuations instead: pending and forwarded
        rows stay, the subject re-runs from wherever it is."""
        nonlocal forwarded_since_boundary, backlog_rows
        if not rescan_safe or last_published_state is None:
            return
        with lock:
            if not is_upsert:
                comp = [
                    (k, r, -d) for (k, r, d) in ledger_rows()
                ]
                if comp:
                    _stamp(conn)
                    account_put(comp)
                    out_queue.put((conn, comp, None, []))
                # engine rolled back to the boundary: the ledger restarts
                # empty, matching it
                unjournaled.clear()
                backlog_rows = 0
                forwarded_since_boundary = 0
            # upsert path: the engine KEEPS the forwarded rows (the rescan
            # retracts/re-inserts through the live session), so the ledger
            # must keep them too — clearing it would journal only the
            # rescan's retract/insert pair at the next boundary, which
            # consolidates to nothing on replay (silent loss)
            pending.clear()
        subject.seek(last_published_state)

    # -- supervisor loop ---------------------------------------------------
    attempt = 0
    budget_boundary = -1  # boundary_seq at the last restart
    failure: Exception | None = None
    try:
        backoff = policy.resolved_backoff(conn_name)
        while True:
            heartbeat()
            subject._attach(emit, commit_flush)
            try:
                subject.run()
                break
            except Exception as exc:
                # a restart that reached a fresh durable boundary counts
                # as recovered: the budget is per failure episode, so a
                # long-lived source surviving one transient failure per
                # day is not killed on day max_restarts+1
                if boundary_seq != budget_boundary and attempt:
                    attempt = 0
                if (
                    not supervised
                    or attempt >= policy.max_restarts
                    or getattr(exc, "pw_parse_poison", False)
                    or not policy.retryable(exc)
                ):
                    failure = exc
                    break
                attempt += 1
                budget_boundary = boundary_seq
                if runtime is not None:
                    report = getattr(
                        runtime, "report_connector_restart", None
                    )
                    if report is not None:
                        report(conn, exc, attempt)
                restart_reset()  # a broken seek falls through as permanent
                # sliced backoff sleep with heartbeats: a connector
                # deliberately backing off must not trip the watchdog
                deadline = _time.monotonic() + backoff.delay_s(attempt - 1)
                while True:
                    heartbeat()
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        break
                    _time.sleep(min(0.2, remaining))
    except Exception as sup_exc:
        # the supervisor machinery itself failed (user retry_on/backoff
        # callbacks, seek, ...): permanent
        failure = sup_exc
    finally:
        # epilogue runs even for BaseException (SystemExit on the subject
        # thread): on_stop cleanup + the final boundary flush, exactly as
        # the pre-supervision driver guaranteed
        try:
            subject.on_stop()
        except Exception:
            pass
        try:
            commit_flush()
        except Exception as exc:
            if failure is None:
                failure = exc
        if failure is not None:
            _report_permanent(conn, failure)
    # the finish sentinel is enqueued by run_connector_thread's finally
