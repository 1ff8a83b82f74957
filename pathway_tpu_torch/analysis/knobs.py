"""Central registry of every ``PATHWAY_*`` environment knob.

Before this registry the knobs were scattered ``os.environ`` reads across
config/nodes/procgroup/supervisor/io — a typo (``PATHWAY_THREDS=8``,
``PATHWAY_NO_NB_JOIN=0`` meaning *on* under truthiness) was silently
ignored or silently misread. The runtime now validates the environment at
startup (engine/runtime.py) and rejects unknown or out-of-range values;
``pw.analyze`` reports the same findings as diagnostics, and the README
knob table is generated from here (``knob_table_markdown``).

Escape hatch: ``PATHWAY_KNOB_CHECK=0`` downgrades startup rejection to a
logged warning (for embedding environments that share a process with
unrelated PATHWAY_* vars).
"""

from __future__ import annotations

import difflib
import os
from dataclasses import dataclass
from typing import Any, Mapping

# matches config._env_bool_field: an empty string is NOT a boolean (a
# `VAR= cmd` shell accident), even though the pure-flag readers
# (eligibility.env_flag) would defensively treat it as off
_BOOL_VALUES = ("0", "1", "false", "true", "no", "yes")


@dataclass(frozen=True)
class Knob:
    name: str
    type: str               # "int" | "float" | "bool" | "str" | "enum"
    default: Any
    description: str
    lo: float | None = None  # inclusive bounds for int/float
    hi: float | None = None
    choices: tuple = ()      # for enum

    def check(self, raw: str) -> str | None:
        """Problem description for a raw env value, or None when valid."""
        if self.type == "bool":
            if raw.strip().lower() not in _BOOL_VALUES:
                return (
                    f"expected a boolean ({'/'.join(_BOOL_VALUES)}), "
                    f"got {raw!r}"
                )
            return None
        if self.type in ("int", "float"):
            try:
                val = int(raw) if self.type == "int" else float(raw)
            except ValueError:
                return f"expected {self.type}, got {raw!r}"
            if self.lo is not None and val < self.lo:
                return f"{val} is below the minimum {self.lo}"
            if self.hi is not None and val > self.hi:
                return f"{val} is above the maximum {self.hi}"
            return None
        if self.type == "enum":
            if raw not in self.choices:
                return (
                    f"expected one of {list(self.choices)}, got {raw!r}"
                )
            return None
        return None  # free-form str


def _k(name, type, default, description, lo=None, hi=None, choices=()):
    return Knob(name, type, default, description, lo, hi, tuple(choices))


KNOBS: dict[str, Knob] = {
    k.name: k
    for k in [
        # -- core topology ------------------------------------------------
        _k("PATHWAY_THREADS", "int", 1,
           "Native executor shard threads per process (C++ apply phase "
           "runs GIL-free across them).", lo=1, hi=1024),
        _k("PATHWAY_PROCESSES", "int", 1,
           "World size of the process mesh (multi-rank runs).", lo=1,
           hi=4096),
        _k("PATHWAY_PROCESS_ID", "int", 0,
           "This rank's id in [0, PATHWAY_PROCESSES).", lo=0, hi=4095),
        _k("PATHWAY_FIRST_PORT", "int", 10000,
           "Base TCP port of the mesh; rank r listens on base + r.",
           lo=1, hi=65535),
        _k("PATHWAY_HOSTS", "str", None,
           "Comma-separated host[:port] list for multi-host meshes "
           "(default: loopback)."),
        # -- run configuration --------------------------------------------
        _k("PATHWAY_RUN_ID", "str", None, "Run identifier (telemetry)."),
        _k("PATHWAY_LICENSE_KEY", "str", None,
           "License key (recorded, not enforced in this build)."),
        _k("PATHWAY_MONITORING_SERVER", "str", None,
           "OTLP endpoint for telemetry export."),
        # -- flight recorder (internals/flight.py) ------------------------
        _k("PATHWAY_TRACE", "str", None,
           "Arm the flight recorder and write a Perfetto/Chrome-trace "
           "JSON to this path (multi-rank runs merge per-rank partials "
           "into it; feed it to `python -m pathway_tpu_torch.analysis "
           "--profile`)."),
        _k("PATHWAY_TRACE_RING_EVENTS", "int", 65536,
           "Capacity (events per thread) of the native executor's "
           "GIL-free trace ring buffers.", lo=1024, hi=16_777_216),
        _k("PATHWAY_TRACE_MAX_EVENTS", "int", 2_000_000,
           "In-memory event cap of the flight recorder (per rank); a "
           "long-running traced pipeline keeps the NEWEST events and "
           "the dump records that the head was capped.", lo=10_000,
           hi=100_000_000),
        # -- device plane (internals/device.py) ------------------
        _k("PATHWAY_DEVICE_TRACE", "bool", True,
           "Device plane of the flight recorder: engine dispatch sites "
           "(KNN scan, embedder forward, serving window) record timed "
           "per-dispatch device spans, FLOPs and transfer bytes while "
           "the profiling plane is armed. 0 opts out even on a traced "
           "run — armed dispatches block_until_ready for attribution, "
           "trading dispatch pipelining for visibility."),
        _k("PATHWAY_DEVICE_PEAK_FLOPS", "float", None,
           "Override the MFU denominator (peak device FLOP/s). Default: "
           "resolved from the device kind (H100 SXM/PCIe table; "
           "modest CPU fallback).", lo=1.0),
        _k("PATHWAY_DEVICE_PEAK_GBPS", "float", None,
           "Override the roofline ridge's peak HBM bandwidth (GB/s). "
           "Default: resolved from the device kind.", lo=0.001),
        # -- fused ingest ---------------------------------------
        _k("PATHWAY_INGEST_DEPTH", "int", 2,
           "Tokenize-ahead depth of the fused ingest chain "
           "(ops/ingest.py): how many tokenized+padded batches the host "
           "producer may stage ahead of the device. 1 degrades to "
           "strict alternation; 2 is classic double buffering.",
           lo=1, hi=64),
        _k("PATHWAY_INDEX_SHARDS", "int", None,
           "Back vector-index adapters with the pod-sharded HBM index "
           "over an N-device data-parallel mesh (one corpus shard per "
           "chip, queries broadcast, per-shard fused matmul+top-k, "
           "merged across devices). Unset/0/1 = single-chip shard; ignored "
           "when fewer than N devices are visible.", lo=0, hi=4096),
        # -- device fault domain --------------------------------
        _k("PATHWAY_DEVICE_DISPATCH_TIMEOUT_S", "float", 0.0,
           "Watchdog deadline (seconds) on supervised device dispatch "
           "sites (KNN write/search, fused ingest): a dispatch that "
           "exceeds it is abandoned and raises WatchdogTimeout (a "
           "permanent fault, routed to epoch abort). 0 disables the "
           "watchdog. Set well under PATHWAY_MESH_OP_TIMEOUT_S so a "
           "hung chip surfaces as a node fault before the mesh "
           "collective deadline declares the whole rank dead.",
           lo=0.0, hi=86400.0),
        _k("PATHWAY_DEVICE_RETRIES", "int", 2,
           "Bounded retry budget for transient device dispatch "
           "failures (supervised_dispatch / the fused-ingest producer): "
           "transient errors retry with exponential backoff up to this "
           "many times; OOM flips the serving breaker into brownout; "
           "permanent faults abort the epoch immediately.",
           lo=0, hi=64),
        _k("PATHWAY_DEVICE_SNAPSHOT", "bool", True,
           "Epoch-aligned incremental index snapshots: under "
           "OPERATOR_PERSISTING, HBM index shards write per-epoch delta "
           "segments (only slots touched since the last cut) through "
           "the persistence store at the same marker the mesh commits; "
           "restore rebuilds the HBM shard from segments instead of "
           "re-embedding. 0 falls back to inline full-state snapshots."),
        _k("PATHWAY_INDEX_SNAPSHOT_SEGMENTS", "int", 8,
           "Segment-chain length at which an index snapshot compacts: "
           "once an index's manifest references this many delta "
           "segments, the next cut folds the chain into one full "
           "segment (TxnDeltaSink-style folded-manifest compaction) so "
           "restore cost stays bounded.", lo=1, hi=4096),
        _k("PATHWAY_TERMINATE_ON_ERROR", "bool", True,
           "Abort the run on the first data error instead of poisoning "
           "rows to ERROR."),
        _k("PATHWAY_IGNORE_ASSERTS", "bool", False,
           "Skip runtime assert_table_has_* checks."),
        _k("PATHWAY_RUNTIME_TYPECHECKING", "bool", False,
           "Enable runtime dtype checks on column values."),
        _k("PATHWAY_KNOB_CHECK", "bool", True,
           "Validate PATHWAY_* env vars at startup; 0 downgrades "
           "rejection to a warning."),
        # -- persistence / replay -----------------------------------------
        _k("PATHWAY_REPLAY_STORAGE", "str", None,
           "Filesystem path for record/replay storage."),
        _k("PATHWAY_SNAPSHOT_ACCESS", "enum", None,
           "Record/replay mode for PATHWAY_REPLAY_STORAGE.",
           choices=("record", "replay", "speedrun")),
        _k("PATHWAY_PERSISTENCE_MODE", "str", None,
           "Persistence mode override (e.g. OPERATOR_PERSISTING)."),
        _k("PATHWAY_CONTINUE_AFTER_REPLAY", "bool", False,
           "Keep consuming live data after replay finishes."),
        _k("PATHWAY_PERSISTENT_STORAGE", "str", None,
           "Directory for persistent UDF caches (udfs/caches.py)."),
        # -- transactional egress (io/txn.py) -------------------
        _k("PATHWAY_SINK_TXN", "bool", True,
           "Epoch-aligned two-phase-commit sinks: under OPERATOR_"
           "PERSISTING, staged sink output finalizes only when the "
           "snapshot_commit marker lands (exactly-once committed "
           "egress across rollback/rescale). 0 reverts to finalize-"
           "per-commit-timestamp (still torn-write-proof)."),
        _k("PATHWAY_SINK_FSYNC", "bool", True,
           "fsync staged segments, finalized files and their "
           "directories at every sink rename point. 0 trades "
           "power-loss durability for test speed."),
        _k("PATHWAY_SINK_STAGE_DIR", "str", None,
           "Root for transactional sinks' staging/segment areas "
           "(default: '<output>.pw-txn' next to each output file)."),
        # -- NativeBatch fused chain --------------------------------------
        _k("PATHWAY_NO_NB_JOIN", "bool", False,
           "Force joins onto the tuple path (fused-vs-tuple parity "
           "batteries)."),
        _k("PATHWAY_NO_NB_EXCHANGE", "bool", False,
           "Force exchanges onto the pickled tuple path."),
        _k("PATHWAY_NO_NB_CAPTURE", "bool", False,
           "Force the row-expanding egress path (capture/sinks "
           "materialize Python rows instead of Arrow record batches) — "
           "the rows-vs-arrow parity knob."),
        _k("PATHWAY_NB_STRICT", "bool", False,
           "Raise NBStrictError (with fusion blame) when a fused-eligible "
           "node demotes or de-optimizes to the tuple path, instead of "
           "degrading silently."),
        _k("PATHWAY_NATIVE_BUILD_DIR", "str", None,
           "Override the native extension build dir (sanitizer lanes)."),
        # -- REST serving gateway (io/http/_server.py) --------------------
        _k("PATHWAY_REST_TIMEOUT_S", "float", 120.0,
           "Per-request deadline on the REST gateway; timed-out requests "
           "get 504 and are evicted from the batch window.", lo=0.001,
           hi=86400),
        _k("PATHWAY_SERVE_WINDOW_MS", "float", 5.0,
           "Dynamic batch window of the serving gateway: requests "
           "coalesce into ONE dataflow commit until the window closes "
           "(0 = commit per request).", lo=0, hi=60_000),
        _k("PATHWAY_SERVE_MAX_BATCH", "int", 32,
           "Close the serving batch window early once this many requests "
           "are collected.", lo=1, hi=65536),
        _k("PATHWAY_SERVE_QUEUE_CAP", "int", 2048,
           "Bounded admission queue of the serving gateway; overflow is "
           "shed with 503 + Retry-After.", lo=1, hi=10_000_000),
        _k("PATHWAY_SERVE_WORKERS", "int", 1,
           "Gateway dispatch workers draining closed batch windows into "
           "the dataflow (each window stays one atomic commit).", lo=1,
           hi=64),
        _k("PATHWAY_SERVE_TIMING", "bool", False,
           "Server-Timing response header on the gateway: per-request "
           "queue/window/dispatch/egress milliseconds, so a "
           "client-observed p50 decomposes without a trace file."),
        # -- serving through rollback (io/http/_frontend.py + breaker) ----
        _k("PATHWAY_SERVE_BROWNOUT", "bool", False,
           "Degraded-answer mode: with the dispatch circuit breaker open "
           "the gateway answers from the last committed index snapshot "
           "(brownout_answer hook) with a Degraded: true header instead "
           "of shedding."),
        _k("PATHWAY_SERVE_BREAKER_THRESHOLD", "int", 5,
           "Consecutive dispatch failures or request-deadline breaches "
           "that open the device-dispatch circuit breaker (0 disables "
           "it).", lo=0, hi=1_000_000),
        _k("PATHWAY_SERVE_BREAKER_COOLDOWN_S", "float", 5.0,
           "Open-breaker cooldown before one probe window half-opens "
           "it.", lo=0.01, hi=3600),
        _k("PATHWAY_SERVE_PARK_BUDGET", "int", 1024,
           "Requests the epoch-survivable frontend will hold parked "
           "during a rollback before shedding new arrivals.", lo=0,
           hi=10_000_000),
        _k("PATHWAY_SERVE_BACKEND_PORT", "int", None,
           "Set by the mesh supervisor's serving frontend: the gateway "
           "binds this loopback port instead of its public host:port, "
           "and the frontend owns the public listener across epochs.",
           lo=1, hi=65535),
        _k("PATHWAY_SERVE_PUBLIC_PORT", "int", None,
           "Set alongside PATHWAY_SERVE_BACKEND_PORT: scopes the "
           "backend rewrite to the one webserver configured on the "
           "frontend's public port (other webservers keep their own "
           "ports).", lo=1, hi=65535),
        # -- connector supervision ----------------------------------------
        _k("PATHWAY_CONNECTOR_MAX_RESTARTS", "int", 3,
           "In-place restart budget per connector subject.", lo=0,
           hi=1_000_000),
        _k("PATHWAY_CONNECTOR_BACKOFF_MS", "int", 500,
           "Base backoff between connector restarts (exponential, "
           "seeded jitter).", lo=0, hi=3_600_000),
        # -- fault injection ----------------------------------------------
        _k("PATHWAY_FAULT_PLAN", "str", None,
           "Deterministic fault-injection schedule "
           "(internals/faults.py plan syntax)."),
        # -- mesh fault tolerance -----------------------------------------
        _k("PATHWAY_MESH_SECRET", "str", None,
           "Shared secret MAC'd into the mesh handshake."),
        _k("PATHWAY_MESH_EPOCH", "int", 0,
           "Recovery epoch bound into the handshake (set by the "
           "supervisor on rollback respawns).", lo=0, hi=1_000_000_000),
        _k("PATHWAY_MESH_HEARTBEAT_S", "float", 2.0,
           "Heartbeat frame cadence per peer link (0 disables).", lo=0,
           hi=3600),
        _k("PATHWAY_MESH_PEER_TIMEOUT_S", "float", 10.0,
           "Liveness window before a silent peer is declared failed.",
           lo=0.001, hi=86400),
        _k("PATHWAY_MESH_OP_TIMEOUT_S", "float", 300.0,
           "Hard deadline on every mesh collective (0 disables).",
           lo=0, hi=86400),
        _k("PATHWAY_MESH_MAX_FRAME_MB", "int", 256,
           "Receiver-side cap on a single exchange frame, per ORIGIN "
           "rank: on tree-gather meshes the effective cap scales by "
           "the largest subtree span, since a relayed frame "
           "legitimately aggregates its whole subtree's slices.",
           lo=1, hi=65536),
        # -- fast wire -----------------------------------------
        _k("PATHWAY_MESH_COMPRESSION", "enum", "auto",
           "Per-blob compression of exchange frames, negotiated at the "
           "mesh handshake: off | zlib (stdlib, always available) | "
           "lz4 | zstd (used when importable) | auto (best common "
           "codec, with an entropy probe skipping incompressible "
           "blobs). CRC is verified over the wire image before any "
           "decompression.",
           choices=("off", "zlib", "lz4", "zstd", "auto")),
        _k("PATHWAY_MESH_COMPRESS_MIN_BYTES", "int", 512,
           "Blobs below this size skip the codec entirely (tiny frames "
           "cost more to compress than to ship).", lo=0,
           hi=1_000_000_000),
        _k("PATHWAY_MESH_TREE_FANOUT", "str", "auto",
           "Gather-leg topology of the exchange wave engine: 'auto' "
           "(k=2 reduction tree at world >= 4), 'off' (flat, every "
           "sender ships straight to rank 0), or an integer fanout "
           ">= 2."),
        _k("PATHWAY_MESH_SEND_QUEUE", "int", None,
           "Bounded per-peer sender-thread queue (frames): exchange "
           "sends are encoded+compressed and drained off the engine "
           "loop so the native executor keeps applying while frames "
           "ship; a full queue blocks the producer (backpressure). "
           "0 = synchronous sends on the engine thread. Default: "
           "adaptive — 8 when the host has at least 2 cores per local "
           "rank (the threads have somewhere to run), else 0 (on a "
           "saturated host the per-frame GIL handoff would sit on "
           "every wave's critical path).", lo=0, hi=4096),
        _k("PATHWAY_MESH_SUPERVISED", "bool", False,
           "Exit MESH_RESTART_EXIT_CODE on mesh failure so the "
           "supervisor can roll the epoch back."),
        _k("PATHWAY_MESH_GRACE_S", "float", 20.0,
           "Supervisor grace period before SIGKILL on rollback.", lo=0,
           hi=3600),
        _k("PATHWAY_MESH_MAX_RESTARTS", "int", 3,
           "Supervisor rollback budget.", lo=0, hi=1_000_000),
        # -- cluster metrics plane (internals/cluster.py) -----------------
        _k("PATHWAY_CLUSTER_METRICS_PORT", "int", None,
           "Serve the merged /metrics/cluster view on this port: every "
           "rank's OpenMetrics endpoint (20000 + rank) is scraped and "
           "re-labeled with rank=..., plus derived mesh_skew_seconds / "
           "scaling_efficiency gauges. The MeshSupervisor hosts it "
           "across rollbacks when it owns the rank set; an unsupervised "
           "multi-rank run hosts it on rank 0 (which also force-enables "
           "the per-rank /metrics endpoints).", lo=1, hi=65535),
        _k("PATHWAY_CLUSTER_SCRAPE_S", "float", 2.0,
           "Scrape cadence of the cluster metrics aggregator.", lo=0.05,
           hi=3600),
        _k("PATHWAY_CLUSTER_BASELINE_ROWS_PER_S", "float", None,
           "1-rank ingest-throughput baseline: when set, the cluster "
           "view derives scaling_efficiency = observed rows/s / "
           "(baseline × world). The N-rank bench lanes compute the same "
           "number from their own measured 1-rank run.", lo=0.001),
        # -- elastic-mesh autoscaler (parallel/autoscale.py) --------------
        _k("PATHWAY_AUTOSCALE_MIN", "int", 1,
           "Smallest world size the autoscaler may shrink the mesh to.",
           lo=1, hi=4096),
        _k("PATHWAY_AUTOSCALE_MAX", "int", 8,
           "Largest world size the autoscaler may grow the mesh to.",
           lo=1, hi=4096),
        _k("PATHWAY_AUTOSCALE_COOLDOWN_S", "float", 30.0,
           "Hold window after every rescale: the policy re-accumulates "
           "its hysteresis streaks against the NEW world before it may "
           "rescale again.", lo=0, hi=86400),
        _k("PATHWAY_AUTOSCALE_INTERVAL_S", "float", 2.0,
           "Autoscaler observation cadence (one policy step per tick).",
           lo=0.05, hi=3600),
        _k("PATHWAY_AUTOSCALE_BUDGET", "int", 4,
           "Total rescales one supervisor lifetime may perform — a "
           "flapping load signal cannot thrash the mesh.", lo=0,
           hi=1000),
        _k("PATHWAY_AUTOSCALE_GROW_PRESSURE", "float", 1.0,
           "Serving-pressure threshold (parked requests + new sheds per "
           "tick) at or above which the grow streak advances.",
           lo=0.0),
        _k("PATHWAY_AUTOSCALE_SHRINK_EFFICIENCY", "float", 0.35,
           "scaling_efficiency below which (with zero serving pressure) "
           "the shrink streak advances — running wide when narrow "
           "suffices burns the pod.", lo=0.0, hi=1.0),
        _k("PATHWAY_AUTOSCALE_HYSTERESIS", "int", 2,
           "Consecutive ticks a grow/shrink condition must hold before "
           "the autoscaler acts.", lo=1, hi=1000),
        # -- memory governance / backpressure (internals/memory.py) ------
        _k("PATHWAY_MEM_BUDGET_MB", "int", None,
           "Host-plane memory budget in MiB for the accounted "
           "components (connector backlog, exchange queues, native "
           "stores, capture pending, txn staging). Unset/0 disables "
           "the degradation ladder — legacy un-governed behavior.",
           lo=0, hi=1_048_576),
        _k("PATHWAY_MEM_HIGH", "float", 0.8,
           "High watermark as a fraction of the budget: accounted "
           "bytes at/above it step the ladder to pacing (pausable "
           "sources stop reading).", lo=0.0, hi=1.0),
        _k("PATHWAY_MEM_LOW", "float", 0.6,
           "Low watermark as a fraction of the budget: the ladder "
           "only releases back to ok (sources resume) once accounted "
           "bytes drain below it — the hysteresis band that stops "
           "pause/resume flapping.", lo=0.0, hi=1.0),
        # -- CI / test harness --------------------------------------------
        _k("PATHWAY_LANE_PROCESSES", "int", 1,
           "Emulated-rank CI lane: every run transparently joins N "
           "thread-ranks over loopback TCP.", lo=1, hi=64),
    ]
}


class KnobError(ValueError):
    """Unknown or out-of-range PATHWAY_* environment variable."""


def validate_environment(
    environ: Mapping[str, str] | None = None,
) -> list[tuple[str, str, str | None]]:
    """Scan ``environ`` for PATHWAY_* vars; return a list of
    ``(name, problem, hint)`` findings (empty when clean)."""
    environ = os.environ if environ is None else environ
    findings: list[tuple[str, str, str | None]] = []
    for name in sorted(environ):
        if not name.startswith("PATHWAY_"):
            continue
        raw = environ[name]
        knob = KNOBS.get(name)
        if knob is None:
            close = difflib.get_close_matches(name, KNOBS, n=1, cutoff=0.75)
            hint = f"did you mean {close[0]}?" if close else (
                "see the PATHWAY_* knob table in README.md"
            )
            findings.append((name, "unknown knob (typo?)", hint))
            continue
        problem = knob.check(raw)
        if problem is not None:
            findings.append(
                (name, problem, f"default: {knob.default!r} — "
                                f"{knob.description}")
            )
    return findings


def knob_check_disabled() -> bool:
    """The PATHWAY_KNOB_CHECK=0 escape hatch: downgrade knob rejection
    to a warning (embedding environments sharing a process with
    unrelated PATHWAY_* vars)."""
    return os.environ.get("PATHWAY_KNOB_CHECK", "1").strip().lower() in (
        "0", "false", "no",
    )


_checked: tuple | None = None


def enforce_environment() -> None:
    """Startup gate: raise KnobError on unknown/out-of-range PATHWAY_*
    vars (warn-only under PATHWAY_KNOB_CHECK=0). Memoized per environment
    snapshot — runtimes are created per run and per emulated rank."""
    global _checked
    snapshot = tuple(
        sorted(
            (k, v) for k, v in os.environ.items() if k.startswith("PATHWAY_")
        )
    )
    if snapshot == _checked:
        return
    findings = validate_environment()
    if not findings:
        _checked = snapshot
        return
    lines = [
        f"  {name}: {problem}" + (f" ({hint})" if hint else "")
        for name, problem, hint in findings
    ]
    msg = "invalid PATHWAY_* environment knob(s):\n" + "\n".join(lines)
    if knob_check_disabled():
        import logging

        logging.getLogger(__name__).warning(msg)
        _checked = snapshot
        return
    raise KnobError(msg)


def knob_table_markdown() -> str:
    """README knob table, generated from the registry so docs cannot
    drift from the code."""
    rows = [
        "| knob | type | default | description |",
        "|---|---|---|---|",
    ]
    for name in sorted(KNOBS):
        k = KNOBS[name]
        typ = k.type
        if k.type in ("int", "float") and (k.lo is not None or k.hi is not None):
            typ = f"{k.type} [{k.lo if k.lo is not None else ''}..{k.hi if k.hi is not None else ''}]"
        elif k.type == "enum":
            typ = " \\| ".join(k.choices)
        default = "" if k.default is None else repr(k.default)
        rows.append(f"| `{name}` | {typ} | {default} | {k.description} |")
    return "\n".join(rows) + "\n"
