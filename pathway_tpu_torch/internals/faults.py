"""Deterministic fault-injection harness (reference pattern: the
wordcount integration battery's kill-at-phase loop,
integration_tests/wordcount/ — generalized into named in-process
injection points so crash/recovery scenarios replay bit-identically).

Injection points threaded through the hot paths:

    connector.read                  per message a connector subject emits
    connector.flush                 per connector flush (timer or commit)
    persistence.journal_write       before a journal batch is appended
    persistence.journal_write.post  after the append is durable, before
                                    control returns to the engine loop
                                    (crash here = journaled, never accepted)
    persistence.checkpoint          before an operator snapshot / subject
                                    state write
    runtime.step                    per engine timestamp step
    mesh.send                       per mesh frame sent (procgroup.py
                                    send/send_exchange)
    mesh.recv                       per mesh recv (collectives included)
    mesh.rank_kill                  phase-tagged kill slots on the
                                    distributed recovery path: the runtime
                                    hits it with ``phase=`` context at
                                    ``wave_send`` (before an exchange
                                    wave's frames ship), ``post_snapshot``
                                    (rank-local snapshot written, commit
                                    marker not yet moved) and ``restore``
                                    (distributed snapshot restore after
                                    the marker tag is agreed)
    serve.dispatch                  per serving batch window, phase-tagged:
                                    ``window`` (window formed, upserts not
                                    yet committed) and ``committed`` (the
                                    window's commit applied, responses not
                                    yet delivered) — the serve chaos lane
                                    kills mid-dispatch here
    serve.park                      per request parked by the serving
                                    frontend at backend loss
    serve.replay                    per parked request replayed into the
                                    first window of epoch+1
    sink.stage                      per staged egress segment (a
                                    transactional sink sealing one
                                    commit's rows into its staging area,
                                    io/txn.py — crash here = staged
                                    output the next recovery discards)
    sink.finalize                   per staged unit becoming externally
                                    visible (marker landed; crash here =
                                    marker moved but the unit still
                                    pending — recovery must FINALIZE it)
    sink.recover                    per sink recovery scan at restore
                                    (crash here = recovery repeats —
                                    double recovery must be idempotent)
    device.dispatch                 per supervised device dispatch
                                    (internals/device.py
                                    supervised_dispatch — the KNN
                                    search/write sites and the fused
                                    ingest chain), with ``site=``
                                    context; a retryable raise here
                                    exercises the bounded-backoff retry
                                    classifier, a delay longer than
                                    PATHWAY_DEVICE_DISPATCH_TIMEOUT_S
                                    trips the watchdog
    device.h2d                      per host->device staging copy
                                    (ops/ingest.py tokenize-ahead
                                    producer)
    device.oom                      HBM growth attempts
                                    (KnnShard._grow_to /
                                    ShardedKnnIndex._grow_to_local): a
                                    raise here emulates allocator
                                    RESOURCE_EXHAUSTED — growth refuses
                                    and the serving breaker browns out
    device.snapshot                 per index snapshot cut, phase-tagged
                                    ``cut`` (before any segment write)
                                    and ``post_segment`` (segment
                                    durable, manifest not yet part of a
                                    committed cut) — the --device grid
                                    kills both sides of the boundary
    device.restore                  per index restore-from-segments
                                    (phase ``restore``)
    mesh.slow                       straggler injection slots on the wave
                                    path (never crashes — pair with the
                                    ``delay`` action): the runtime hits it
                                    with ``phase="wave_send"`` (slices
                                    prepared, frames about to ship — a
                                    delay here stalls this rank's sends so
                                    every peer's recv-wait points at it)
                                    and ``phase="step"`` (once per engine
                                    timestamp step — a compute-side drag)
    mem.pressure                    per memory-accountant sample
                                    (internals/memory.py sample(), phase
                                    ``sample``): a ``raise`` here is
                                    CAUGHT by the accountant and read as
                                    a synthetic over-high-watermark
                                    sample — the ladder steps up at
                                    exactly the listed hits, which is
                                    how the pacing checker's traces and
                                    the ``fault_matrix --pressure`` grid
                                    replay pressure episodes
                                    deterministically; ``crash`` kills
                                    the rank mid-pressure as usual

A *plan* is a schedule of rules. Each rule names a point, when it fires —
explicit 1-based ``hits``, a modular ``every``, or a seeded probability
``prob`` (drawn from ``random.Random(seed ^ rule_index)`` so the draw
sequence replays exactly) — and an action: ``raise`` throws
:class:`InjectedFault` (retryable unless ``retryable: false``, so the
connector supervisor's default classifier fails fast on it), ``crash``
hard-kills the process via ``os._exit`` (default exit code
``CRASH_EXIT_CODE``), ``delay`` sleeps ``delay_ms`` milliseconds and
returns normally — the straggler injection the N-rank scaling lanes use
(a ``rank``-scoped ``mesh.slow`` delay rule makes exactly one rank
deterministically slow, with no crash and no semantic change, so the
critical-path analyzer's straggler attribution is replayable like every
other fault). Hit counters are global per point and deterministic
given the program's emit/commit order — with the one caveat that
``connector.flush`` also counts wall-clock autocommit flushes, so exact-
hit plans against it are only fully deterministic when autocommit is
disabled (``autocommit_duration_ms=None``); the other points count only
program-ordered events.

Multi-rank schedules: a rule may carry ``"phase"`` (matches only hits
whose call-site context has that phase, counted on a per-(point, phase)
counter so kill-phase schedules stay deterministic regardless of how
phases interleave) and ``"rank"`` (fires only in the process whose
``pathway_config.process_id`` matches — one shared ``PATHWAY_FAULT_PLAN``
can then name its victim rank, which is how the mesh supervisor smoke
kills exactly one rank of a supervised run).

Plans come from the ``PATHWAY_FAULT_PLAN`` env var (inline JSON, or a
path to a JSON file) or programmatically via
``install_plan()``/``clear_plan()``::

    PATHWAY_FAULT_PLAN='{"seed": 7, "rules": [
        {"point": "persistence.journal_write", "hits": [2], "action": "crash"}
    ]}'

The disabled fast path is two attribute loads — safe on per-row paths.
"""

from __future__ import annotations

import json
import os
import random
import threading
from typing import Any

CRASH_EXIT_CODE = 27

POINTS = (
    "connector.read",
    "connector.flush",
    "persistence.journal_write",
    "persistence.journal_write.post",
    "persistence.checkpoint",
    "runtime.step",
    "mesh.send",
    "mesh.recv",
    "mesh.rank_kill",
    "serve.dispatch",
    "serve.park",
    "serve.replay",
    "mesh.slow",
    "sink.stage",
    "sink.finalize",
    "sink.recover",
    "device.dispatch",
    "device.h2d",
    "device.oom",
    "device.snapshot",
    "device.restore",
    "mem.pressure",
)

_ACTIONS = ("raise", "crash", "delay")


class InjectedFault(RuntimeError):
    """Raised by a firing ``raise`` rule. ``retryable`` feeds the
    connector supervisor's default classifier."""

    def __init__(self, point: str, hit: int, retryable: bool = True):
        super().__init__(f"injected fault at {point} (hit {hit})")
        self.point = point
        self.hit = hit
        self.retryable = retryable


class FaultRule:
    __slots__ = (
        "point", "hits", "every", "prob", "action", "retryable",
        "max_fires", "fired", "exit_code", "phase", "rank", "delay_ms",
        "_rng",
    )

    def __init__(
        self,
        point: str,
        hits=None,
        every: int | None = None,
        prob: float | None = None,
        action: str = "raise",
        retryable: bool = True,
        max_fires: int | None = None,
        exit_code: int = CRASH_EXIT_CODE,
        phase: str | None = None,
        rank: int | None = None,
        delay_ms: float = 0.0,
    ):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; use {_ACTIONS}")
        if point not in POINTS:
            # a typo'd point would silently never fire, making a crash-
            # recovery test pass vacuously
            raise ValueError(
                f"unknown injection point {point!r}; known points: {POINTS}"
            )
        self.point = point
        self.hits = set(hits) if hits is not None else None
        self.every = every
        self.prob = prob
        self.action = action
        self.retryable = retryable
        # crash rules fire at most once by nature; raise rules default to
        # one fire per listed hit unless max_fires widens/narrows it
        self.max_fires = max_fires
        self.fired = 0
        self.exit_code = exit_code
        # phase-scoped rules count hits on the (point, phase) counter so a
        # "second wave_send" schedule replays identically no matter how
        # other phases of the same point interleave with it
        self.phase = phase
        self.rank = rank
        # "delay" action: how long a firing rule stalls the caller (the
        # straggler knob; a non-positive delay makes the rule a no-op)
        self.delay_ms = float(delay_ms)
        self._rng: random.Random | None = None  # bound by the plan

    def applies(self, context: dict | None) -> bool:
        """Context filters that gate whether a hit is even considered:
        call-site phase and the firing process's mesh rank."""
        if self.phase is not None:
            if context is None or context.get("phase") != self.phase:
                return False
        if self.rank is not None:
            from pathway_tpu_torch.internals.config import get_pathway_config

            if get_pathway_config().process_id != self.rank:
                return False
        return True

    def matches(self, hit: int) -> bool:
        if self.max_fires is not None and self.fired >= self.max_fires:
            return False
        if self.hits is not None:
            return hit in self.hits
        if self.every is not None:
            return hit % self.every == 0
        if self.prob is not None:
            # one deterministic draw per hit at this point, in hit order
            return self._rng.random() < self.prob
        return True  # unconditional: fires on every hit (cap via max_fires)


class FaultPlan:
    """Seeded, thread-safe schedule of fault rules with per-point hit
    counters. Deterministic: the same program order replays the same
    fires bit-identically."""

    def __init__(self, rules, seed: int = 0):
        self.rules = [
            r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules
        ]
        self.seed = seed
        for i, rule in enumerate(self.rules):
            rule._rng = random.Random((seed << 8) ^ i)
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: "FaultPlan | str | dict") -> "FaultPlan":
        if isinstance(spec, FaultPlan):
            return spec
        if isinstance(spec, str):
            spec = json.loads(spec)
        return cls(spec.get("rules", []), seed=int(spec.get("seed", 0)))

    def on_hit(self, point: str, context: dict | None = None):
        """Count a hit at `point`; return (rule, hit) if a rule fires.
        Hits with a ``phase`` in their context are additionally counted on
        a per-(point, phase) counter — phase-scoped rules match against
        THAT counter, so their schedules are deterministic per phase."""
        with self._lock:
            hit = self._counts.get(point, 0) + 1
            self._counts[point] = hit
            phase_hit = None
            phase = context.get("phase") if context else None
            if phase is not None:
                pkey = f"{point}#{phase}"
                phase_hit = self._counts.get(pkey, 0) + 1
                self._counts[pkey] = phase_hit
            for rule in self.rules:
                if rule.point != point or not rule.applies(context):
                    continue
                h = phase_hit if rule.phase is not None else hit
                if h is not None and rule.matches(h):
                    rule.fired += 1
                    return rule, h
        return None

    def hit_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


_active: FaultPlan | None = None
_env_checked = False


def install_plan(spec) -> FaultPlan | None:
    """Install a plan programmatically (FaultPlan, dict spec, or JSON
    string); None uninstalls. Returns the active plan."""
    global _active, _env_checked
    _active = FaultPlan.from_spec(spec) if spec is not None else None
    _env_checked = True  # programmatic choice wins over the env var
    return _active


def clear_plan() -> None:
    install_plan(None)


def reset() -> None:
    """Forget any installed plan AND re-read PATHWAY_FAULT_PLAN on the
    next hit (test isolation helper)."""
    global _active, _env_checked
    _active = None
    _env_checked = False


def active_plan() -> FaultPlan | None:
    global _active, _env_checked
    if _active is not None or _env_checked:
        return _active
    _env_checked = True
    spec = os.environ.get("PATHWAY_FAULT_PLAN")
    if spec:
        if not spec.lstrip().startswith("{"):
            with open(spec) as f:
                spec = f.read()
        _active = FaultPlan.from_spec(spec)
    return _active


def fault_point(point: str, **context: Any) -> None:
    """Hot-path hook. No-op without an active plan; otherwise counts the
    hit and executes the first matching rule's action. Context keys the
    rules understand: ``phase`` (kill-phase schedules)."""
    if _active is None and _env_checked:
        return
    plan = active_plan()
    if plan is None:
        return
    fired = plan.on_hit(point, context or None)
    if fired is None:
        return
    rule, hit = fired
    if rule.action == "crash":
        os._exit(rule.exit_code)
    if rule.action == "delay":
        # straggler injection: stall, never raise — the run's semantics
        # (and its exactly-once audit) must be bit-identical to fault-free
        if rule.delay_ms > 0:
            import time as _time

            _time.sleep(rule.delay_ms / 1000.0)
        return
    raise InjectedFault(point, hit, retryable=rule.retryable)
