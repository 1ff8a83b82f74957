"""Host-plane memory accountant + degradation ladder.

Nothing in the engine used to bound memory under overload: connectors
ingest as fast as they can read and the only pushback in the data plane
(``io/_connector.py`` ``_BACKLOG_CAP``) silently *weakens delivery
semantics* instead of slowing down. This module is the governed
alternative: per-component byte accounting — connector backlog, exchange
send/recv queues, native-store state (``exec.cpp store_nbytes`` /
``join_store_nbytes`` GIL-free probes), capture pending, txn staging —
summed against a budget (``PATHWAY_MEM_BUDGET_MB`` with
``PATHWAY_MEM_HIGH`` / ``PATHWAY_MEM_LOW`` watermarks) and stepped
through the pure
degradation ladder ``parallel/protocol.py mem_ladder``:

    ok -> pacing (pausable sources stop reading)
       -> brownout (serving sheds; breaker consumes the memory signal)
       -> abort (epoch abort — the last resort, sticky until restore)

The accountant owns NO policy: every verdict comes from the protocol
transitions it binds from ``protocol.TRANSITIONS`` (same objects the
pacing model checker ``analysis/meshcheck.py check_pacing`` explores —
the anti-drift identity pin in ``tests/test_backpressure.py``). The
runtime's connector-health pass calls :meth:`MemoryAccountant.sample`
once per cadence; everything else just reports bytes into it.

``sample()`` is a ``mem.pressure`` fault point with a twist: a firing
``raise`` rule is CAUGHT here and read as a synthetic over-high-
watermark sample, so pressure episodes — including the minimal traces
the pacing checker renders for a caught mutant — replay
deterministically through the standard ``PATHWAY_FAULT_PLAN``
machinery (``scripts/fault_matrix.py --pressure`` / ``--from-trace``).

With the budget unset the ladder never leaves ``"ok"`` and every legacy
behavior (including the ``_BACKLOG_CAP`` at-least-once overflow path)
is preserved bit-for-bit.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Mapping

from pathway_tpu_torch.parallel import protocol as _protocol
from pathway_tpu_torch.internals.faults import InjectedFault, fault_point

# Accounted component names, fixed so the OpenMetrics gauge set (and the
# metrics-registry drift pin) cannot wander: every ``set_component`` call
# must name one of these.
COMPONENTS = (
    "connector_backlog",   # io/_connector.py unjournaled ledger + pending
    "exchange_send",       # parallel/procgroup.py per-peer send queues
    "exchange_recv",       # parallel/procgroup.py reassembled recv frames
    "store",               # native GroupStore/JoinStore bytes (exec.cpp)
    "capture_pending",     # operator-snapshot capture staging
    "txn_staging",         # io/txn.py staged egress units
)


def resolve_watermarks(
    environ: Mapping[str, str] | None = None,
) -> tuple[int, int, int]:
    """``(low_bytes, high_bytes, budget_bytes)`` from the memory
    knobs; ``(0, 0, 0)`` when governance is disabled (budget unset, 0,
    or unparseable). A low fraction above the high one is clamped down
    to it — an inverted hysteresis band would flap forever."""
    env = os.environ if environ is None else environ
    raw = (env.get("PATHWAY_MEM_BUDGET_MB") or "").strip()
    try:
        budget_mb = int(raw) if raw else 0
    except ValueError:
        budget_mb = 0
    if budget_mb <= 0:
        return (0, 0, 0)
    budget = budget_mb * 1024 * 1024

    def _frac(name: str, default: float) -> float:
        try:
            return float((env.get(name) or "").strip() or default)
        except ValueError:
            return default

    high = _frac("PATHWAY_MEM_HIGH", 0.8)
    low = min(_frac("PATHWAY_MEM_LOW", 0.6), high)
    return (int(budget * low), int(budget * high), budget)


def approx_nbytes(obj: object, _depth: int = 3) -> int:
    """Cheap recursive payload-size estimate for accounting (NOT a
    precise heap measure): container ``sys.getsizeof`` plus element
    sizes down to a small depth. Used for connector rows and capture
    payloads where exact native sizes don't exist; the native stores
    report exact bytes through their own probes instead."""
    try:
        n = sys.getsizeof(obj)
    except TypeError:
        return 64
    if _depth <= 0:
        return n
    if isinstance(obj, (tuple, list, set, frozenset)):
        for item in obj:
            n += approx_nbytes(item, _depth - 1)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            n += approx_nbytes(k, _depth - 1)
            n += approx_nbytes(v, _depth - 1)
    return n


class MemoryAccountant:
    """Byte registry + cached ladder state for ONE runtime.

    Thread-safe: reporters (connector driver threads, exchange pumps)
    call :meth:`set_component` concurrently with the runtime loop's
    :meth:`sample`. Reads of :attr:`state` are a plain attribute load —
    cheap enough for per-request serving checks."""

    def __init__(
        self,
        environ: Mapping[str, str] | None = None,
        abort_streak: int = 4,
    ):
        self.low_bytes, self.high_bytes, self.budget_bytes = (
            resolve_watermarks(environ)
        )
        self.abort_streak = abort_streak
        self._lock = threading.Lock()
        self._components: dict[str, int] = {}
        # the protocol transitions, bound from the table so the engine
        # provably drives the same objects the checker explores
        self._ladder = _protocol.TRANSITIONS["mem_ladder"]
        self._pace_decide = _protocol.TRANSITIONS["pace_decide"]
        self._pace_resume = _protocol.TRANSITIONS["pace_resume"]
        self.state = "ok"
        self.total_bytes = 0
        self.peak_bytes = 0
        self.over_streak = 0
        self.samples = 0
        self.pressure_injections = 0

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    def set_component(self, name: str, nbytes: int) -> None:
        if name not in COMPONENTS:
            raise ValueError(
                f"unknown memory component {name!r} (not in COMPONENTS)"
            )
        with self._lock:
            self._components[name] = max(0, int(nbytes))

    def components(self) -> dict[str, int]:
        with self._lock:
            return dict(self._components)

    def total(self) -> int:
        with self._lock:
            return sum(self._components.values())

    def sample(self) -> str:
        """One accounting sample: sum components, step the ladder, cache
        the verdict. The ``mem.pressure`` fault point fires here (phase
        ``sample``); a ``raise`` rule is caught and read as a synthetic
        at-high-watermark sample, a ``crash`` rule kills the rank as
        usual."""
        synthetic = False
        try:
            fault_point("mem.pressure", phase="sample")
        except InjectedFault:
            synthetic = True
        with self._lock:
            total = sum(self._components.values())
            if synthetic and self.enabled:
                self.pressure_injections += 1
                total = max(total, self.high_bytes)
            prev = self.state
            state = self._ladder(
                total,
                self.low_bytes,
                self.high_bytes,
                self.budget_bytes,
                prev=prev,
                over_streak=self.over_streak,
                abort_streak=self.abort_streak,
            )
            if self.enabled and total >= self.budget_bytes:
                self.over_streak += 1
            else:
                self.over_streak = 0
            self.total_bytes = total
            self.peak_bytes = max(self.peak_bytes, total)
            self.state = state
            self.samples += 1
            return state

    def reset(self) -> None:
        """Post-restore reset: a rolled-back epoch starts over with a
        fresh ladder (this is the ONLY exit from the sticky ``abort``
        rung) — the restored components re-report their real sizes on
        the next cadence."""
        with self._lock:
            self._components.clear()
            self.state = "ok"
            self.total_bytes = 0
            self.over_streak = 0


# -- the process-current accountant -----------------------------------------
# One runtime owns one accountant; the serving gateway and the exchange
# layer reach it through this slot rather than threading a handle through
# every constructor. ``None`` (no runtime, or governance never installed)
# reads as "disabled" everywhere.

_current: MemoryAccountant | None = None
_current_lock = threading.Lock()


def install(acct: MemoryAccountant | None) -> None:
    global _current
    with _current_lock:
        _current = acct


def current() -> MemoryAccountant | None:
    return _current


def ladder_state() -> str:
    """The cached ladder verdict, ``"ok"`` when no accountant is
    installed — the cheap read serving admission uses per request."""
    acct = _current
    return acct.state if acct is not None else "ok"
