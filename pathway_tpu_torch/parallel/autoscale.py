"""Observatory-driven autoscaler: capacity follows load.

The policy loop composes the two planes earlier PRs built: the cluster
metrics observatory (``internals/cluster.py`` — ``scaling_efficiency``,
per-rank throughput) and the epoch-survivable serving frontend
(``io/http/_frontend.py`` — parked requests, shed/Retry-After
pressure). Each tick it folds those signals into one observation and
drives the **pure** ``protocol.autoscale_decide`` transition:

* serving pressure (parked + newly shed requests) at or above
  ``PATHWAY_AUTOSCALE_GROW_PRESSURE`` for
  ``PATHWAY_AUTOSCALE_HYSTERESIS`` consecutive ticks → grow (double,
  capped at ``PATHWAY_AUTOSCALE_MAX``);
* zero pressure with ``scaling_efficiency`` below
  ``PATHWAY_AUTOSCALE_SHRINK_EFFICIENCY`` for the same streak → shrink
  (halve, floored at ``PATHWAY_AUTOSCALE_MIN``) — BENCH round 5
  measured 0.137 efficiency at 4 ranks for wordcount: running wide when
  narrow suffices burns most of the pod;
* every rescale starts a ``PATHWAY_AUTOSCALE_COOLDOWN_S`` window during
  which the policy holds (streaks re-accumulate against the NEW world),
  and ``PATHWAY_AUTOSCALE_BUDGET`` bounds the total number of rescales
  per supervisor lifetime — a flapping signal cannot thrash the mesh.

The verdict lands in :meth:`MeshSupervisor.request_rescale`, which
executes the rollback-into-M-ranks transition (reap at the committed
cut, respawn at epoch+1, re-sharded restore). The decision function
itself lives in ``parallel/protocol.py`` so tests and the model checker
pin the policy without a live mesh.

This module is deliberately **stdlib-only and file-path-loadable**
(like protocol.py / _frontend.py / cluster.py): the supervisor loads it
without executing the package ``__init__``s, keeping import-light
drivers jax-free.
"""

from __future__ import annotations

import os
import threading
import urllib.request

if __package__:
    from pathway_tpu_torch.parallel import protocol as _proto
else:  # pragma: no cover - file-path load (supervisor)
    import importlib.util as _ilu

    _spec = _ilu.spec_from_file_location(
        "_pw_mesh_protocol",
        os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "protocol.py"
        ),
    )
    _proto = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_proto)


def _env_num(name: str, default, cast):
    try:
        raw = os.environ.get(name, "")
        return cast(raw) if raw.strip() else default
    except ValueError:
        return default


class AutoscaleConfig:
    """The knob family (registered in analysis/knobs.py; README table).

    Full knob names (the registry's coverage test greps for them):
    PATHWAY_AUTOSCALE_MIN, PATHWAY_AUTOSCALE_MAX,
    PATHWAY_AUTOSCALE_COOLDOWN_S, PATHWAY_AUTOSCALE_INTERVAL_S,
    PATHWAY_AUTOSCALE_BUDGET, PATHWAY_AUTOSCALE_GROW_PRESSURE,
    PATHWAY_AUTOSCALE_SHRINK_EFFICIENCY, PATHWAY_AUTOSCALE_HYSTERESIS.

    Plain class, not a dataclass: the supervisor loads this module by
    FILE PATH (no sys.modules entry), where the dataclass decorator's
    module lookup breaks on 3.10."""

    def __init__(
        self,
        min_world: int = 1,
        max_world: int = 8,
        cooldown_s: float = 30.0,
        interval_s: float = 2.0,
        budget: int = 4,
        grow_pressure: float = 1.0,
        shrink_efficiency: float = 0.35,
        hysteresis: int = 2,
    ):
        self.min_world = min_world
        self.max_world = max_world
        self.cooldown_s = cooldown_s
        self.interval_s = interval_s
        self.budget = budget
        self.grow_pressure = grow_pressure
        self.shrink_efficiency = shrink_efficiency
        self.hysteresis = hysteresis

    @classmethod
    def from_env(cls) -> "AutoscaleConfig":
        return cls(
            min_world=_env_num("PATHWAY_AUTOSCALE_MIN", 1, int),
            max_world=_env_num("PATHWAY_AUTOSCALE_MAX", 8, int),
            cooldown_s=_env_num("PATHWAY_AUTOSCALE_COOLDOWN_S", 30.0, float),
            interval_s=_env_num("PATHWAY_AUTOSCALE_INTERVAL_S", 2.0, float),
            budget=_env_num("PATHWAY_AUTOSCALE_BUDGET", 4, int),
            grow_pressure=_env_num(
                "PATHWAY_AUTOSCALE_GROW_PRESSURE", 1.0, float
            ),
            shrink_efficiency=_env_num(
                "PATHWAY_AUTOSCALE_SHRINK_EFFICIENCY", 0.35, float
            ),
            hysteresis=_env_num("PATHWAY_AUTOSCALE_HYSTERESIS", 2, int),
        )

    def describe(self) -> str:
        return (
            f"world [{self.min_world}..{self.max_world}], "
            f"grow at pressure>={self.grow_pressure:g}, shrink below "
            f"efficiency {self.shrink_efficiency:g}, hysteresis "
            f"{self.hysteresis}, cooldown {self.cooldown_s:g}s, budget "
            f"{self.budget}"
        )


class Observation:
    """One tick's folded signals; kept explicit so tests drive
    :meth:`Autoscaler.step` with synthetic observations."""

    __slots__ = ("pressure", "efficiency")

    def __init__(self, pressure: float, efficiency: float | None):
        self.pressure = pressure
        self.efficiency = efficiency


class Autoscaler:
    """The impure half: signal collection + streak/cooldown/budget
    bookkeeping around the pure ``autoscale_decide`` transition."""

    def __init__(self, supervisor, config: AutoscaleConfig, clock=None):
        import time as _time

        self.supervisor = supervisor
        self.config = config
        self.clock = clock or _time.monotonic
        self.budget_remaining = config.budget
        self.grow_streak = 0
        self.shrink_streak = 0
        self.cooldown_until = 0.0
        self.decisions: list[tuple[str, int]] = []  # observability
        self._last_shed: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @classmethod
    def from_env(cls, supervisor) -> "Autoscaler":
        return cls(supervisor, AutoscaleConfig.from_env())

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._loop, name="pw-autoscale", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                obs = self.observe()
                if obs is not None:
                    self.step(obs)
            except Exception:
                pass  # a broken scrape must never take the mesh down

    # -- signal collection --------------------------------------------------
    def observe(self) -> Observation | None:
        """Fold the frontend's demand signals and the observatory's
        efficiency gauge into one observation. The supervisor hosts
        both objects in-process; a standalone deployment can subclass
        and scrape ``/metrics`` + ``/metrics/cluster`` over HTTP
        (:func:`scrape_gauge` is the helper)."""
        sup = self.supervisor
        pressure = 0.0
        fe = getattr(sup, "frontend", None)
        if fe is not None:
            try:
                pressure += float(len(fe._parked))
                shed = float(fe.metrics.shed)
                if self._last_shed is not None:
                    pressure += max(0.0, shed - self._last_shed)
                self._last_shed = shed
            except Exception:
                pass
        efficiency = None
        cl = getattr(sup, "cluster", None)
        if cl is not None:
            try:
                efficiency = cl.derived().get("scaling_efficiency")
            except Exception:
                pass
        return Observation(pressure, efficiency)

    # -- the policy step ----------------------------------------------------
    def step(self, obs: Observation) -> tuple[str, int]:
        """One tick: update hysteresis streaks, drive the shared
        ``autoscale_decide`` transition, and (on grow/shrink) arm the
        supervisor's rescale — consuming cooldown and budget."""
        c = self.config
        world = self.supervisor.processes
        self.grow_streak = (
            self.grow_streak + 1 if obs.pressure >= c.grow_pressure else 0
        )
        self.shrink_streak = (
            self.shrink_streak + 1
            if (
                obs.pressure <= 0
                and obs.efficiency is not None
                and obs.efficiency < c.shrink_efficiency
            )
            else 0
        )
        verdict, target = _proto.autoscale_decide(
            world,
            c.min_world,
            c.max_world,
            obs.pressure,
            c.grow_pressure,
            obs.efficiency,
            c.shrink_efficiency,
            self.grow_streak,
            self.shrink_streak,
            c.hysteresis,
            max(0.0, self.cooldown_until - self.clock()),
            self.budget_remaining,
        )
        if verdict != "hold" and self.supervisor.request_rescale(
            target, reason=f"autoscale {verdict}"
        ):
            self.budget_remaining -= 1
            self.cooldown_until = self.clock() + c.cooldown_s
            self.grow_streak = 0
            self.shrink_streak = 0
            self.decisions.append((verdict, target))
        return verdict, target


def scrape_gauge(url: str, name: str, timeout: float = 2.0) -> float | None:
    """Read one gauge off an OpenMetrics endpoint (standalone
    deployments watching /metrics/cluster over HTTP)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            text = r.read().decode("utf-8", "replace")
    except OSError:
        return None
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            try:
                return float(line.rsplit(" ", 1)[1])
            except ValueError:
                continue
    return None
