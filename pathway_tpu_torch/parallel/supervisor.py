"""Mesh supervisor: rollback-recovery driver for multi-rank runs.

The recovery model is coordinated rollback (Carbone et al., "Lightweight
Asynchronous Snapshots for Distributed Dataflows" — the same model
Flink's checkpoint/restart implements; failure semantics as in Naiad,
Murray et al. SOSP'13): the engine takes lockstep distributed snapshots
(engine/runtime.py ``_save_operator_snapshot_distributed``) whose commit
marker only advances once EVERY rank's rank-local snapshot is durable.
When any rank dies, the surviving ranks *detect* it (procgroup.py
heartbeats, peer timeouts, bounded collectives), *abort the epoch* —
drain in-flight frames, close the mesh, exit with
:data:`MESH_RESTART_EXIT_CODE` instead of deadlocking mid-wave — and
this supervisor *rolls the mesh back*: it reaps the whole rank set and
respawns it at ``epoch+1``. The fresh processes re-handshake the mesh
(the epoch is bound into the procgroup handshake, so a straggler from
the dead epoch can never rejoin), restore the last committed snapshot
via the ``snapshot_commit`` marker path, rewind their connectors to the
saved scan states, and resume. With a durable upsert sink (the
operator-persistence contract), recovered output is bit-identical to an
uninterrupted run — pinned by tests/test_fault_injection.py and the
``scripts/fault_matrix.py`` mesh grid.

Why whole-mesh rollback rather than surgically restarting only the dead
rank: the surviving ranks' in-memory operator state has advanced past
the last committed cut (uncommitted timestamps, half-delivered waves),
and connector subjects are arbitrary user code mid-``run()`` that cannot
be rewound in place. Rolling every rank back to the committed cut is the
only state all ranks provably share — exactly the reference semantics of
asynchronous-barrier-snapshot systems.

Knobs: ``PATHWAY_MESH_MAX_RESTARTS`` (rollback budget, default 3),
``PATHWAY_MESH_GRACE_S`` (how long survivors get to self-detect and exit
before SIGKILL, default 20). ``PATHWAY_FAULT_PLAN`` is stripped from
respawned epochs by default so an injected crash behaves like the
transient fault it models (override with
``clear_fault_plan_on_restart=False`` to test deterministic-failure
budgets).

Usage::

    python -m pathway_tpu_torch.parallel.supervisor --processes 2 -- my_pipe.py

or programmatically::

    from pathway_tpu_torch.parallel.supervisor import MeshSupervisor
    rc = MeshSupervisor([sys.executable, "my_pipe.py"], processes=2).run()

This module's own imports are deliberately stdlib-only. Note that
``python -m pathway_tpu_torch.parallel.supervisor`` still executes the package
``__init__``s (a one-time jax import at supervisor startup); a driver
that must stay import-light can load this file directly by path —
``importlib.util.spec_from_file_location`` — which is exactly what
``scripts/fault_matrix.py`` does to share
:data:`MESH_RESTART_EXIT_CODE` and :func:`_free_port_base`.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Sequence

# the rollback decision (and the restart exit code it keys on) live in
# the shared protocol transition table that analysis/meshcheck.py
# model-checks (parallel/protocol.py). protocol.py is itself
# stdlib-only, so when THIS module was loaded by file path (the
# stdlib-light drivers: scripts/fault_matrix.py) it is loaded the same
# way — never through the package __init__s.
if __package__:
    from pathway_tpu_torch.parallel import protocol as _proto
else:  # pragma: no cover - exercised via scripts/fault_matrix.py
    import importlib.util as _ilu

    _spec = _ilu.spec_from_file_location(
        "_pw_mesh_protocol",
        os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "protocol.py"
        ),
    )
    _proto = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_proto)

# a surviving rank that detected a peer failure exits with this code to
# request a rollback restart (engine/runtime.py's supervised abort path);
# distinct from faults.CRASH_EXIT_CODE (27), which marks the injected
# crash itself
MESH_RESTART_EXIT_CODE = _proto.MESH_RESTART_EXIT_CODE

logger = logging.getLogger(__name__)

_cluster_mod = None


def _load_cluster_module():
    """internals/cluster.py loaded by file path (stdlib-only, like
    protocol.py above) and cached: the knob parse, port validation and
    the aggregator class all come from the ONE module the engine
    runtime also routes through — no drift between the two hosts of
    the /metrics/cluster view."""
    global _cluster_mod
    if _cluster_mod is None:
        import importlib.util as _ilu

        spec = _ilu.spec_from_file_location(
            "_pw_cluster",
            os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "internals", "cluster.py",
            ),
        )
        _cluster_mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(_cluster_mod)
    return _cluster_mod


def _free_port_base(n: int) -> int:
    """A base port with n consecutive free ports — each epoch gets a
    fresh range so late packets/TIME_WAIT of the dead epoch cannot
    collide with the recovered mesh's listeners.

    Probes bind with ``SO_REUSEADDR`` — the same option the mesh
    listeners themselves use — so a range is only rejected for ports
    another live socket actually owns, not for TIME_WAIT remnants of
    the epoch we just reaped (which the ranks' own REUSEADDR bind would
    sail past anyway). The whole range is held until every port proved
    bindable, shrinking the probe-to-bind race window; the residual
    race (an unrelated process grabbing a port between our close and
    the rank's bind) is absorbed by the ranks' bounded bind retry
    (procgroup ``_bind_listener``)."""
    for _ in range(64):
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind(("127.0.0.1", 0))
        base = probe.getsockname()[1]
        probe.close()
        if base + n > 65535:
            continue
        held = []
        try:
            for i in range(n):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", base + i))
                held.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
    raise RuntimeError("no consecutive free port range found")


class MeshSupervisor:
    """Spawn ``processes`` rank subprocesses running ``command`` and keep
    the set alive through rollback restarts.

    Every rank gets ``PATHWAY_PROCESSES`` / ``PATHWAY_PROCESS_ID`` /
    ``PATHWAY_FIRST_PORT`` plus ``PATHWAY_MESH_EPOCH`` (the rollback
    generation) and ``PATHWAY_MESH_SUPERVISED=1`` (tells the runtime to
    exit :data:`MESH_RESTART_EXIT_CODE` on a detected mesh failure
    instead of raising to the user). ``run()`` returns 0 once every rank
    of some epoch exits cleanly, or the first failing exit code once the
    restart budget is exhausted."""

    def __init__(
        self,
        command: Sequence[str],
        processes: int | None = None,
        *,
        max_restarts: int | None = None,
        grace_s: float | None = None,
        env: dict | None = None,
        clear_fault_plan_on_restart: bool = True,
        poll_s: float = 0.05,
        serve_frontend: int | None = None,
        serve_backend_port: int | None = None,
        cluster_metrics: int | None = None,
        rescale: int | None = None,
        rescale_ctl: str | None = None,
        autoscale: bool = False,
    ):
        if processes is None:
            processes = int(os.environ.get("PATHWAY_PROCESSES", "2") or 2)
        if max_restarts is None:
            max_restarts = int(
                os.environ.get("PATHWAY_MESH_MAX_RESTARTS", "3") or 3
            )
        if grace_s is None:
            grace_s = float(
                os.environ.get("PATHWAY_MESH_GRACE_S", "20") or 20
            )
        self.command = list(command)
        self.processes = processes
        self.max_restarts = max_restarts
        self.grace_s = grace_s
        self.env = env
        self.clear_fault_plan_on_restart = clear_fault_plan_on_restart
        self.poll_s = poll_s
        # epoch-survivable serving frontend: when a public
        # port is given, the supervisor owns the HTTP listener across
        # rollbacks — every epoch's gateway binds the loopback backend
        # port instead (PATHWAY_SERVE_BACKEND_PORT in the rank env) and
        # in-flight requests park at the frontend through the blip
        self.serve_frontend_port = serve_frontend
        self.serve_backend_port = serve_backend_port
        self.frontend = None
        # cluster metrics plane: like the serving frontend,
        # the supervisor owns the merged /metrics/cluster listener for
        # its WHOLE lifetime while epochs come and go — a rollback is a
        # scrape blip, not a dead dashboard. Default from the shared
        # PATHWAY_CLUSTER_METRICS_PORT knob (the ranks see the same var
        # but skip self-hosting under PATHWAY_MESH_SUPERVISED); parse
        # and bounds live in internals/cluster.py, shared with the
        # engine runtime's unsupervised host path.
        if cluster_metrics is None and os.environ.get(
            "PATHWAY_CLUSTER_METRICS_PORT", ""
        ).strip():
            cluster_metrics = _load_cluster_module().metrics_port_from_env()
        if cluster_metrics is not None and not _load_cluster_module(
        ).valid_port(cluster_metrics):
            logger.warning(
                "cluster metrics disabled: port %r outside 1..65535",
                cluster_metrics,
            )
            cluster_metrics = None
        self.cluster_metrics_port = cluster_metrics
        self.cluster = None
        # elastic mesh: a pending rescale target is a
        # VOLUNTARY rollback into a different world size — reap the
        # rank set, respawn M ranks at epoch+1; the fresh ranks restore
        # the committed cut re-sharded through the stable mint
        # (persistence/reshard.py). Never charged to the failure
        # restart budget. One-shot `rescale=` arms a target applied
        # once the first epoch is up; `rescale_ctl=` names a control
        # file polled for a target world size (`echo 4 > ctl`);
        # `autoscale=True` hosts the observatory-driven policy loop
        # (parallel/autoscale.py) that calls request_rescale itself.
        self._pending_rescale: int | None = rescale
        self.rescale_ctl = rescale_ctl
        self._ctl_seen: str | None = None
        self.autoscale = autoscale
        self.autoscaler = None
        self.rescales_performed = 0
        # exposed for tests/observability
        self.epoch = 0
        self.restarts_performed = 0
        self.history: list[list[int]] = []  # per-epoch exit codes

    def _start_frontend(self) -> None:
        """Bring the serving frontend up once, before epoch 0: it holds
        the public listener for the supervisor's whole lifetime while
        epochs come and go on the backend port. _frontend.py is loaded
        by file path like protocol.py above (stdlib-only), so
        file-path-loaded supervisors stay import-light."""
        if self.serve_frontend_port is None or self.frontend is not None:
            return
        if self.serve_backend_port is None:
            self.serve_backend_port = _free_port_base(1)
        import importlib.util as _ilu

        spec = _ilu.spec_from_file_location(
            "_pw_serve_frontend",
            os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "io", "http", "_frontend.py",
            ),
        )
        mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self.frontend = mod.ServingFrontend(
            host="0.0.0.0",
            port=self.serve_frontend_port,
            backend_port=self.serve_backend_port,
        ).start()
        logger.info(
            "mesh supervisor: serving frontend up on :%d (backend :%d)",
            self.serve_frontend_port,
            self.serve_backend_port,
        )

    def _start_cluster(self) -> None:
        """Bring the cluster metrics aggregator up once, before epoch 0:
        it scrapes every rank's OpenMetrics endpoint (20000 + rank) and
        serves the merged /metrics/cluster view across rollbacks.
        internals/cluster.py is loaded by file path like protocol.py
        above (stdlib-only), so file-path-loaded supervisors stay
        import-light."""
        if self.cluster_metrics_port is None or self.cluster is not None:
            return
        mod = _load_cluster_module()
        self.cluster = mod.ClusterMetricsAggregator.from_env(
            self.cluster_metrics_port, world=self.processes
        ).start()
        logger.info(
            "mesh supervisor: cluster metrics up on :%d "
            "(/metrics/cluster over %d ranks)",
            self.cluster_metrics_port,
            self.processes,
        )

    def _spawn_epoch(self, epoch: int) -> list[subprocess.Popen]:
        port = _free_port_base(self.processes)
        # the serve backend port is FREE at respawn time (the dead
        # epoch's gateway just released it) — a mesh range swallowing it
        # would leave epoch+1's gateway with EADDRINUSE while the
        # frontend's attach probe happily connects to a mesh listener
        while self.serve_backend_port is not None and (
            port <= self.serve_backend_port < port + self.processes
        ):
            port = _free_port_base(self.processes)
        procs = []
        for rank in range(self.processes):
            env = dict(os.environ)
            if self.env:
                env.update(self.env)
            env.update(
                PATHWAY_PROCESSES=str(self.processes),
                PATHWAY_PROCESS_ID=str(rank),
                PATHWAY_FIRST_PORT=str(port),
                PATHWAY_MESH_EPOCH=str(epoch),
                PATHWAY_MESH_SUPERVISED="1",
            )
            if self.cluster_metrics_port is not None:
                # ranks must serve their per-rank /metrics endpoints for
                # the aggregator to scrape; the knob force-enables them
                # (they skip SELF-hosting the cluster view because
                # PATHWAY_MESH_SUPERVISED is set — this supervisor owns it)
                env["PATHWAY_CLUSTER_METRICS_PORT"] = str(
                    self.cluster_metrics_port
                )
            if self.serve_backend_port is not None:
                env["PATHWAY_SERVE_BACKEND_PORT"] = str(
                    self.serve_backend_port
                )
                if self.serve_frontend_port is not None:
                    # scopes the gateway's backend rewrite to the ONE
                    # webserver bound to the frontend's public port
                    env["PATHWAY_SERVE_PUBLIC_PORT"] = str(
                        self.serve_frontend_port
                    )
            # emulated-lane inheritance would turn real ranks back into
            # thread companions
            env.pop("PATHWAY_LANE_PROCESSES", None)
            if epoch > 0 and self.clear_fault_plan_on_restart:
                env.pop("PATHWAY_FAULT_PLAN", None)
            procs.append(subprocess.Popen(self.command, env=env))
        return procs

    # -- elastic mesh -------------------------------------------
    def request_rescale(self, target: int, reason: str = "manual") -> bool:
        """Arm a rescale to ``target`` ranks (thread-safe: the
        autoscaler loop and operators call this; the run loop performs
        it). The target is clamped through the shared
        ``protocol.rescale_plan`` transition; a no-op target (equal to
        the current world after clamping) is ignored. Returns whether a
        rescale was armed."""
        new_world = _proto.rescale_plan(self.processes, target)
        if new_world == self.processes:
            return False
        logger.info(
            "mesh supervisor: rescale %d -> %d ranks armed (%s)",
            self.processes, new_world, reason,
        )
        self._pending_rescale = new_world
        return True

    def _poll_rescale_ctl(self) -> None:
        """``--rescale-ctl FILE``: a target world size written to the
        control file arms a rescale (the rescale_smoke lane drives the
        2→4→2 sequence through this). Content is re-read per poll;
        unparsable content is ignored until it changes."""
        if self.rescale_ctl is None:
            return
        try:
            with open(self.rescale_ctl) as f:
                raw = f.read().strip()
        except OSError:
            return
        if not raw or raw == self._ctl_seen:
            return
        self._ctl_seen = raw
        try:
            target = int(raw)
        except ValueError:
            logger.warning(
                "mesh supervisor: rescale control file %r holds %r — "
                "not a world size", self.rescale_ctl, raw,
            )
            return
        self.request_rescale(target, reason="control file")

    def _perform_rescale(
        self, procs: list[subprocess.Popen], new_world: int
    ) -> None:
        """Execute an armed rescale: a voluntary rollback into a
        different world size. The serving frontend is told FIRST so the
        detached-backend window reads ``rescaling`` (and sizes
        Retry-After from the rescale EWMA, not the crash one); on a
        shrink the cluster plane takes a final scrape so departed
        ranks' last samples survive marked stale."""
        old_world = self.processes
        logger.warning(
            "mesh supervisor: rescaling %d -> %d ranks (epoch %d -> %d): "
            "reaping the rank set at the committed snapshot cut; the "
            "fresh world restores it re-sharded",
            old_world, new_world, self.epoch, self.epoch + 1,
        )
        if self.frontend is not None:
            try:
                self.frontend.note_rescale()
            except Exception:
                pass
        if self.cluster is not None and new_world < old_world:
            try:
                self.cluster.scrape_once()
            except Exception:
                pass
        codes = self._reap(procs, 0.0)
        self.history.append(codes)
        self.processes = new_world
        self.epoch += 1
        self.rescales_performed += 1

    def _start_autoscaler(self) -> None:
        """Host the observatory-driven autoscaler (parallel/autoscale.py,
        loaded by file path like protocol.py so file-path-loaded
        supervisors stay import-light). It watches the cluster metrics
        plane and the serving frontend this supervisor already owns and
        calls :meth:`request_rescale` under the registered
        autoscale knobs (analysis/knobs.py)."""
        if not self.autoscale or self.autoscaler is not None:
            return
        import importlib.util as _ilu

        spec = _ilu.spec_from_file_location(
            "_pw_autoscale",
            os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "autoscale.py"
            ),
        )
        mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self.autoscaler = mod.Autoscaler.from_env(self).start()
        logger.info(
            "mesh supervisor: autoscaler up (%s)",
            self.autoscaler.config.describe(),
        )

    @staticmethod
    def _reap(procs: list[subprocess.Popen], grace_s: float) -> list[int]:
        """Give survivors the grace window to self-detect the failure and
        exit on their own (their exit code then records WHAT they saw),
        then SIGKILL stragglers. Returns the final exit codes."""
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and any(
            p.poll() is None for p in procs
        ):
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGKILL)
                except OSError:
                    pass
        return [p.wait() for p in procs]

    def run(self) -> int:
        """Returns 0 once every rank of some epoch exits cleanly. The
        rank set never outlives the supervisor: any exit from this
        method — including SystemExit from a signal handler or an
        unexpected exception mid-loop — SIGKILLs the live children, so a
        stopped deployment cannot leave a detached mesh advancing the
        shared persistence state behind the operator's back."""
        procs: list[subprocess.Popen] = []
        try:
            return self._run(procs)
        finally:
            if self.autoscaler is not None:
                try:
                    self.autoscaler.stop()
                except Exception:
                    pass
                self.autoscaler = None
            if self.frontend is not None:
                # shed new arrivals (Retry-After) while the rank set
                # winds down, then release the public listener
                try:
                    self.frontend.drain()
                except Exception:
                    pass
            for p in procs:
                if p.poll() is None:
                    try:
                        p.send_signal(signal.SIGKILL)
                    except OSError:
                        pass
            for p in procs:
                if p.poll() is None:
                    p.wait()
            if self.frontend is not None:
                try:
                    self.frontend.stop()
                except Exception:
                    pass
                self.frontend = None
            if self.cluster is not None:
                # final scrape first: the shutdown snapshot (skew,
                # totals) should cover the rank set's last breath
                try:
                    self.cluster.stop(final_scrape=True)
                except Exception:
                    pass
                self.cluster = None
            self._merge_trace_fallback()

    def _merge_trace_fallback(self) -> None:
        """Flight-recorder fallback merge: rank 0 normally merges the
        per-rank trace partials at its own shutdown, but a rolled-back
        (or crashed-after-dump) epoch leaves partials behind — including
        the aborting epoch's rollback marks, which are exactly what a
        post-mortem wants. Best-effort, stdlib-light: flight.py is
        loaded by file path like protocol.py above, so file-path-loaded
        supervisors (scripts/fault_matrix.py) never touch the package
        __init__s."""
        path = os.environ.get("PATHWAY_TRACE")
        if not path:
            return
        if not any(
            os.path.exists(f"{path}.r{r}") for r in range(self.processes)
        ):
            return
        try:
            import importlib.util as _ilu

            spec = _ilu.spec_from_file_location(
                "_pw_flight",
                os.path.join(
                    os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)
                    )),
                    "internals", "flight.py",
                ),
            )
            flight = _ilu.module_from_spec(spec)
            spec.loader.exec_module(flight)
            merged = flight.merge_trace_files(path, self.processes)
            if merged:
                logger.info(
                    "mesh supervisor: merged leftover trace partials "
                    "into %s", merged,
                )
        except Exception:
            logger.warning(
                "mesh supervisor: trace partial merge failed",
                exc_info=True,
            )

    def _run(self, procs: list[subprocess.Popen]) -> int:
        self._start_frontend()
        self._start_cluster()
        self._start_autoscaler()
        while True:
            procs[:] = self._spawn_epoch(self.epoch)
            if self.cluster is not None:
                # re-resolve rank endpoints for the fresh epoch: ports
                # are stable (20000 + rank) but scrape health resets and
                # the view stamps the new epoch (and, across a rescale,
                # the new world size), so a rolled-back rank's
                # pre-rollback counters read as stale, not current
                self.cluster.set_endpoints(
                    self.cluster.default_endpoints(self.processes),
                    epoch=self.epoch,
                )
            logger.info(
                "mesh supervisor: epoch %d up (%d ranks)",
                self.epoch,
                self.processes,
            )
            rescaled = False
            while True:
                codes = [p.poll() for p in procs]
                if any(c is not None and c != 0 for c in codes):
                    break
                if all(c == 0 for c in codes):
                    self.history.append([0] * len(procs))
                    logger.info(
                        "mesh supervisor: epoch %d finished cleanly",
                        self.epoch,
                    )
                    return 0
                self._poll_rescale_ctl()
                pending = self._pending_rescale
                if pending is not None:
                    self._pending_rescale = None
                    new_world = _proto.rescale_plan(
                        self.processes, pending
                    )
                    if new_world != self.processes:
                        self._perform_rescale(procs, new_world)
                        rescaled = True
                        break
                time.sleep(self.poll_s)
            if rescaled:
                continue
            codes = self._reap(procs, self.grace_s)
            self.history.append(codes)
            # the rollback-vs-give-up verdict over a reaped epoch is a
            # protocol decision (parallel/protocol.py supervisor_decide,
            # model-checked by analysis/meshcheck.py): give_up prefers a
            # failing rank's own exit code over MESH_RESTART_EXIT_CODE
            # (survivors merely REPORTING the failure) — returning 28
            # would tell an outer orchestrator "retryable rollback
            # request" about a deterministically failing deployment
            verdict, payload = _proto.supervisor_decide(
                codes, self.restarts_performed, self.max_restarts
            )
            if verdict == "done":  # every straggler exited 0 during reap
                logger.info(
                    "mesh supervisor: epoch %d finished cleanly",
                    self.epoch,
                )
                return 0
            if verdict == "give_up":
                logger.error(
                    "mesh supervisor: epoch %d failed (exit codes %s) "
                    "and the restart budget (%d) is exhausted",
                    self.epoch,
                    codes,
                    self.max_restarts,
                )
                return payload
            self.restarts_performed += 1
            self.epoch += payload
            logger.warning(
                "mesh supervisor: epoch %d failed (exit codes %s; %d = "
                "rollback requested) — rolling back to the last committed "
                "snapshot as epoch %d (restart %d/%d)",
                self.epoch - 1,
                codes,
                MESH_RESTART_EXIT_CODE,
                self.epoch,
                self.restarts_performed,
                self.max_restarts,
            )


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        usage=(
            "python -m pathway_tpu_torch.parallel.supervisor "
            "[--processes N] [--max-restarts M] [--grace S] -- "
            "program.py [args...]"
        ),
    )
    ap.add_argument("--processes", type=int, default=None)
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--grace", type=float, default=None)
    ap.add_argument(
        "--serve-frontend", type=int, default=None, metavar="PORT",
        help="own this public HTTP port across rollbacks: epochs bind a "
        "loopback backend port (PATHWAY_SERVE_BACKEND_PORT) and "
        "in-flight requests park/replay through mesh restarts",
    )
    ap.add_argument(
        "--serve-backend-port", type=int, default=None,
        help="explicit backend port for --serve-frontend (default: a "
        "free port probed at startup)",
    )
    ap.add_argument(
        "--cluster-metrics", type=int, default=None, metavar="PORT",
        help="serve the merged /metrics/cluster view on this port across "
        "rollbacks: every rank's OpenMetrics endpoint (20000 + rank) is "
        "scraped and re-labeled with rank=..., plus derived "
        "mesh_skew_seconds / scaling_efficiency gauges (default: the "
        "PATHWAY_CLUSTER_METRICS_PORT knob)",
    )
    ap.add_argument(
        "--rescale", type=int, default=None, metavar="M",
        help="one-shot elastic rescale: once the mesh is up, roll it "
        "back into M ranks at epoch+1 — the committed snapshot cut is "
        "restored re-sharded through the stable mint "
        "(persistence/reshard.py); requires OPERATOR_PERSISTING "
        "persistence for stateful pipelines",
    )
    ap.add_argument(
        "--rescale-ctl", default=None, metavar="FILE",
        help="poll FILE for a target world size: `echo 4 > FILE` "
        "rescales the running mesh to 4 ranks (the rescale_smoke lane "
        "drives 2→4→2 through this)",
    )
    ap.add_argument(
        "--autoscale", action="store_true",
        help="host the observatory-driven autoscaler "
        "(parallel/autoscale.py): serve backlog/park pressure up grows "
        "the mesh, scaling_efficiency below threshold shrinks it, under "
        "the autoscale knobs (PATHWAY_AUTOSCALE_MIN / "
        "PATHWAY_AUTOSCALE_MAX / PATHWAY_AUTOSCALE_COOLDOWN_S / "
        "PATHWAY_AUTOSCALE_BUDGET / PATHWAY_AUTOSCALE_HYSTERESIS); "
        "pairs with --cluster-metrics and --serve-frontend",
    )
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = list(args.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given")
    if cmd[0].endswith(".py"):
        cmd = [sys.executable] + cmd
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    # a plain `kill <supervisor-pid>` must take the rank set down with
    # it: SystemExit unwinds through run()'s finally, which reaps the
    # children (SIGINT already reaches the foreground process group)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    return MeshSupervisor(
        cmd,
        args.processes,
        max_restarts=args.max_restarts,
        grace_s=args.grace,
        serve_frontend=args.serve_frontend,
        serve_backend_port=args.serve_backend_port,
        cluster_metrics=args.cluster_metrics,
        rescale=args.rescale,
        rescale_ctl=args.rescale_ctl,
        autoscale=args.autoscale,
    ).run()


if __name__ == "__main__":
    sys.exit(main())
