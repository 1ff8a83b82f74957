"""Cluster metrics plane: one merged view over every rank.

Per-rank OpenMetrics endpoints (``internals/monitoring.py``, port
``20000 + process_id``) are islands: nothing aggregates them, so
multi-rank runs have no single place that answers "where is the mesh's
wall-clock going" — the visibility ROADMAP item 3 needs before the mesh
scales past 2 ranks. This module is the aggregation layer:
:class:`ClusterMetricsAggregator` periodically scrapes every rank's
``/metrics``, relabels each sample with ``rank="r"``, and serves ONE
merged ``/metrics/cluster`` view plus derived cluster gauges:

* ``cluster_ranks`` / ``cluster_ranks_expected`` — live-scraped vs
  configured world size (a rank that misses a scrape drops out of the
  view but its last-seen samples are retained and marked stale);
* ``mesh_skew_seconds`` — max−min across ranks of cumulative exchange
  recv-wait. Semantics: every wave ends in a rendezvous, so the rank
  that finishes its own work LAST waits least and everyone else's wait
  absorbs the spread — the cumulative (max−min) of per-rank recv-wait
  is the total per-wave finish spread the fastest rank lost to the
  slowest. (Exact per-wave skew lives in the trace-based analyzer,
  ``python -m pathway_tpu_torch.analysis --critical-path``.)
* ``cluster_rows_per_s`` — ingest throughput over the aggregator's own
  observation window (Δ connector rows / Δ time between scrapes);
* ``scaling_efficiency`` — ``cluster_rows_per_s / (baseline × world)``
  when a 1-rank baseline is configured
  (``PATHWAY_CLUSTER_BASELINE_ROWS_PER_S``); 1.0 = perfect linear
  scaling, the number every scaling PR is judged on;
* the exchange **byte matrix**: per-rank ``exchange_peer_bytes_total``
  samples pass through with the scraping rank's label added, so
  ``{rank="0",peer="1"}`` reads "bytes rank 0 shipped to rank 1".

Ownership: the :class:`~pathway_tpu_torch.parallel.supervisor.MeshSupervisor`
hosts the aggregator ACROSS epochs when it owns the rank set
(``--cluster-metrics PORT``) — rank endpoints are re-resolved on every
respawn, so a rollback is a scrape blip, not a dead dashboard. An
unsupervised multi-rank run hosts it on rank 0 instead
(``PATHWAY_CLUSTER_METRICS_PORT``, engine/runtime.py
``_start_monitoring``), which also feeds the TUI dashboard's per-rank
section via :meth:`ClusterMetricsAggregator.summary`.

This module is deliberately stdlib-only and file-path-loadable (like
``parallel/protocol.py`` and ``io/http/_frontend.py``): the supervisor
loads it without executing the package ``__init__``s, keeping
import-light drivers (scripts/fault_matrix.py) jax-free.
"""

from __future__ import annotations

import http.server
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Iterable

# metric families whose per-rank samples the cluster view re-exports
# with a rank label. Everything else a rank serves is reachable on the
# rank's own endpoint; the cluster view curates the cross-rank story
# (where did the wall-clock go, who talks to whom, who is behind).
PASSTHROUGH_FAMILIES = (
    "connector_rows_total",
    "output_rows_total",
    "exchange_frames_total",
    "exchange_bytes_total",
    # fast wire: frame bytes before/after the wire codec —
    # the cross-rank compression-effectiveness story
    "exchange_uncompressed_bytes_total",
    "exchange_compressed_bytes_total",
    "exchange_peer_frames_total",
    "exchange_peer_bytes_total",
    "exchange_peer_uncompressed_bytes_total",
    "exchange_peer_compressed_bytes_total",
    "mesh_tree_depth",
    "exchange_comms_seconds_total",
    "exchange_compute_seconds_total",
    "exchange_recv_wait_seconds_total",
    "exchange_peer_recv_wait_seconds_total",
    "exchange_waves_total",
    "exchange_wave_seconds_total",
    "exchange_fallbacks_total",
    "nb_fallbacks_total",
    # columnar egress: which ranks deliver Arrow batches vs
    # row-expand at their sinks (partitioned sinks write on every rank)
    "capture_arrow_batches_total",
    "capture_arrow_rows_total",
    "capture_rows_expanded_total",
    "sink_egress_seconds_total",
    # device plane: which ranks' accelerators are busy, at
    # what MFU, and whether any rank's trace ring is dropping events
    "device_dispatches_total",
    "device_dispatch_seconds_total",
    "device_wall_seconds_total",
    "device_flops_total",
    "device_flops_effective_total",
    "device_transfer_bytes_total",
    "device_recompiles_total",
    "device_mfu",
    "device_mfu_padded",
    "device_hbm_live_bytes",
    "device_hbm_peak_bytes",
    "device_queue_depth",
    "device_hbm_stats_available",
    "device_peak_flops",
    "device_site_dispatches_total",
    "device_site_dispatch_seconds_total",
    "device_site_wall_seconds_total",
    "device_site_flops_total",
    "device_site_flops_effective_total",
    "device_site_queue_depth_total",
    "device_site_recompiles_total",
    # device fault domain: which rank is retrying, tripping
    # its watchdog, refusing growth, or paying restore time — per rank
    "device_dispatch_retries_total",
    "device_dispatch_failures_total",
    "device_watchdog_trips_total",
    "device_oom_events_total",
    "device_index_restore_seconds_total",
    "device_index_snapshot_bytes_total",
    "index_filter_errors_total",
    "device_site_dispatch_retries_total",
    "device_site_dispatch_failures_total",
    "device_site_watchdog_trips_total",
    "device_site_oom_events_total",
    "trace_dropped_events_total",
    "runtime_idle_seconds_total",
    "mesh_heartbeats_missed_total",
    "mesh_rank_restarts_total",
    "mesh_rollbacks_total",
    "mesh_last_committed_epoch",
    # backpressure plane: which rank is under memory
    # pressure, how deep into its budget, and which connectors are
    # paced — the engage/release story the backpressure lane watches
    "mem_pressure_state",
    "mem_total_bytes",
    "mem_peak_bytes",
    "mem_budget_bytes",
    "mem_pressure_injections_total",
    "mem_component_bytes",
    "connector_paused",
    "connector_paused_seconds_total",
)


def valid_port(port) -> bool:
    return isinstance(port, int) and 1 <= port <= 65535


def metrics_port_from_env() -> int | None:
    """The one parse of PATHWAY_CLUSTER_METRICS_PORT (the runtime and
    the supervisor both route through this module — no drift): unset,
    unparsable or out-of-range reads as off. The knob registry
    (analysis/knobs.py) rejects bad values at engine startup with a
    rich error; this guard covers the paths that do not validate the
    environment (file-path-loaded supervisors)."""
    raw = os.environ.get("PATHWAY_CLUSTER_METRICS_PORT", "")
    try:
        port = int(raw) if raw.strip() else None
    except ValueError:
        return None
    return port if port is not None and valid_port(port) else None


def parse_openmetrics(text: str) -> list[tuple[str, dict, float]]:
    """Minimal OpenMetrics text parser: ``(name, labels, value)`` per
    sample line. Skips comments/TYPE lines and anything unparsable
    (histograms' bucket lines parse fine — ``le`` is just a label)."""
    out: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, _, raw_val = line.rpartition(" ")
            value = float(raw_val)
            labels: dict = {}
            if "{" in head:
                name, _, rest = head.partition("{")
                body = rest.rsplit("}", 1)[0]
                for part in _split_labels(body):
                    k, _, v = part.partition("=")
                    labels[k.strip()] = v.strip().strip('"')
            else:
                name = head
            name = name.strip()
            if name:
                out.append((name, labels, value))
        except ValueError:
            continue
    return out


def _split_labels(body: str) -> Iterable[str]:
    """Split ``a="x",b="y"`` on commas outside quotes."""
    part, quoted = [], False
    for ch in body:
        if ch == '"':
            quoted = not quoted
        if ch == "," and not quoted:
            yield "".join(part)
            part = []
        else:
            part.append(ch)
    if part:
        yield "".join(part)


def render_sample(name: str, labels: dict, value: float) -> str:
    lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
    val = f"{value:g}" if value != int(value) else str(int(value))
    return f"{name}{{{lab}}} {val}" if lab else f"{name} {val}"


class _RankState:
    """Last successful scrape of one rank. ``departed`` marks a rank a
    shrink rescale removed from the world: its endpoint is
    gone, its final-scrape samples are retained and served with
    ``stale="1"`` so the dashboards keep the departed rank's last
    totals instead of watching them vanish."""

    __slots__ = ("samples", "scraped_at", "stale", "errors", "departed")

    def __init__(self):
        self.samples: list[tuple[str, dict, float]] = []
        self.scraped_at: float = 0.0
        self.stale = True
        self.errors = 0
        self.departed = False


class ClusterMetricsAggregator:
    """Scrape every rank's ``/metrics``; serve ``/metrics/cluster``.

    ``endpoints`` maps rank -> URL; :meth:`set_endpoints` re-resolves
    them (the supervisor calls it on every epoch respawn — rank metric
    ports are stable at ``20000 + process_id``, but re-resolving resets
    scrape health and stamps the new epoch so a rolled-back rank's
    stale sample set is marked rather than trusted)."""

    def __init__(
        self,
        port: int,
        endpoints: dict[int, str],
        *,
        interval_s: float = 2.0,
        baseline_rows_per_s: float | None = None,
        timeout_s: float = 2.0,
        host: str = "0.0.0.0",
    ):
        self.port = port
        self.host = host
        self.interval_s = max(0.05, float(interval_s))
        self.baseline_rows_per_s = baseline_rows_per_s
        self.timeout_s = timeout_s
        self._endpoints = dict(endpoints)
        self._ranks: dict[int, _RankState] = {
            r: _RankState() for r in self._endpoints
        }
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._server: http.server.ThreadingHTTPServer | None = None
        self.epoch = 0
        # observation window for cluster_rows_per_s: (monotonic, rows)
        # at the first and latest scrape that saw any connector rows
        self._rate_first: tuple[float, float] | None = None
        self._rate_last: tuple[float, float] | None = None

    # -- construction helpers ---------------------------------------------
    @staticmethod
    def default_endpoints(
        world: int, host: str = "127.0.0.1", base_port: int = 20000
    ) -> dict[int, str]:
        """The engine's per-rank metric endpoints: 20000 + process_id
        (internals/monitoring.py start_http_server call sites)."""
        return {
            r: f"http://{host}:{base_port + r}/metrics"
            for r in range(world)
        }

    @classmethod
    def from_env(cls, port: int, world: int) -> "ClusterMetricsAggregator":
        """Knob-configured construction (PATHWAY_CLUSTER_SCRAPE_S,
        PATHWAY_CLUSTER_BASELINE_ROWS_PER_S); stdlib env reads so
        file-path loads need no package config."""
        try:
            interval = float(
                os.environ.get("PATHWAY_CLUSTER_SCRAPE_S", "") or 2.0
            )
        except ValueError:
            interval = 2.0
        baseline = None
        raw = os.environ.get("PATHWAY_CLUSTER_BASELINE_ROWS_PER_S", "")
        if raw.strip():
            try:
                baseline = float(raw)
            except ValueError:
                baseline = None
        return cls(
            port,
            cls.default_endpoints(world),
            interval_s=interval,
            baseline_rows_per_s=baseline,
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ClusterMetricsAggregator":
        agg = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    body = b"ok\n"
                    ctype = "text/plain"
                elif path in ("/metrics/cluster", "/metrics", "/"):
                    body = agg.render_cluster().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # scrape cadence must not bury the pipeline's logs

        self._server = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler
        )
        threading.Thread(
            target=self._server.serve_forever, daemon=True
        ).start()
        self._thread = threading.Thread(target=self._scrape_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, final_scrape: bool = False) -> None:
        if final_scrape:
            try:
                self.scrape_once()
            except Exception:
                pass
        self._stop.set()
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except OSError:
                pass
            self._server = None

    # -- epoch survival -----------------------------------------------------
    def set_endpoints(
        self, endpoints: dict[int, str], epoch: int | None = None
    ) -> None:
        """Re-resolve rank endpoints (supervisor respawn path): fresh
        scrape-health state per rank; last-seen samples are kept but
        marked stale until the new epoch's endpoint answers."""
        with self._lock:
            self._endpoints = dict(endpoints)
            for r in self._endpoints:
                st = self._ranks.get(r)
                if st is None:
                    self._ranks[r] = _RankState()
                else:
                    st.stale = True
                    st.departed = False
            for r in list(self._ranks):
                if r not in self._endpoints:
                    # a shrink rescale removed this rank from the world
                    #: keep its final-scrape samples, marked
                    # stale + departed, instead of erasing its history
                    # (the supervisor takes one last scrape before the
                    # reap so the totals cover the rank's whole life)
                    st = self._ranks[r]
                    if st.samples:
                        st.stale = True
                        st.departed = True
                    else:
                        del self._ranks[r]
            if epoch is not None:
                self.epoch = epoch
            # a rollback restarts ingest counters from the committed
            # cut: restart the throughput observation window too
            self._rate_first = None
            self._rate_last = None

    # -- scraping -----------------------------------------------------------
    def _scrape_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:
                pass  # individual rank failures are per-rank state

    def scrape_once(self) -> int:
        """Scrape every rank once; returns how many answered."""
        with self._lock:
            endpoints = dict(self._endpoints)
        ok = 0
        results: dict[int, list | None] = {}
        for rank, url in endpoints.items():
            try:
                with urllib.request.urlopen(
                    url, timeout=self.timeout_s
                ) as resp:
                    results[rank] = parse_openmetrics(
                        resp.read().decode("utf-8", "replace")
                    )
                    ok += 1
            except (OSError, urllib.error.URLError, ValueError):
                results[rank] = None
        now = time.monotonic()
        with self._lock:
            total_rows = 0.0
            any_rows = False
            for rank, samples in results.items():
                st = self._ranks.setdefault(rank, _RankState())
                if samples is None:
                    st.errors += 1
                    st.stale = True
                    continue
                st.samples = samples
                st.scraped_at = now
                st.stale = False
            for st in self._ranks.values():
                for name, _labels, value in st.samples:
                    if name == "connector_rows_total":
                        total_rows += value
                        any_rows = True
            if any_rows:
                if self._rate_first is None:
                    self._rate_first = (now, total_rows)
                self._rate_last = (now, total_rows)
        return ok

    # -- derived + rendering ------------------------------------------------
    def _per_rank(self, family: str) -> dict[int, float]:
        """Sum of a family's samples per rank (labels collapsed).
        Departed ranks (shrink rescale) are excluded: their frozen
        totals would distort cross-rank derivations (skew) computed
        over the CURRENT world."""
        out: dict[int, float] = {}
        for rank, st in self._ranks.items():
            if st.departed:
                continue
            total = None
            for name, _labels, value in st.samples:
                if name == family:
                    total = (total or 0.0) + value
            if total is not None:
                out[rank] = total
        return out

    def _rows_per_s(self) -> float | None:
        if self._rate_first is None or self._rate_last is None:
            return None
        (t0, r0), (t1, r1) = self._rate_first, self._rate_last
        if t1 - t0 < 1e-3 or r1 <= r0:
            return None
        return (r1 - r0) / (t1 - t0)

    def derived(self) -> dict:
        """The cluster gauges, as numbers (render_cluster serializes
        them; summary() hands them to the TUI dashboard)."""
        waits = self._per_rank("exchange_recv_wait_seconds_total")
        skew = (max(waits.values()) - min(waits.values())) if len(
            waits
        ) >= 2 else 0.0
        rate = self._rows_per_s()
        eff = None
        if (
            rate is not None
            and self.baseline_rows_per_s
            and self._endpoints
        ):
            eff = rate / (self.baseline_rows_per_s * len(self._endpoints))
        return {
            "ranks_live": sum(
                1 for st in self._ranks.values() if not st.stale
            ),
            "ranks_expected": len(self._endpoints),
            "mesh_skew_seconds": skew,
            "rows_per_s": rate,
            "scaling_efficiency": eff,
        }

    def render_cluster(self) -> str:
        with self._lock:
            d = self.derived()
            lines = [
                "# TYPE cluster_ranks gauge",
                f"cluster_ranks {d['ranks_live']}",
                "# TYPE cluster_ranks_expected gauge",
                f"cluster_ranks_expected {d['ranks_expected']}",
                "# TYPE cluster_epoch gauge",
                f"cluster_epoch {self.epoch}",
                # the CURRENT world size, stamped next to the epoch so a
                # rescale is visible the scrape after it happens
                # (departed ranks' retained samples carry stale="1")
                "# TYPE cluster_world_size gauge",
                f"cluster_world_size {len(self._endpoints)}",
                "# TYPE mesh_skew_seconds gauge",
                f"mesh_skew_seconds {d['mesh_skew_seconds']:.6f}",
            ]
            if d["rows_per_s"] is not None:
                lines.append("# TYPE cluster_rows_per_s gauge")
                lines.append(f"cluster_rows_per_s {d['rows_per_s']:.1f}")
            if d["scaling_efficiency"] is not None:
                lines.append("# TYPE scaling_efficiency gauge")
                lines.append(
                    f"scaling_efficiency {d['scaling_efficiency']:.4f}"
                )
            # pass-through: every curated family, grouped under one TYPE
            # line across ranks (the OpenMetrics grouping contract),
            # each sample re-labeled with its rank (+ stale marker when
            # the rank's endpoint missed the last scrape)
            by_family: dict[str, list[str]] = {}
            for rank in sorted(self._ranks):
                st = self._ranks[rank]
                extra = {"rank": str(rank)}
                if st.stale and st.samples:
                    extra["stale"] = "1"
                for name, labels, value in st.samples:
                    if name not in PASSTHROUGH_FAMILIES:
                        continue
                    by_family.setdefault(name, []).append(
                        render_sample(name, {**extra, **labels}, value)
                    )
            for name in PASSTHROUGH_FAMILIES:
                samples = by_family.get(name)
                if samples:
                    kind = (
                        "gauge"
                        if name in (
                            "mesh_last_committed_epoch", "mesh_tree_depth",
                            "device_mfu", "device_mfu_padded",
                            "device_hbm_live_bytes",
                            "device_hbm_peak_bytes", "device_queue_depth",
                            "device_hbm_stats_available",
                            "device_peak_flops",
                            "trace_dropped_events_total",
                        )
                        else "counter"
                    )
                    lines.append(f"# TYPE {name} {kind}")
                    lines.extend(samples)
            return "\n".join(lines) + "\n"

    def summary(self) -> dict | None:
        """Per-rank wall-clock split + derived gauges for the TUI
        dashboard's cluster section; None before the first scrape."""
        with self._lock:
            if not any(st.samples for st in self._ranks.values()):
                return None
            rows = self._per_rank("connector_rows_total")
            comms = self._per_rank("exchange_comms_seconds_total")
            compute = self._per_rank("exchange_compute_seconds_total")
            idle = self._per_rank("runtime_idle_seconds_total")
            waits = self._per_rank("exchange_recv_wait_seconds_total")
            d = self.derived()
            return {
                "ranks": {
                    r: {
                        "rows": rows.get(r, 0.0),
                        "comms_s": comms.get(r, 0.0),
                        "compute_s": compute.get(r, 0.0),
                        "idle_s": idle.get(r, 0.0),
                        "recv_wait_s": waits.get(r, 0.0),
                        "stale": self._ranks[r].stale,
                    }
                    for r in self._ranks
                    if self._ranks[r].samples
                },
                "skew_s": d["mesh_skew_seconds"],
                "rows_per_s": d["rows_per_s"],
                "efficiency": d["scaling_efficiency"],
                "epoch": self.epoch,
            }


def load_by_path() -> "type[ClusterMetricsAggregator]":
    """Helper mirror of the supervisor's file-path load pattern (used by
    tests to pin that this module stays stdlib-only/importable without
    the package __init__s)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_pw_cluster", os.path.abspath(__file__)
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ClusterMetricsAggregator
