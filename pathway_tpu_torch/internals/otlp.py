"""Hand-rolled OTLP/HTTP JSON exporter (reference: src/engine/telemetry.rs
— OTLP exporters with process memory/CPU gauges and input/output latency,
60 s periodic reader at telemetry.rs:38-45; Python side
graph_runner/telemetry.py).

No OpenTelemetry SDK required: spans and gauges are encoded directly as
OTLP/HTTP JSON (`/v1/traces`, `/v1/metrics` per the OTLP spec) and POSTed
with urllib on a background thread. Activated by
``pw.set_monitoring_config(server_endpoint=...)`` / PATHWAY_MONITORING_SERVER.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import urllib.request
from typing import Any

_SERVICE = "pathway_tpu_torch"


def _resource() -> dict:
    return {
        "attributes": [
            {"key": "service.name", "value": {"stringValue": _SERVICE}},
            {"key": "process.pid", "value": {"intValue": str(os.getpid())}},
        ]
    }


def _attr_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _attrs(d: dict) -> list[dict]:
    return [{"key": k, "value": _attr_value(v)} for k, v in d.items()]


class OtlpHttpExporter:
    """POSTs OTLP JSON payloads; failures are swallowed (telemetry must
    never take the pipeline down) but counted for tests/diagnostics."""

    def __init__(self, endpoint: str, timeout: float = 5.0):
        endpoint = endpoint.rstrip("/")
        if not endpoint.startswith(("http://", "https://")):
            endpoint = "http://" + endpoint
        self.endpoint = endpoint
        self.timeout = timeout
        self.sent = 0
        self.errors = 0

    def _post(self, path: str, payload: dict) -> bool:
        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
            self.sent += 1
            return True
        except Exception:
            self.errors += 1
            return False

    def export_spans(self, spans: list[dict]) -> bool:
        if not spans:
            return True
        payload = {
            "resourceSpans": [
                {
                    "resource": _resource(),
                    "scopeSpans": [
                        {"scope": {"name": _SERVICE}, "spans": spans}
                    ],
                }
            ]
        }
        return self._post("/v1/traces", payload)

    def export_gauges(self, gauges: dict[str, float], unit: str = "") -> bool:
        now = str(time.time_ns())
        metrics = [
            {
                "name": name,
                "unit": unit,
                "gauge": {
                    "dataPoints": [
                        {"timeUnixNano": now, "asDouble": float(value)}
                    ]
                },
            }
            for name, value in gauges.items()
        ]
        payload = {
            "resourceMetrics": [
                {
                    "resource": _resource(),
                    "scopeMetrics": [
                        {"scope": {"name": _SERVICE}, "metrics": metrics}
                    ],
                }
            ]
        }
        return self._post("/v1/metrics", payload)


def process_gauges() -> dict[str, float]:
    """Process memory/CPU gauges (reference: telemetry.rs:41-45)."""
    import resource as _res

    ru = _res.getrusage(_res.RUSAGE_SELF)
    gauges = {
        "process.memory.usage": float(ru.ru_maxrss * 1024),
        "process.cpu.utime": float(ru.ru_utime),
        "process.cpu.stime": float(ru.ru_stime),
    }
    try:
        with open("/proc/self/statm") as f:
            gauges["process.memory.rss"] = (
                float(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
            )
    except OSError:
        pass
    return gauges


class OtlpTelemetry:
    """Span recorder + periodic metrics pusher over OtlpHttpExporter.

    Matches internals.telemetry.Telemetry's span() contract so the graph
    runner can use either interchangeably.
    """

    def __init__(
        self,
        endpoint: str,
        *,
        stats=None,
        interval_s: float = 60.0,
        autostart_metrics: bool = True,
    ):
        import queue as _queue

        self.exporter = OtlpHttpExporter(endpoint)
        self.stats = stats
        self.interval_s = interval_s
        self._trace_id = os.urandom(16).hex()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # spans export on a background worker so an unreachable collector
        # never stalls the pipeline (the POST timeout would otherwise be
        # paid inline in the span context manager)
        self._span_queue: "_queue.Queue" = _queue.Queue()
        self._span_worker = threading.Thread(
            target=self._span_loop, name="pw-otlp-spans", daemon=True
        )
        self._span_worker.start()
        if autostart_metrics:
            self.start_metrics_thread()

    def _span_loop(self) -> None:
        while True:
            span = self._span_queue.get()
            try:
                if span is not None:
                    self.exporter.export_spans([span])
            finally:
                self._span_queue.task_done()

    def flush(self, timeout: float = 5.0) -> None:
        """Best-effort wait for queued spans to be exported. Waits on
        task COMPLETION (unfinished_tasks, decremented by the worker's
        task_done after the POST), not queue emptiness — the worker
        dequeues a span before exporting it, so an empty queue can
        still have the last span's POST in flight (a caller tearing
        down its collector right after flush() would lose it)."""
        deadline = time.monotonic() + timeout
        q = self._span_queue
        while q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)

    def drain(self, node_spans=None, timeout: float = 5.0) -> None:
        """Flush-on-shutdown (graph_runner calls this after every run):
        the metrics thread pushes on a 60 s cadence, so a short run
        would exit with its gauges never exported and its spans still
        queued — push the gauges once, enqueue the flight recorder's
        per-node aggregate spans (same OTLP channel as the build/run
        spans), and wait out the span queue. The periodic thread keeps
        running — the telemetry object is cached per endpoint and
        reused by later runs in the same process."""
        for s in node_spans or ():
            self._span_queue.put(
                {
                    "traceId": self._trace_id,
                    "spanId": os.urandom(8).hex(),
                    "name": s["name"],
                    "kind": 1,
                    "startTimeUnixNano": str(int(s["start_ns"])),
                    "endTimeUnixNano": str(int(s["end_ns"])),
                    "attributes": _attrs(s.get("attrs", {})),
                    "status": {"code": 1},
                }
            )
        try:
            self.push_metrics_once()
        except Exception:
            pass
        self.flush(timeout)

    # -- spans ------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        start = time.time_ns()
        span_id = os.urandom(8).hex()
        try:
            yield None
            status = {"code": 1}  # OK
        except BaseException:
            status = {"code": 2}  # ERROR
            raise
        finally:
            self._span_queue.put(
                {
                    "traceId": self._trace_id,
                    "spanId": span_id,
                    "name": name,
                    "kind": 1,
                    "startTimeUnixNano": str(start),
                    "endTimeUnixNano": str(time.time_ns()),
                    "attributes": _attrs(attributes),
                    "status": status,
                }
            )

    # -- metrics ----------------------------------------------------------
    def collect_gauges(self) -> dict[str, float]:
        gauges = process_gauges()
        stats = self.stats
        if stats is not None:
            try:
                gauges["input_latency_ms"] = float(stats.input_latency_ms())
                gauges["output_latency_ms"] = float(stats.output_latency_ms())
            except Exception:
                pass
        return gauges

    def push_metrics_once(self) -> bool:
        return self.exporter.export_gauges(self.collect_gauges())

    def start_metrics_thread(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval_s):
                self.push_metrics_once()

        self._thread = threading.Thread(
            target=loop, name="pw-otlp-metrics", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
