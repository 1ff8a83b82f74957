"""OpenTelemetry tracing surface (reference:
python/pathway/internals/graph_runner/telemetry.py, 140 LoC — spans
`graph_runner.build` / `graph_runner.run` around lowering and execution;
engine side src/engine/telemetry.rs exports OTLP).

Only the OTel API is required: with no SDK configured the spans are
no-ops; installing `opentelemetry-sdk` + an exporter activates them
without code changes (`pw.set_monitoring_config(server_endpoint=...)`
records the OTLP endpoint for the SDK bootstrap)."""

from __future__ import annotations

import contextlib
from typing import Any


class Telemetry:
    def __init__(self, tracer):
        self.tracer = tracer

    _otlp_cache: dict = {}

    @classmethod
    def create(cls, endpoint: str | None = None, *, stats=None):
        if endpoint is not None:
            # hand-rolled OTLP/HTTP JSON exporter (internals/otlp.py):
            # spans + 60 s process/latency gauges with no OTel SDK needed
            # (reference: src/engine/telemetry.rs:38-45). One instance per
            # endpoint per process — repeated pw.run() calls must not each
            # leak a metrics thread.
            from pathway_tpu_torch.internals.otlp import OtlpTelemetry

            tel = cls._otlp_cache.get(endpoint)
            if tel is None:
                tel = OtlpTelemetry(endpoint, stats=stats)
                cls._otlp_cache[endpoint] = tel
            else:
                tel.stats = stats  # gauge source follows the live runtime
            return tel
        try:
            from opentelemetry import trace

            tracer = trace.get_tracer("pathway_tpu_torch")
        except ImportError:
            tracer = None
        return cls(tracer)

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        if self.tracer is None:
            yield None
            return
        with self.tracer.start_as_current_span(name) as s:
            for k, v in attributes.items():
                try:
                    s.set_attribute(k, v)
                except Exception:
                    pass
            yield s
