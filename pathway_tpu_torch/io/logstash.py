"""pw.io.logstash — Logstash HTTP-input output connector (reference:
python/pathway/io/logstash — rows POSTed to the logstash http plugin
endpoint with time/diff fields, configurable retries/timeouts)."""

from __future__ import annotations

from pathway_tpu_torch.io.http._client import write as _http_write


def write(
    table,
    endpoint: str,
    n_retries: int = 0,
    retry_policy=None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int = 30_000,
    *,
    name: str | None = None,
    **kwargs,
) -> None:
    """POST each row change (inserts AND retractions) to the Logstash HTTP
    input as JSON with `time` and `diff` fields appended (reference
    payload contract)."""
    _http_write(
        table,
        endpoint,
        method="POST",
        n_retries=n_retries,
        connect_timeout_ms=connect_timeout_ms,
        request_timeout_ms=request_timeout_ms,
    )
