"""HTTP streaming client connector (reference:
python/pathway/io/http/__init__.py:28 — poll an endpoint into a table;
write: POST each row to an endpoint) + the keep-alive request session the
serving clients (VectorStoreClient, RAGClient) reuse so a closed-loop
client pays TCP setup once, not per query."""

from __future__ import annotations

import http.client
import json as _json
import threading
import time
import urllib.parse
import urllib.request
from typing import Any

from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


class HttpError(urllib.error.HTTPError):
    """Non-2xx response from a keep-alive session request. Subclasses
    ``urllib.error.HTTPError`` so callers that caught the old
    urllib-based clients' errors (``e.code``, ``e.read()``) keep
    working unchanged. ``headers`` carries the response headers (the
    backpressure contract rides them: ``Retry-After`` on 503 sheds,
    ``Degraded`` on brownout answers)."""

    def __init__(
        self, status: int, body: bytes, url: str = "", headers=None
    ):
        import email.message
        import io

        hdrs = email.message.Message()
        for k, v in (headers or {}).items():
            hdrs[k] = v
        # .status/.code come from HTTPError itself
        super().__init__(url, status, f"HTTP {status}", hdrs, io.BytesIO(body))
        self.body = body

    def json(self):
        return _json.loads(self.body.decode())


class KeepAliveSession:
    """Persistent-connection JSON client over ``http.client``.

    One kept-alive HTTP/1.1 connection PER THREAD (``threading.local``),
    re-established transparently when the server closes it — concurrent
    callers sharing one session keep their independent parallelism (no
    cross-thread lock held over a round trip) while each thread's
    request stream pays connection setup once. This is what lets a
    closed-loop client of the batching gateway ride the keep-alive path
    the server now serves."""

    def __init__(
        self,
        url: str,
        timeout: float = 90.0,
        retries: int = 0,
        max_retry_wait_s: float = 30.0,
    ):
        if "://" not in url:
            # scheme-less "host:port" would mis-parse as scheme=host
            url = "http://" + url
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme not in ("http", "https"):
            raise ValueError(
                f"KeepAliveSession supports http(s):// urls, got {url!r}"
            )
        self.tls = parsed.scheme == "https"
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or (443 if self.tls else 80)
        # a base path in the url (reverse-proxy prefix) prepends to
        # every route, matching the old `url + route` concatenation
        self.base_path = parsed.path.rstrip("/")
        self.timeout = timeout
        # opt-in bounded retry of the DOCUMENTED backpressure contract:
        # a 503 carrying Retry-After (admission shed, brownout breaker,
        # parked-deadline expiry during a rollback) is an explicit
        # "come back in N seconds" — with retries > 0 the session honors
        # it, sleeping min(Retry-After, max_retry_wait_s) between
        # attempts. 503s WITHOUT Retry-After and every other status
        # still raise immediately: only the server-invited retry is
        # safe to automate.
        self.retries = retries
        self.max_retry_wait_s = max_retry_wait_s
        self._local = threading.local()

    def _connect(self) -> http.client.HTTPConnection:
        cls = (
            http.client.HTTPSConnection
            if self.tls
            else http.client.HTTPConnection
        )
        conn = cls(self.host, self.port, timeout=self.timeout)
        conn.connect()
        return conn

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            finally:
                self._local.conn = None

    def request_json(self, method: str, route: str, payload=None):
        body = None
        headers = {}
        if payload is not None:
            body = _json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        route = self.base_path + route
        attempts = 0
        while True:
            resp, data = self._roundtrip(method, route, body, headers)
            if (
                resp.status == 503
                and attempts < self.retries
                and resp.getheader("Retry-After") is not None
            ):
                try:
                    delay = float(resp.getheader("Retry-After"))
                except (TypeError, ValueError):
                    delay = 1.0
                attempts += 1
                time.sleep(max(0.0, min(delay, self.max_retry_wait_s)))
                continue
            break
        if resp.status >= 400:
            raise HttpError(
                resp.status, data, headers=dict(resp.getheaders())
            )
        if not data:
            return None
        return _json.loads(data.decode())

    def _roundtrip(self, method, route, body, headers):
        while True:
            reused = getattr(self._local, "conn", None) is not None
            conn = self._local.conn if reused else self._connect()
            self._local.conn = conn
            sent = False
            try:
                conn.request(method, route, body=body, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
                if resp.will_close:
                    conn.close()
                    self._local.conn = None
                break
            except (
                http.client.HTTPException, ConnectionError, OSError
            ) as exc:
                conn.close()
                self._local.conn = None
                # retry ONLY the stale keep-alive race, where the server
                # provably never processed the request: a send-phase
                # failure on a reused socket, or a zero-byte
                # "closed without response" on a reused socket (the
                # idle-timeout close raced our request). Anything after
                # response bytes began — or any fresh-connection failure
                # — may have been processed server-side, and re-sending
                # would duplicate a non-idempotent request: propagate.
                stale = reused and (
                    not sent
                    or isinstance(
                        exc,
                        (
                            http.client.RemoteDisconnected,
                            http.client.BadStatusLine,
                        ),
                    )
                )
                if not stale:
                    raise
        return resp, data

    def post(self, route: str, payload: dict):
        return self.request_json("POST", route, payload)

    def get(self, route: str):
        return self.request_json("GET", route)


class _HttpPollSubject(ConnectorSubject):
    def __init__(self, url, refresh_interval, headers, method="GET"):
        super().__init__()
        self.url = url
        self.refresh_interval = refresh_interval
        self.headers = headers or {}
        self.method = method
        self._stop = False
        self._seen_lines: set[str] = set()

    def run(self):
        while not self._stop:
            req = urllib.request.Request(
                self.url, headers=self.headers, method=self.method
            )
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    body = resp.read().decode()
            except Exception:
                time.sleep(self.refresh_interval)
                continue
            emitted = False
            for line in body.splitlines():
                line = line.strip()
                if not line or line in self._seen_lines:
                    continue  # only NEW lines become rows across polls
                self._seen_lines.add(line)
                emitted = True
                try:
                    self.next(**_json.loads(line))
                except Exception:
                    self.next(data=line)
            if emitted:
                self.commit()
            time.sleep(self.refresh_interval)

    def on_stop(self):
        self._stop = True

    def snapshot_state(self):
        return {"seen_lines": set(self._seen_lines)}

    def seek(self, state):
        self._seen_lines = set(state.get("seen_lines", ()))


def read(
    url: str,
    *,
    schema: type[Schema] | None = None,
    method: str = "GET",
    refresh_interval: float = 5.0,
    headers: dict | None = None,
    format: str = "json",
    **kwargs,
):
    subject = _HttpPollSubject(url, refresh_interval, headers, method=method)
    return python_read(subject, schema=schema, name=f"http:{url}")


def write(
    table,
    url: str,
    *,
    method: str = "POST",
    headers: dict | None = None,
    format: str = "json",
    n_retries: int = 0,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int = 30_000,
    payload_fn=None,
    response_check=None,
    include_special_fields: bool = True,
    **kwargs,
) -> None:
    """POST every row CHANGE (inserts and retractions) to `url` with
    `time`/`diff` fields appended (reference: io/http write — the payload
    downstream needs to mirror table state). `payload_fn(row_dict) ->
    bytes | None` customizes the body (None skips the change);
    `response_check(body_bytes)` may log/raise on API-level failures."""
    import logging

    cols = table.column_names()
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    timeout_s = request_timeout_ms / 1000.0
    log = logging.getLogger("pathway_tpu_torch.io.http")

    def on_change(key, row, time_, diff):
        data = dict(zip(cols, row))
        if include_special_fields:
            data["time"] = time_
            data["diff"] = diff
        if payload_fn is not None:
            payload = payload_fn(data, diff)
            if payload is None:
                return
        else:
            payload = _json.dumps(data, default=str).encode()
        req = urllib.request.Request(
            url, data=payload, method=method, headers=hdrs
        )
        for attempt in range(n_retries + 1):
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                    body = resp.read()
                if response_check is not None:
                    response_check(body)
                return
            except Exception as exc:
                if attempt == n_retries:
                    log.warning("http write to %s failed: %r", url, exc)
                else:
                    time.sleep(min(0.1 * (2 ** attempt), 2.0))

    def lower(ctx):
        ctx.scope.output(ctx.engine_table(table), on_change=on_change)

    G.add_operator([table], [], lower, "http_write", is_output=True)
