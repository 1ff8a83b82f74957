"""REST server connector (reference: python/pathway/io/http/_server.py —
PathwayWebserver :329, rest_connector :624, RestServerSubject :525).

One aiohttp application (owned by a PathwayWebserver) serves any number of
routes; each route is a connector: an incoming request becomes a row in the
queries table, the caller's response future resolves when the paired
response-writer table produces the row with the same id.

Serving gateway (ROADMAP item 1 — serve at the device bound): requests do
NOT commit one-by-one. Each admitted request joins the route's dynamic
batch window; the window closes on ``PATHWAY_SERVE_WINDOW_MS`` elapsed or
``PATHWAY_SERVE_MAX_BATCH`` collected — whichever first — and the whole
window enters the dataflow as ONE commit (= one dataflow timestamp = one
BSP round = one fused KNN+rerank device dispatch downstream, because the
external-index operator batches queries per timestamp). Responses fan out
per window through the batched subscribe path (``on_batch``), one
cross-thread hop per window instead of one per row. Admission is bounded
(``PATHWAY_SERVE_QUEUE_CAP``): overflow is shed with 503 + ``Retry-After``
sized from the observed service rate, and shed/timed-out requests are
evicted from their window so they never occupy a batch slot or a device
dispatch. aiohttp keeps HTTP/1.1 connections alive, so a closed-loop
client pays the TCP+TLS setup once, not per query.

Serving through rollback: under a mesh supervisor with
``--serve-frontend``, the PUBLIC listener lives in the supervisor's
epoch-survivable frontend (``_frontend.py``) and this gateway binds the
loopback ``PATHWAY_SERVE_BACKEND_PORT`` instead — a mesh rollback then
parks in-flight requests at the frontend and replays them into
epoch+1's first windows rather than resetting connections. This module
adds the epoch-abort half (``abort_windows_for_rollback``: an
all-parked window commits nothing), stable request keys from the
frontend's ``X-Pathway-Request-Id``, and a circuit breaker on the
dispatch path whose open state answers DEGRADED from the last committed
snapshot (``brownout_answer`` + ``Degraded: true`` header) under
``PATHWAY_SERVE_BROWNOUT=1`` instead of shedding.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json as _json
import math
import os
import queue as _queue
import threading
import time as _time
from typing import Any, Sequence

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import faults as _faults
from pathway_tpu_torch.internals import memory as _memory
from pathway_tpu_torch.internals.device import PLANE as _DEVICE, device_site
from pathway_tpu_torch.internals.api import Json, Pointer, ref_scalar
from pathway_tpu_torch.internals.monitoring import ServeMetrics
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read

# the dispatch circuit breaker and the brownout/shed verdicts are
# protocol decisions (parallel/protocol.py breaker_decide) shared with
# the serving model checker
from pathway_tpu_torch.parallel import protocol as _proto

device_site(
    "serve.window",
    # host-only site: the window commit launches no device work itself
    # (the downstream index site records its own device-bounded span),
    # so the model is honestly zero — registered anyway because every
    # begin() site must be in the registry (lint_gil pass 4)
    cost_model=lambda *a: (0.0, 0.0),
    dtypes=(),
    where="pathway_tpu_torch/io/http/_server.py:_dispatch_window",
    description="serving gateway windowed commit (host-only record, "
                "device time honestly zero)",
)


def _env_knob(name: str, default: float) -> float:
    """Best-effort env read for the serving knobs; the registry
    (analysis/knobs.py) validates the same names at runtime startup, so
    a malformed value is rejected there with a rich KnobError — here it
    just falls back to the default."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclasses.dataclass
class EndpointDocumentation:
    summary: str | None = None
    description: str | None = None
    tags: Sequence[str] = ()
    method_types: Sequence[str] | None = None


def _openapi_type(dtype) -> dict:
    """pw dtype -> OpenAPI schema object (reference: _server.py:126-329
    generates the schema from the route's pw.Schema)."""
    if dtype is dt.INT:
        return {"type": "integer", "format": "int64"}
    if dtype is dt.FLOAT:
        return {"type": "number", "format": "double"}
    if dtype is dt.BOOL:
        return {"type": "boolean"}
    if dtype is dt.STR:
        return {"type": "string"}
    if dtype is dt.BYTES:
        return {"type": "string", "format": "byte"}
    if dtype is dt.JSON:
        return {}  # any JSON value
    name = getattr(dtype, "name", None) or str(dtype)
    if "Optional" in name:
        wrapped = getattr(dtype, "wrapped", None)
        if callable(wrapped):  # DType.wrapped is a method
            wrapped = wrapped()
        if wrapped is not None:
            inner = _openapi_type(wrapped)
            inner["nullable"] = True
            return inner
    if name.startswith(("List", "Tuple", "Array")):
        return {"type": "array", "items": {}}
    return {}


def _schema_request_body(schema: type[Schema]) -> dict:
    hints = schema.typehints()
    defaults = schema.default_values()
    props = {}
    required = []
    for col in schema.column_names():
        spec = _openapi_type(hints.get(col))
        if col in defaults:
            try:
                _json.dumps(defaults[col])
                spec["default"] = defaults[col]
            except TypeError:
                pass
        else:
            required.append(col)
        props[col] = spec
    body: dict[str, Any] = {"type": "object", "properties": props}
    if required:
        body["required"] = required
    return body


def _schema_query_params(schema: type[Schema]) -> list[dict]:
    hints = schema.typehints()
    defaults = schema.default_values()
    return [
        {
            "name": col,
            "in": "query",
            "required": col not in defaults,
            "schema": _openapi_type(hints.get(col)),
        }
        for col in schema.column_names()
    ]


def _validate_payload_types(schema: type[Schema], payload: dict) -> str | None:
    """Schema-driven request validation: wrong-typed fields are rejected
    with 400 before they enter the dataflow."""
    hints = schema.typehints()
    for col, value in payload.items():
        t = hints.get(col)
        if value is None or t is None:
            continue
        if t is dt.INT and not (
            isinstance(value, int) and not isinstance(value, bool)
        ):
            return f"field {col!r} must be an integer"
        if t is dt.FLOAT and not (
            isinstance(value, (int, float)) and not isinstance(value, bool)
        ):
            return f"field {col!r} must be a number"
        if t is dt.BOOL and not isinstance(value, bool):
            return f"field {col!r} must be a boolean"
        if t is dt.STR and not isinstance(value, str):
            return f"field {col!r} must be a string"
    return None


class PathwayWebserver:
    """Shared aiohttp server; routes register before pw.run() starts it
    (reference: _server.py:329)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080,
                 with_cors: bool = False, with_schema_endpoint: bool = True):
        self.public_host, self.public_port = host, port
        # epoch-survivable frontend mode: when the mesh
        # supervisor runs a ServingFrontend it owns the public listener
        # across rollbacks and hands this epoch's gateway a loopback
        # backend port via PATHWAY_SERVE_BACKEND_PORT — the pipeline
        # program keeps naming its public host:port unchanged. The
        # rewrite applies ONLY to the webserver whose configured port is
        # the frontend's public port (PATHWAY_SERVE_PUBLIC_PORT): a
        # program with a second webserver on another port must not have
        # both rebound onto one backend port (instant EADDRINUSE and a
        # rollback loop). Without the public-port var (standalone
        # frontends, older supervisors) every webserver rewrites, as
        # before.
        backend = os.environ.get("PATHWAY_SERVE_BACKEND_PORT")
        public = os.environ.get("PATHWAY_SERVE_PUBLIC_PORT")
        if backend:
            try:
                if not public or int(public) == port:
                    host, port = "127.0.0.1", int(backend)
            except ValueError:
                pass
        self.host = host
        self.port = port
        self.with_cors = with_cors
        self._routes: list[tuple[str, tuple[str, ...], Any, Any]] = []
        self._openapi: dict[str, Any] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._thread: threading.Thread | None = None
        self.with_schema_endpoint = with_schema_endpoint

    def _register_route(self, route, methods, handler, docs, schema=None) -> None:
        self._routes.append((route, methods, handler, docs))
        ops: dict[str, Any] = {}
        for m in methods:
            op: dict[str, Any] = {
                "summary": getattr(docs, "summary", None) or route,
                "responses": {
                    "200": {"description": "OK"},
                    "400": {"description": "Invalid request"},
                    "504": {"description": "Processing timeout"},
                },
            }
            desc = getattr(docs, "description", None)
            if desc:
                op["description"] = desc
            tags = list(getattr(docs, "tags", ()) or ())
            if tags:
                op["tags"] = tags
            if schema is not None:
                if m == "GET":
                    op["parameters"] = _schema_query_params(schema)
                else:
                    op["requestBody"] = {
                        "required": True,
                        "content": {
                            "application/json": {
                                "schema": _schema_request_body(schema)
                            }
                        },
                    }
            ops[m.lower()] = op
        self._openapi[route] = ops

    def openapi_document(self) -> dict:
        return {
            "openapi": "3.0.3",
            "info": {"title": "Pathway REST connector", "version": "1.0.0"},
            "servers": [{"url": f"http://{self.host}:{self.port}"}],
            "paths": self._openapi,
        }

    def _ensure_started(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)

    def _run(self) -> None:
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        app = web.Application()
        for route, methods, handler, _docs in self._routes:
            for m in methods:
                app.router.add_route(m, route, handler)
        if self.with_schema_endpoint:
            async def schema_handler(request):
                return web.json_response(self.openapi_document())

            app.router.add_route("GET", "/_schema", schema_handler)
            app.router.add_route("GET", "/openapi.json", schema_handler)

        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, self.host, self.port)
        loop.run_until_complete(site.start())
        self._started.set()
        loop.run_forever()


class _PendingRequest:
    """One admitted request riding a batch window."""

    __slots__ = (
        "key", "values", "future", "admitted_at", "evicted",
        # Server-Timing stamps (PATHWAY_SERVE_TIMING=1):
        # window-close, dispatch-start and response-resolve
        # perf_counter readings, so each response can decompose its own
        # latency into queue/window/dispatch/egress without a trace file
        "t_closed", "t_dispatch0", "t_resolved",
    )

    def __init__(self, key, values, future):
        self.key = key
        self.values = values
        self.future = future
        self.admitted_at = _time.perf_counter()
        self.evicted = False
        self.t_closed = None
        self.t_dispatch0 = None
        self.t_resolved = None


class RestServerSubject(ConnectorSubject):
    """Request-coalescing serving gateway over the python connector.

    Pipeline per request: admission (bounded; overflow shed with 503 +
    Retry-After) → dynamic batch window (closes on
    ``PATHWAY_SERVE_WINDOW_MS`` or ``PATHWAY_SERVE_MAX_BATCH``, whichever
    first) → a dispatch worker turns the window into upserts + ONE
    ``commit()`` (one dataflow timestamp, one fused device dispatch
    downstream) → the response table's batched subscribe callback
    resolves the whole window's futures in one cross-thread hop.
    Timed-out/disconnected requests are evicted from their window before
    dispatch; ``delete_completed_queries`` retractions are batched and
    ride the next window's commit instead of paying their own."""

    # serving requests are ephemeral: they must never enter the input
    # journal (io/_connector.py) — a rolled-back epoch's journaled
    # queries replayed at epoch+1 would double-dispatch the very
    # requests the frontend is already replaying with live futures
    _ephemeral = True

    def __init__(
        self,
        webserver: PathwayWebserver,
        route: str,
        methods: tuple[str, ...],
        schema: type[Schema],
        delete_completed_queries: bool,
        request_validator=None,
        documentation=None,
        window_ms: float | None = None,
        max_batch: int | None = None,
        queue_cap: int | None = None,
        timeout_s: float | None = None,
        workers: int | None = None,
        brownout_answer=None,
        breaker_threshold: int | None = None,
        breaker_cooldown_s: float | None = None,
    ):
        super().__init__()
        self.webserver = webserver
        self.route = route
        self.schema = schema
        self.delete_completed_queries = delete_completed_queries
        self.request_validator = request_validator
        self._tasks: dict[Pointer, asyncio.Future] = {}
        self._seq = 0
        self._key_salt = int.from_bytes(os.urandom(8), "little")
        self._lock = threading.Lock()
        # gateway knobs: explicit args win, then the serve/REST env knobs
        self.window_s = (
            window_ms
            if window_ms is not None
            else _env_knob("PATHWAY_SERVE_WINDOW_MS", 5.0)
        ) / 1000.0
        self.max_batch = int(
            max_batch
            if max_batch is not None
            else _env_knob("PATHWAY_SERVE_MAX_BATCH", 32)
        )
        self.queue_cap = int(
            queue_cap
            if queue_cap is not None
            else _env_knob("PATHWAY_SERVE_QUEUE_CAP", 2048)
        )
        self.timeout_s = (
            timeout_s
            if timeout_s is not None
            else _env_knob("PATHWAY_REST_TIMEOUT_S", 120.0)
        )
        self.workers = int(
            workers
            if workers is not None
            else _env_knob("PATHWAY_SERVE_WORKERS", 1)
        )
        # -- brownout + dispatch circuit breaker ---------------
        # consecutive dispatch failures or request-deadline breaches
        # open the breaker; while open, requests answer DEGRADED from
        # the last committed snapshot (brownout_answer, Degraded: true)
        # under PATHWAY_SERVE_BROWNOUT=1 instead of shedding
        self.brownout_answer = brownout_answer
        self.brownout_enabled = str(
            os.environ.get("PATHWAY_SERVE_BROWNOUT", "0")
        ).strip().lower() in ("1", "true", "yes")
        self.breaker_threshold = int(
            breaker_threshold
            if breaker_threshold is not None
            else _env_knob("PATHWAY_SERVE_BREAKER_THRESHOLD", 5)
        )
        self.breaker_cooldown_s = (
            breaker_cooldown_s
            if breaker_cooldown_s is not None
            else _env_knob("PATHWAY_SERVE_BREAKER_COOLDOWN_S", 5.0)
        )
        self._breaker = "closed"
        self._breaker_failures = 0  # consecutive, dispatch + deadline
        self._breaker_opened_at = 0.0
        self._breaker_lock = threading.Lock()
        # X-Pathway-Request-Id is honored ONLY behind the
        # epoch-survivable frontend (loopback backend bind): on a public
        # gateway the header is client-spoofable — two requests naming
        # the same id would collide on one dataflow key and future slot
        self._frontend_mode = bool(
            os.environ.get("PATHWAY_SERVE_BACKEND_PORT")
        )
        # Server-Timing response header: per-request
        # queue/window/dispatch/egress ms, so a client-observed p50
        # decomposes without a trace file
        self._server_timing = str(
            os.environ.get("PATHWAY_SERVE_TIMING", "0")
        ).strip().lower() in ("1", "true", "yes")
        self.serve_metrics = ServeMetrics(route=route)
        # collecting window (event-loop thread only) + closed-window queue
        # drained by the dispatch workers
        self._window: list[_PendingRequest] = []
        self._window_timer = None
        self._windows_q: "_queue.Queue" = _queue.Queue()
        self._commit_lock = threading.Lock()
        self._inflight = 0  # admitted, unresponded (event-loop thread)
        # delete_completed_queries retractions batched onto later commits
        self._removals: list[tuple[Pointer, dict]] = []
        self._removals_lock = threading.Lock()
        self._removal_timer = None
        self._live: dict[Pointer, dict] = {}  # dispatched, not yet removed
        # rolling (t, n) response counts — the observed service rate that
        # sizes Retry-After when admission sheds
        self._recent_done: list[tuple[float, int]] = []
        # EWMA of the response drain rate (responses/s) — the honest
        # denominator for pace_retry_after when the memory ladder sheds
        #: the 10 s rolling qps reads near-zero exactly when
        # the governor has been throttling, which would tell clients to
        # come back immediately into a pressured engine
        self._done_rate_ewma = 0.0
        self._done_rate_t: float | None = None
        self._dispatchers: list[threading.Thread] = []
        self._gateway_up = False
        # device OOM -> serving brownout: an HBM-growth
        # refusal on the index is not a per-request failure streak, it
        # is an immediate capacity loss — trip the breaker open at once
        # so requests answer Degraded from the last committed snapshot
        # instead of piling onto a device that cannot grow
        from pathway_tpu_torch.internals import device as _devsup

        self._oom_listener = lambda site: self._on_device_oom(site)
        _devsup.on_oom(self._oom_listener)
        webserver._register_route(
            route, methods, self._handle, documentation, schema=schema
        )

    # -- lifecycle --------------------------------------------------------
    def _ensure_gateway(self) -> None:
        # raced by the connector thread (run) and the event loop (first
        # request): the commit lock keeps worker startup single-shot
        if self._gateway_up:
            return
        with self._commit_lock:
            if self._gateway_up:
                return
            for i in range(max(1, self.workers)):
                t = threading.Thread(
                    target=self._dispatch_loop,
                    name=f"pw-serve-{self.route}-{i}",
                    daemon=True,
                )
                t.start()
                self._dispatchers.append(t)
            self._gateway_up = True

    def run(self):
        self.webserver._ensure_started()
        self._ensure_gateway()
        # stays alive for the whole pipeline; requests drive windows/commits
        self._shutdown = threading.Event()
        self._shutdown.wait()

    def on_stop(self):
        if hasattr(self, "_shutdown"):
            self._shutdown.set()
        if self._gateway_up:
            self._gateway_up = False
            for _ in self._dispatchers:
                self._windows_q.put(None)
            for t in self._dispatchers:
                t.join(timeout=2)
            self._dispatchers.clear()

    def abort_windows_for_rollback(self) -> int:
        """Epoch-abort half of request parking (engine/runtime.py calls
        this before the supervised exit): queued-but-undispatched windows
        are aborted — every member evicted, so a racing dispatch worker
        commits NOTHING for them (the all-parked-window invariant) — and
        their requests are left to the frontend, which holds the real
        client futures and replays them into epoch+1. Returns the number
        of windows aborted."""
        n = 0
        sentinels = 0
        while True:
            try:
                window = self._windows_q.get_nowait()
            except _queue.Empty:
                break
            if window is None:
                # a worker stop sentinel (on_stop racing the rollback):
                # swallowing it would leave a dispatch worker blocked in
                # get() past its join timeout — put it back
                sentinels += 1
                continue
            for p in window:
                p.evicted = True
            if window:
                n += 1
        for _ in range(sentinels):
            self._windows_q.put(None)
        # the collecting (not yet closed) window parks the same way —
        # and counts: in the low-traffic case it is often the ONLY
        # window, and the abort must still be observable
        if any(not p.evicted for p in self._window):
            n += 1
        for p in self._window:
            p.evicted = True
        if n:
            self.serve_metrics.on_windows_aborted(n)
        return n

    def _on_device_oom(self, site: str) -> None:
        """Flip the breaker straight to open on a device OOM: the
        failure streak heuristic is for transient dispatch errors, but
        refused HBM growth means every future write dispatch fails
        until the operator intervenes or load drops."""
        with self._breaker_lock:
            self._breaker = "open"
            self._breaker_failures = max(
                self._breaker_failures, self.breaker_threshold
            )
            self._breaker_opened_at = _time.monotonic()
        if self.serve_metrics.breaker_state != "open":
            self.serve_metrics.set_breaker("open")

    # -- dispatch circuit breaker (protocol.breaker_decide) ----------------
    def _breaker_now(self) -> str:
        """Current breaker verdict; transitions open -> half_open after
        the cooldown so ONE probe window can close it again."""
        with self._breaker_lock:
            state = _proto.breaker_decide(
                self._breaker,
                self._breaker_failures,
                self.breaker_threshold,
                _time.monotonic() - self._breaker_opened_at,
                self.breaker_cooldown_s,
            )
            self._breaker = state
        if self.serve_metrics.breaker_state != state:
            self.serve_metrics.set_breaker(state)
        return state

    def _breaker_record(self, ok: bool) -> None:
        with self._breaker_lock:
            if ok:
                self._breaker_failures = 0
                self._breaker = "closed"
            elif self.breaker_threshold > 0:
                self._breaker_failures += 1
                if self._breaker != "closed":
                    # a failing half_open probe (or a failure while
                    # already open) re-arms the full cooldown
                    self._breaker = "open"
                    self._breaker_opened_at = _time.monotonic()
                elif _proto.breaker_decide(
                    "closed",
                    self._breaker_failures,
                    self.breaker_threshold,
                    0.0,
                    self.breaker_cooldown_s,
                ) == "open":
                    self._breaker = "open"
                    self._breaker_opened_at = _time.monotonic()
        state = self._breaker
        if self.serve_metrics.breaker_state != state:
            self.serve_metrics.set_breaker(state)

    # -- request path (webserver event loop) ------------------------------

    def _request_key(self, rid: str | None) -> Pointer:
        """The dataflow key of a request: the frontend's request id when
        it stamped one, else this server's salt and a counter. The salt,
        drawn per server, keeps keys unique across runs: a persisted
        program restores operator state that can still hold the rows of
        the previous run's last requests, and a counter that restarts at
        0 would key a new request onto one of them (its answer then holds
        both requests' hits)."""
        if rid is not None:
            return ref_scalar("rest", self.route, "rid", rid)
        with self._lock:
            self._seq += 1
            return ref_scalar("rest", self.route, self._key_salt, self._seq)

    async def _handle(self, request):
        from aiohttp import web

        cols = self.schema.column_names()
        defaults = self.schema.default_values()
        if request.method == "GET":
            # query-string values are strings — coerce to the schema
            # types; a value that does not parse as its typed column is a
            # client error, reported with the offending field (it must
            # never enter the dataflow as a raw string in a typed column)
            hints = self.schema.typehints()
            payload = {}
            for key, value in request.query.items():
                t = hints.get(key)
                try:
                    if t is dt.INT:
                        value = int(value)
                    elif t is dt.FLOAT:
                        value = float(value)
                    elif t is dt.BOOL:
                        low = value.lower()
                        if low in ("1", "true", "yes"):
                            value = True
                        elif low in ("0", "false", "no"):
                            value = False
                        else:
                            raise ValueError(value)
                except (TypeError, ValueError):
                    return web.json_response(
                        {
                            "error": (
                                f"field {key!r} must be "
                                f"{_coercion_target(t)}, got {value!r}"
                            )
                        },
                        status=400,
                    )
                payload[key] = value
        else:
            try:
                payload = await request.json()
            except Exception:
                payload = {}
        if self.request_validator is not None:
            try:
                err = self.request_validator(payload)
                if err is not None:
                    return web.json_response({"error": str(err)}, status=400)
            except Exception as e:
                return web.json_response({"error": str(e)}, status=400)
        missing = [
            c for c in cols if c not in payload and c not in defaults
        ]
        if missing:
            return web.json_response(
                {"error": f"missing fields: {missing}"}, status=400
            )
        if request.method != "GET":
            type_err = _validate_payload_types(self.schema, payload)
            if type_err is not None:
                return web.json_response({"error": type_err}, status=400)
        values = {c: payload.get(c, defaults.get(c)) for c in cols}
        # JSON-typed columns wrap payload fragments
        for c, typ in self.schema.typehints().items():
            if typ is dt.JSON and values.get(c) is not None and not isinstance(values[c], Json):
                values[c] = Json(values[c])

        metrics = self.serve_metrics
        metrics.on_request()
        # dispatch circuit breaker: consecutive dispatch
        # failures / deadline breaches opened it — answer DEGRADED from
        # the last committed snapshot (no update-fold, no device
        # dispatch) instead of shedding when brownout is on; cooldown
        # half-opens it so one probe window can close it again.
        # The memory-governance ladder feeds the same path:
        # at "brownout"/"abort" the runtime is shedding load to stay
        # inside its budget, so serving answers degraded (or sheds with
        # a drain-rate-honest Retry-After) instead of queuing new work
        # into a pressured engine.
        mem_state = _memory.ladder_state()
        mem_degraded = mem_state in ("brownout", "abort")
        if self.breaker_threshold > 0 or mem_degraded:
            breaker = (
                self._breaker_now()
                if self.breaker_threshold > 0
                else "closed"
            )
            if breaker == "open" or mem_degraded:
                if self.brownout_enabled and self.brownout_answer is not None:
                    try:
                        result = await asyncio.get_event_loop()\
                            .run_in_executor(
                                None, self.brownout_answer, dict(values)
                            )
                    except Exception as exc:
                        return web.json_response(
                            {"error": f"brownout answer failed: {exc}"},
                            status=503,
                            headers={
                                "Retry-After": str(
                                    self._retry_after_s(mem_state)
                                )
                            },
                        )
                    metrics.on_brownout()
                    return web.json_response(
                        result, headers={"Degraded": "true"}
                    )
                metrics.on_shed()
                return web.json_response(
                    {"error": (
                        "memory pressure, retry later"
                        if mem_degraded
                        else "device dispatch degraded, retry later"
                    )},
                    status=503,
                    headers={
                        "Retry-After": str(
                            self._retry_after_s(mem_state)
                            if mem_degraded
                            else _proto.serve_retry_after(
                                self.breaker_cooldown_s
                            )
                        )
                    },
                )
        # admission control: bounded in-flight backlog; overflow is shed
        # rather than queued into latency the client will time out on
        # anyway (the device is behind the N/C capacity line)
        if self._inflight >= self.queue_cap:
            metrics.on_shed()
            return web.json_response(
                {"error": "overloaded, retry later"},
                status=503,
                headers={"Retry-After": str(self._retry_after_s(mem_state))},
            )
        # the epoch-survivable frontend stamps its own request id so a
        # request REPLAYED into epoch+1 keys the same dataflow row — an
        # upsert, idempotent even if the dead epoch's row survived in a
        # restored snapshot (the park/replay exactly-once boundary).
        # Only trusted in frontend mode: the loopback bind means the
        # header can only come from the frontend itself.
        rid = (
            request.headers.get("X-Pathway-Request-Id")
            if self._frontend_mode
            else None
        )
        key = self._request_key(rid)
        future: asyncio.Future = asyncio.get_event_loop().create_future()
        self._tasks[key] = future
        pending = _PendingRequest(key, values, future)
        if self._server_timing:
            # the response fan-in only sees the future — hang the
            # pending off it so the resolve stamp lands per request
            future._pw_pending = pending
        self._inflight += 1
        self._join_window(pending)
        try:
            result = await asyncio.wait_for(future, timeout=self.timeout_s)
        except asyncio.TimeoutError:
            # evicted: if the window has not dispatched yet, the request
            # vanishes before it can occupy a batch slot / device dispatch
            pending.evicted = True
            metrics.on_timeout()
            # a deadline breach is a breaker signal: a wedged device
            # path shows up as timeouts long before dispatch exceptions
            self._breaker_record(False)
            return web.json_response({"error": "timeout"}, status=504)
        except asyncio.CancelledError:
            # client disconnected: same eviction semantics as a timeout
            pending.evicted = True
            raise
        finally:
            self._inflight -= 1
            self._tasks.pop(key, None)
        metrics.on_latency_ms(
            (_time.perf_counter() - pending.admitted_at) * 1000.0
        )
        if self._server_timing:
            return web.json_response(
                result,
                headers={
                    "Server-Timing": _server_timing_header(pending)
                },
            )
        return web.json_response(result)

    def _retry_after_s(self, mem_state: str = "ok") -> int:
        """Seconds until the current backlog drains at the observed
        service rate — the Retry-After a shed client should honor.
        During a memory-ladder episode (``pacing``/``brownout``/
        ``abort``) the horizon comes from the SAME ``pace_retry_after``
        transition the pacing model checks: in-flight backlog over the
        EWMA drain rate — honest exactly when the rolling qps reads
        near-zero because the governor has been throttling."""
        now = _time.monotonic()
        with self._lock:  # _resolve_batch appends from the engine thread
            self._recent_done = [
                (t, n) for t, n in self._recent_done if now - t <= 10.0
            ]
            qps = sum(n for _, n in self._recent_done) / 10.0
            ewma = self._done_rate_ewma
        if mem_state not in ("", "ok"):
            return max(
                1,
                math.ceil(
                    _proto.pace_retry_after(max(self._inflight, 1), ewma)
                ),
            )
        if qps <= 0:
            return 1
        return max(1, min(60, math.ceil(self._inflight / qps)))

    # -- batch window (event-loop thread) ---------------------------------
    def _join_window(self, pending: _PendingRequest) -> None:
        self._ensure_gateway()  # first request may beat the run() thread
        self._window.append(pending)
        if self.window_s <= 0 or len(self._window) >= self.max_batch:
            self._close_window(self._window)
            return
        if len(self._window) == 1:
            self._window_timer = asyncio.get_event_loop().call_later(
                self.window_s, self._close_window, self._window
            )

    def _close_window(self, window: list) -> None:
        if window is not self._window:
            return  # already closed by the max-batch trigger
        if self._window_timer is not None:
            self._window_timer.cancel()
            self._window_timer = None
        self._window = []
        if self._server_timing:
            now = _time.perf_counter()
            for p in window:
                p.t_closed = now
        self._windows_q.put(window)

    # -- dispatch workers (threads) ---------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            window = self._windows_q.get()
            if window is None:
                return
            try:
                self._dispatch_window(window)
            except Exception:
                # consecutive dispatch failures open the circuit breaker
                self._breaker_record(False)
                # a failing dispatch must fail the window's futures, not
                # kill the worker (clients would hang to their timeouts)
                loop = self.webserver._loop
                if loop is not None:
                    futures = [
                        p.future for p in window if not p.evicted
                    ]

                    def _fail(futures=futures):
                        for f in futures:
                            if not f.done():
                                f.set_exception(
                                    RuntimeError("gateway dispatch failed")
                                )

                    loop.call_soon_threadsafe(_fail)

    def _dispatch_window(self, window: list) -> None:
        """The windowed commit: every live request of the window upserts,
        batched completed-query retractions piggyback, then ONE commit —
        the whole window is one dataflow timestamp. The lock keeps
        concurrent workers' windows atomic (interleaved upserts would
        merge two windows into one flush)."""
        with self._commit_lock:
            live = [p for p in window if not p.evicted]
            with self._removals_lock:
                removals, self._removals = self._removals, []
            if not live and not removals:
                return
            # chaos slot: kill with the window formed but its upserts
            # not yet committed (the all-parked-window invariant: this
            # window must commit NOTHING at epoch+1 unless replayed)
            _faults.fault_point("serve.dispatch", phase="window")
            # device plane: the gateway's fused window
            # dispatch as a timed record — one commit = one downstream
            # device dispatch. Host-only here (the JAX launch happens in
            # the engine's step, where the index site records its own
            # device-bounded span), so no output to block on: the record
            # carries the window's wall span and the dispatch-queue
            # depth, and its device time is honestly zero.
            dev = _DEVICE.begin("serve.window") if _DEVICE.on else None
            if self._server_timing:
                now = _time.perf_counter()
                for p in live:
                    p.t_dispatch0 = now
            try:
                for p in live:
                    if self.delete_completed_queries:
                        # tracked only for the later retraction — an
                        # unconditional record would grow per request
                        # forever on keep-queries servers
                        self._live[p.key] = p.values
                    self._upsert(p.key, p.values)
                for key, values in removals:
                    self._remove(key, values)
                self.commit()
            except BaseException:
                if dev is not None:
                    # close the record on the failure path too — an
                    # abandoned record would leak dispatch-queue depth
                    _DEVICE.end(dev, None, block=False)
                if removals:
                    # the swapped-out retractions must not vanish with
                    # the failed dispatch — re-queue them for the next
                    # window (their keys already left _live)
                    with self._removals_lock:
                        self._removals[:0] = removals
                raise
            # chaos slot: window committed in-memory, responses not yet
            # delivered — the frontend must replay (the rollback cut
            # discards this commit) without double-answering anyone
            _faults.fault_point("serve.dispatch", phase="committed")
            if dev is not None:
                _DEVICE.end(dev, None, block=False)
            if live:
                self.serve_metrics.on_window(len(live))

    # -- response fan-in (engine output thread) ---------------------------
    def _resolve_batch(self, resolved: list[tuple[Pointer, Any]]) -> None:
        """One delivered response batch (= one window downstream):
        resolve every future in a single cross-thread hop and queue the
        completed rows' retractions onto the next commit."""
        # breaker success is RESPONSE DELIVERY, not window commit: a
        # wedged device path keeps committing windows in-memory while
        # answers never arrive — commits must not reset the
        # deadline-breach streak or the breaker could never open for
        # exactly the scenario it exists for
        self._breaker_record(True)
        loop = self.webserver._loop
        t_resolved = _time.perf_counter() if self._server_timing else None
        futures = []
        for key, result in resolved:
            future = self._tasks.get(key)
            if future is not None:
                futures.append((future, result))
                if t_resolved is not None:
                    p = getattr(future, "_pw_pending", None)
                    if p is not None:
                        p.t_resolved = t_resolved
            if self.delete_completed_queries:
                values = self._live.pop(key, None)
                if values is not None:
                    with self._removals_lock:
                        self._removals.append((key, values))
        with self._lock:  # _retry_after_s prunes from the event loop
            now = _time.monotonic()
            self._recent_done.append((now, len(resolved)))
            del self._recent_done[:-256]
            if self._done_rate_t is not None:
                dt_s = max(now - self._done_rate_t, 1e-3)
                inst = len(resolved) / dt_s
                self._done_rate_ewma += 0.3 * (inst - self._done_rate_ewma)
            self._done_rate_t = now
        if loop is not None and futures:
            def _set():
                for future, result in futures:
                    if not future.done():
                        future.set_result(result)

            loop.call_soon_threadsafe(_set)
        if self.delete_completed_queries and self._removals:
            # under load the retractions ride the next window's commit;
            # when traffic pauses, a lazy flush (4 windows, min 50 ms)
            # clears the tail without paying a commit per response batch
            if loop is not None and self._removal_timer is None:
                delay = max(4 * self.window_s, 0.05)

                def _arm():
                    self._removal_timer = loop.call_later(
                        delay, self._flush_removals
                    )

                loop.call_soon_threadsafe(_arm)

    def _flush_removals(self) -> None:
        self._removal_timer = None
        self._windows_q.put([])  # removal-only window

    def _resolve(self, key: Pointer, value: Any) -> None:
        """Single-row compatibility shim over the batched fan-in."""
        self._resolve_batch([(key, value)])


def _server_timing_header(p: _PendingRequest) -> str:
    """RFC-style ``Server-Timing`` value decomposing one response's
    latency (PATHWAY_SERVE_TIMING=1):

    * ``queue``    — admission to window close (batch-window wait);
    * ``window``   — window close to dispatch start (worker pickup);
    * ``dispatch`` — the windowed commit through the dataflow to the
      response batch resolving (the engine + device share);
    * ``egress``   — future resolve to response serialization.

    Missing stamps (a replayed/brownout path) collapse to 0 rather than
    lying with negative durations."""
    now = _time.perf_counter()
    t_admit = p.admitted_at
    t_closed = p.t_closed if p.t_closed is not None else t_admit
    t_d0 = p.t_dispatch0 if p.t_dispatch0 is not None else t_closed
    t_res = p.t_resolved if p.t_resolved is not None else now
    legs = (
        ("queue", t_closed - t_admit),
        ("window", t_d0 - t_closed),
        ("dispatch", t_res - t_d0),
        ("egress", now - t_res),
    )
    return ", ".join(
        f"{name};dur={max(0.0, s) * 1000.0:.2f}" for name, s in legs
    )


def _coercion_target(t) -> str:
    if t is dt.INT:
        return "an integer"
    if t is dt.FLOAT:
        return "a number"
    return "a boolean (1/0/true/false/yes/no)"


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    schema: type[Schema] | None = None,
    methods: Sequence[str] = ("POST",),
    autocommit_duration_ms: int | None = None,
    keep_queries: bool | None = None,
    delete_completed_queries: bool | None = None,
    request_validator=None,
    documentation: EndpointDocumentation | None = None,
    window_ms: float | None = None,
    max_batch: int | None = None,
    queue_cap: int | None = None,
    timeout_s: float | None = None,
    workers: int | None = None,
    brownout_answer=None,
    breaker_threshold: int | None = None,
    breaker_cooldown_s: float | None = None,
):
    """Returns (queries_table, response_writer) (reference: _server.py:624).

    response_writer(table) — table keyed like queries with a `result`
    column; writing it resolves the matching pending HTTP requests, one
    batched callback per delivered window.

    The gateway coalesces requests into batch windows (``window_ms`` /
    ``max_batch``, defaulting to the registered serve knobs) and
    commits one dataflow timestamp per window, so
    ``autocommit_duration_ms`` defaults to None — the window IS the
    commit cadence, and a timer flush racing a window's upserts would
    split one window across two timestamps.
    """
    if webserver is None:
        webserver = PathwayWebserver(
            host=host or "0.0.0.0", port=port or 8080
        )
    if delete_completed_queries is None:
        delete_completed_queries = (
            not keep_queries if keep_queries is not None else False
        )
    if schema is None:
        raise ValueError("rest_connector requires a schema")

    subject = RestServerSubject(
        webserver,
        route,
        tuple(m.upper() for m in methods),
        schema,
        delete_completed_queries,
        request_validator,
        documentation,
        window_ms=window_ms,
        max_batch=max_batch,
        queue_cap=queue_cap,
        timeout_s=timeout_s,
        workers=workers,
        brownout_answer=brownout_answer,
        breaker_threshold=breaker_threshold,
        breaker_cooldown_s=breaker_cooldown_s,
    )
    queries = python_read(
        subject, schema=schema, autocommit_duration_ms=autocommit_duration_ms
    )

    def response_writer(response_table) -> None:
        cols = tuple(response_table.column_names())
        try:
            result_idx = cols.index("result")
        except ValueError:
            result_idx = None

        def on_batch(time_, deltas):
            # one callback per delivered batch (= one window): the whole
            # window's futures resolve in a single cross-thread hop —
            # the batched-subscribe egress, not a per-row callback
            resolved = []
            for key, row, diff in deltas:
                if diff <= 0:
                    continue
                if result_idx is not None:
                    result = row[result_idx]
                else:
                    result = dict(zip(cols, row))
                if isinstance(result, Json):
                    result = result.value
                resolved.append((key, result))
            if resolved:
                subject._resolve_batch(resolved)

        def lower(ctx):
            ctx.scope.output(
                ctx.engine_table(response_table), on_batch=on_batch
            )

        G.add_operator(
            [response_table], [], lower, "rest_response", is_output=True
        )

    return queries, response_writer
