"""Epoch-survivable serving frontend.

The mesh rollback makes a rank failure exit the whole process
(``MESH_RESTART_EXIT_CODE``), so an in-rank gateway would drop its
listener, its admission queue and every in-flight window mid-dispatch —
a single flaky rank became user-visible connection resets, exactly the
failure class coordinated rollback is supposed to hide from clients.

This module moves the HTTP listener and the admission queue OUT of the
epoch-scoped runtime into a supervisor-side frontend that survives the
rollback:

* the frontend owns the public ``host:port`` across epochs; the rank's
  gateway binds a loopback **backend port** instead
  (``PATHWAY_SERVE_BACKEND_PORT``, set by the supervisor) and the
  frontend proxies keep-alive HTTP/1.1 to it;
* on backend loss (``MeshPeerFailure`` → epoch abort → the rank's
  listener dies) every admitted, unresponded request is **parked** —
  its client connection and future are retained — and new arrivals park
  too, up to ``PATHWAY_SERVE_PARK_BUDGET``;
* when the supervisor's epoch+1 gateway re-binds the backend port, the
  parked set **replays** into its first batch windows with deadline
  accounting: requests whose ``PATHWAY_REST_TIMEOUT_S`` budget expired
  while parked get 503 + Retry-After sized by the OBSERVED restart
  time, never a dropped connection;
* readiness (serving / draining / recovering) is exposed on
  ``/healthz`` and park/replay/expiry counters plus an epoch-handoff
  latency histogram on ``/metrics``.

Every park/replay decision is a pure transition in
``parallel/protocol.py`` (``serve_frontend_state`` / ``serve_admit`` /
``serve_park`` / ``serve_replay_split`` / ``serve_retry_after``) that
``analysis/meshcheck.py check_serving`` exhaustively model-checks — no
admitted request is lost or answered twice across a rollback, by the
same anti-drift construction the mesh verifier uses.

Exactly-once boundary: a request whose response was fully received from
the backend is TERMINAL and never replays (``serve_park`` filters on
the responded set); a request cut mid-dispatch replays into epoch+1,
which is safe because the dead epoch's serving state was discarded at
the rollback cut — the gateway keys rows by the frontend's
``X-Pathway-Request-Id``, so even a surviving duplicate upsert is
idempotent at the dataflow level.

This module is deliberately **stdlib-only** (asyncio + http framing by
hand): the mesh supervisor loads it by file path exactly like
``protocol.py``, so stdlib-light drivers (``scripts/fault_matrix.py``,
``scripts/serve_chaos_smoke.py``) never touch the package __init__s.
"""

from __future__ import annotations

import asyncio
import json as _json
import os
import threading
import time as _time
from typing import Any

if __package__:
    from pathway_tpu_torch.internals import faults as _faults
    from pathway_tpu_torch.parallel import protocol as _proto
else:  # pragma: no cover - file-path load (supervisor / chaos drivers)
    import importlib.util as _ilu

    def _load_by_path(name, *parts):
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            ))),
            *parts,
        )
        spec = _ilu.spec_from_file_location(name, path)
        mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _proto = _load_by_path("_pw_mesh_protocol", "parallel", "protocol.py")
    _faults = _load_by_path("_pw_faults", "internals", "faults.py")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# epoch-handoff latency histogram edges (seconds): spans loopback
# respawns (sub-second) up to multi-host rollbacks. Kept here (not
# monitoring.py) because this module must stay stdlib-only.
HANDOFF_BUCKETS_S = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0)


class FrontendMetrics:
    """Minimal OpenMetrics surface for the frontend process — the
    serving-through-rollback serving counters plus the
    epoch-handoff histogram. Same family names the dashboards expect;
    this renders in the SUPERVISOR process, the gateway's ServeMetrics
    in the rank process."""

    def __init__(self):
        self.admitted = 0
        self.shed = 0
        self.parked = 0
        self.replayed = 0
        self.deadline_expired = 0
        self.responses = 0
        self.timeouts = 0
        self.backend_losses = 0
        self.handoff_counts = [0] * (len(HANDOFF_BUCKETS_S) + 1)
        self.handoff_sum = 0.0
        self.handoff_total = 0

    def on_handoff_s(self, s: float) -> None:
        self.handoff_total += 1
        self.handoff_sum += s
        for i, edge in enumerate(HANDOFF_BUCKETS_S):
            if s <= edge:
                self.handoff_counts[i] += 1
                return
        self.handoff_counts[-1] += 1

    def render(self) -> str:
        lines = []
        for metric, val in (
            ("serve_frontend_requests_total", self.admitted),
            ("serve_frontend_shed_total", self.shed),
            ("serve_parked_total", self.parked),
            ("serve_replayed_total", self.replayed),
            ("serve_deadline_expired_total", self.deadline_expired),
            ("serve_frontend_responses_total", self.responses),
            ("serve_frontend_timeouts_total", self.timeouts),
            ("serve_backend_losses_total", self.backend_losses),
        ):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {val}")
        lines.append("# TYPE serve_epoch_handoff_seconds histogram")
        cum = 0
        for edge, n in zip(HANDOFF_BUCKETS_S, self.handoff_counts):
            cum += n
            lines.append(
                f'serve_epoch_handoff_seconds_bucket{{le="{edge:g}"}} {cum}'
            )
        cum += self.handoff_counts[-1]
        lines.append(
            f'serve_epoch_handoff_seconds_bucket{{le="+Inf"}} {cum}'
        )
        lines.append(
            f"serve_epoch_handoff_seconds_sum {self.handoff_sum:.6g}"
        )
        lines.append(
            f"serve_epoch_handoff_seconds_count {self.handoff_total}"
        )
        return "\n".join(lines) + "\n"


class _BackendDown(ConnectionError):
    """The backend epoch is gone mid-roundtrip: park and replay.
    ``stale`` marks a failure on a REUSED kept-alive socket before any
    response byte — the gateway's idle keep-alive close racing our
    request (the same provably-unprocessed race KeepAliveSession
    retries), NOT evidence the backend died: retry on a fresh
    connection before declaring a loss."""

    def __init__(self, message: str, stale: bool = False):
        super().__init__(message)
        self.stale = stale


class _Request:
    __slots__ = ("method", "path", "headers", "body")

    def __init__(self, method, path, headers, body):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body


# public-edge hardening: the frontend runs inside the SUPERVISOR
# process (which owns the mesh), so an unbounded request body would let
# one hostile POST OOM the whole deployment. Matches the order of the
# aiohttp edge it replaces (client_max_size); responses from the
# trusted loopback backend are not capped.
MAX_REQUEST_BODY = 16 * 1024 * 1024
MAX_HEADER_LINES = 256


async def _read_http(reader, *, request: bool, max_body: int | None = None):
    """One HTTP/1.1 message off ``reader``. Returns ``None`` on a clean
    EOF before the start line; raises ``ValueError`` on malformed or
    over-sized input and ``asyncio.IncompleteReadError`` on a torn
    message (callers close the connection for both)."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").rstrip("\r\n").split(None, 2)
    if len(parts) < 2:
        # a scanner's garbage start line must close the connection
        # cleanly (callers catch ValueError), not kill the handler task
        raise ValueError(f"malformed HTTP start line: {line[:80]!r}")
    headers: dict[str, str] = {}
    for _ in range(MAX_HEADER_LINES):
        h = await reader.readline()
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise asyncio.IncompleteReadError(b"", None)
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    else:
        raise ValueError("too many header lines")
    te = headers.get("transfer-encoding", "")
    if "chunked" in te.lower():
        chunks = []
        total = 0
        while True:
            size_line = await reader.readline()
            size = int(size_line.strip().split(b";")[0] or b"0", 16)
            if size == 0:
                await reader.readline()  # trailing CRLF
                break
            total += size
            if max_body is not None and total > max_body:
                raise ValueError("chunked body exceeds the request cap")
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)  # chunk CRLF
        body = b"".join(chunks)
    else:
        n = int(headers.get("content-length", "0") or 0)
        if max_body is not None and n > max_body:
            raise ValueError(
                f"declared body of {n} bytes exceeds the request cap"
            )
        body = await reader.readexactly(n) if n > 0 else b""
    if request:
        return _Request(parts[0], parts[1], headers, body)
    return int(parts[1]), headers, body


# end-to-end headers the relay must NOT forward verbatim: hop-by-hop
# semantics, or recomputed by the frontend itself
_HOP_BY_HOP = frozenset(
    (
        "connection", "keep-alive", "transfer-encoding", "content-length",
        "te", "trailer", "upgrade", "proxy-authenticate",
        "proxy-authorization",
    )
)


class _BackendConn:
    """One kept-alive backend connection per client connection — the
    proxy preserves the closed-loop client's parallelism and its
    keep-alive amortization through to the gateway."""

    def __init__(self, frontend: "ServingFrontend"):
        self.fe = frontend
        self.reader = None
        self.writer = None
        # which backend ATTACHMENT this socket belongs to: a kept-alive
        # socket from the dead epoch failing AFTER epoch+1 attached is a
        # stale connection to retry, not a fresh backend loss
        self.gen = -1

    def close(self) -> None:
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
        self.reader = self.writer = None

    async def roundtrip(self, req: _Request, rid: int):
        """Forward ``req`` (with the frontend's request id stamped) and
        read the full response; a transport failure raises
        ``_BackendDown`` (``stale=True`` when a reused kept-alive socket
        failed before any response byte — retry, don't declare a
        loss)."""
        reused = self.writer is not None
        try:
            if self.writer is None:
                # stamp the generation BEFORE connecting: a failing
                # CONNECT at the current attachment is a real loss
                self.gen = self.fe._attach_gen
                self.reader, self.writer = await asyncio.open_connection(
                    self.fe.backend_host, self.fe.backend_port
                )
            head = [
                f"{req.method} {req.path} HTTP/1.1",
                f"Host: {self.fe.backend_host}:{self.fe.backend_port}",
                f"Content-Length: {len(req.body)}",
                f"X-Pathway-Request-Id: {rid}",
                "Connection: keep-alive",
            ]
            # forward the client's end-to-end headers (Origin/CORS,
            # Authorization, custom validator inputs...) — only
            # hop-by-hop semantics, the recomputed framing, and any
            # client-supplied copy of the request-id header (ours is
            # authoritative) are rebuilt by the frontend
            for k, v in req.headers.items():
                if (
                    k not in _HOP_BY_HOP
                    and k not in ("host", "x-pathway-request-id")
                ):
                    head.append(f"{k.title()}: {v}")
            self.writer.write(
                ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                + req.body
            )
            await self.writer.drain()
            out = await _read_http(self.reader, request=False)
            if out is None:
                raise _BackendDown(
                    "backend closed the connection", stale=reused
                )
            status, headers, body = out
            if "close" in headers.get("connection", "").lower():
                self.close()
            return status, headers, body
        except _BackendDown:
            self.close()
            raise
        except (OSError, asyncio.IncompleteReadError, ValueError) as exc:
            self.close()
            raise _BackendDown(repr(exc), stale=reused) from exc


class ServingFrontend:
    """The supervisor-side (or standalone) serving frontend. Runs its
    own asyncio loop on a daemon thread; ``start()`` returns once the
    public listener is bound."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 8080,
        backend_port: int | None = None,
        backend_host: str = "127.0.0.1",
        timeout_s: float | None = None,
        park_budget: int | None = None,
        queue_cap: int | None = None,
        attach_poll_s: float = 0.1,
    ):
        self.host = host
        self.port = port
        self.backend_host = backend_host
        if backend_port is None:
            backend_port = int(
                os.environ.get("PATHWAY_SERVE_BACKEND_PORT", "0") or 0
            )
        if not backend_port:
            raise ValueError("ServingFrontend requires backend_port")
        self.backend_port = backend_port
        self.timeout_s = (
            timeout_s
            if timeout_s is not None
            else _env_float("PATHWAY_REST_TIMEOUT_S", 120.0)
        )
        self.park_budget = int(
            park_budget
            if park_budget is not None
            else _env_float("PATHWAY_SERVE_PARK_BUDGET", 1024)
        )
        self.queue_cap = int(
            queue_cap
            if queue_cap is not None
            else _env_float("PATHWAY_SERVE_QUEUE_CAP", 2048)
        )
        self.attach_poll_s = attach_poll_s
        self.metrics = FrontendMetrics()
        # -- state (touched only on the frontend's asyncio loop) --------
        self._backend_up = False
        self._draining = False
        self._stopped = False
        self._inflight: dict[int, float] = {}  # rid -> deadline (loop time)
        self._parked: dict[int, float] = {}    # rid -> deadline, arrival order
        self._responded: set[int] = set()
        self._expired: set[int] = set()        # decided by serve_replay_split
        self._seq = 0
        self._down_since: float | None = None
        self._had_attach = False
        self._attach_gen = 0  # bumped per successful attach
        self.observed_restart_s = 0.0
        # elastic mesh: a supervisor-initiated rescale
        # announces itself BEFORE reaping the backend, so the detached
        # window reads `rescaling` on /healthz and its duration feeds a
        # SEPARATE EWMA — a rescale restores a re-sharded world (more
        # state, different cost curve) and must not pollute the crash
        # recovery estimate that sizes Retry-After for real failures
        self._rescaling = False
        self._loss_was_rescale = False
        self.observed_rescale_s = 0.0
        self.rescales_seen = 0
        self._attach_event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server = None
        self._started = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingFrontend":
        self._thread = threading.Thread(
            target=self._run, name="pw-serve-frontend", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("serving frontend failed to start")
        return self

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        loop.run_until_complete(self._start_async())
        self._started.set()
        loop.run_forever()
        # cancel stragglers so the loop closes cleanly
        for task in asyncio.all_tasks(loop):
            task.cancel()
        try:
            loop.run_until_complete(
                asyncio.gather(*asyncio.all_tasks(loop), return_exceptions=True)
            )
        except Exception:
            pass
        loop.close()

    async def _start_async(self) -> None:
        self._attach_event = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, reuse_address=True
        )
        asyncio.ensure_future(self._attach_loop())

    def state(self) -> str:
        return _proto.serve_frontend_state(
            self._backend_up, self._draining, self._rescaling
        )

    def note_rescale(self) -> None:
        """Called by the supervisor BEFORE it reaps the rank set for a
        rescale: the upcoming backend loss is planned, so readiness
        reads ``rescaling`` (not ``recovering``) and the outage duration
        lands on the rescale EWMA. Thread-safe."""
        loop = self._loop
        if loop is not None:
            loop.call_soon_threadsafe(self._set_rescaling)

    def _set_rescaling(self) -> None:
        self._rescaling = True

    def _retry_after_s(self) -> float:
        """The restart-time estimate behind Retry-After: the rescale
        EWMA while a rescale is in flight (or when it is all we have
        observed), the crash EWMA otherwise."""
        if self._rescaling and self.observed_rescale_s > 0:
            return self.observed_rescale_s
        if self.observed_restart_s > 0:
            return self.observed_restart_s
        return self.observed_rescale_s

    def drain(self) -> None:
        """Enter draining: new arrivals shed with Retry-After so a load
        balancer rotates away; in-flight requests finish."""
        loop = self._loop
        if loop is not None:
            loop.call_soon_threadsafe(self._set_draining)

    def _set_draining(self) -> None:
        self._draining = True

    def stop(self) -> None:
        loop = self._loop
        if loop is None:
            return
        self._stopped = True

        def _shutdown():
            if self._server is not None:
                self._server.close()
            loop.stop()

        loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- backend attach / loss (asyncio loop only) -------------------------
    async def _attach_loop(self) -> None:
        """Probe the backend port while detached; on success run the
        replay split and wake every parked coroutine."""
        while not self._stopped:
            if self._backend_up:
                await asyncio.sleep(self.attach_poll_s)
                continue
            try:
                r, w = await asyncio.open_connection(
                    self.backend_host, self.backend_port
                )
                w.close()
            except OSError:
                await asyncio.sleep(self.attach_poll_s)
                continue
            self._on_attach()

    def _on_attach(self) -> None:
        now = self._loop.time()
        if self._down_since is not None:
            # a previously-attached epoch was lost: this is a rollback
            # handoff — record how long serving was dark (the blip)
            handoff = now - self._down_since
            self.metrics.on_handoff_s(handoff)
            # EWMA of observed restart time sizes Retry-After for sheds
            # and deadline expiries — clients back off for as long as a
            # rollback actually takes here. Rescale handoffs feed their
            # OWN estimate (a re-sharded restore loads every old rank's
            # snapshot — different cost curve than a crash respawn)
            if self._loss_was_rescale:
                self.rescales_seen += 1
                self.observed_rescale_s = (
                    handoff
                    if self.observed_rescale_s <= 0
                    else 0.5 * self.observed_rescale_s + 0.5 * handoff
                )
            else:
                self.observed_restart_s = (
                    handoff
                    if self.observed_restart_s <= 0
                    else 0.5 * self.observed_restart_s + 0.5 * handoff
                )
            self._down_since = None
        self._rescaling = False
        self._loss_was_rescale = False
        self._had_attach = True
        self._attach_gen += 1
        self._backend_up = True
        # the replay-vs-expire verdict over the parked set is a protocol
        # decision (serve_replay_split) — parked coroutines consult the
        # expired set it computed instead of re-deciding per coroutine
        replay, expired = _proto.serve_replay_split(
            list(self._parked), now, self._parked
        )
        self._expired.update(expired)
        ev = self._attach_event
        if ev is not None:
            ev.set()

    def _note_backend_loss(self) -> None:
        if not self._backend_up and self._down_since is not None:
            return  # already noted
        first = self._backend_up or self._down_since is None
        # fresh event FIRST: coroutines that observe backend_up == False
        # after this point wait on the new event, which only the next
        # attach sets
        self._attach_event = asyncio.Event()
        self._backend_up = False
        if self._had_attach and first:
            self._down_since = self._loop.time()
            # classify the loss NOW: a note_rescale that arrives after
            # the links already dropped must not retroactively relabel
            # a crash window as a planned rescale
            self._loss_was_rescale = self._rescaling
            self.metrics.backend_losses += 1
            # the park set at loss: every admitted, unresponded request
            # (the exactly-once boundary — responded ids never replay)
            for rid in _proto.serve_park(self._inflight, self._responded):
                if rid not in self._parked:
                    self._parked[rid] = self._inflight[rid]
                    self.metrics.parked += 1
                    _faults.fault_point("serve.park")

    # -- request path (asyncio loop) ---------------------------------------
    async def _handle_conn(self, reader, writer) -> None:
        backend = _BackendConn(self)
        try:
            while True:
                try:
                    # bounded read: body cap (a hostile Content-Length
                    # must not buffer gigabytes inside the SUPERVISOR
                    # process) and an idle timeout so slow-loris clients
                    # cannot hold handler tasks forever
                    req = await asyncio.wait_for(
                        _read_http(
                            reader, request=True,
                            max_body=MAX_REQUEST_BODY,
                        ),
                        timeout=max(300.0, self.timeout_s),
                    )
                except (
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,
                    ValueError,
                    OSError,
                ):
                    break
                if req is None:
                    break
                keep = "close" not in req.headers.get(
                    "connection", ""
                ).lower()
                path = req.path.split("?", 1)[0]
                if path == "/healthz":
                    await self._respond_local(writer, req, keep)
                elif path == "/metrics":
                    await self._write_response(
                        writer, 200, self.metrics.render().encode(),
                        keep, ctype="text/plain; version=0.0.4",
                    )
                else:
                    await self._serve(req, writer, backend, keep)
                if not keep:
                    break
        finally:
            backend.close()
            try:
                writer.close()
            except Exception:
                pass

    async def _respond_local(self, writer, req, keep) -> None:
        state = self.state()
        body = _json.dumps(
            {
                "state": state,
                "backend_port": self.backend_port,
                "parked": len(self._parked),
                "observed_restart_s": round(self.observed_restart_s, 3),
                "observed_rescale_s": round(self.observed_rescale_s, 3),
                "rescales_seen": self.rescales_seen,
            }
        ).encode()
        await self._write_response(
            writer, 200 if state == "serving" else 503, body, keep,
            ctype="application/json",
        )

    async def _serve(self, req, writer, backend, keep) -> None:
        m = self.metrics
        verdict = _proto.serve_admit(
            self.state(), len(self._inflight), self.queue_cap,
            len(self._parked), self.park_budget,
        )
        if verdict == "shed":
            m.shed += 1
            await self._write_response(
                writer, 503,
                b'{"error": "overloaded or draining, retry later"}',
                keep, ctype="application/json",
                extra={
                    "Retry-After": str(
                        _proto.serve_retry_after(self._retry_after_s())
                    )
                },
            )
            return
        m.admitted += 1
        self._seq += 1
        rid = self._seq
        deadline = self._loop.time() + self.timeout_s
        self._inflight[rid] = deadline
        if verdict == "park":
            self._parked[rid] = deadline
            m.parked += 1
            _faults.fault_point("serve.park")
        try:
            await self._serve_inflight(req, writer, backend, keep, rid)
        finally:
            self._inflight.pop(rid, None)
            self._parked.pop(rid, None)
            self._expired.discard(rid)
            self._responded.discard(rid)

    async def _serve_inflight(self, req, writer, backend, keep, rid) -> None:
        """Forward → (park → replay)* → terminal response. Every admitted
        request leaves through exactly one of: relayed backend response,
        deadline 503 + Retry-After, or frontend-timeout 504."""
        m = self.metrics
        deadline = self._inflight[rid]
        while True:
            if not self._backend_up:
                # -- parked: future retained, waiting for epoch+1 -------
                # (membership-checked on the shared dict, not a local
                # flag: _note_backend_loss may have parked this rid
                # already while its roundtrip was failing)
                if rid not in self._parked:
                    self._parked[rid] = deadline
                    m.parked += 1
                    _faults.fault_point("serve.park")
                ev = self._attach_event
                remaining = deadline - self._loop.time()
                if remaining <= 0 or rid in self._expired:
                    m.deadline_expired += 1
                    await self._write_deadline_503(writer, keep)
                    return
                try:
                    await asyncio.wait_for(ev.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    m.deadline_expired += 1
                    await self._write_deadline_503(writer, keep)
                    return
                if rid in self._expired:
                    # serve_replay_split put this id in the expired half
                    m.deadline_expired += 1
                    await self._write_deadline_503(writer, keep)
                    return
            if rid in self._parked and self._backend_up:
                # -- replay into the recovered epoch's first windows ----
                # (single accounting site: covers both a woken parked
                # coroutine and one whose roundtrip failure raced a
                # fast reattach)
                self._parked.pop(rid, None)
                m.replayed += 1
                _faults.fault_point("serve.replay")
            remaining = deadline - self._loop.time()
            if remaining <= 0:
                m.deadline_expired += 1
                await self._write_deadline_503(writer, keep)
                return
            try:
                status, headers, body = await asyncio.wait_for(
                    backend.roundtrip(req, rid), timeout=remaining + 0.5
                )
            except _BackendDown as exc:
                if not exc.stale and backend.gen == self._attach_gen:
                    # a FRESH connection failed at the current
                    # attachment: the backend epoch is genuinely gone
                    self._note_backend_loss()
                # else: a reused kept-alive socket went stale (gateway
                # idle-close race, or a socket from a previous
                # attachment) — retry on a fresh connection without
                # declaring (and mis-measuring) a backend loss; if the
                # backend really died, the fresh connect fails next
                # iteration with stale=False and the loss is declared
                continue
            except asyncio.TimeoutError:
                # backend alive but past the request deadline: the
                # gateway's own 504 raced us — answer and drop the
                # (mid-response) backend connection
                backend.close()
                m.timeouts += 1
                await self._write_response(
                    writer, 504, b'{"error": "timeout"}', keep,
                    ctype="application/json",
                )
                return
            # response fully received: the request is TERMINAL — it must
            # never replay (the park set filters on this)
            self._responded.add(rid)
            m.responses += 1
            # relay every end-to-end backend header (CORS, Retry-After,
            # Degraded, caching...) — only hop-by-hop semantics and the
            # recomputed framing headers are the frontend's own
            extra = {
                k.title(): v
                for k, v in headers.items()
                if k not in _HOP_BY_HOP and k != "content-type"
            }
            await self._write_response(
                writer, status, body, keep,
                ctype=headers.get("content-type", "application/json"),
                extra=extra,
            )
            return

    async def _write_deadline_503(self, writer, keep) -> None:
        """Deadline accounting for a parked request: its budget expired
        while serving was dark — a terminal 503 whose Retry-After is the
        observed restart time, NOT a dropped connection."""
        await self._write_response(
            writer, 503,
            b'{"error": "rolling back, deadline expired while parked"}',
            keep, ctype="application/json",
            extra={
                "Retry-After": str(
                    _proto.serve_retry_after(self._retry_after_s())
                )
            },
        )

    async def _write_response(
        self, writer, status, body, keep, ctype="application/json",
        extra=None,
    ) -> None:
        reason = {200: "OK", 503: "Service Unavailable", 504: "Gateway Timeout"}
        head = [
            f"HTTP/1.1 {status} {reason.get(status, 'Status')}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(body)}",
            f"Connection: {'keep-alive' if keep else 'close'}",
        ]
        for k, v in (extra or {}).items():
            head.append(f"{k}: {v}")
        try:
            writer.write(
                ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body
            )
            await writer.drain()
        except (OSError, ConnectionError):
            pass  # client went away; its request already terminated


def main(argv=None) -> int:  # pragma: no cover - thin CLI
    import argparse

    ap = argparse.ArgumentParser(
        description="standalone epoch-survivable serving frontend"
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--backend-port", type=int, required=True)
    args = ap.parse_args(argv)
    fe = ServingFrontend(
        host=args.host, port=args.port, backend_port=args.backend_port
    ).start()
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        fe.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
