"""pw.viz — live table visualization (reference:
python/pathway/stdlib/viz/table_viz.py:165 + plotting.py:138 — Bokeh/Panel
dashboards, Table.plot, show). Bokeh/Panel gate lazily; `show`/`_repr_html_`
degrade to a static HTML/text snapshot without them."""

from __future__ import annotations

from typing import Any, Callable


def table_to_pandas(table):
    """Materialize a (static) table into a pandas DataFrame — one shared
    implementation (pathway_tpu_torch.debug.table_to_pandas)."""
    from pathway_tpu_torch.debug import table_to_pandas as _impl

    return _impl(table)


def table_viz(table, **kwargs):
    """Render a table snapshot (reference: table_viz.py). With Panel
    installed returns a live widget; otherwise a DataFrame."""
    try:
        import panel as pn

        df = table_to_pandas(table)
        return pn.widgets.Tabulator(df, **kwargs)
    except ImportError:
        return table_to_pandas(table)


def plot(table, plotting_function: Callable | None = None, sorting_col=None):
    """reference: plotting.py Table.plot — live Bokeh plot over a table."""
    try:
        import bokeh.plotting as bp
    except ImportError as e:
        raise ImportError("pw.Table.plot requires the `bokeh` package") from e
    df = table_to_pandas(table)
    fig = bp.figure(height=300)
    if plotting_function is not None:
        return plotting_function(bp.ColumnDataSource(df))
    num_cols = [c for c in df.columns if df[c].dtype.kind in "if"]
    for c in num_cols:
        fig.line(list(range(len(df))), df[c], legend_label=c)
    return fig


class LiveView:
    """Diff-driven live table view (reference: table_viz.py:165 — the
    Bokeh/Panel streams update per diff, not per re-render).

    Maintains row state from the table's update stream via pw.io.subscribe
    and refreshes an IPython display handle (or any `on_update` callback)
    as commits land. Works headless: `snapshot()` / `to_html()` /
    `__repr__` read the current state at any time during a streaming run.
    """

    def __init__(self, table, *, on_update=None, refresh_s: float = 0.5):
        import threading

        import pathway_tpu_torch as pw

        self.table = table
        self.columns = list(table.column_names())
        self._rows: dict = {}
        self._lock = threading.Lock()
        self._dirty = threading.Event()
        self._on_update = on_update
        self._display_handle = None
        self.refresh_s = refresh_s

        def on_change(key, row, time_, is_addition):
            with self._lock:
                if is_addition:
                    self._rows[key] = row
                else:
                    self._rows.pop(key, None)
            self._dirty.set()
            if self._on_update is not None:
                self._on_update(self)

        pw.io.subscribe(self.table, on_change=on_change)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._rows.values())

    def to_html(self) -> str:
        import html as _html

        rows = self.snapshot()
        esc = lambda v: _html.escape(str(v))  # untrusted cell text
        head = "".join(f"<th>{esc(c)}</th>" for c in self.columns)
        body = "".join(
            "<tr>"
            + "".join(f"<td>{esc(r.get(c))}</td>" for c in self.columns)
            + "</tr>"
            for r in rows
        )
        return (
            f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"
            f"<p>{len(rows)} rows (live)</p>"
        )

    def _repr_html_(self) -> str:
        return self.to_html()

    def __repr__(self):
        lines = [" | ".join(self.columns)]
        for r in self.snapshot():
            lines.append(" | ".join(str(r.get(c)) for c in self.columns))
        return "\n".join(lines)

    def display(self):
        """Show in a notebook with in-place refresh as diffs arrive. One
        refresher thread per view; transient update errors are tolerated."""
        import threading
        import time as _t

        from IPython.display import HTML, display

        self._display_handle = display(HTML(self.to_html()), display_id=True)
        if getattr(self, "_refresher", None) is not None:
            return self  # re-displaying reuses the existing thread

        def refresher():
            while True:
                self._dirty.wait()
                self._dirty.clear()
                try:
                    self._display_handle.update(HTML(self.to_html()))
                except Exception:
                    pass  # comm hiccup: keep serving later updates
                _t.sleep(self.refresh_s)

        self._refresher = threading.Thread(target=refresher, daemon=True)
        self._refresher.start()
        return self


class _SseHub:
    """Per-view fan-out of diff events to connected SSE clients. Client
    queues are small and keep-latest: only the newest table snapshot
    matters for this UI, so a stalled browser never accumulates frames."""

    def __init__(self):
        import queue as _q
        import threading

        self._clients: list = []
        self._lock = threading.Lock()
        self._q = _q  # module handle for subscriber queues

    def subscribe(self):
        q = self._q.Queue(maxsize=2)
        with self._lock:
            self._clients.append(q)
        return q

    def unsubscribe(self, q) -> None:
        with self._lock:
            if q in self._clients:
                self._clients.remove(q)

    def has_clients(self) -> bool:
        with self._lock:
            return bool(self._clients)

    def publish(self, payload: str) -> None:
        with self._lock:
            clients = list(self._clients)
        for q in clients:
            while True:
                try:
                    q.put_nowait(payload)
                    break
                except self._q.Full:
                    try:
                        q.get_nowait()  # drop the stalest frame
                    except self._q.Empty:
                        pass


def _live_page(title: str) -> str:
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title></head><body>"
        f"<h3>{title} <small>(streaming)</small></h3>"
        "<div id='tbl'>connecting…</div>"
        "<script>"
        "const es = new EventSource('/stream');"
        "es.onmessage = (e) => {"
        "  document.getElementById('tbl').innerHTML = JSON.parse(e.data).html;"
        "};"
        "</script></body></html>"
    )


def serve_live_view(view: "LiveView", host: str = "127.0.0.1", port: int = 0):
    """True streaming dashboard for a LiveView: every table diff PUSHES a
    Server-Sent-Events message to connected browsers — no client polling
    (the native stand-in for the reference's Bokeh/Panel streams,
    table_viz.py:165; bokeh is not a dependency of this image).
    Returns the bound (host, port)."""
    import http.server
    import json as _json
    import threading

    hub = _SseHub()
    prev_update = view._on_update
    dirty = threading.Event()

    def on_update(v):
        # subscribe-callback thread: just flag; rendering + fan-out happen
        # on the publisher thread, coalescing bursts of diffs into one
        # frame and doing no work at all while no client is connected
        dirty.set()
        if prev_update is not None:
            prev_update(v)

    view._on_update = on_update

    def publisher():
        import time as _t

        while True:
            dirty.wait()
            dirty.clear()
            if not hub.has_clients():
                continue
            hub.publish(
                _json.dumps(
                    {"html": view.to_html(), "rows": len(view._rows)}
                )
            )
            _t.sleep(0.2)  # coalesce bursts into ≤5 frames/s

    threading.Thread(target=publisher, daemon=True).start()

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/stream":
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                q = hub.subscribe()
                try:
                    # initial frame so a fresh client renders immediately
                    first = _json.dumps({"html": view.to_html()})
                    self.wfile.write(f"data: {first}\n\n".encode())
                    self.wfile.flush()
                    while True:
                        payload = q.get()
                        self.wfile.write(f"data: {payload}\n\n".encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionError, OSError):
                    pass
                finally:
                    hub.unsubscribe(q)
                return
            body = _live_page("pathway live table").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    view._sse_server = server
    return server.server_address


def show(table, *, live: bool = False, **kwargs):
    """reference: table_viz.py show — display in notebook/panel server.
    ``live=True`` returns a diff-driven LiveView (register BEFORE pw.run();
    the view keeps updating while the pipeline streams)."""
    if live:
        view = LiveView(table, **kwargs)
        try:
            view.display()
        except Exception:
            pass  # headless: snapshot()/repr serve the live state
        return view
    widget = table_viz(table, **kwargs)
    try:
        from IPython.display import display

        display(widget)
    except ImportError:
        print(widget)
    return widget
