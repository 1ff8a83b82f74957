"""pw.io.nats — NATS connector (reference: python/pathway/io/nats over
the native NatsReader/NatsWriter, src/connectors/data_storage.rs:2226,
:2300).

Redesigned transport: no nats-py — a dependency-free wire-protocol
client (`pathway_tpu_torch/io/_nats.py`). The writer attaches the reference's
``pathway_time`` / ``pathway_diff`` headers to every message; the reader
supports raw / plaintext / json formats with an autogenerated primary
key, like the reference surface.
"""

from __future__ import annotations

import json as _json
from typing import Any, Iterable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema, schema_from_types
from pathway_tpu_torch.io._nats import NatsConnection
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read

__all__ = ["read", "write"]


class _NatsSubject(ConnectorSubject):
    _deletions_enabled = False  # live bus: append-only messages

    def __init__(self, uri, topic, fmt, columns, connection=None):
        super().__init__()
        self.uri = uri
        self.topic = topic
        self.fmt = fmt
        self.columns = columns
        self._conn = connection
        self._stop = False

    def run(self):
        conn = self._conn or NatsConnection(self.uri)
        conn.subscribe(self.topic)
        try:
            while not self._stop:
                try:
                    msg = conn.next_msg(timeout=0.3)
                except EOFError:
                    break  # server closed: end of stream
                if msg is None:
                    continue
                _subject, payload, _headers = msg
                if self.fmt == "raw":
                    self.next(data=payload)
                elif self.fmt == "plaintext":
                    self.next(data=payload.decode("utf-8", "replace"))
                else:  # json
                    doc = _json.loads(payload)
                    self.next(**{c: doc.get(c) for c in self.columns})
        finally:
            conn.close()

    def on_stop(self):
        self._stop = True


def read(
    uri: str,
    topic: str,
    *,
    schema: type[Schema] | None = None,
    format: str = "raw",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    _connection=None,
    **kwargs,
):
    """Read messages from a NATS topic (reference: io/nats/__init__.py:23
    — raw/plaintext/json formats, autogenerated primary key)."""
    if format in ("raw", "plaintext"):
        schema = schema_from_types(
            data=dt.BYTES if format == "raw" else dt.STR
        )
    elif schema is None:
        raise ValueError("pw.io.nats.read requires schema= for json format")
    subject = _NatsSubject(
        uri, topic, format, schema.column_names(), connection=_connection
    )
    return python_read(
        subject,
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"nats://{topic}",
    )


def write(
    table,
    uri: str,
    topic: str,
    *,
    format: str = "json",
    delimiter: str = ",",
    value=None,
    headers: Iterable | None = None,
    name: str | None = None,
    _connection=None,
) -> None:
    """Publish table updates to a NATS topic (reference:
    io/nats/__init__.py:154). Every message carries ``pathway_time`` and
    ``pathway_diff`` headers; json/dsv serialize the whole row, while
    plaintext/raw publish the ``value`` column's payload."""
    cols = table.column_names()
    if format in ("plaintext", "raw") and value is None:
        raise ValueError(
            f"pw.io.nats.write format={format!r} needs the value= column"
        )
    value_name = getattr(value, "name", value)
    header_names = [getattr(h, "name", h) for h in (headers or [])]
    state: dict[str, Any] = {"conn": _connection}

    def _conn():
        if state["conn"] is None:
            state["conn"] = NatsConnection(uri)
        return state["conn"]

    def on_change(key, row, time_, diff):
        doc = dict(zip(cols, row))
        msg_headers = {
            "pathway_time": str(time_),
            "pathway_diff": str(1 if diff > 0 else -1),
        }
        for h in header_names:
            msg_headers[h] = str(doc.get(h))
        if format == "json":
            payload = _json.dumps(doc, default=str).encode()
        elif format == "dsv":
            payload = delimiter.join(str(doc[c]) for c in cols).encode()
        else:
            v = doc.get(value_name)
            payload = v if isinstance(v, bytes) else str(v).encode()
        _conn().publish(topic, payload, headers=msg_headers)

    def on_end():
        if state["conn"] is not None:
            state["conn"].close()
            state["conn"] = None

    def lower(ctx):
        ctx.scope.output(
            ctx.engine_table(table), on_change=on_change, on_end=on_end
        )

    G.add_operator([table], [], lower, "nats_write", is_output=True)
