"""Output formatter suite (reference: src/connectors/data_format.rs —
trait Formatter :452; DsvFormatter :941, SingleColumn :1014, PsqlUpdates
:1632, PsqlSnapshot :1691, JsonLines :1829, Bson :1982, Null :1869).

A formatter turns one output delta ``(key, values, time, diff)`` into the
wire payload(s) for a writer. Formatters are transport-independent and
fully testable offline; gated connectors (postgres/mongodb) use them once
their client libraries exist, and `pw.io.subscribe`-style sinks can use
them directly.
"""

from __future__ import annotations

import datetime as _dt
import json as _json
import struct
from typing import Any, Sequence

from pathway_tpu_torch.internals.api import Json, Pointer


class FormatterContext:
    """One formatted output event (reference: FormatterContext,
    data_format.rs:328): payloads + key + time + diff."""

    __slots__ = ("payloads", "key", "time", "diff")

    def __init__(self, payloads, key, time, diff):
        self.payloads = payloads
        self.key = key
        self.time = time
        self.diff = diff


def _plain(v: Any) -> Any:
    if isinstance(v, Json):
        return v.value
    if isinstance(v, Pointer):
        return repr(v)
    return v


class JsonLinesFormatter:
    """reference: data_format.rs:1829 — one JSON object per delta with
    time/diff fields."""

    def __init__(self, value_fields: Sequence[str]):
        self.value_fields = list(value_fields)

    def format(self, key, values, time, diff) -> FormatterContext:
        payload = {
            f: _plain(v) for f, v in zip(self.value_fields, values)
        }
        payload["time"] = time
        payload["diff"] = diff
        line = _json.dumps(payload, default=str).encode() + b"\n"
        return FormatterContext([line], key, time, diff)


class DsvFormatter:
    """reference: data_format.rs:941 — delimiter-separated values plus
    time/diff columns."""

    def __init__(self, value_fields: Sequence[str], separator: str = ","):
        self.value_fields = list(value_fields)
        self.separator = separator

    def header(self) -> bytes:
        return (
            self.separator.join([*self.value_fields, "time", "diff"]) + "\n"
        ).encode()

    def _cell(self, v: Any) -> str:
        s = "" if v is None else str(_plain(v))
        if self.separator in s or '"' in s or "\n" in s:
            s = '"' + s.replace('"', '""') + '"'
        return s

    def format(self, key, values, time, diff) -> FormatterContext:
        cells = [self._cell(v) for v in values] + [str(time), str(diff)]
        return FormatterContext(
            [(self.separator.join(cells) + "\n").encode()], key, time, diff
        )


class SingleColumnFormatter:
    """reference: data_format.rs:1014 — the raw value of one column."""

    def __init__(self, value_index: int = 0):
        self.value_index = value_index

    def format(self, key, values, time, diff) -> FormatterContext:
        v = values[self.value_index]
        if isinstance(v, bytes):
            payload = v
        else:
            payload = str(_plain(v)).encode()
        return FormatterContext([payload], key, time, diff)


def _sql_literal(v: Any) -> str:
    import math

    v = _plain(v)
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, float) and not math.isfinite(v):
        # bare nan/inf are not SQL literals; PostgreSQL wants quoted forms
        if math.isnan(v):
            return "'NaN'::float8"
        return "'Infinity'::float8" if v > 0 else "'-Infinity'::float8"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, bytes):
        return "'\\x" + v.hex() + "'"
    if isinstance(v, (dict, list)):
        v = _json.dumps(v, default=str)
    return "'" + str(v).replace("'", "''") + "'"


def _sql_ident(name: str) -> str:
    """Double-quote an identifier (each dotted part) so reserved words
    (user, order, ...) and mixed-case names survive a real PostgreSQL
    parser — the mock-free failure mode is an upsert keyed on the
    SESSION user instead of the column."""
    return ".".join(
        '"' + part.replace('"', '""') + '"' for part in name.split(".")
    )


class PsqlUpdatesFormatter:
    """reference: data_format.rs:1632 — INSERT per delta carrying time and
    diff columns; consumers reconstruct the update stream."""

    def __init__(self, table_name: str, value_fields: Sequence[str]):
        self.table_name = table_name
        self.value_fields = list(value_fields)

    def format(self, key, values, time, diff) -> FormatterContext:
        cols = ",".join(
            _sql_ident(c) for c in [*self.value_fields, "time", "diff"]
        )
        vals = ",".join(
            [_sql_literal(v) for v in values] + [str(time), str(diff)]
        )
        stmt = (
            f"INSERT INTO {_sql_ident(self.table_name)} ({cols}) "
            f"VALUES ({vals});\n"
        )
        return FormatterContext([stmt.encode()], key, time, diff)


class PsqlSnapshotFormatter:
    """reference: data_format.rs:1691 — maintain the CURRENT snapshot:
    upsert on the primary key for insertions, DELETE for retractions."""

    def __init__(
        self,
        table_name: str,
        primary_key_fields: Sequence[str],
        value_fields: Sequence[str],
    ):
        self.table_name = table_name
        self.primary_key_fields = list(primary_key_fields)
        self.value_fields = list(value_fields)
        missing = set(primary_key_fields) - set(value_fields)
        if missing:
            raise ValueError(
                f"primary key fields {sorted(missing)} not in value fields"
            )

    def format(self, key, values, time, diff) -> FormatterContext:
        by_name = dict(zip(self.value_fields, values))
        if diff < 0:
            cond = " AND ".join(
                f"{_sql_ident(f)}={_sql_literal(by_name[f])}"
                for f in self.primary_key_fields
            )
            stmt = f"DELETE FROM {_sql_ident(self.table_name)} WHERE {cond};\n"
        else:
            cols = ",".join(_sql_ident(c) for c in self.value_fields)
            vals = ",".join(_sql_literal(v) for v in values)
            pk = ",".join(_sql_ident(f) for f in self.primary_key_fields)
            non_pk = [
                f for f in self.value_fields
                if f not in self.primary_key_fields
            ]
            if non_pk:
                update = ",".join(
                    f"{_sql_ident(f)}={_sql_literal(by_name[f])}"
                    for f in non_pk
                )
                conflict = f"DO UPDATE SET {update}"
            else:
                conflict = "DO NOTHING"
            stmt = (
                f"INSERT INTO {_sql_ident(self.table_name)} ({cols}) "
                f"VALUES ({vals}) ON CONFLICT ({pk}) {conflict};\n"
            )
        return FormatterContext([stmt.encode()], key, time, diff)


# -- BSON (hand-rolled: no bson client lib in this image) -------------------

def _bson_cstring(s: str) -> bytes:
    return s.encode("utf-8") + b"\x00"


def _bson_string(s: str) -> bytes:
    raw = s.encode("utf-8") + b"\x00"
    return struct.pack("<i", len(raw)) + raw


def _bson_element(name: str, v: Any) -> bytes:
    v = _plain(v)
    n = _bson_cstring(name)
    if v is None:
        return b"\x0a" + n
    if isinstance(v, bool):
        return b"\x08" + n + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(2**31) <= v < 2**31:
            return b"\x10" + n + struct.pack("<i", v)
        if -(2**63) <= v < 2**63:
            return b"\x12" + n + struct.pack("<q", v)
        raise ValueError(f"integer {v} exceeds BSON int64 range")
    if isinstance(v, float):
        return b"\x01" + n + struct.pack("<d", v)
    if isinstance(v, str):
        return b"\x02" + n + _bson_string(v)
    if isinstance(v, bytes):
        return b"\x05" + n + struct.pack("<i", len(v)) + b"\x00" + v
    if isinstance(v, _dt.datetime):
        millis = int(v.timestamp() * 1000)
        return b"\x09" + n + struct.pack("<q", millis)
    if isinstance(v, dict):
        return b"\x03" + n + bson_document(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + n + bson_document(
            {str(i): x for i, x in enumerate(v)}
        )
    return b"\x02" + n + _bson_string(str(v))


def bson_document(doc: dict) -> bytes:
    """Serialize a dict as a BSON document (spec: bsonspec.org, the format
    the reference's Bson formatter emits via the bson crate)."""
    body = b"".join(_bson_element(str(k), v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


class BsonFormatter:
    """reference: data_format.rs:1982 — one BSON document per delta with
    time/diff fields (MongoWriter's wire format)."""

    def __init__(self, value_fields: Sequence[str]):
        self.value_fields = list(value_fields)

    def format(self, key, values, time, diff) -> FormatterContext:
        doc = {f: _plain(v) for f, v in zip(self.value_fields, values)}
        doc["time"] = time
        doc["diff"] = diff
        return FormatterContext([bson_document(doc)], key, time, diff)


class NullFormatter:
    """reference: data_format.rs:1869."""

    def format(self, key, values, time, diff) -> FormatterContext:
        return FormatterContext([], key, time, diff)
