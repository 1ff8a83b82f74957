"""pw.demo — synthetic streams, the port's copy of the JAX package's
``demo`` (reference: python/pathway/demo/__init__.py:28
generate_custom_stream, :118 noisy_linear_stream, range stream,
replay_csv)."""

from __future__ import annotations

import csv as _csv
import random
import time
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import Schema, schema_from_types
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


def generate_custom_stream(
    value_generators: dict[str, Callable[[int], Any]],
    *,
    schema: type[Schema] | None = None,
    nb_rows: int | None = None,
    autocommit_duration_ms: int = 1000,
    input_rate: float = 1.0,
    persistent_id: str | None = None,
):
    """Stream rows produced by per-column generators called with the row
    index (reference: demo/__init__.py:28)."""
    if schema is None:
        schema = schema_from_types(**{name: dt.ANY for name in value_generators})

    class _Gen(ConnectorSubject):
        def run(self):
            i = 0
            while nb_rows is None or i < nb_rows:
                self.next(
                    **{name: gen(i) for name, gen in value_generators.items()}
                )
                i += 1
                if input_rate > 0:
                    time.sleep(1.0 / input_rate)
            self.commit()

    return python_read(
        _Gen(), schema=schema, autocommit_duration_ms=autocommit_duration_ms
    )


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0):
    """Rows (x, y) with y ~ x + noise (reference: demo/__init__.py:118)."""
    rng = random.Random(0)

    return generate_custom_stream(
        {
            "x": lambda i: i,
            "y": lambda i: i + (2 * rng.random() - 1) / 10,
        },
        schema=schema_from_types(x=dt.INT, y=dt.FLOAT),
        nb_rows=nb_rows,
        input_rate=input_rate,
    )


def range_stream(
    nb_rows: int = 30, offset: int = 0, input_rate: float = 1.0, **kwargs
):
    return generate_custom_stream(
        {"value": lambda i: i + offset},
        schema=schema_from_types(value=dt.INT),
        nb_rows=nb_rows,
        input_rate=input_rate,
    )


def _schema_coercer(schema: type[Schema]):
    """Coerce CSV strings per the declared column types — guessing int/float
    would corrupt str columns like \"0123\"."""
    hints = schema.typehints()

    def coerce(col: str, v):
        if v is None:
            return None
        t = hints.get(col)
        if t is dt.INT:
            return int(v)
        if t is dt.FLOAT:
            return float(v)
        if t is dt.BOOL:
            return v in ("True", "true", "1")
        if t is dt.STR:
            return str(v)
        return _coerce(v)

    return coerce


def replay_csv(
    path: str,
    *,
    schema: type[Schema],
    input_rate: float = 1.0,
):
    """Replay a CSV file row by row at `input_rate` rows/s (reference:
    demo/__init__.py replay_csv)."""
    cols = schema.column_names()
    coerce = _schema_coercer(schema)

    class _Replay(ConnectorSubject):
        def run(self):
            with open(path, newline="") as f:
                for rec in _csv.DictReader(f):
                    self.next(**{c: coerce(c, rec.get(c)) for c in cols})
                    if input_rate > 0:
                        time.sleep(1.0 / input_rate)
            self.commit()

    return python_read(_Replay(), schema=schema, autocommit_duration_ms=1000)


def replay_csv_with_time(
    path: str,
    *,
    schema: type[Schema],
    time_column: str,
    unit: str = "s",
    autocommit_ms: int = 100,
    speedup: float = 1,
):
    """Replay a CSV using the time column's deltas as real delays
    (reference: demo/__init__.py replay_csv_with_time)."""
    cols = schema.column_names()
    unit_s = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[unit]
    coerce = _schema_coercer(schema)

    class _Replay(ConnectorSubject):
        def run(self):
            prev_t = None
            with open(path, newline="") as f:
                for rec in _csv.DictReader(f):
                    row = {c: coerce(c, rec.get(c)) for c in cols}
                    t = float(row[time_column])
                    if prev_t is not None and t > prev_t:
                        time.sleep((t - prev_t) * unit_s / speedup)
                    prev_t = t
                    self.next(**row)
            self.commit()

    return python_read(_Replay(), schema=schema, autocommit_duration_ms=autocommit_ms)


def _coerce(v):
    if v is None:
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except (TypeError, ValueError):
            pass
    return v
