"""Top-level API compatibility surface (reference:
python/pathway/__init__.py __all__ — aliases and small helpers that
round out the `import pathway as pw` drop-in surface)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import Schema, schema_from_types


# -- pw.Type / pw.PersistenceMode ------------------------------------------

Type = dt.DType


class PersistenceMode:
    """reference: api.PersistenceMode (engine.pyi:776)."""

    PERSISTING = "PERSISTING"
    OPERATOR_PERSISTING = "OPERATOR_PERSISTING"
    BATCH = "BATCH"
    REALTIME_REPLAY = "REALTIME_REPLAY"
    SPEEDRUN_REPLAY = "SPEEDRUN_REPLAY"
    UDF_CACHING = "UDF_CACHING"


# -- custom accumulators ----------------------------------------------------


class BaseCustomAccumulator(ABC):
    """reference: internals/custom_reducers.py:174 — subclass with
    from_row/update/compute_result (+ optional neutral/retract) and use via
    pw.reducers.udf_reducer(MyAccumulator)."""

    @classmethod
    @abstractmethod
    def from_row(cls, row: list) -> "BaseCustomAccumulator": ...

    @abstractmethod
    def update(self, other: "BaseCustomAccumulator") -> "BaseCustomAccumulator": ...

    @abstractmethod
    def compute_result(self) -> Any: ...


# -- schema helpers ---------------------------------------------------------


@dataclass(frozen=True)
class SchemaProperties:
    append_only: bool = False


def schema_from_csv(path: str, *, name: str = "schema_from_csv",
                    num_parsed_rows: int | None = 20, **kwargs) -> type[Schema]:
    """Infer a schema from a CSV file's header + sampled rows (reference:
    schema.py schema_from_csv)."""
    import csv as _csv

    with open(path, newline="") as f:
        reader = _csv.DictReader(f)
        names = reader.fieldnames or []
        samples: list[dict] = []
        for i, rec in enumerate(reader):
            if num_parsed_rows is not None and i >= num_parsed_rows:
                break
            samples.append(rec)
    cols = {}
    for cname in names:
        vals = [_coerce(r.get(cname)) for r in samples]
        cols[cname] = (
            dt.lub(*(dt.dtype_of_value(v) for v in vals)) if vals else dt.ANY
        )
    return schema_from_types(**cols)


def _coerce(v):
    if v is None:
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except (TypeError, ValueError):
            pass
    return v


def assert_table_has_schema(
    table, schema: type[Schema], *, allow_superset: bool = False, **kwargs
) -> None:
    """reference: assert_table_has_schema — column-name (and presence)
    validation at declaration time."""
    expected = set(schema.column_names())
    actual = set(table.column_names())
    if allow_superset:
        missing = expected - actual
        if missing:
            raise AssertionError(
                f"table is missing columns {sorted(missing)}"
            )
    elif expected != actual:
        raise AssertionError(
            f"table columns {sorted(actual)} != schema columns "
            f"{sorted(expected)}"
        )


# -- decorators / free functions -------------------------------------------


def table_transformer(func: Callable) -> Callable:
    """reference: internals/common.py:520 — marks a Table -> Table
    function; a passthrough here (argument checking is dynamic)."""
    return func


def join(left, right, *on, **kwargs):
    return left.join(right, *on, **kwargs)


def join_inner(left, right, *on, **kwargs):
    return left.join_inner(right, *on, **kwargs)


def join_left(left, right, *on, **kwargs):
    return left.join_left(right, *on, **kwargs)


def join_right(left, right, *on, **kwargs):
    return left.join_right(right, *on, **kwargs)


def join_outer(left, right, *on, **kwargs):
    return left.join_outer(right, *on, **kwargs)


def groupby(table, *args, **kwargs):
    return table.groupby(*args, **kwargs)


def iterate_universe(body, **kwargs):
    """reference: iterate_universe — universe-changing fixed point; our
    iterate already permits key-set changes across iterations."""
    from pathway_tpu_torch.internals.iterate import iterate

    return iterate(body, **kwargs)


def local_error_log():
    """reference: local_error_log — per-scope error log; scopes are not
    nested here, so this is the global log."""
    from pathway_tpu_torch.internals.error_log import global_error_log

    return global_error_log()
