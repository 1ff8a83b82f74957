"""Schema system (reference: python/pathway/internals/schema.py:913).

``class MySchema(pw.Schema): x: int = pw.column_definition(...)`` declares
column names, dtypes, primary keys and defaults.  Schemas are classes whose
metaclass collects annotations into ordered ``ColumnDefinition``s.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass
from typing import Any, Mapping

from pathway_tpu_torch.internals import dtype as dt

_NO_DEFAULT = object()


@dataclass
class ColumnDefinition:
    dtype: dt.DType = dt.ANY
    primary_key: bool = False
    default_value: Any = _NO_DEFAULT
    name: str | None = None
    append_only: bool | None = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not _NO_DEFAULT


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _NO_DEFAULT,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
) -> Any:
    return ColumnDefinition(
        dtype=dt.wrap(dtype) if dtype is not None else dt.ANY,
        primary_key=primary_key,
        default_value=default_value,
        name=name,
        append_only=append_only,
    )


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnDefinition]

    def __new__(mcs, name, bases, namespace, append_only=False, **kwargs):
        cls = super().__new__(mcs, name, bases, namespace)
        columns: dict[str, ColumnDefinition] = {}
        for base in bases:
            columns.update(getattr(base, "__columns__", {}))
        annotations = namespace.get("__annotations__", {})
        hints: dict[str, Any] = {}
        for col, annotation in annotations.items():
            try:
                hints[col] = typing.get_type_hints(
                    type("..", (), {"__annotations__": {col: annotation}})
                )[col]
            except Exception:
                hints[col] = annotation
        for col, annotation in annotations.items():
            definition = namespace.get(col, None)
            if not isinstance(definition, ColumnDefinition):
                definition = ColumnDefinition(
                    default_value=definition if col in namespace else _NO_DEFAULT
                )
            definition.dtype = dt.wrap(hints.get(col, annotation))
            definition.name = definition.name or col
            if definition.append_only is None:
                definition.append_only = append_only
            columns[definition.name] = definition
        cls.__columns__ = columns
        return cls

    def __init__(cls, name, bases, namespace, **kwargs):
        super().__init__(name, bases, namespace)

    # -- introspection ----------------------------------------------------
    def columns(cls) -> Mapping[str, ColumnDefinition]:
        return dict(cls.__columns__)

    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def _dtypes(cls) -> dict[str, dt.DType]:
        return {name: c.dtype for name, c in cls.__columns__.items()}

    def typehints(cls) -> dict[str, Any]:
        return {name: c.dtype for name, c in cls.__columns__.items()}

    def primary_key_columns(cls) -> list[str] | None:
        pkeys = [name for name, c in cls.__columns__.items() if c.primary_key]
        return pkeys or None

    def default_values(cls) -> dict[str, Any]:
        return {
            name: c.default_value
            for name, c in cls.__columns__.items()
            if c.has_default_value
        }

    def keys(cls):
        return cls.__columns__.keys()

    def __getitem__(cls, name: str) -> ColumnDefinition:
        return cls.__columns__[name]

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        cols = dict(cls.__columns__)
        cols.update(other.__columns__)
        return schema_builder(cols, name=f"{cls.__name__}|{other.__name__}")

    def with_types(cls, **kwargs) -> "SchemaMetaclass":
        cols = {n: ColumnDefinition(**vars(c)) for n, c in cls.__columns__.items()}
        for name, t in kwargs.items():
            if name not in cols:
                raise ValueError(f"unknown column {name}")
            cols[name].dtype = dt.wrap(t)
        return schema_builder(cols, name=cls.__name__)

    def without(cls, *names) -> "SchemaMetaclass":
        names = {n if isinstance(n, str) else n.name for n in names}
        cols = {n: c for n, c in cls.__columns__.items() if n not in names}
        return schema_builder(cols, name=cls.__name__)

    def update_properties(cls, **kwargs) -> "SchemaMetaclass":
        return cls

    def __repr__(cls):
        fields = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<pathway.Schema types={{{fields}}}>"


class Schema(metaclass=SchemaMetaclass):
    """Base class for user-declared schemas."""


def schema_from_types(_name: str = "Schema", **kwargs) -> type[Schema]:
    cols = {
        name: ColumnDefinition(dtype=dt.wrap(t), name=name) for name, t in kwargs.items()
    }
    return schema_builder(cols, name=_name)


def schema_from_dict(
    columns: Mapping[str, Any], *, name: str = "Schema"
) -> type[Schema]:
    cols = {}
    for cname, spec in columns.items():
        if isinstance(spec, ColumnDefinition):
            spec.name = spec.name or cname
            cols[cname] = spec
        elif isinstance(spec, dict):
            cols[cname] = ColumnDefinition(
                dtype=dt.wrap(spec.get("dtype", dt.ANY)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", _NO_DEFAULT),
                name=cname,
            )
        else:
            cols[cname] = ColumnDefinition(dtype=dt.wrap(spec), name=cname)
    return schema_builder(cols, name=name)


def schema_builder(
    columns: Mapping[str, ColumnDefinition], *, name: str = "custom_schema", properties=None
) -> type[Schema]:
    cls = SchemaMetaclass(name, (Schema,), {})
    cls.__columns__ = dict(columns)
    return cls


def schema_from_pandas(df, *, id_from=None, name: str = "schema_from_pandas") -> type[Schema]:
    import numpy as np

    cols = {}
    for cname in df.columns:
        series = df[cname]
        # extension dtypes (pandas StringDtype/Int64 etc.) are not numpy
        # dtypes and crash np.issubdtype — use the dtype kind; nullable
        # EXTENSION columns (Int64 carrying pd.NA) fall to value inference
        # so they type as Optional (numpy float NaN stays plain FLOAT)
        kind = getattr(series.dtype, "kind", None)
        is_ext = not isinstance(series.dtype, np.dtype)
        ext_na = is_ext and len(series) and bool(series.isna().any())
        if kind in ("i", "u") and not ext_na:
            t: Any = dt.INT
        elif kind == "f" and not ext_na:
            t = dt.FLOAT
        elif kind == "b" and not ext_na:
            t = dt.BOOL
        else:
            t = dt.lub(*(dt.dtype_of_value(v) for v in series)) if len(series) else dt.ANY
        cols[cname] = ColumnDefinition(
            dtype=t, name=cname, primary_key=bool(id_from and cname in id_from)
        )
    return schema_builder(cols, name=name)
