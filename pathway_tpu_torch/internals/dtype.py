"""Type lattice for column dtypes.

A rebuild of the reference's dtype system (reference:
python/pathway/internals/dtype.py, 979 LoC).  We keep the same user-facing
lattice — ANY at the top, concrete scalar types below, composites
(List/Tuple/Array), Optional as a union with NONE — but the implementation is
a fresh, small singleton-based design.  Machine representation decisions
(numpy/JAX dtypes for the dense path) live in :mod:`pathway_tpu_torch.engine`.
"""

from __future__ import annotations

import datetime
import typing
from typing import Any, Iterable

import numpy as np


class DType:
    """Base of all dtypes. Concrete singletons are created below."""

    _name: str

    def __repr__(self) -> str:
        return self._name

    def is_optional(self) -> bool:
        return False

    def wrapped(self) -> DType:
        return self

    # -- lattice ---------------------------------------------------------
    def is_subtype_of(self, other: DType) -> bool:
        if other is ANY or self == other:
            return True
        if isinstance(other, _OptionalDType):
            if self is NONE:
                return True
            inner = self.wrapped() if isinstance(self, _OptionalDType) else self
            return inner.is_subtype_of(other.wrapped())
        if self is INT and other is FLOAT:
            return True
        if isinstance(self, _OptionalDType):
            return False
        return False

    def __eq__(self, other: object) -> bool:
        return self is other

    def __hash__(self) -> int:
        return id(self)


class _SimpleDType(DType):
    def __init__(self, name: str):
        self._name = name


class _OptionalDType(DType):
    _cache: dict[DType, _OptionalDType] = {}

    def __new__(cls, wrapped: DType) -> _OptionalDType:
        if wrapped in cls._cache:
            return cls._cache[wrapped]
        self = super().__new__(cls)
        self._wrapped = wrapped
        self._name = f"Optional({wrapped!r})"
        cls._cache[wrapped] = self
        return self

    def is_optional(self) -> bool:
        return True

    def wrapped(self) -> DType:
        return self._wrapped

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _OptionalDType) and other._wrapped == self._wrapped

    def __hash__(self) -> int:
        return hash(("Optional", self._wrapped))


class _TupleDType(DType):
    def __init__(self, args: tuple[DType, ...]):
        self.args = args
        self._name = f"Tuple({', '.join(map(repr, args))})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _TupleDType) and other.args == self.args

    def __hash__(self) -> int:
        return hash(("Tuple", self.args))


class _ListDType(DType):
    def __init__(self, arg: DType):
        self.arg = arg
        self._name = f"List({arg!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _ListDType) and other.arg == self.arg

    def __hash__(self) -> int:
        return hash(("List", self.arg))


class _ArrayDType(DType):
    """N-dimensional numeric array column (reference dtype.Array)."""

    def __init__(self, n_dim: int | None = None, wrapped: DType | None = None):
        self.n_dim = n_dim
        self.element_type = wrapped
        self._name = f"Array({n_dim}, {wrapped!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, _ArrayDType)
            and other.n_dim == self.n_dim
            and other.element_type == self.element_type
        )

    def __hash__(self) -> int:
        return hash(("Array", self.n_dim, self.element_type))

    def is_subtype_of(self, other: DType) -> bool:
        if isinstance(other, _ArrayDType):
            dim_ok = other.n_dim is None or other.n_dim == self.n_dim
            el_ok = other.element_type is None or other.element_type == self.element_type
            return dim_ok and el_ok
        return super().is_subtype_of(other)


class _CallableDType(DType):
    def __init__(self, arg_types, return_type):
        self.arg_types = arg_types
        self.return_type = return_type
        self._name = f"Callable(..., {return_type!r})"

    def __eq__(self, other):
        return (
            isinstance(other, _CallableDType)
            and other.arg_types == self.arg_types
            and other.return_type == self.return_type
        )

    def __hash__(self):
        return hash(("Callable", tuple(self.arg_types or ()), self.return_type))


class _PointerDType(DType):
    def __init__(self, *args):
        self.args = args
        self._name = "Pointer" if not args else f"Pointer({args})"

    def __eq__(self, other):
        return isinstance(other, _PointerDType)

    def __hash__(self):
        return hash("Pointer")


ANY = _SimpleDType("ANY")
NONE = _SimpleDType("NONE")
BOOL = _SimpleDType("BOOL")
INT = _SimpleDType("INT")
FLOAT = _SimpleDType("FLOAT")
STR = _SimpleDType("STR")
BYTES = _SimpleDType("BYTES")
JSON = _SimpleDType("JSON")
DATE_TIME_NAIVE = _SimpleDType("DATE_TIME_NAIVE")
DATE_TIME_UTC = _SimpleDType("DATE_TIME_UTC")
DURATION = _SimpleDType("DURATION")
PY_OBJECT_WRAPPER = _SimpleDType("PY_OBJECT_WRAPPER")
POINTER = _PointerDType()
ANY_TUPLE = _SimpleDType("ANY_TUPLE")
ANY_ARRAY = _ArrayDType(None, None)
INT_ARRAY = _ArrayDType(None, INT)
FLOAT_ARRAY = _ArrayDType(None, FLOAT)


def Optional(wrapped: DType) -> DType:
    if wrapped is ANY or isinstance(wrapped, _OptionalDType) or wrapped is NONE:
        return wrapped
    return _OptionalDType(wrapped)


def Tuple(*args: DType) -> DType:
    return _TupleDType(tuple(args))


def List(arg: DType) -> DType:
    return _ListDType(arg)


def Array(n_dim: int | None = None, wrapped: DType | None = None) -> DType:
    return _ArrayDType(n_dim, wrapped)


def Callable(arg_types=..., return_type=ANY) -> DType:
    return _CallableDType(arg_types, return_type)


def Pointer(*args) -> DType:
    return _PointerDType(*args)


_PY_TYPE_MAP: dict[Any, DType] = {
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    type(None): NONE,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
    # pw.DateTimeNaive/DateTimeUtc/Duration (pandas-extending classes,
    # internals/datetime_types.py) resolve via wrap()'s subclass checks
    np.ndarray: ANY_ARRAY,
    dict: JSON,
    Any: ANY,
    typing.Any: ANY,
}


def wrap(input_type: Any) -> DType:
    """Convert a python type annotation / dtype-ish object to a DType."""
    if isinstance(input_type, DType):
        return input_type
    if input_type is None:
        return NONE
    if input_type in _PY_TYPE_MAP:
        return _PY_TYPE_MAP[input_type]
    origin = typing.get_origin(input_type)
    if origin is typing.Union:
        args = typing.get_args(input_type)
        non_none = [a for a in args if a is not type(None)]
        inner = wrap(non_none[0]) if len(non_none) == 1 else ANY
        if type(None) in args:
            return Optional(inner)
        return inner
    if origin in (list, typing.List):
        args = typing.get_args(input_type)
        return List(wrap(args[0])) if args else List(ANY)
    if origin in (tuple, typing.Tuple):
        args = typing.get_args(input_type)
        if not args:
            return ANY_TUPLE
        if len(args) == 2 and args[1] is Ellipsis:
            return List(wrap(args[0]))
        return Tuple(*(wrap(a) for a in args))
    from pathway_tpu_torch.internals.api import Json as JsonCls, Pointer as PointerCls

    if isinstance(input_type, type) and issubclass(input_type, PointerCls):
        return POINTER
    if isinstance(input_type, type) and issubclass(input_type, JsonCls):
        return JSON
    if isinstance(input_type, type):
        # user-facing datetime classes (internals/datetime_types.py):
        # pw.DateTimeNaive / pw.DateTimeUtc / pw.Duration annotations
        from pathway_tpu_torch.internals import datetime_types as _dtt

        if issubclass(input_type, _dtt.Duration):
            return DURATION
        if issubclass(input_type, _dtt.DateTimeUtc):
            return DATE_TIME_UTC
        if issubclass(input_type, _dtt.DateTimeNaive):
            return DATE_TIME_NAIVE
        import pandas as _pd

        if issubclass(input_type, _pd.Timedelta):
            return DURATION
        if issubclass(input_type, _pd.Timestamp):
            return DATE_TIME_NAIVE
    return ANY


def dtype_of_value(value: Any) -> DType:
    from pathway_tpu_torch.internals.api import Json, Pointer as PointerCls, PyObjectWrapper

    if value is None:
        return NONE
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return BOOL
    if isinstance(value, (int, np.integer)):
        return INT
    if isinstance(value, (float, np.floating)):
        return FLOAT
    if isinstance(value, str):
        return STR
    if isinstance(value, bytes):
        return BYTES
    if isinstance(value, PointerCls):
        return POINTER
    if isinstance(value, datetime.datetime):
        return DATE_TIME_UTC if value.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(value, datetime.timedelta):
        return DURATION
    if isinstance(value, np.ndarray):
        if np.issubdtype(value.dtype, np.integer):
            return Array(value.ndim, INT)
        if np.issubdtype(value.dtype, np.floating):
            return Array(value.ndim, FLOAT)
        return Array(value.ndim, ANY)
    if isinstance(value, Json):
        return JSON
    if isinstance(value, (dict, list)):
        return JSON
    if isinstance(value, tuple):
        return Tuple(*(dtype_of_value(v) for v in value))
    if isinstance(value, PyObjectWrapper):
        return PY_OBJECT_WRAPPER
    return ANY


def lub(*types: DType) -> DType:
    """Least upper bound of dtypes in the lattice."""
    result: DType | None = None
    for t in types:
        if result is None:
            result = t
        elif t.is_subtype_of(result):
            pass
        elif result.is_subtype_of(t):
            result = t
        elif result is NONE:
            result = Optional(t)
        elif t is NONE:
            result = Optional(result)
        elif {result.wrapped(), t.wrapped()} <= {INT, FLOAT} and (
            result.is_optional() or t.is_optional()
        ):
            result = Optional(FLOAT)
        else:
            return ANY
    return result if result is not None else ANY


def types_lca(a: DType, b: DType, raising: bool = False) -> DType:
    out = lub(a, b)
    if raising and out is ANY and a is not ANY and b is not ANY:
        raise TypeError(f"no common supertype of {a} and {b}")
    return out


def normalize_default(dtypes: Iterable[DType]) -> DType:
    return lub(*dtypes)


def unoptionalize(t: DType) -> DType:
    return t.wrapped() if isinstance(t, _OptionalDType) else t
