"""Column expression algebra (reference: python/pathway/internals/expression.py:88).

Expressions are built at declaration time by operator overloading on
``ColumnExpression`` and evaluated natively by the engine's batch evaluator
(:mod:`pathway_tpu_torch.engine.expression`) — vectorised over row batches, with
numeric columns lowered to numpy/JAX where possible.  No Python per-row
dispatch happens for pure expressions; only ``pw.apply`` re-enters Python.
"""

from __future__ import annotations

import operator
from typing import TYPE_CHECKING, Any, Callable, Iterable

from pathway_tpu_torch.internals import dtype as dt

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class ColumnExpression:
    _dtype: dt.DType

    def __init__(self):
        self._dtype = dt.ANY

    # -- arithmetics -----------------------------------------------------
    def __add__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.add, "+")

    def __radd__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.add, "+")

    def __sub__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.sub, "-")

    def __rsub__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.sub, "-")

    def __mul__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.mul, "*")

    def __rmul__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.mul, "*")

    def __truediv__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.truediv, "/")

    def __rtruediv__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.truediv, "/")

    def __floordiv__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.floordiv, "//")

    def __rfloordiv__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.floordiv, "//")

    def __mod__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.mod, "%")

    def __rmod__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.mod, "%")

    def __pow__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.pow, "**")

    def __rpow__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.pow, "**")

    def __matmul__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.matmul, "@")

    def __rmatmul__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.matmul, "@")

    def __neg__(self):
        return ColumnUnaryOpExpression(self, operator.neg, "-")

    # -- comparisons -----------------------------------------------------
    def __eq__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression(self, other, operator.eq, "==")

    def __ne__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression(self, other, operator.ne, "!=")

    def __lt__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.lt, "<")

    def __le__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.le, "<=")

    def __gt__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.gt, ">")

    def __ge__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.ge, ">=")

    # -- boolean ---------------------------------------------------------
    def __and__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.and_, "&")

    def __rand__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.and_, "&")

    def __or__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.or_, "|")

    def __ror__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.or_, "|")

    def __xor__(self, other):
        return ColumnBinaryOpExpression(self, other, operator.xor, "^")

    def __rxor__(self, other):
        return ColumnBinaryOpExpression(other, self, operator.xor, "^")

    def __invert__(self):
        return ColumnUnaryOpExpression(self, operator.not_, "~")

    def __abs__(self):
        return ColumnUnaryOpExpression(self, operator.abs, "abs")

    def __bool__(self):
        raise RuntimeError(
            "Cannot use a ColumnExpression as a boolean; "
            "use & | ~ instead of and/or/not"
        )

    def __hash__(self):
        return id(self)

    # -- containers ------------------------------------------------------
    def __getitem__(self, index):
        return GetExpression(self, index, check_if_exists=False)

    def get(self, index, default=None):
        return GetExpression(self, index, default=default, check_if_exists=True)

    # -- misc API --------------------------------------------------------
    def is_none(self):
        return IsNoneExpression(self)

    def is_not_none(self):
        return IsNotNoneExpression(self)

    def to_string(self):
        return MethodCallExpression("to_string", (self,), _to_string, dt.STR)

    def as_int(self, **kw):
        return ConvertExpression(self, dt.Optional(dt.INT), int)

    def as_float(self, **kw):
        return ConvertExpression(self, dt.Optional(dt.FLOAT), float)

    def as_str(self, **kw):
        return ConvertExpression(self, dt.Optional(dt.STR), str)

    def as_bool(self, **kw):
        return ConvertExpression(self, dt.Optional(dt.BOOL), bool)

    @property
    def dt(self):
        from pathway_tpu_torch.internals.expressions import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from pathway_tpu_torch.internals.expressions import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from pathway_tpu_torch.internals.expressions import NumericalNamespace

        return NumericalNamespace(self)

    def _subexpressions(self) -> Iterable["ColumnExpression"]:
        return ()

    @property
    def _deps(self) -> tuple["ColumnReference", ...]:
        out: list[ColumnReference] = []
        stack = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, ColumnReference):
                out.append(e)
            else:
                stack.extend(e._subexpressions())
        return tuple(out)

    @property
    def _is_deterministic(self) -> bool:
        """False if any apply in the tree is declared non-deterministic —
        such expressions must replay memoized outputs on retraction
        (reference: `deterministic` flag, graph.rs:751 + dataflow.rs:1480
        map_named_async_with_consistent_deletions)."""
        stack: list[ColumnExpression] = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, ApplyExpression) and not e._deterministic:
                return False
            stack.extend(e._subexpressions())
        return True


def _to_string(x):
    return str(x)


def smart_coerce(arg: Any) -> ColumnExpression:
    if isinstance(arg, ColumnExpression):
        return arg
    return ColumnConstExpression(arg)


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        super().__init__()
        self._val = value
        self._dtype = dt.dtype_of_value(value)

    def __repr__(self):
        return repr(self._val)


class ColumnReference(ColumnExpression):
    """Reference to a column of a table: ``table.colname`` / ``pw.this.colname``."""

    def __init__(self, *, table: "Table", name: str):
        super().__init__()
        self._table = table
        self._name = name
        if name == "id":
            self._dtype = dt.POINTER
        else:
            self._dtype = table.schema._dtypes().get(name, dt.ANY)

    @property
    def table(self) -> "Table":
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"<{self._table._name}>.{self._name}"

    def _subexpressions(self):
        return ()


class ColumnBinaryOpExpression(ColumnExpression):
    def __init__(self, left, right, op: Callable, symbol: str):
        super().__init__()
        self._left = smart_coerce(left)
        self._right = smart_coerce(right)
        self._operator = op
        self._symbol = symbol
        self._dtype = _binary_dtype(symbol, self._left._dtype, self._right._dtype)

    def _subexpressions(self):
        return (self._left, self._right)

    def __repr__(self):
        return f"({self._left!r} {self._symbol} {self._right!r})"


def _binary_dtype(symbol: str, lt: dt.DType, rt: dt.DType) -> dt.DType:
    if symbol in ("==", "!=", "<", "<=", ">", ">="):
        return dt.BOOL
    if symbol in ("&", "|", "^") and lt is dt.BOOL and rt is dt.BOOL:
        return dt.BOOL
    if symbol == "/":
        if lt in (dt.INT, dt.FLOAT) and rt in (dt.INT, dt.FLOAT):
            return dt.FLOAT
    if symbol in ("+", "-", "*", "//", "%", "**"):
        if lt is dt.INT and rt is dt.INT:
            return dt.INT
        if lt in (dt.INT, dt.FLOAT) and rt in (dt.INT, dt.FLOAT):
            return dt.FLOAT
        if symbol == "+" and lt is dt.STR and rt is dt.STR:
            return dt.STR
    return dt.lub(lt, rt) if symbol in ("+", "-") else dt.ANY


class ColumnUnaryOpExpression(ColumnExpression):
    def __init__(self, expr, op: Callable, symbol: str):
        super().__init__()
        self._expr = smart_coerce(expr)
        self._operator = op
        self._symbol = symbol
        self._dtype = dt.BOOL if symbol == "~" else self._expr._dtype

    def _subexpressions(self):
        return (self._expr,)

    def __repr__(self):
        return f"{self._symbol}({self._expr!r})"


class ReducerExpression(ColumnExpression):
    def __init__(self, reducer, *args, **kwargs):
        super().__init__()
        self._reducer = reducer
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = kwargs
        self._dtype = reducer.return_type([a._dtype for a in self._args])

    def _subexpressions(self):
        return self._args

    def __repr__(self):
        return f"pathway.reducers.{self._reducer.name}({', '.join(map(repr, self._args))})"


class ApplyExpression(ColumnExpression):
    def __init__(
        self,
        fun: Callable,
        return_type: Any,
        propagate_none: bool,
        deterministic: bool,
        args: tuple,
        kwargs: dict,
        max_batch_size: int | None = None,
    ):
        super().__init__()
        self._fun = fun
        self._return_type = return_type
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = {k: smart_coerce(v) for k, v in kwargs.items()}
        self._max_batch_size = max_batch_size
        self._dtype = dt.wrap(return_type)

    def _subexpressions(self):
        return self._args + tuple(self._kwargs.values())

    def __repr__(self):
        return f"pathway.apply({getattr(self._fun, '__name__', self._fun)}, ...)"


class AsyncApplyExpression(ApplyExpression):
    pass


class FullyAsyncApplyExpression(AsyncApplyExpression):
    pass


class CastExpression(ColumnExpression):
    def __init__(self, return_type: Any, expr):
        super().__init__()
        self._expr = smart_coerce(expr)
        self._dtype = dt.wrap(return_type)

    def _subexpressions(self):
        return (self._expr,)


class ConvertExpression(ColumnExpression):
    """Json →scalar conversions (as_int etc.)."""

    def __init__(self, expr, target: dt.DType, fun: Callable):
        super().__init__()
        self._expr = smart_coerce(expr)
        self._fun = fun
        self._dtype = target

    def _subexpressions(self):
        return (self._expr,)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, return_type: Any, expr):
        super().__init__()
        self._expr = smart_coerce(expr)
        self._dtype = dt.wrap(return_type)

    def _subexpressions(self):
        return (self._expr,)


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args):
        super().__init__()
        self._args = tuple(smart_coerce(a) for a in args)
        self._dtype = dt.lub(*(dt.unoptionalize(a._dtype) for a in self._args))

    def _subexpressions(self):
        return self._args


class RequireExpression(ColumnExpression):
    def __init__(self, val, *args):
        super().__init__()
        self._val = smart_coerce(val)
        self._args = tuple(smart_coerce(a) for a in args)
        self._dtype = dt.Optional(self._val._dtype)

    def _subexpressions(self):
        return (self._val,) + self._args


class IfElseExpression(ColumnExpression):
    def __init__(self, _if, _then, _else):
        super().__init__()
        self._if = smart_coerce(_if)
        self._then = smart_coerce(_then)
        self._else = smart_coerce(_else)
        self._dtype = dt.lub(self._then._dtype, self._else._dtype)

    def _subexpressions(self):
        return (self._if, self._then, self._else)


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr):
        super().__init__()
        self._expr = smart_coerce(expr)
        self._dtype = dt.BOOL

    def _subexpressions(self):
        return (self._expr,)


class IsNotNoneExpression(ColumnExpression):
    def __init__(self, expr):
        super().__init__()
        self._expr = smart_coerce(expr)
        self._dtype = dt.BOOL

    def _subexpressions(self):
        return (self._expr,)


class PointerExpression(ColumnExpression):
    """``table.pointer_from(...)`` — derive a row id from values."""

    def __init__(self, table: "Table", *args, optional: bool = False, instance=None):
        super().__init__()
        self._table = table
        self._args = tuple(smart_coerce(a) for a in args)
        self._optional = optional
        self._instance = smart_coerce(instance) if instance is not None else None
        self._dtype = dt.Optional(dt.POINTER) if optional else dt.POINTER

    def _subexpressions(self):
        extra = (self._instance,) if self._instance is not None else ()
        return self._args + extra


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args):
        super().__init__()
        self._args = tuple(smart_coerce(a) for a in args)
        self._dtype = dt.Tuple(*(a._dtype for a in self._args))

    def _subexpressions(self):
        return self._args


class GetExpression(ColumnExpression):
    def __init__(self, obj, index, default=None, check_if_exists=True):
        super().__init__()
        self._object = smart_coerce(obj)
        self._index = smart_coerce(index)
        self._default = smart_coerce(default)
        self._check_if_exists = check_if_exists
        obj_t = self._object._dtype
        if isinstance(obj_t, dt._TupleDType) and isinstance(
            self._index, ColumnConstExpression
        ):
            idx = self._index._val
            if isinstance(idx, int) and -len(obj_t.args) <= idx < len(obj_t.args):
                self._dtype = obj_t.args[idx]
            else:
                self._dtype = dt.ANY
        elif isinstance(obj_t, dt._ListDType):
            self._dtype = obj_t.arg if not check_if_exists else dt.Optional(obj_t.arg)
        elif obj_t is dt.JSON:
            self._dtype = dt.Optional(dt.JSON) if check_if_exists else dt.JSON
        else:
            self._dtype = dt.ANY

    def _subexpressions(self):
        return (self._object, self._index, self._default)


class MethodCallExpression(ColumnExpression):
    """A .dt/.str/.num namespace method lowered to a native batch function.

    ``propagate_none=False`` lets the function see None subjects —
    required by methods whose JOB is handling None (num.fill_na)."""

    def __init__(
        self, name: str, args: tuple, fun: Callable, return_type: Any,
        propagate_none: bool = True,
    ):
        super().__init__()
        self._name = name
        self._args = tuple(smart_coerce(a) for a in args)
        self._fun = fun
        self._dtype = dt.wrap(return_type)
        self._propagate_none = propagate_none

    def _subexpressions(self):
        return self._args

    def __repr__(self):
        return f"({self._args[0]!r}).{self._name}(...)"


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr):
        super().__init__()
        self._expr = smart_coerce(expr)
        self._dtype = dt.unoptionalize(self._expr._dtype)

    def _subexpressions(self):
        return (self._expr,)


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr, replacement):
        super().__init__()
        self._expr = smart_coerce(expr)
        self._replacement = smart_coerce(replacement)
        self._dtype = dt.lub(self._expr._dtype, self._replacement._dtype)

    def _subexpressions(self):
        return (self._expr, self._replacement)


# -- free functions exposed as pw.* -------------------------------------


def if_else(_if, _then, _else) -> IfElseExpression:
    return IfElseExpression(_if, _then, _else)


def coalesce(*args) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val, *args) -> RequireExpression:
    return RequireExpression(val, *args)


def cast(target_type, expr) -> CastExpression:
    return CastExpression(target_type, expr)


def declare_type(target_type, expr) -> DeclareTypeExpression:
    return DeclareTypeExpression(target_type, expr)


def unwrap(expr) -> UnwrapExpression:
    return UnwrapExpression(expr)


def fill_error(expr, replacement) -> FillErrorExpression:
    return FillErrorExpression(expr, replacement)


def make_tuple(*args) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def apply(fun, *args, **kwargs) -> ApplyExpression:
    return ApplyExpression(fun, dt.ANY, False, True, args, kwargs)


def apply_with_type(fun, ret_type, *args, **kwargs) -> ApplyExpression:
    return ApplyExpression(fun, ret_type, False, True, args, kwargs)


def apply_async(fun, *args, **kwargs) -> AsyncApplyExpression:
    return AsyncApplyExpression(fun, dt.ANY, False, True, args, kwargs)


def assert_table_has_columns(table, columns) -> None:
    """Raise AssertionError unless every name in `columns` is a column of
    `table` (reference: table presence checks used in pipeline glue)."""
    missing = [c for c in columns if c not in table.column_names()]
    assert not missing, (
        f"table is missing columns {missing}; has {table.column_names()}"
    )
