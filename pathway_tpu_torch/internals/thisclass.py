"""``pw.this`` / ``pw.left`` / ``pw.right`` deferred references
(reference: python/pathway/internals/thisclass.py:313) and the desugaring
rewriter (reference: internals/desugaring.py).
"""

from __future__ import annotations

import copy
from typing import Any, Callable

from pathway_tpu_torch.internals.expression import ColumnExpression


class ThisColumnReference(ColumnExpression):
    def __init__(self, owner: "ThisClass", name: str):
        super().__init__()
        self._owner = owner
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"{self._owner._repr}.{self._name}"

    def _subexpressions(self):
        return ()


class ThisClass:
    _expelled = ("_repr",)

    def __init__(self, repr_name: str):
        self._repr = repr_name

    def __getattr__(self, name: str) -> ThisColumnReference:
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return ThisColumnReference(self, name)

    def __getitem__(self, arg):
        if isinstance(arg, (list, tuple)):
            return [self[a] for a in arg]
        if isinstance(arg, str):
            return ThisColumnReference(self, arg)
        if isinstance(arg, ThisColumnReference):
            return arg
        from pathway_tpu_torch.internals.expression import ColumnReference

        if isinstance(arg, ColumnReference):
            return ThisColumnReference(self, arg.name)
        raise TypeError(f"cannot index pw.this with {arg!r}")

    @property
    def id(self) -> ThisColumnReference:
        return ThisColumnReference(self, "id")

    def without(self, *columns):
        names = frozenset(
            c if isinstance(c, str) else c.name for c in columns
        )
        return _ThisWithout(self, names)

    def __iter__(self):
        raise TypeError(f"{self._repr} is not iterable at declaration time")


class _ThisWithout:
    """Marker for ``pw.this.without(cols)`` used in select(*args)."""

    def __init__(self, owner: ThisClass, excluded: frozenset[str]):
        self._owner = owner
        self._excluded = excluded


this = ThisClass("<this>")
left = ThisClass("<left>")
right = ThisClass("<right>")


def rewrite(e: Any, fn: Callable[[ColumnExpression], ColumnExpression | None]) -> Any:
    """Rebuild an expression tree applying `fn`; fn returns replacement or None."""
    if not isinstance(e, ColumnExpression):
        return e
    replaced = fn(e)
    if replaced is not None:
        return replaced
    new = copy.copy(e)
    for attr, value in vars(e).items():
        if isinstance(value, ColumnExpression):
            setattr(new, attr, rewrite(value, fn))
        elif isinstance(value, tuple) and any(
            isinstance(v, ColumnExpression) for v in value
        ):
            setattr(new, attr, tuple(rewrite(v, fn) for v in value))
        elif isinstance(value, dict) and any(
            isinstance(v, ColumnExpression) for v in value.values()
        ):
            setattr(new, attr, {k: rewrite(v, fn) for k, v in value.items()})
    # rebinding children can sharpen their dtypes (pw.this.x is ANY until
    # the table context resolves it): recompute inferable result dtypes so
    # int+int comes out INT post-desugar, matching reference inference
    from pathway_tpu_torch.internals import expression as _expr

    if isinstance(new, _expr.ColumnBinaryOpExpression):
        new._dtype = _expr._binary_dtype(
            new._symbol, new._left._dtype, new._right._dtype
        )
    elif isinstance(new, _expr.ColumnUnaryOpExpression):
        new._dtype = (
            _expr.dt.BOOL if new._symbol == "~" else new._expr._dtype
        )
    return new


def desugar(e: Any, this_table=None, left_table=None, right_table=None) -> Any:
    """Replace pw.this/left/right deferred refs with concrete column refs."""

    def fn(x: ColumnExpression):
        if isinstance(x, ThisColumnReference):
            if x._owner is this:
                if this_table is None:
                    raise ValueError("pw.this used without a table context")
                return this_table._resolve_deferred(x._name)
            if x._owner is left:
                if left_table is None:
                    raise ValueError("pw.left used outside of a join")
                return left_table._resolve_deferred(x._name)
            if x._owner is right:
                if right_table is None:
                    raise ValueError("pw.right used outside of a join")
                return right_table._resolve_deferred(x._name)
        return None

    return rewrite(e, fn)
