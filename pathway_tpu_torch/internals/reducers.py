"""Reducers (reference: python/pathway/internals/reducers.py +
src/engine/reduce.rs ``enum Reducer``).

Each DSL reducer lowers to an engine function evaluated over a group's
multiset of argument combos.  The engine contract (GroupByNode): entries is a
list of ``(combo_tuple, count[, stamp])`` where ``combo_tuple[slot]`` is this
reducer's argument tuple ``(*args, order_token, row_key)`` — the order token
(the groupby ``sort_by`` value when given, else the row key) drives the tuple
reducer's ordering, the row key backs argmin/argmax, and ``stamp`` (the
engine ``(time, batch position)`` at multiset-entry creation) drives
earliest/latest, which rank by PROCESSING TIME like the reference
(EarliestReducer, reduce.rs:594) and ignore ``sort_by``.
Semigroup reducers (sum/count) could use running state; the rediff strategy
recomputes per touched group, which is exact and fast enough until the C++
core lands.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ERROR
from pathway_tpu_torch.internals.expression import ColumnExpression, ReducerExpression


def _entries(ms, slot: int):
    items = ms.items() if hasattr(ms, "items") else ms
    for entry in items:  # (combo, count[, stamp])
        yield entry[0][slot], entry[1]


# full (non-abelian) reducers the C++ executor runs natively; the _sn
# variants are the skip_nones tuple forms
_NATIVE_FULL_CODES = frozenset(
    {
        "min", "max", "argmin", "argmax", "unique", "any", "earliest",
        "latest", "tuple", "tuple_sn", "sorted_tuple", "sorted_tuple_sn",
    }
)


class Reducer:
    def __init__(
        self,
        name: str,
        engine_fn_factory: Callable,
        return_type_fn=None,
        abelian_factory: Callable | None = None,
    ):
        self.name = name
        self._factory = engine_fn_factory
        self._return_type_fn = return_type_fn
        # abelian reducers (count/sum/avg) maintain O(1) running state per
        # group instead of rescanning the multiset (reference: semigroup
        # fast path, src/engine/reduce.rs:40 SemigroupReducerImpl)
        self._abelian_factory = abelian_factory

    def return_type(self, arg_types: list[dt.DType]) -> dt.DType:
        if self._return_type_fn is not None:
            return self._return_type_fn(arg_types)
        return arg_types[0] if arg_types else dt.ANY

    def engine_fn(self, **kwargs) -> Callable:
        return self._factory(**kwargs)

    def engine_spec(self, **kwargs):
        """("abelian", update(state, combo, diff), finish(state), init[,
        native_code]) when incremental maintenance applies, else ("full",
        fn[, native_code]). native_code marks specs the sharded C++
        executor (native/exec.cpp) runs natively: count/sum/avg keep O(1)
        abelian state; min/max keep an ordered value multiset per group;
        tuple/sorted_tuple/unique/any/argmin/argmax/earliest/latest are
        recomputed from the joint row multiset with GIL-free change
        fingerprints (reference: the full Reducer enum, reduce.rs:22-594).
        ndarray and stateful reducers stay on the Python path."""
        if self._abelian_factory is not None:
            spec = ("abelian",) + self._abelian_factory(**kwargs)
            if self.name in ("count", "sum", "avg"):
                spec = spec + (self.name,)
            return spec
        spec = ("full", self._factory(**kwargs))
        code = getattr(self, "_native_code", self.name)
        if code in _NATIVE_FULL_CODES:
            spec = spec + (code,)
        return spec

    def __call__(self, *args, **kwargs) -> ReducerExpression:
        return ReducerExpression(self, *args, **kwargs)

    def __repr__(self):
        return f"pathway.reducers.{self.name}"


# -- engine implementations ----------------------------------------------


def _count_factory(**kw):
    def fn(ms, slot):
        return builtins.sum(count for _, count in _entries(ms, slot))

    return fn


def _count_abelian(**kw):
    def update(state, combo, diff):
        return state + diff

    return (update, lambda s: s, 0)


def _sum_abelian(**kw):
    # state: [n_numeric, total, err_count] — n_numeric tracks live numeric
    # rows so full retraction returns None (matching the full reducer),
    # not a stale 0
    def update(state, combo, diff):
        v = combo[0]
        if state is None:
            state = [0, None, 0]
        if v is ERROR:
            state[2] += diff
        elif v is not None:
            contrib = v * diff
            state[1] = contrib if state[1] is None else state[1] + contrib
            state[0] += diff
        return state

    def finish(state):
        if state is None:
            return None
        if state[2] > 0:
            return ERROR
        return state[1] if state[0] > 0 else None

    return (update, finish, None)


def _avg_abelian(**kw):
    # state: [total, n, err_count]
    def update(state, combo, diff):
        v = combo[0]
        if state is None:
            state = [0.0, 0, 0]
        if v is ERROR:
            state[2] += diff
        elif v is not None:
            state[0] += v * diff
            state[1] += diff
        return state

    def finish(state):
        if state is None:
            return None
        if state[2] > 0:
            return ERROR  # error poison outranks emptiness (full-reducer parity)
        return state[0] / state[1] if state[1] else None

    return (update, finish, None)


def _sum_factory(**kw):
    def fn(ms, slot):
        # None entries are skipped (outer temporal windows pad unmatched
        # rows with None); an all-None group sums to None
        total = None
        for args, count in _entries(ms, slot):
            v = args[0]
            if v is ERROR:
                return ERROR
            if v is None:
                continue
            contrib = v * count
            total = contrib if total is None else total + contrib
        return total

    return fn


def _min_factory(**kw):
    def fn(ms, slot):
        vals = [args[0] for args, _ in _entries(ms, slot)]
        if builtins.any(v is ERROR for v in vals):
            return ERROR
        vals = [v for v in vals if v is not None]
        return builtins.min(vals) if vals else None

    return fn


def _max_factory(**kw):
    def fn(ms, slot):
        vals = [args[0] for args, _ in _entries(ms, slot)]
        if builtins.any(v is ERROR for v in vals):
            return ERROR
        vals = [v for v in vals if v is not None]
        return builtins.max(vals) if vals else None

    return fn


def _argmin_factory(**kw):
    def fn(ms, slot):
        best = builtins.min(_entries(ms, slot), key=lambda e: (e[0][0], e[0][-1]))
        return best[0][-1]

    return fn


def _argmax_factory(**kw):
    def fn(ms, slot):
        best = builtins.max(_entries(ms, slot), key=lambda e: (e[0][0], -e[0][-1]))
        return best[0][-1]

    return fn


def _unique_factory(**kw):
    def fn(ms, slot):
        distinct = {args[0] for args, _ in _entries(ms, slot)}
        if len(distinct) != 1:
            return ERROR
        return next(iter(distinct))

    return fn


def _any_factory(**kw):
    def fn(ms, slot):
        return builtins.min(_entries(ms, slot), key=lambda e: (e[0][-2], e[0][-1]))[0][0]

    return fn


def _avg_factory(**kw):
    def fn(ms, slot):
        total = 0.0
        n = 0
        for args, count in _entries(ms, slot):
            if args[0] is ERROR:
                return ERROR
            if args[0] is None:
                continue
            total += args[0] * count
            n += count
        return total / n if n else None

    return fn


def _sorted_tuple_factory(skip_nones: bool = False, **kw):
    def fn(ms, slot):
        vals = []
        for args, count in _entries(ms, slot):
            v = args[0]
            if skip_nones and v is None:
                continue
            vals.extend([v] * count)
        # None sorts FIRST (reference: Value::None is the smallest Value,
        # value.rs:208; pinned by test_common.py test_tuple_reducer)
        return builtins.tuple(
            builtins.sorted(
                vals, key=lambda v: (0, 0) if v is None else (1, v)
            )
        )

    return fn


def _tuple_factory(skip_nones: bool = False, **kw):
    def fn(ms, slot):
        entries = builtins.sorted(_entries(ms, slot), key=lambda e: (e[0][-2], e[0][-1]))
        vals = []
        for args, count in entries:
            v = args[0]
            if skip_nones and v is None:
                continue
            vals.extend([v] * count)
        return builtins.tuple(vals)

    return fn


def _ndarray_factory(skip_nones: bool = False, **kw):
    tup = _tuple_factory(skip_nones=skip_nones)

    def fn(ms, slot):
        return np.array(tup(ms, slot))

    return fn


def _stamped_entries(ms, slot: int):
    """(spec_combo, count, stamp) triples — stamp is the engine (time,
    batch position) recorded when the multiset entry was created."""
    items = ms.items() if hasattr(ms, "items") else ms
    for entry in items:
        combo, count = entry[0], entry[1]
        stamp = entry[2] if len(entry) > 2 else (0, 0)
        yield combo[slot], count, stamp


def _earliest_factory(**kw):
    # reference: EarliestReducer (reduce.rs:594) — the value with the
    # LOWEST processing time; row key breaks same-batch ties
    def fn(ms, slot):
        return builtins.min(
            _stamped_entries(ms, slot), key=lambda e: (e[2], e[0][-1])
        )[0][0]

    return fn


def _latest_factory(**kw):
    def fn(ms, slot):
        return builtins.max(
            _stamped_entries(ms, slot), key=lambda e: (e[2], e[0][-1])
        )[0][0]

    return fn


def _sum_return_type(arg_types: list[dt.DType]) -> dt.DType:
    if not arg_types:
        return dt.ANY
    t = arg_types[0]
    if t in (dt.INT, dt.FLOAT) or isinstance(t, dt._ArrayDType):
        return t
    return dt.ANY


count = Reducer("count", _count_factory, lambda ts: dt.INT, abelian_factory=_count_abelian)
sum = Reducer("sum", _sum_factory, _sum_return_type, abelian_factory=_sum_abelian)
min = Reducer("min", _min_factory)
max = Reducer("max", _max_factory)
argmin = Reducer("argmin", _argmin_factory, lambda ts: dt.POINTER)
argmax = Reducer("argmax", _argmax_factory, lambda ts: dt.POINTER)
unique = Reducer("unique", _unique_factory)
any = Reducer("any", _any_factory)
avg = Reducer("avg", _avg_factory, lambda ts: dt.FLOAT, abelian_factory=_avg_abelian)
earliest = Reducer("earliest", _earliest_factory)
latest = Reducer("latest", _latest_factory)
ndarray_reducer = Reducer(
    "ndarray", _ndarray_factory, lambda ts: dt.ANY_ARRAY
)


def sorted_tuple(arg, skip_nones: bool = False) -> ReducerExpression:
    r = Reducer(
        "sorted_tuple",
        lambda **kw: _sorted_tuple_factory(skip_nones=skip_nones),
        lambda ts: dt.List(ts[0]) if ts else dt.ANY_TUPLE,
    )
    r._native_code = "sorted_tuple_sn" if skip_nones else "sorted_tuple"
    return ReducerExpression(r, arg)


def tuple(arg, skip_nones: bool = False) -> ReducerExpression:  # noqa: A001
    r = Reducer(
        "tuple",
        lambda **kw: _tuple_factory(skip_nones=skip_nones),
        lambda ts: dt.List(ts[0]) if ts else dt.ANY_TUPLE,
    )
    r._native_code = "tuple_sn" if skip_nones else "tuple"
    return ReducerExpression(r, arg)


def ndarray(arg, skip_nones: bool = False) -> ReducerExpression:
    r = Reducer(
        "ndarray",
        lambda **kw: _ndarray_factory(skip_nones=skip_nones),
        lambda ts: dt.ANY_ARRAY,
    )
    return ReducerExpression(r, arg)


class StatefulReducer(Reducer):
    """pw.reducers.stateful_many / stateful_single (reference:
    custom_reducers.py; engine Reducer::Stateful)."""

    def __init__(self, combine_many: Callable, name="stateful_many"):
        self.combine_many = combine_many
        super().__init__(name, lambda **kw: None, lambda ts: dt.ANY)
        self.is_stateful = True


def stateful_many(combine_many: Callable) -> Callable:
    def wrapper(*args) -> ReducerExpression:
        return ReducerExpression(StatefulReducer(combine_many), *args)

    return wrapper


def stateful_single(combine_single: Callable) -> Callable:
    def combine_many(state, rows):
        for row, count in rows:
            if count > 0:
                for _ in range(count):
                    state = combine_single(state, *row)
        return state

    return stateful_many(combine_many)


def udf_reducer(reducer_cls):
    """@pw.reducers.udf_reducer over a BaseCustomAccumulator subclass."""

    def combine_many(state, rows):
        for row, count in rows:
            if count <= 0:
                continue
            for _ in range(count):
                neu = reducer_cls.from_row(list(row))
                state = neu if state is None else state.update(neu)
        return state

    def wrapper(*args) -> ReducerExpression:
        expr = ReducerExpression(
            StatefulReducer(combine_many, name="udf_reducer"), *args
        )
        expr._post_process = lambda acc: acc.compute_result() if acc is not None else None
        return expr

    return wrapper


# deprecated reference spellings (reference: reducers.py int_sum/npsum)
int_sum = sum
npsum = sum
