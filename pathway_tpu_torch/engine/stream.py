"""Diff-batch primitives for the incremental engine.

The unit of data flow is a *delta batch*: a list of ``(key, row, diff)``
triples at one logical timestamp, where ``key`` is a 128-bit Pointer, ``row``
a tuple of engine values and ``diff`` a signed multiplicity (reference
semantics: differential-dataflow ``Collection`` updates, see
src/engine/dataflow.rs).  A table state is the consolidated
sum of all batches up to the frontier: a map ``key -> row`` (every key has
multiplicity exactly one in table-land).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Iterable

Key = int  # Pointer
Row = tuple
Delta = tuple  # (key, row, diff)

import numpy as _np


def freeze_value(v: Any) -> Any:
    """Hashable, equality-faithful stand-in for any engine value (ndarrays,
    Json, nested tuples) — used to key multiset state so retractions cancel
    insertions exactly."""
    if isinstance(v, _np.ndarray):
        return ("__ndarray__", v.shape, v.dtype.str, v.tobytes())
    if isinstance(v, tuple):
        return tuple(freeze_value(x) for x in v)
    if isinstance(v, list):
        return ("__list__",) + tuple(freeze_value(x) for x in v)
    if isinstance(v, dict):
        return ("__dict__",) + tuple(
            sorted((freeze_value(k), freeze_value(x)) for k, x in v.items())
        )
    try:
        hash(v)
        return v
    except TypeError:
        return ("__repr__", repr(v))


def freeze_row(row: Row) -> tuple:
    # fast path: an already-hashable row IS its own frozen form (per-value
    # freezing only rewrites unhashable values, which would have made the
    # row unhashable too)
    try:
        hash(row)
        return row
    except TypeError:
        return tuple(freeze_value(v) for v in row)


def _consolidate_py(deltas: Iterable[Delta]) -> list[Delta]:
    """Sum multiplicities of identical (key, row) pairs, drop zeros."""
    acc: dict[tuple, int] = {}
    rows: dict[tuple, tuple] = {}
    for key, row, diff in deltas:
        ident = (key, freeze_row(row))
        acc[ident] = acc.get(ident, 0) + diff
        rows[ident] = row
    return [
        (ident[0], rows[ident], diff) for ident, diff in acc.items() if diff != 0
    ]


class ConsolidatedList(list):
    """A delta batch already in net form (no duplicate (key, row) pairs, no
    zero diffs). consolidate() passes these through — node outputs are
    consolidated once at the producer and not re-consolidated per hop."""

    __slots__ = ()


_consolidate_impl = None
_fp_cached: Any = False
_nb_type: Any = False


def native_batch_type():
    """The pwexec.NativeBatch type (columnar zero-Python delta batch), or
    None without a toolchain. NativeBatch batches flow from the C parser
    straight into the C group-by executor; every other consumer sees a
    normal (key, row, diff) sequence via lazy materialization."""
    global _nb_type
    if _nb_type is False:
        try:
            from pathway_tpu_torch.native import get_pwexec

            ex = get_pwexec()
            _nb_type = getattr(ex, "NativeBatch", None)
        except Exception:
            _nb_type = None
    return _nb_type


def is_native_batch(obj: Any) -> bool:
    t = native_batch_type()
    return t is not None and type(obj) is t


def get_fp():
    """The native fastpath extension module, or None without a toolchain.
    Cached after the first resolution attempt (same policy as
    consolidate's lazy binding)."""
    global _fp_cached
    if _fp_cached is False:
        try:
            from pathway_tpu_torch.native import get_fastpath

            _fp_cached = get_fastpath()
        except Exception:
            _fp_cached = None
    return _fp_cached


def consolidate(deltas: Iterable[Delta]) -> list[Delta]:
    """Native C fast path when a toolchain exists (native/fastpath.c — the
    engine's hottest loop), else the Python implementation. Resolved
    lazily on first use so importing the package never compiles."""
    global _consolidate_impl
    if type(deltas) is ConsolidatedList:
        # fresh copy: the upstream batch object is shared by every consumer
        # (fan-out delivery), so callers that sort/mutate their view must
        # not alias siblings' data. A pointer-copy is still far cheaper
        # than re-hashing the batch.
        return ConsolidatedList(deltas)
    if is_native_batch(deltas):
        # parse output is net form by construction (distinct minted keys,
        # all +1); materialization is cached on the batch, the wrap gives
        # this consumer its own mutable view
        return ConsolidatedList(deltas.materialize())
    if _consolidate_impl is None:
        impl = _consolidate_py
        try:
            from pathway_tpu_torch.native import get_fastpath

            fp = get_fastpath()
            if fp is not None:
                native_fn = fp.consolidate

                def impl(deltas):  # noqa: F811
                    return native_fn(
                        deltas
                        if isinstance(deltas, (list, tuple))
                        else list(deltas)
                    )
        except Exception:
            pass
        _consolidate_impl = impl
    return ConsolidatedList(_consolidate_impl(deltas))


class TableState:
    """Consolidated key->row view maintained from delta batches."""

    __slots__ = ("rows",)

    def __init__(self):
        self.rows: dict[Key, Row] = {}

    def apply(self, deltas: Iterable[Delta]) -> None:
        pending_add: dict[Key, Row] = {}
        for key, row, diff in deltas:
            if diff > 0:
                if key in self.rows and key not in pending_add:
                    # upsert arriving as (del, add) in any order within batch
                    pending_add[key] = row
                else:
                    self.rows[key] = row
            elif diff < 0:
                if key in self.rows:
                    del self.rows[key]
        for key, row in pending_add.items():
            self.rows[key] = row

    def __len__(self):
        return len(self.rows)


class MultisetState:
    """key -> Counter(row) multiset state; exact differential arrangement.

    Rows are keyed by their frozen (hashable) form but returned as original
    values, so ndarray/Json columns flow through joins and groupbys.
    """

    __slots__ = ("data",)

    def __init__(self):
        # key -> {frozen_row: [row, count]}
        self.data: dict[Key, dict[tuple, list]] = defaultdict(dict)

    def apply_one(self, key: Key, row: Row, diff: int) -> None:
        d = self.data[key]
        fr = freeze_row(row) if not _row_hashable(row) else row
        entry = d.get(fr)
        if entry is None:
            entry = [row, 0]
            d[fr] = entry
        entry[1] += diff
        if entry[1] == 0:
            del d[fr]
            if not d:
                del self.data[key]

    def apply(self, deltas: Iterable[Delta]) -> None:
        for key, row, diff in deltas:
            self.apply_one(key, row, diff)

    def get(self, key: Key) -> list[tuple[Row, int]]:
        """[(row, count)] — a list, not a dict: rows may hold unhashable
        values (ndarrays); the frozen form is an internal detail."""
        return [
            (entry[0], entry[1]) for entry in self.data.get(key, {}).values()
        ]

    def items(self):
        for key, d in self.data.items():
            yield key, [(entry[0], entry[1]) for entry in d.values()]


def _row_hashable(row: Row) -> bool:
    try:
        hash(row)
        return True
    except TypeError:
        return False


def negate(deltas: Iterable[Delta]) -> list[Delta]:
    return [(k, r, -d) for k, r, d in deltas]
