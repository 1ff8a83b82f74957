"""The Table DSL (reference: python/pathway/internals/table.py:52, 2,675 LoC).

Every method is declarative: it appends an Operator to the global ParseGraph
``G`` with a ``lower_fn`` that knows how to build the corresponding engine
nodes.  Rows live as schema-ordered tuples in the engine; ids are 128-bit
Pointers.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.api import Pointer, ref_scalar
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    PointerExpression,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema, schema_from_types
from pathway_tpu_torch.internals.universe import SOLVER, Universe

_table_counter = itertools.count()


class TableLike:
    _universe: Universe


class Table(TableLike):
    def __init__(
        self,
        schema: type[Schema],
        universe: Universe | None = None,
        name: str | None = None,
    ):
        self._schema_cls = schema
        self._universe = universe if universe is not None else Universe()
        self._name = name or f"table_{next(_table_counter)}"
        self._column_names: list[str] = list(schema.column_names())
        self._source = None  # producing Operator
        self._id_dtype = dt.POINTER

    # -- basic introspection ----------------------------------------------
    @property
    def schema(self) -> type[Schema]:
        return self._schema_cls

    def column_names(self) -> list[str]:
        return list(self._column_names)

    def keys(self):
        return list(self._column_names)

    def typehints(self):
        return self._schema_cls.typehints()

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(table=self, name="id")

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self.__dict__.get("_column_names", ()):
            raise AttributeError(
                f"Table has no column {name!r}; columns: {self._column_names}"
            )
        return ColumnReference(table=self, name=name)

    def __getitem__(self, args):
        if isinstance(args, (list, tuple)):
            return self.select(*[self[a] for a in args])
        if isinstance(args, str):
            if args == "id":
                return self.id
            if args not in self._column_names:
                raise KeyError(args)
            return ColumnReference(table=self, name=args)
        if isinstance(args, thisclass.ThisColumnReference):
            return self[args.name]
        if isinstance(args, ColumnReference):
            return self[args.name]
        raise TypeError(f"cannot index Table with {args!r}")

    def __iter__(self):
        return iter([self[name] for name in self._column_names])

    def _resolve_deferred(self, name: str) -> ColumnReference:
        if name == "id":
            return self.id
        return self[name]

    def __repr__(self):
        return f"<pathway.Table {self._name} schema={self._schema_cls!r}>"

    def _ipython_key_completions_(self):
        return list(self._column_names)

    # -- helpers -----------------------------------------------------------
    def _desugar(self, e: Any) -> Any:
        return thisclass.desugar(e, this_table=self)

    def _select_output(
        self, args: tuple, kwargs: dict
    ) -> tuple[list[str], list[ColumnExpression]]:
        names: list[str] = []
        exprs: list[ColumnExpression] = []

        def add(name, e):
            if name in names:
                idx = names.index(name)
                exprs[idx] = e
            else:
                names.append(name)
                exprs.append(e)

        for arg in args:
            if isinstance(arg, thisclass._ThisWithout):
                for cname in self._column_names:
                    if cname not in arg._excluded:
                        add(cname, self[cname])
            elif isinstance(arg, thisclass.ThisClass):
                for cname in self._column_names:
                    add(cname, self[cname])
            elif isinstance(arg, thisclass.ThisColumnReference):
                add(arg.name, self._desugar(arg))
            elif isinstance(arg, ColumnReference):
                add(arg.name, arg)
            else:
                raise ValueError(
                    f"positional select() arguments must be column references, got {arg!r}"
                )
        for name, e in kwargs.items():
            add(name, self._desugar(expr_mod.smart_coerce(e)))
        return names, exprs

    def _output_schema(self, names: list[str], exprs: list[ColumnExpression]):
        return schema_from_types(
            **{n: e._dtype for n, e in zip(names, exprs)}
        )

    def _dep_tables(self, exprs: Iterable[ColumnExpression]) -> list["Table"]:
        """All tables referenced by the expressions (for tree-shaking)."""
        out: list[Table] = [self]
        seen = {id(self)}
        for e in exprs:
            for ref in expr_mod.smart_coerce(e)._deps:
                if id(ref.table) not in seen:
                    seen.add(id(ref.table))
                    out.append(ref.table)
        return out

    # -- projections -------------------------------------------------------
    def select(self, *args, **kwargs) -> "Table":
        names, exprs = self._select_output(args, kwargs)
        out = Table(self._output_schema(names, exprs), self._universe)
        self_ = self

        deterministic = all(e._is_deterministic for e in exprs)

        def lower(ctx):
            inp, fn = ctx.rowwise_eval(self_, exprs)
            ctx.set_engine_table(
                out,
                ctx.scope.rowwise_auto(
                    inp, fn, len(exprs), deterministic, src_exprs=exprs
                ),
            )

        G.add_operator(self._dep_tables(exprs), [out], lower, "select")
        return out

    def with_columns(self, *args, **kwargs) -> "Table":
        all_args = (thisclass.this,) + args
        return self.select(*all_args, **kwargs)

    def __add__(self, other: "Table") -> "Table":
        if not SOLVER.query_are_equal(self._universe, other._universe):
            raise ValueError("can only add tables with the same universe")
        kwargs = {n: other[n] for n in other._column_names}
        return self.select(*self, **kwargs)

    def copy(self) -> "Table":
        return self.select(*self)

    def without(self, *columns) -> "Table":
        excluded = {c if isinstance(c, str) else c.name for c in columns}
        return self.select(
            *[self[c] for c in self._column_names if c not in excluded]
        )

    def rename_columns(self, **kwargs) -> "Table":
        mapping = {}
        for new, old in kwargs.items():
            old_name = old if isinstance(old, str) else old.name
            mapping[old_name] = new
        cols = {}
        for c in self._column_names:
            cols[mapping.get(c, c)] = self[c]
        return self.select(**cols)

    def rename_by_dict(self, names_mapping: dict) -> "Table":
        mapping = {
            (k if isinstance(k, str) else k.name): v for k, v in names_mapping.items()
        }
        cols = {}
        for c in self._column_names:
            cols[mapping.get(c, c)] = self[c]
        return self.select(**cols)

    def rename(self, names_mapping: dict | None = None, **kwargs) -> "Table":
        if names_mapping is not None:
            return self.rename_by_dict(names_mapping)
        return self.rename_columns(**kwargs)

    def with_prefix(self, prefix: str) -> "Table":
        return self.select(**{prefix + c: self[c] for c in self._column_names})

    def with_suffix(self, suffix: str) -> "Table":
        return self.select(**{c + suffix: self[c] for c in self._column_names})

    def update_types(self, **kwargs) -> "Table":
        out = self.select(*self)
        out._schema_cls = out._schema_cls.with_types(**kwargs)
        return out

    def cast_to_types(self, **kwargs) -> "Table":
        cols = {}
        for c in self._column_names:
            if c in kwargs:
                cols[c] = expr_mod.cast(kwargs[c], self[c])
            else:
                cols[c] = self[c]
        return self.select(**cols)

    # -- filtering ---------------------------------------------------------
    def filter(self, filter_expression: ColumnExpression) -> "Table":
        e = self._desugar(expr_mod.smart_coerce(filter_expression))
        out = Table(self._schema_cls, self._universe.subset())
        self_ = self
        width = len(self._column_names)

        def lower(ctx):
            combined, mask_fn = ctx.mask_eval(self_, e)
            filtered = ctx.scope.filter_table(combined, mask_fn)
            if combined.width != width:
                filtered = ctx.scope.rowwise(
                    filtered, lambda keys, rows: [r[:width] for r in rows], width
                )
            ctx.set_engine_table(out, filtered)

        G.add_operator(self._dep_tables([e]), [out], lower, "filter")
        return out

    def split(self, split_expression):
        pos = self.filter(split_expression)
        neg = self.filter(~expr_mod.smart_coerce(self._desugar(split_expression)))
        return pos, neg

    # -- universes ---------------------------------------------------------
    def difference(self, other: "Table") -> "Table":
        out = Table(self._schema_cls, self._universe.subset())
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(
                out,
                ctx.scope.difference(
                    ctx.engine_table(self_), ctx.engine_table(other)
                ),
            )

        G.add_operator([self, other], [out], lower, "difference")
        return out

    def intersect(self, *tables: "Table") -> "Table":
        out = Table(self._schema_cls, self._universe.subset())
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(
                out,
                ctx.scope.intersect(
                    ctx.engine_table(self_), [ctx.engine_table(t) for t in tables]
                ),
            )

        G.add_operator([self, *tables], [out], lower, "intersect")
        return out

    def restrict(self, other: TableLike) -> "Table":
        out = Table(self._schema_cls, other._universe)
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(
                out,
                ctx.scope.intersect(
                    ctx.engine_table(self_), [ctx.engine_table(other)]
                ),
            )

        G.add_operator([self, other], [out], lower, "restrict")
        return out

    def _having(self, indexer: ColumnReference) -> "Table":
        keys_table = indexer.table
        out = Table(self._schema_cls, self._universe.subset())
        self_ = self
        name = indexer.name

        def lower(ctx):
            # keep rows of self whose id appears as a value of indexer
            keys_et, key_one = ctx.row_fn(keys_table, [indexer])
            projected = ctx.scope.reindex(
                keys_et, lambda k, row, f=key_one: f(k, row)[0]
            )
            ctx.set_engine_table(
                out, ctx.scope.intersect(ctx.engine_table(self_), [projected])
            )

        G.add_operator([self, keys_table], [out], lower, "having")
        return out

    def with_universe_of(self, other: TableLike) -> "Table":
        """Reindex onto ``other``'s key set, with the reference's runtime
        checks (test_errors.py:573): keys of other missing here become
        ERROR rows and keys here missing in other are dropped — both
        logged to the global error log. A valid promise passes through
        unchanged."""
        out = Table(self._schema_cls, other._universe)
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(
                out,
                ctx.scope.reuniverse(
                    ctx.engine_table(self_), ctx.engine_table(other)
                ),
            )

        G.add_operator([self, other], [out], lower, "with_universe_of")
        return out

    def _unsafe_promise_universe(self, other: TableLike) -> "Table":
        """Check-free universe relabel: the caller GUARANTEES the key
        sets match (the reference's unsafe variant). No state, no
        runtime verification — internal callers whose universes are
        equal by construction use this; user code should prefer
        with_universe_of."""
        out = Table(self._schema_cls, other._universe)
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(out, ctx.engine_table(self_))

        G.add_operator([self], [out], lower, "promise_universe")
        return out

    # -- groupby / reduce --------------------------------------------------
    def groupby(self, *args, id=None, instance=None, sort_by=None, **kwargs):
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        if kwargs:
            raise TypeError(
                f"groupby() got unexpected keyword arguments {sorted(kwargs)}"
            )
        if id is not None:
            # reference semantics (table.py groupby id=): group by a Pointer
            # column whose values become the output row ids
            if args:
                raise ValueError("groupby() takes either positional columns or id=")
            grouping = [self._desugar(expr_mod.smart_coerce(id))]
            return GroupedTable(
                self, grouping, sort_by=sort_by, id_from_first_group_col=True
            )
        grouping = [self._desugar(a) for a in args]
        if instance is not None:
            grouping.append(self._desugar(expr_mod.smart_coerce(instance)))
        return GroupedTable(self, grouping, sort_by=sort_by)

    def reduce(self, *args, **kwargs) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value,
        instance=None,
        acceptor,
        persistent_id=None,
        name=None,
    ) -> "Table":
        value_e = self._desugar(expr_mod.smart_coerce(value))
        instance_e = (
            self._desugar(expr_mod.smart_coerce(instance))
            if instance is not None
            else expr_mod.ColumnConstExpression(None)
        )
        out = Table(self._schema_cls, Universe())
        self_ = self

        def lower(ctx):
            et, vfn = ctx.row_fn(self_, [value_e, instance_e])
            ctx.set_engine_table(
                out,
                ctx.scope.deduplicate(
                    et,
                    instance_fn=lambda k, row: vfn(k, row)[1],
                    value_fn=lambda k, row: vfn(k, row)[0],
                    acceptor=acceptor,
                ),
            )

        G.add_operator(self._dep_tables([value_e, instance_e]), [out], lower, "deduplicate")
        return out

    # -- joins -------------------------------------------------------------
    _ALLOWED_JOIN_KWARGS = {"left_instance", "right_instance", "exact_match"}

    def join(
        self,
        other: "Table",
        *on,
        id=None,
        how="inner",
        left_instance=None,
        right_instance=None,
        exact_match: bool = False,
        **kwargs,
    ):
        from pathway_tpu_torch.internals.joins import JoinResult

        if kwargs:
            raise TypeError(
                f"join() got unexpected keyword arguments {sorted(kwargs)}"
            )
        on = list(on)
        if (left_instance is None) != (right_instance is None):
            raise ValueError(
                "left_instance and right_instance must be given together"
            )
        if left_instance is not None:
            # instance partitioning = an extra equality condition
            on.append(
                self._desugar(expr_mod.smart_coerce(left_instance))
                == other._desugar(expr_mod.smart_coerce(right_instance))
            )
        how_str = how.value if hasattr(how, "value") else str(how)
        return JoinResult(
            self, other, on, id=id, how=how_str, exact_match=exact_match
        )

    def join_inner(self, other, *on, id=None, **kwargs):
        return self.join(other, *on, id=id, how="inner", **kwargs)

    def join_left(self, other, *on, id=None, **kwargs):
        return self.join(other, *on, id=id, how="left", **kwargs)

    def join_right(self, other, *on, id=None, **kwargs):
        return self.join(other, *on, id=id, how="right", **kwargs)

    def join_outer(self, other, *on, id=None, **kwargs):
        return self.join(other, *on, id=id, how="outer", **kwargs)

    # -- asof / temporal entry points (stdlib.temporal wires the real ones) --
    def windowby(self, time_expr, *, window, instance=None, behavior=None, **kwargs):
        from pathway_tpu_torch.stdlib.temporal import windowby as _windowby

        return _windowby(
            self, time_expr, window=window, instance=instance, behavior=behavior
        )

    def interval_join(self, other, self_time, other_time, interval, *on, **kwargs):
        from pathway_tpu_torch.stdlib.temporal import interval_join as _ij

        return _ij(self, other, self_time, other_time, interval, *on, **kwargs)

    def interval_join_inner(self, other, self_time, other_time, interval, *on, **kw):
        return self.interval_join(other, self_time, other_time, interval, *on, how="inner", **kw)

    def interval_join_left(self, other, self_time, other_time, interval, *on, **kw):
        return self.interval_join(other, self_time, other_time, interval, *on, how="left", **kw)

    def interval_join_right(self, other, self_time, other_time, interval, *on, **kw):
        return self.interval_join(other, self_time, other_time, interval, *on, how="right", **kw)

    def interval_join_outer(self, other, self_time, other_time, interval, *on, **kw):
        return self.interval_join(other, self_time, other_time, interval, *on, how="outer", **kw)

    def asof_join(self, other, self_time, other_time, *on, **kwargs):
        from pathway_tpu_torch.stdlib.temporal import asof_join as _aj

        return _aj(self, other, self_time, other_time, *on, **kwargs)

    def asof_join_left(self, other, self_time, other_time, *on, **kw):
        return self.asof_join(other, self_time, other_time, *on, how="left", **kw)

    def asof_join_right(self, other, self_time, other_time, *on, **kw):
        return self.asof_join(other, self_time, other_time, *on, how="right", **kw)

    def asof_join_outer(self, other, self_time, other_time, *on, **kw):
        return self.asof_join(other, self_time, other_time, *on, how="outer", **kw)

    def asof_now_join(self, other, *on, **kwargs):
        from pathway_tpu_torch.stdlib.temporal import asof_now_join as _anj

        return _anj(self, other, *on, **kwargs)

    def window_join(self, other, self_time, other_time, window, *on, **kwargs):
        from pathway_tpu_torch.stdlib.temporal import window_join as _wj

        return _wj(self, other, self_time, other_time, window, *on, **kwargs)

    # -- concat / update ---------------------------------------------------
    def concat(self, *others: "Table") -> "Table":
        out = Table(
            self._schema_cls,
            SOLVER.get_union(self._universe, *[o._universe for o in others]),
        )
        tables = [self, *others]
        col_names = self._column_names

        def lower(ctx):
            ets = []
            for t in tables:
                et = ctx.engine_table(t)
                if t._column_names != col_names:
                    order = [t._column_names.index(c) for c in col_names]
                    et = ctx.scope.rowwise(
                        et,
                        lambda keys, rows, order=order: [
                            tuple(r[i] for i in order) for r in rows
                        ],
                        len(order),
                    )
                ets.append(et)
            ctx.set_engine_table(out, ctx.scope.concat(ets))

        G.add_operator(tables, [out], lower, "concat")
        return out

    def concat_reindex(self, *tables: "Table") -> "Table":
        reindexed = [
            t._reindex_with_salt(i) for i, t in enumerate([self, *tables])
        ]
        return reindexed[0].concat(*reindexed[1:])

    def _reindex_with_salt(self, salt: int) -> "Table":
        out = Table(self._schema_cls, Universe())
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(
                out,
                ctx.scope.reindex(
                    ctx.engine_table(self_),
                    lambda k, row: ref_scalar(k, salt),
                ),
            )

        G.add_operator([self], [out], lower, "reindex_salt")
        return out

    def update_rows(self, other: "Table") -> "Table":
        out = Table(
            self._schema_cls, SOLVER.get_union(self._universe, other._universe)
        )
        self_ = self
        col_names = self._column_names

        def lower(ctx):
            right = ctx.engine_table(other)
            if other._column_names != col_names:
                order = [other._column_names.index(c) for c in col_names]
                right = ctx.scope.rowwise(
                    right,
                    lambda keys, rows, order=order: [
                        tuple(r[i] for i in order) for r in rows
                    ],
                    len(order),
                )
            ctx.set_engine_table(
                out, ctx.scope.update_rows(ctx.engine_table(self_), right)
            )

        G.add_operator([self, other], [out], lower, "update_rows")
        return out

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def update_cells(self, other: "Table", _stacklevel: int = 1) -> "Table":
        positions = []
        for c in other._column_names:
            if c not in self._column_names:
                raise ValueError(f"update_cells: unknown column {c!r}")
            positions.append(self._column_names.index(c))
        out = Table(self._schema_cls, self._universe)
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(
                out,
                ctx.scope.update_cells(
                    ctx.engine_table(self_), ctx.engine_table(other), positions
                ),
            )

        G.add_operator([self, other], [out], lower, "update_cells")
        return out

    # -- reindexing --------------------------------------------------------
    def with_id_from(self, *args, instance=None) -> "Table":
        exprs = [self._desugar(expr_mod.smart_coerce(a)) for a in args]
        if instance is not None:
            exprs.append(self._desugar(expr_mod.smart_coerce(instance)))
        out = Table(self._schema_cls, Universe())
        self_ = self
        width = len(self._column_names)

        def lower(ctx):
            et, fn = ctx.row_fn(self_, exprs)
            reindexed = ctx.scope.reindex_checked(
                et, lambda k, row, f=fn: ref_scalar(*f(k, row))
            )
            if reindexed.width != width:
                reindexed = ctx.scope.rowwise(
                    reindexed, lambda keys, rows: [r[:width] for r in rows], width
                )
            ctx.set_engine_table(out, reindexed)

        G.add_operator(self._dep_tables(exprs), [out], lower, "with_id_from")
        return out

    def with_id(self, new_index: ColumnReference) -> "Table":
        return self._with_id_impl(new_index, checked=True)

    def _with_id_unchecked(self, new_index: ColumnReference) -> "Table":
        """Check-free rekey for internal callers whose keys are unique by
        construction (round-tripped row ids): skips CheckedReindexNode's
        per-key row state."""
        return self._with_id_impl(new_index, checked=False)

    def _with_id_impl(self, new_index: ColumnReference, checked: bool) -> "Table":
        e = self._desugar(new_index)
        out = Table(self._schema_cls, Universe())
        self_ = self
        width = len(self._column_names)

        def lower(ctx):
            et, fn = ctx.row_fn(self_, [e])
            rekey = (
                ctx.scope.reindex_checked if checked else ctx.scope.reindex
            )
            reindexed = rekey(et, lambda k, row, f=fn: f(k, row)[0])
            if reindexed.width != width:
                reindexed = ctx.scope.rowwise(
                    reindexed, lambda keys, rows: [r[:width] for r in rows], width
                )
            ctx.set_engine_table(out, reindexed)

        G.add_operator(self._dep_tables([e]), [out], lower, "with_id")
        return out

    # -- pointer ops -------------------------------------------------------
    def pointer_from(self, *args, optional=False, instance=None) -> PointerExpression:
        return PointerExpression(
            self,
            *[self._desugar(expr_mod.smart_coerce(a)) for a in args],
            optional=optional,
            instance=instance,
        )

    def ix(self, expression, *, optional: bool = False, context=None) -> "Table":
        e = expression
        if isinstance(e, thisclass.ThisColumnReference):
            raise ValueError("t.ix(pw.this.col) requires explicit table context")
        keys_table = _origin_table(e)
        out = Table(self._schema_cls, keys_table._universe)
        self_ = self

        def lower(ctx):
            keys_et, fn = ctx.row_fn(keys_table, [e])
            ctx.set_engine_table(
                out,
                ctx.scope.ix(
                    ctx.engine_table(self_),
                    keys_et,
                    key_fn=lambda k, row, f=fn: f(k, row)[0],
                    optional=optional,
                    strict=True,
                ),
            )

        G.add_operator([self, keys_table], [out], lower, "ix")
        return out

    def ix_ref(self, *args, optional: bool = False, context=None, instance=None):
        keys_tables = {
            r.table
            for a in args
            if isinstance(a, ColumnExpression)
            for r in expr_mod.smart_coerce(a)._deps
        }
        if not keys_tables:
            raise ValueError("ix_ref needs at least one column argument")
        keys_table = next(iter(keys_tables))
        return self.ix(
            self.pointer_from(*args, instance=instance)._rebind(keys_table),
            optional=optional,
        )

    # -- structure ---------------------------------------------------------
    def flatten(self, to_flatten: ColumnReference, origin_id: str | None = None) -> "Table":
        e = self._desugar(to_flatten)
        name = e.name
        idx = self._column_names.index(name)
        inner_t = self._schema_cls._dtypes().get(name, dt.ANY)
        if isinstance(inner_t, dt._ListDType):
            elem_t = inner_t.arg
        elif isinstance(inner_t, dt._TupleDType) and inner_t.args:
            elem_t = dt.lub(*inner_t.args)
        elif inner_t is dt.STR:
            elem_t = dt.STR
        else:
            elem_t = dt.ANY
        new_types = dict(self._schema_cls._dtypes())
        new_types[name] = elem_t
        out = Table(schema_from_types(**new_types), Universe())
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(
                out, ctx.scope.flatten(ctx.engine_table(self_), idx)
            )

        G.add_operator([self], [out], lower, "flatten")
        return out

    def _time_gate(self, kind: str, threshold, time_expr) -> "Table":
        threshold_e = self._desugar(expr_mod.smart_coerce(threshold))
        time_e = self._desugar(expr_mod.smart_coerce(time_expr))
        out = Table(self._schema_cls, Universe())
        self_ = self

        def lower(ctx):
            et, fn = ctx.row_fn(self_, [threshold_e, time_e])
            ctx.set_engine_table(out, getattr(ctx.scope, kind)(et, fn))

        G.add_operator(
            self._dep_tables([threshold_e, time_e]), [out], lower, kind
        )
        return out

    def _buffer(self, threshold, time_expr) -> "Table":
        """Hold rows until the operator watermark reaches `threshold`
        (reference: Table._buffer -> time_column.rs postpone_core)."""
        return self._time_gate("buffer", threshold, time_expr)

    def _freeze(self, threshold, time_expr) -> "Table":
        """Ignore updates arriving after `threshold` passed (reference:
        Table._freeze -> TimeColumnFreeze)."""
        return self._time_gate("freeze", threshold, time_expr)

    def _forget(self, threshold, time_expr, mark_forgetting: bool = True) -> "Table":
        """Retract rows once the watermark passes `threshold` (reference:
        Table._forget -> TimeColumnForget)."""
        return self._time_gate("forget", threshold, time_expr)

    def _gradual_broadcast(
        self, threshold_table, lower_column, value_column, upper_column
    ) -> "Table":
        """Append `apx_value` apportioning a slowly-changing threshold
        (reference: table.py:631 -> gradual_broadcast.rs)."""
        exprs = [
            threshold_table._desugar(expr_mod.smart_coerce(c))
            for c in (lower_column, value_column, upper_column)
        ]
        schema_cols = dict(self.schema.typehints())
        schema_cols["apx_value"] = dt.ANY
        out = Table(schema_from_types(**schema_cols), self._universe)
        self_ = self

        def lower(ctx):
            let = ctx.engine_table(self_)
            tet, resolver = ctx._combined_view(threshold_table, exprs)
            from pathway_tpu_torch.engine.expression import compile_expression

            fns = [compile_expression(e, resolver, ctx.runtime) for e in exprs]

            def triplet_fn(k, row):
                return tuple(f([k], [row])[0] for f in fns)

            ctx.set_engine_table(
                out, ctx.scope.gradual_broadcast(let, tet, triplet_fn)
            )

        G.add_operator(
            [self, threshold_table], [out], lower, "gradual_broadcast"
        )
        return out

    def _forget_immediately(self) -> "Table":
        """Rows pass through and are retracted at the next timestamp
        (reference: internals/table.py _forget_immediately — as-of-now
        query plumbing, stdlib/indexing/data_index.py:46-120)."""
        out = Table(self._schema_cls, Universe())
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(
                out, ctx.scope.forget_immediately(ctx.engine_table(self_))
            )

        G.add_operator([self], [out], lower, "forget_immediately")
        return out

    def sort(self, key: ColumnExpression, instance: ColumnExpression | None = None) -> "Table":
        key_e = self._desugar(expr_mod.smart_coerce(key))
        inst_e = (
            self._desugar(expr_mod.smart_coerce(instance))
            if instance is not None
            else expr_mod.ColumnConstExpression(None)
        )
        out = Table(
            schema_from_types(
                prev=dt.Optional(dt.POINTER), next=dt.Optional(dt.POINTER)
            ),
            self._universe,
        )
        self_ = self

        def lower(ctx):
            et, fn = ctx.row_fn(self_, [key_e, inst_e])
            ctx.set_engine_table(
                out,
                ctx.scope.sort(
                    et,
                    key_fn=lambda k, row, f=fn: f(k, row)[0],
                    instance_fn=lambda k, row, f=fn: f(k, row)[1],
                ),
            )

        G.add_operator(self._dep_tables([key_e, inst_e]), [out], lower, "sort")
        return out

    def diff(self, timestamp: ColumnExpression, *values, instance=None) -> "Table":
        from pathway_tpu_torch.stdlib.ordered import diff as _diff

        return _diff(self, timestamp, *values, instance=instance)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def empty(**kwargs) -> "Table":
        schema = schema_from_types(**kwargs)
        out = Table(schema, Universe())

        def lower(ctx):
            ctx.set_engine_table(out, ctx.scope.empty_table(len(kwargs)))

        G.add_operator([], [out], lower, "empty")
        return out

    @staticmethod
    def from_columns(*args, **kwargs) -> "Table":
        all_refs: list[ColumnReference] = []
        names = []
        for a in args:
            all_refs.append(a)
            names.append(a.name)
        for n, a in kwargs.items():
            all_refs.append(a)
            names.append(n)
        if not all_refs:
            raise ValueError("from_columns needs at least one column")
        base = all_refs[0].table
        return base.select(**{n: r for n, r in zip(names, all_refs)})

    # -- misc --------------------------------------------------------------
    def _materialize(self, universe: Universe) -> "Table":
        out = Table(self._schema_cls, universe)
        self_ = self

        def lower(ctx):
            ctx.set_engine_table(out, ctx.engine_table(self_))

        G.add_operator([self], [out], lower, "materialize")
        return out

    @property
    def slice(self):
        return _TableSlice(self)

    @property
    def C(self) -> "_ColumnNamespace":
        """Column accessor namespace (reference: Joinable.C — reach
        columns whose names collide with Table methods: ``t.C.select``).
        Unlike ``slice``, carries no helper methods at all, so even
        columns named ``keys``/``without`` resolve."""
        return _ColumnNamespace(self)

    # -- reference surface conveniences -----------------------------------
    def debug(self, name: str) -> "Table":
        """Print this table's change stream during the run, prefixed with
        ``name`` (reference: Table.debug / DebugOperator)."""
        from pathway_tpu_torch.io import subscribe as _subscribe

        cols = self.column_names()

        def on_change(key, row, time, diff):
            sign = "+" if diff > 0 else "-"
            vals = ", ".join(f"{c}={row.get(c)!r}" for c in cols)
            print(f"[debug:{name}] {sign} {key!r} {vals} @ {time}")

        _subscribe(self, on_change=on_change)
        return self

    def eval_type(self, expression) -> Any:
        """Resolved dtype of ``expression`` against this table (reference:
        Table.eval_type)."""
        return self._desugar(expr_mod.smart_coerce(expression))._dtype

    def live(self, name: str | None = None):
        """Interactive live view of this table (reference: Table.live —
        here a LiveTableHandle; pw.enable_interactive_mode first).
        ``name=`` pins a stable identity so the handle re-attaches to the
        same logical table across REPL reruns."""
        from pathway_tpu_torch.internals.interactive import live as _live

        return _live(self, name=name)

    def remove_errors(self) -> "Table":
        """Drop rows containing ERROR values (method form of
        pw.remove_errors_from_table; reference: Table.remove_errors)."""
        from pathway_tpu_torch.internals.error_log import remove_errors_from_table

        return remove_errors_from_table(self)

    def to(self, sink) -> None:
        """Send this table to a sink (reference: Table.to(DataSink)).
        Accepts any callable sink factory: ``t.to(lambda tb: pw.io.csv.
        write(tb, path))`` or a writer partial."""
        if callable(sink):
            sink(self)
            return
        raise TypeError(
            "Table.to expects a callable sink (e.g. a pw.io.*.write "
            "partial); got " + type(sink).__name__
        )

    def update_id_type(self, id_type, *, id_append_only=None) -> "Table":
        """Annotate the id column's Pointer type (reference:
        Table.update_id_type). Ids here are untyped 128-bit Pointers, so
        this is a schema-level annotation pass-through."""
        return self.copy()


class _ColumnNamespace:
    """Pure column accessor (Table.C): NOTHING but column resolution, so
    columns named like helper methods (``keys``, ``without``) still
    resolve — the collision case C exists to solve."""

    __slots__ = ("_ns_table",)

    def __init__(self, table: Table):
        object.__setattr__(self, "_ns_table", table)

    def __getattr__(self, name):
        try:
            return self._ns_table[name]
        except KeyError:
            # AttributeError keeps hasattr/getattr-with-default protocols
            # (and introspection machinery probing dunders) working
            raise AttributeError(name) from None

    def __getitem__(self, name):
        return self._ns_table[name]


class _TableSlice(_ColumnNamespace):
    def without(self, *cols):
        names = {c if isinstance(c, str) else c.name for c in cols}
        return [
            self._ns_table[c]
            for c in self._ns_table._column_names
            if c not in names
        ]

    def keys(self):
        return self._ns_table.column_names()


def _origin_table(e: ColumnExpression) -> Table:
    tables = {id(r.table): r.table for r in expr_mod.smart_coerce(e)._deps}
    if len(tables) != 1:
        raise ValueError("expression must reference exactly one table")
    return next(iter(tables.values()))


def _rebind_pointer(self: PointerExpression, table: Table) -> PointerExpression:
    self._table = table
    return self


PointerExpression._rebind = _rebind_pointer  # type: ignore[attr-defined]
