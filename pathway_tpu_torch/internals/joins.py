"""Join machinery (reference: python/pathway/internals/joins.py, 1,422 LoC;
engine side: Graph::join_tables graph.rs + JoinType graph.rs:480).

``t1.join(t2, t1.a == t2.b).select(...)`` — the JoinResult carries the two
sides and on-conditions; select lowers to the engine JoinNode (incremental,
all four join types) followed by a rowwise projection over the concatenated
left+right row.
"""

from __future__ import annotations

import enum
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.internals.universe import Universe


class JoinMode(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


class JoinResult:
    def __init__(self, left, right, on, *, id=None, how="inner", exact_match=False):
        self._left = left
        self._right = right
        self._how = how
        self._id = id
        # exact_match promises every left row matches exactly once
        # (reference: joins.py exact_match — keeps right columns
        # non-optional); types are dynamic here so it is metadata only
        self._exact_match = exact_match
        self._on: list[tuple[ColumnExpression, ColumnExpression]] = []
        for cond in on:
            cond = thisclass.desugar(cond, left_table=left, right_table=right)
            if (
                not isinstance(cond, expr_mod.ColumnBinaryOpExpression)
                or cond._symbol != "=="
            ):
                raise ValueError("join conditions must be of the form left.col == right.col")
            import builtins

            lhs, rhs = cond._left, cond._right
            l_tabs = {builtins.id(r.table) for r in lhs._deps}
            if builtins.id(right) in l_tabs:
                lhs, rhs = rhs, lhs
            for r in lhs._deps:
                if r.table is not left:
                    raise ValueError("left side of join condition must use the left table")
            for r in rhs._deps:
                if r.table is not right:
                    raise ValueError("right side of join condition must use the right table")
            self._on.append((lhs, rhs))

    # -- deferred resolution ----------------------------------------------
    def _resolve_deferred(self, name: str) -> ColumnExpression:
        if name == "id":
            return _join_id_ref(self)
        in_left = name in self._left._column_names
        in_right = name in self._right._column_names
        if in_left and in_right:
            # unified if it is an on-pair of same-named columns
            for lhs, rhs in self._on:
                if (
                    isinstance(lhs, ColumnReference)
                    and isinstance(rhs, ColumnReference)
                    and lhs.name == name
                    and rhs.name == name
                ):
                    if self._how in ("right", "outer"):
                        # padded side carries None — unify across both sides
                        return expr_mod.coalesce(
                            self._left[name], self._right[name]
                        )
                    return self._left[name]
            raise ValueError(
                f"column {name!r} exists in both sides of the join; "
                f"use pw.left/pw.right to disambiguate"
            )
        if in_left:
            return self._left[name]
        if in_right:
            return self._right[name]
        raise KeyError(name)

    @property
    def _all_column_names(self) -> list[str]:
        seen = []
        for n in self._left._column_names + self._right._column_names:
            if n not in seen:
                try:
                    self._resolve_deferred(n)
                except ValueError:
                    continue
                except KeyError:
                    continue
                seen.append(n)
        return seen

    def select(self, *args, **kwargs):
        from pathway_tpu_torch.internals.table import Table

        names: list[str] = []
        exprs: list[ColumnExpression] = []

        def add(name, e):
            if name in names:
                exprs[names.index(name)] = e
            else:
                names.append(name)
                exprs.append(e)

        for arg in args:
            if isinstance(arg, thisclass._ThisWithout):
                for n in self._all_column_names:
                    if n not in arg._excluded:
                        add(n, self._resolve_deferred(n))
            elif isinstance(arg, thisclass.ThisClass):
                for n in self._all_column_names:
                    add(n, self._resolve_deferred(n))
            elif isinstance(arg, thisclass.ThisColumnReference):
                add(arg.name, self._desugar(arg))
            elif isinstance(arg, ColumnReference):
                add(arg.name, arg)
            else:
                raise ValueError(f"invalid select argument {arg!r}")
        for n, e in kwargs.items():
            add(n, self._desugar(expr_mod.smart_coerce(e)))

        left, right = self._left, self._right
        lw = len(left._column_names)
        rw = len(right._column_names)
        id_from_left = False
        id_from_right = False
        id_expr = None      # pointer-valued expression supplying output ids
        id_expr_side = None
        if self._id is not None:
            idref = self._id
            if isinstance(idref, thisclass.ThisColumnReference):
                idref = self._desugar(idref)
            id_deps = idref._deps
            dep_tables = {d.table for d in id_deps}
            if (
                isinstance(idref, ColumnReference)
                and idref.name == "id"
                and idref.table is left
            ):
                id_from_left = True
            elif (
                isinstance(idref, ColumnReference)
                and idref.name == "id"
                and idref.table is right
            ):
                id_from_right = True
            elif dep_tables <= {left}:
                # ids come from the VALUES of a left-side pointer expression
                id_expr, id_expr_side = idref, "left"
            elif dep_tables <= {right}:
                id_expr, id_expr_side = idref, "right"
            else:
                raise ValueError("join id= must reference one side of the join")

        out_schema = schema_from_types(**{n: e._dtype for n, e in zip(names, exprs)})
        universe = (
            left._universe
            if id_from_left
            else right._universe if id_from_right else Universe()
        )
        out = Table(out_schema, universe)
        on = self._on
        how = self._how
        self_ = self

        def lower(ctx):
            from pathway_tpu_torch.engine.expression import compile_expression

            let = ctx.engine_table(left)
            ret = ctx.engine_table(right)

            def side_resolver(table):
                def resolver(ref):
                    if ref.name == "id":
                        return "id"
                    if ref.table is not table:
                        raise KeyError(
                            f"join key must reference {table._name}; got {ref!r}"
                        )
                    return table._column_names.index(ref.name)

                return resolver

            lfns = [
                compile_expression(lhs, side_resolver(left), ctx.runtime)
                for lhs, _ in on
            ]
            rfns = [
                compile_expression(rhs, side_resolver(right), ctx.runtime)
                for _, rhs in on
            ]

            def lkey(k, row):
                return tuple(f([k], [row])[0] for f in lfns)

            def rkey(k, row):
                return tuple(f([k], [row])[0] for f in rfns)

            # column-oriented key evaluation for the engine's batch path
            # (one compiled-expression call per batch per key column)
            def lkey_batch(keys, rows):
                cols = [f(keys, rows) for f in lfns]
                return list(zip(*cols)) if cols else [()] * len(keys)

            def rkey_batch(keys, rows):
                cols = [f(keys, rows) for f in rfns]
                return list(zip(*cols)) if cols else [()] * len(keys)

            # NativeBatch fused-chain eligibility: every join condition a
            # plain column == plain column (the shapes join_batch_nb
            # extracts straight from the columnar image); anything else —
            # expressions over the key, pw.this.id — keeps the tuple
            # path. The predicate (and the blame naming the offending
            # expression) lives in analysis/eligibility.py, shared with
            # pw.analyze so analyzer and executor cannot drift.
            from pathway_tpu_torch.analysis import eligibility as _elig

            nb_lkidx, nb_rkidx, nb_lblame, nb_rblame = (
                _elig.join_key_indices(on, left, right)
            )
            nb_blame = (
                nb_lblame + nb_rblame
                + _elig.join_id_blame(id_expr, id_expr_side)
            )

            left_id_fn = right_id_fn = None
            if id_expr is not None:
                side_table = left if id_expr_side == "left" else right
                idf = compile_expression(
                    id_expr, side_resolver(side_table), ctx.runtime
                )

                def _id_fn(k, row):
                    return idf([k], [row])[0]

                if id_expr_side == "left":
                    left_id_fn = _id_fn
                else:
                    right_id_fn = _id_fn

            joined = self_._engine_join(
                ctx,
                let,
                ret,
                lkey,
                rkey,
                how,
                id_from_left=id_from_left,
                id_from_right=id_from_right,
                left_id_fn=left_id_fn,
                right_id_fn=right_id_fn,
                lkey_batch=lkey_batch,
                rkey_batch=rkey_batch,
                nb_lkidx=nb_lkidx,
                nb_rkidx=nb_rkidx,
                nb_blame=nb_blame,
                nb_lblame=nb_lblame,
                nb_rblame=nb_rblame,
            )

            def out_resolver(ref):
                if ref.name == "id":
                    return "id"
                if ref.table is left:
                    return left._column_names.index(ref.name)
                if ref.table is right:
                    return lw + right._column_names.index(ref.name)
                raise KeyError(
                    f"join select can only use columns of the joined tables; got {ref!r}"
                )

            fns = [compile_expression(e, out_resolver, ctx.runtime) for e in exprs]

            def batch_fn(keys, rows):
                cols = [f(keys, rows) for f in fns]
                return list(zip(*cols)) if cols else [()] * len(keys)

            # a select of plain column references is a pure projection:
            # a fused join's NativeBatch output then stays columnar
            # through this hop (RowwiseNode nb_proj_idx -> nb_project)
            nb_proj_idx, proj_blame = _elig.join_projection_indices(
                names, exprs, left, right, lw
            )

            ctx.set_engine_table(
                out,
                ctx.scope.rowwise_auto(
                    joined, batch_fn, len(fns),
                    all(e._is_deterministic for e in exprs),
                    nb_proj_idx=nb_proj_idx,
                    nb_blame=proj_blame,
                    src_exprs=exprs,
                ),
            )

        G.add_operator([left, right], [out], lower, f"join_{how}")
        return out

    def _engine_join(
        self, ctx, let, ret, lkey, rkey, how, *,
        id_from_left, id_from_right, left_id_fn, right_id_fn,
        lkey_batch=None, rkey_batch=None, nb_lkidx=None, nb_rkidx=None,
        nb_blame=(), nb_lblame=None, nb_rblame=None,
    ):
        """Engine-join construction hook; temporal joins override this
        (stdlib/temporal) while reusing the select/desugaring machinery."""
        return ctx.scope.join(
            let,
            ret,
            lkey,
            rkey,
            how,
            id_from_left=id_from_left,
            id_from_right=id_from_right,
            left_id_fn=left_id_fn,
            right_id_fn=right_id_fn,
            lkey_batch=lkey_batch,
            rkey_batch=rkey_batch,
            nb_lkidx=nb_lkidx,
            nb_rkidx=nb_rkidx,
            nb_blame=nb_blame,
            nb_lblame=nb_lblame,
            nb_rblame=nb_rblame,
        )

    def _desugar(self, e):
        def fn(x):
            if isinstance(x, thisclass.ThisColumnReference):
                if x._owner is thisclass.this:
                    return self._resolve_deferred(x.name)
                if x._owner is thisclass.left:
                    return self._left._resolve_deferred(x.name)
                if x._owner is thisclass.right:
                    return self._right._resolve_deferred(x.name)
            return None

        return thisclass.rewrite(expr_mod.smart_coerce(e), fn)

    # -- chained ops over the implicit full select -------------------------
    def _materialized(self):
        return self.select(*[
            self._resolve_deferred(n) for n in self._all_column_names
        ])

    def filter(self, e):
        return self._materialized().filter(e)

    def groupby(self, *args, **kwargs):
        return self._materialized().groupby(*args, **kwargs)

    def reduce(self, *args, **kwargs):
        return self._materialized().reduce(*args, **kwargs)


def _join_id_ref(jr: JoinResult) -> ColumnExpression:
    # pw.this.id in a join select: the joined row's output id.  We expose it
    # as a reference named "id" on the left table; the join lowering maps
    # "id" to the output key directly.
    r = ColumnReference.__new__(ColumnReference)
    ColumnExpression.__init__(r)
    r._table = jr._left
    r._name = "id"
    r._dtype = dt.POINTER
    return r
