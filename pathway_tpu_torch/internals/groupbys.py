"""Groupby/reduce machinery (reference: python/pathway/internals/groupbys.py
+ graph_runner reduce lowering).

``t.groupby(cols).reduce(out=reducer(...))`` lowers to the engine's
GroupByNode: per-group multisets, affected-group rediff, output keyed by
``ref_scalar(*grouping_values)`` (reference: Graph::group_by_table,
graph.rs:885).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.reducers import StatefulReducer
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.internals.universe import Universe


class GroupedTable:
    def __init__(
        self,
        table,
        grouping: list[ColumnExpression],
        sort_by=None,
        id_from_first_group_col: bool = False,
    ):
        self._table = table
        self._grouping = [expr_mod.smart_coerce(g) for g in grouping]
        self._sort_by = (
            table._desugar(expr_mod.smart_coerce(sort_by)) if sort_by is not None else None
        )
        # groupby(id=ptr_col): output row ids ARE the grouping values
        self._id_from_first_group_col = id_from_first_group_col

    def _resolve_deferred(self, name: str):
        return self._table._resolve_deferred(name)

    def reduce(self, *args, **kwargs):
        from pathway_tpu_torch.internals.table import Table

        base = self._table
        names: list[str] = []
        out_exprs: list[ColumnExpression] = []
        for arg in args:
            if isinstance(arg, thisclass.ThisColumnReference):
                names.append(arg.name)
                out_exprs.append(base._desugar(arg))
            elif isinstance(arg, ColumnReference):
                names.append(arg.name)
                out_exprs.append(arg)
            else:
                raise ValueError(
                    "positional reduce() arguments must be column references"
                )
        for n, e in kwargs.items():
            names.append(n)
            out_exprs.append(base._desugar(expr_mod.smart_coerce(e)))

        grouping = self._grouping
        grouping_ids = {id(g) for g in grouping}
        grouping_refs = {
            (id(g.table), g.name): j
            for j, g in enumerate(grouping)
            if isinstance(g, ColumnReference)
        }

        # synthetic result namespace: g0..gN grouping cols, r0..rM reducers
        reducers: list[ReducerExpression] = []
        gtable_cols: dict[str, dt.DType] = {
            f"g{j}": g._dtype for j, g in enumerate(grouping)
        }

        gtable = Table.__new__(Table)  # bare namespace table, never lowered
        gtable._name = "groupby_result"
        gtable._column_names = []
        gtable._schema_cls = None

        def gref(name: str, dtype: dt.DType) -> ColumnReference:
            r = ColumnReference.__new__(ColumnReference)
            ColumnExpression.__init__(r)
            r._table = gtable
            r._name = name
            r._dtype = dtype
            return r

        def _same_structure(a: ColumnExpression, b: ColumnExpression) -> bool:
            # reduce() may repeat the grouping expression as a new object
            # (reference: groupbys.py matches by expression structure).
            # Applies/UDFs are excluded: their reprs elide function identity
            # and arguments, so repr equality would false-positive.
            if type(a) is not type(b) or repr(a) != repr(b):
                return False
            if not (a._is_deterministic and b._is_deterministic):
                return False

            def has_apply(e):
                from pathway_tpu_torch.internals.expression import ApplyExpression

                stack = [e]
                while stack:
                    x = stack.pop()
                    if isinstance(x, ApplyExpression):
                        return True
                    stack.extend(x._subexpressions())
                return False

            if has_apply(a) or has_apply(b):
                return False
            return [(id(r.table), r.name) for r in a._deps] == [
                (id(r.table), r.name) for r in b._deps
            ]

        def rewrite_fn(e: ColumnExpression):
            if isinstance(e, ReducerExpression):
                idx = len(reducers)
                reducers.append(e)
                return gref(f"r{idx}", e._dtype)
            if id(e) in grouping_ids:
                j = grouping.index(e)
                return gref(f"g{j}", e._dtype)
            if not isinstance(e, ColumnReference):
                for j, g in enumerate(grouping):
                    if _same_structure(e, g):
                        return gref(f"g{j}", e._dtype)
            if isinstance(e, ColumnReference):
                j = grouping_refs.get((id(e.table), e.name))
                if j is not None:
                    return gref(f"g{j}", e._dtype)
                if e.name == "id" and e.table is base:
                    raise ValueError(
                        "cannot use id of the source table in reduce(); "
                        "group by it explicitly"
                    )
            return None

        rewritten = [thisclass.rewrite(e, rewrite_fn) for e in out_exprs]

        # validate: no remaining refs outside gtable
        for e in rewritten:
            for ref in e._deps:
                if ref.table is not gtable:
                    raise ValueError(
                        f"column {ref.name!r} must be grouped or wrapped in a reducer"
                    )
        for i, r in enumerate(reducers):
            gtable_cols[f"r{i}"] = r._dtype

        stateful = [r for r in reducers if isinstance(r._reducer, StatefulReducer)]

        out_schema = schema_from_types(
            **{n: e._dtype for n, e in zip(names, rewritten)}
        )
        out = Table(out_schema, Universe())
        n_group = len(grouping)

        sort_by = self._sort_by
        id_from_first = self._id_from_first_group_col
        key_fn = (lambda gvals: gvals[0]) if id_from_first else None

        def lower(ctx):
            from pathway_tpu_torch.engine.expression import compile_expression

            all_input_exprs = list(grouping) + [
                a for r in reducers for a in r._args
            ] + ([sort_by] if sort_by is not None else [])
            et, resolver = ctx._combined_view(base, all_input_exprs)

            deterministic = all(e._is_deterministic for e in all_input_exprs)
            if deterministic:
                gfns = [
                    compile_expression(g, resolver, ctx.runtime) for g in grouping
                ]
                arg_fns = [
                    [compile_expression(a, resolver, ctx.runtime) for a in r._args]
                    for r in reducers
                ]
                sort_fn = (
                    compile_expression(sort_by, resolver, ctx.runtime)
                    if sort_by is not None
                    else None
                )
            else:
                # non-deterministic UDFs feeding a groupby must be computed
                # ONCE per row and replayed on retraction, else the retraction
                # keys a different multiset slot (consistent-deletions
                # semantics, reference dataflow.rs:1480) — pre-materialize all
                # inputs through a memoized rowwise stage and index by slot
                base_fns = [
                    compile_expression(e, resolver, ctx.runtime)
                    for e in all_input_exprs
                ]

                def precompute(keys, rows):
                    cols = [f(keys, rows) for f in base_fns]
                    return list(zip(*cols)) if cols else [()] * len(keys)

                et = ctx.scope.rowwise_memoized(
                    et, precompute, len(all_input_exprs),
                    src_exprs=all_input_exprs,
                )

                def slot_fn(j):
                    def f(keys, rows):
                        return [r[j] for r in rows]

                    return f

                gfns = [slot_fn(j) for j in range(n_group)]
                arg_fns = []
                pos = n_group
                for r in reducers:
                    arg_fns.append(
                        [slot_fn(pos + i) for i in range(len(r._args))]
                    )
                    pos += len(r._args)
                sort_fn = slot_fn(pos) if sort_by is not None else None

            def grouping_fn(k, row):
                return tuple(f([k], [row])[0] for f in gfns)

            def args_fn(k, row):
                # contract: (*args, order_token, row_key) per reducer slot
                order = sort_fn([k], [row])[0] if sort_fn is not None else k
                return tuple(
                    tuple(f([k], [row])[0] for f in fns) + (order, k)
                    for fns in arg_fns
                )

            # column-oriented batch variants: one evaluator call per column
            # per batch instead of two closure calls per row
            def grouping_batch(keys, rows):
                if not gfns:
                    return [()] * len(keys)
                cols = [f(keys, rows) for f in gfns]
                return list(zip(*cols))

            # all-plain-column grouping builds the gvals tuples in one C
            # pass over the rows (the wordcount-class hot path). In the
            # non-deterministic branch the grouping values occupy slots
            # 0..n_group-1 of the pre-materialized rows by construction.
            from pathway_tpu_torch.engine.stream import get_fp

            fp = get_fp()
            if fp is not None and grouping:
                g_idx: list[int] | None = []
                if deterministic:
                    for g in grouping:
                        loc = (
                            resolver(g)
                            if isinstance(g, ColumnReference)
                            else None
                        )
                        if isinstance(loc, int):
                            g_idx.append(loc)
                        else:
                            g_idx = None
                            break
                else:
                    g_idx = list(range(n_group))
                if g_idx is not None and len(g_idx) > 32:
                    g_idx = None  # native projection caps at 32 columns
                if g_idx is not None:
                    idxs = tuple(g_idx)
                    pt = fp.project_tuples

                    def grouping_batch(keys, rows):  # noqa: F811
                        return pt(rows, idxs)

            def args_batch(keys, rows):
                n = len(keys)
                order_col = (
                    sort_fn(keys, rows) if sort_fn is not None else keys
                )
                per_reducer = []
                for fns in arg_fns:
                    if fns:
                        acols = [f(keys, rows) for f in fns]
                        per_reducer.append(
                            [
                                tuple(vals) + (order_col[i], keys[i])
                                for i, vals in enumerate(zip(*acols))
                            ]
                        )
                    else:
                        per_reducer.append(
                            [(order_col[i], keys[i]) for i in range(n)]
                        )
                if not per_reducer:  # reduce() with no reducer columns
                    return [()] * n
                return list(zip(*per_reducer))

            # single-column arg evaluators for the native executor: one
            # entry per reducer — None for arg-less reducers (count);
            # multi-arg reducers make the node ineligible. sort_by rides
            # along as a separate order column (native_order) that the
            # C++ store keys multiset entries and tuple/any orderings on.
            native_args = []
            for fns in arg_fns:
                if len(fns) == 0:
                    native_args.append(None)
                elif len(fns) == 1:
                    native_args.append(fns[0])
                else:
                    native_args = None
                    break

            if len(stateful) == len(reducers) == 1:
                red = reducers[0]
                post = getattr(red, "_post_process", None)
                combine = red._reducer.combine_many

                def combine_rows(state, rows):
                    # rows: list of (args_combo, diff); combo = ((a1..ak, order, key),)
                    flat = [(combo[0][:-2], d) for combo, d in rows]
                    return combine(state, flat)

                get = ctx.scope.stateful_reduce(
                    et, grouping_fn, args_fn, combine_rows, n_group, key_fn=key_fn
                )
                if post is not None:
                    get = ctx.scope.rowwise(
                        get,
                        lambda keys, rows: [
                            r[:-1] + (post(r[-1]),) for r in rows
                        ],
                        get.width,
                    )
                grouped = get
            else:
                reducer_specs = []
                for r in reducers:
                    post = getattr(r, "_post_process", None)
                    if isinstance(r._reducer, StatefulReducer):
                        # stateful rides the general node as a per-row
                        # accumulator slot — freely composable with plain
                        # reducers (reference: reduce.rs:22, Stateful is
                        # just another Reducer variant). Diffs flow into
                        # combine_many exactly like the dedicated node's.
                        combine = r._reducer.combine_many

                        def upd(s, combo, d, _c=combine):
                            return _c(s, [(combo[:-2], d)])

                        fin = (
                            (lambda s, _p=post: _p(s))
                            if post is not None
                            else (lambda s: s)
                        )
                        reducer_specs.append(("abelian", upd, fin, None))
                        continue
                    spec = r._reducer.engine_spec(**r._kwargs)
                    if post is not None:
                        if spec[0] == "abelian":
                            # drops any native code: post-processing needs
                            # the Python finish path
                            upd, fin, init = spec[1], spec[2], spec[3]
                            spec = (
                                "abelian", upd,
                                lambda s, _f=fin, _p=post: _p(_f(s)), init,
                            )
                        else:
                            fn = spec[1]
                            spec = (
                                "full",
                                lambda ms, slot, _f=fn, _p=post: _p(_f(ms, slot)),
                            )
                    reducer_specs.append(spec)
                # NativeBatch fused-chain eligibility: deterministic
                # plain-column grouping and argless/single-plain-column
                # reducer args, no sort_by — the shapes the columnar C
                # parse→groupby path (exec.cpp process_batch_nb) executes
                # with zero per-row Python objects. The predicate (and
                # the blame naming the offending expression/reducer)
                # lives in analysis/eligibility.py, shared with
                # pw.analyze so analyzer and executor cannot drift.
                from pathway_tpu_torch.analysis import eligibility as _elig

                nb_gidx, nb_argidx, nb_blame = _elig.groupby_nb_indices(
                    grouping, reducers, sort_by, deterministic, resolver
                )

                grouped = ctx.scope.group_by(
                    et, grouping_fn, args_fn, reducer_specs, n_group,
                    key_fn=key_fn, grouping_batch=grouping_batch,
                    args_batch=args_batch, native_args=native_args,
                    native_order=sort_fn,
                    nb_gidx=nb_gidx, nb_argidx=nb_argidx,
                    nb_blame=nb_blame,
                    src_exprs=all_input_exprs,
                )

            # stage 2: evaluate output expressions over gvals + reducer values
            def out_resolver(ref):
                if ref.table is gtable:
                    name = ref.name
                    if name.startswith("g"):
                        return int(name[1:])
                    return n_group + int(name[1:])
                if ref.name == "id":
                    return "id"
                raise KeyError(ref.name)

            # identity projection (reduce(word=this.g, c=reducer) in slot
            # order) needs no rowwise stage at all; an all-plain-column
            # projection runs as one C pass. Both are the common shapes on
            # the relational hot path.
            out_idx: list[int] | None = []
            for e in rewritten:
                loc = (
                    out_resolver(e)
                    if isinstance(e, ColumnReference)
                    else None
                )
                if isinstance(loc, int):
                    out_idx.append(loc)
                else:
                    out_idx = None
                    break
            grouped_width = n_group + len(reducers)
            if out_idx is not None and out_idx == list(range(grouped_width)):
                ctx.set_engine_table(out, grouped)
                return
            if out_idx is not None and len(out_idx) > 32:
                out_idx = None  # native projection caps at 32 columns

            if out_idx is not None and fp is not None:
                idxs_out = tuple(out_idx)

                def batch_fn(keys, rows):
                    return fp.project_tuples(rows, idxs_out)

            else:
                out_fns = [
                    compile_expression(e, out_resolver, ctx.runtime)
                    for e in rewritten
                ]

                def batch_fn(keys, rows):  # noqa: F811
                    cols = [f(keys, rows) for f in out_fns]
                    return list(zip(*cols)) if cols else [()] * len(keys)

            ctx.set_engine_table(
                out,
                ctx.scope.rowwise_auto(
                    grouped, batch_fn, len(rewritten),
                    all(e._is_deterministic for e in rewritten),
                    src_exprs=rewritten,
                ),
            )

        dep_exprs = list(grouping) + [a for r in reducers for a in r._args]
        G.add_operator(base._dep_tables(dep_exprs), [out], lower, "groupby_reduce")
        return out
