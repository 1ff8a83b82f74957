"""Batch expression evaluator.

Native-equivalent of the reference's typed expression interpreter (reference:
src/engine/expression.rs — per-type ``Expression`` enums evaluated per row
batch with no Python in the loop).  Here the compiled form is a closure
``(keys, rows) -> list[values]`` evaluated column-wise over the whole batch;
pure-numeric subtrees can vectorise via numpy, and ``apply``/UDF nodes are
the only per-row Python entry points (async UDFs run concurrently per batch
— reference: graph.rs:744 async_apply_table).
"""

from __future__ import annotations

import asyncio
import math
from typing import Any, Callable

import numpy as _np

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.api import ERROR, Json, Pointer, ref_scalar

EvalFn = Callable[[list, list], list]  # (keys, rows) -> values


class ExpressionError(Exception):
    pass


# fastpath.c binop op codes (native/fastpath.c fast_binop): the
# expression plane's numeric hot loop; ** stays on the Python loop
_C_BINOP_CODES = {
    "+": 0, "-": 1, "*": 2, "/": 3, "//": 4, "%": 5,
    "<": 6, "<=": 7, ">": 8, ">=": 9, "==": 10, "!=": 11,
    "&": 12, "|": 13, "^": 14,
}


def compile_expression(e: expr.ColumnExpression, resolver, runtime=None) -> EvalFn:
    """resolver(ColumnReference) -> int column index, or "id"."""

    if isinstance(e, expr.ColumnConstExpression):
        val = e._val
        return lambda keys, rows: [val] * len(keys)

    if isinstance(e, expr.ColumnReference):
        loc = resolver(e)
        if loc == "id":
            return lambda keys, rows: list(keys)
        idx = loc
        from pathway_tpu_torch.engine.stream import get_fp

        fp = get_fp()
        if fp is not None:
            pc = fp.project_col
            return lambda keys, rows: pc(rows, idx)
        return lambda keys, rows: [r[idx] for r in rows]

    if isinstance(e, expr.ColumnBinaryOpExpression):
        lf = compile_expression(e._left, resolver, runtime)
        rf = compile_expression(e._right, resolver, runtime)
        op = e._operator
        symbol = e._symbol

        from pathway_tpu_torch.engine.stream import get_fp

        fp = get_fp()
        ccode = _C_BINOP_CODES.get(symbol) if fp is not None else None
        if ccode is not None:
            fbinop = fp.binop

            def eval_binary_c(keys, rows):
                lv = lf(keys, rows)
                rv = rf(keys, rows)
                out, errs = fbinop(lv, rv, ccode, ERROR, op)
                if errs and runtime is not None:
                    for i, msg in errs:
                        runtime.log_data_error(msg, keys[i])
                return out

            return eval_binary_c

        def eval_binary(keys, rows):
            lv = lf(keys, rows)
            rv = rf(keys, rows)
            out = []
            for i, (a, b) in enumerate(zip(lv, rv)):
                if a is ERROR or b is ERROR:
                    out.append(ERROR)
                    continue
                try:
                    out.append(op(a, b))
                except Exception as exc:
                    if runtime is not None:
                        runtime.log_data_error(str(exc), keys[i])
                    out.append(ERROR)
            return out

        return eval_binary

    if isinstance(e, expr.ColumnUnaryOpExpression):
        f = compile_expression(e._expr, resolver, runtime)
        op = e._operator

        def eval_unary(keys, rows):
            return [ERROR if v is ERROR else op(v) for v in f(keys, rows)]

        return eval_unary

    if isinstance(e, expr.IfElseExpression):
        cf = compile_expression(e._if, resolver, runtime)
        tf = compile_expression(e._then, resolver, runtime)
        ef = compile_expression(e._else, resolver, runtime)

        def eval_ifelse(keys, rows):
            raw = cf(keys, rows)
            n = len(keys)
            # normalize numpy bools; non-booleans (None/Error) poison the row
            mask = [
                bool(m) if isinstance(m, (bool, _np.bool_)) else None
                for m in raw
            ]
            out: list[Any] = [None] * n
            t_idx = [i for i in range(n) if mask[i] is True]
            f_idx = [i for i in range(n) if mask[i] is False]
            e_idx = [i for i in range(n) if mask[i] is None]
            if t_idx:
                vals = tf([keys[i] for i in t_idx], [rows[i] for i in t_idx])
                for i, v in zip(t_idx, vals):
                    out[i] = v
            if f_idx:
                vals = ef([keys[i] for i in f_idx], [rows[i] for i in f_idx])
                for i, v in zip(f_idx, vals):
                    out[i] = v
            for i in e_idx:
                out[i] = ERROR
            return out

        return eval_ifelse

    if isinstance(e, expr.CoalesceExpression):
        fns = [compile_expression(a, resolver, runtime) for a in e._args]

        def eval_coalesce(keys, rows):
            n = len(keys)
            out: list[Any] = [None] * n
            remaining = list(range(n))
            for fn in fns:
                if not remaining:
                    break
                vals = fn([keys[i] for i in remaining], [rows[i] for i in remaining])
                still = []
                for i, v in zip(remaining, vals):
                    if v is None:
                        still.append(i)
                    else:
                        out[i] = v
                remaining = still
            return out

        return eval_coalesce

    if isinstance(e, expr.RequireExpression):
        vf = compile_expression(e._val, resolver, runtime)
        fns = [compile_expression(a, resolver, runtime) for a in e._args]

        def eval_require(keys, rows):
            vals = vf(keys, rows)
            checks = [fn(keys, rows) for fn in fns]
            out = []
            for i, v in enumerate(vals):
                if any(c[i] is None for c in checks):
                    out.append(None)
                else:
                    out.append(v)
            return out

        return eval_require

    if isinstance(e, (expr.IsNoneExpression, expr.IsNotNoneExpression)):
        f = compile_expression(e._expr, resolver, runtime)
        # ERROR is absorbing here too: an undecidable value has an
        # undecidable None-ness (reference: Value::Error propagation)
        if isinstance(e, expr.IsNoneExpression):
            return lambda keys, rows: [
                ERROR if v is ERROR else v is None for v in f(keys, rows)
            ]
        return lambda keys, rows: [
            ERROR if v is ERROR else v is not None for v in f(keys, rows)
        ]

    if isinstance(e, expr.CastExpression):
        f = compile_expression(e._expr, resolver, runtime)
        target = e._dtype
        from pathway_tpu_torch.internals import dtype as dt

        conv: Callable[[Any], Any]
        base = dt.unoptionalize(target)
        if base is dt.INT:
            conv = int
        elif base is dt.FLOAT:
            conv = float
        elif base is dt.STR:
            conv = str
        elif base is dt.BOOL:
            conv = bool
        else:
            conv = lambda v: v

        def eval_cast(keys, rows):
            out = []
            for v in f(keys, rows):
                if v is None or v is ERROR:
                    out.append(v)
                else:
                    try:
                        out.append(conv(v))
                    except Exception:
                        out.append(ERROR)
            return out

        return eval_cast

    if isinstance(e, expr.ConvertExpression):
        f = compile_expression(e._expr, resolver, runtime)
        fun = e._fun

        def eval_convert(keys, rows):
            out = []
            for v in f(keys, rows):
                if v is None or v is ERROR:
                    out.append(v)
                    continue
                if isinstance(v, Json):
                    v = v.value
                try:
                    out.append(fun(v))
                except Exception:
                    out.append(None)
            return out

        return eval_convert

    if isinstance(e, expr.DeclareTypeExpression):
        return compile_expression(e._expr, resolver, runtime)

    if isinstance(e, expr.UnwrapExpression):
        f = compile_expression(e._expr, resolver, runtime)

        def eval_unwrap(keys, rows):
            out = []
            for v in f(keys, rows):
                out.append(ERROR if v is None else v)
            return out

        return eval_unwrap

    if isinstance(e, expr.FillErrorExpression):
        f = compile_expression(e._expr, resolver, runtime)
        rf = compile_expression(e._replacement, resolver, runtime)

        def eval_fill(keys, rows):
            vals = f(keys, rows)
            reps = rf(keys, rows)
            return [r if v is ERROR else v for v, r in zip(vals, reps)]

        return eval_fill

    if isinstance(e, expr.MakeTupleExpression):
        fns = [compile_expression(a, resolver, runtime) for a in e._args]

        def eval_tuple(keys, rows):
            cols = [fn(keys, rows) for fn in fns]
            return list(zip(*cols)) if cols else [()] * len(keys)

        return eval_tuple

    if isinstance(e, expr.GetExpression):
        from pathway_tpu_torch.internals.api import _NAV_MISSING, json_navigate
        from pathway_tpu_torch.internals import dtype as _dt

        of = compile_expression(e._object, resolver, runtime)
        idxf = compile_expression(e._index, resolver, runtime)
        df = compile_expression(e._default, resolver, runtime)
        checked = e._check_if_exists
        # a None OBJECT continues as null only along JSON navigation
        # chains (j["absent"]["deep"]); for tuple/list columns a None
        # object still poisons to ERROR like any bad unchecked access.
        # Chains are detected structurally too: desugaring rebuilds trees
        # with construction-time dtypes, so a get-over-get built through
        # pw.this still types as ANY even when the column is JSON.
        obj_t = e._object._dtype
        json_chain = (
            obj_t is _dt.JSON
            or (
                isinstance(obj_t, _dt._OptionalDType)
                and obj_t._wrapped is _dt.JSON
            )
            or (
                isinstance(e._object, expr.GetExpression)
                and not isinstance(
                    obj_t, (_dt._TupleDType, _dt._ListDType)
                )
            )
        )

        def eval_get(keys, rows):
            objs = of(keys, rows)
            idxs = idxf(keys, rows)
            defaults = df(keys, rows)
            out = []
            for o, i, d in zip(objs, idxs, defaults):
                if o is ERROR or i is ERROR:
                    out.append(ERROR)
                    continue
                if o is None and json_chain:
                    out.append(d if checked else None)
                    continue
                if isinstance(o, Json):
                    # total navigation (reference: test_json.py —
                    # missing/out-of-range/negative -> null, never
                    # Error); single source of truth: api.json_navigate
                    v = json_navigate(o.value, i)
                    if v is _NAV_MISSING:
                        out.append(d if checked else None)
                    else:
                        out.append(Json(v) if isinstance(v, (dict, list)) else v)
                    continue
                try:
                    out.append(o[i])
                except (KeyError, IndexError, TypeError):
                    out.append(d if checked else ERROR)
            return out

        return eval_get

    if isinstance(e, expr.MethodCallExpression):
        fns = [compile_expression(a, resolver, runtime) for a in e._args]
        fun = e._fun
        method_propagate_none = getattr(e, "_propagate_none", True)

        def eval_method(keys, rows):
            cols = [fn(keys, rows) for fn in fns]
            out = []
            for i in range(len(keys)):
                args = [c[i] for c in cols]
                if args[0] is ERROR:
                    out.append(ERROR)
                    continue
                if args[0] is None and method_propagate_none:
                    out.append(None)
                    continue
                if isinstance(args[0], Json):
                    args[0] = args[0].value
                try:
                    out.append(fun(*args))
                except Exception:
                    out.append(ERROR)
            return out

        return eval_method

    if isinstance(e, expr.PointerExpression):
        fns = [compile_expression(a, resolver, runtime) for a in e._args]
        if e._instance is not None:
            fns.append(compile_expression(e._instance, resolver, runtime))
        optional = e._optional

        def eval_pointer(keys, rows):
            cols = [fn(keys, rows) for fn in fns]
            return [
                ref_scalar(*(c[i] for c in cols), optional=optional)
                for i in range(len(keys))
            ]

        return eval_pointer

    if isinstance(e, expr.ReducerExpression):
        raise ExpressionError(
            f"reducer {e._reducer.name} used outside of a reduce() context"
        )

    if isinstance(e, expr.AsyncApplyExpression):
        return _compile_async_apply(e, resolver, runtime)

    if isinstance(e, expr.ApplyExpression):
        return _compile_apply(e, resolver, runtime)

    raise ExpressionError(f"cannot compile expression {e!r} ({type(e).__name__})")


def _arg_columns(e: expr.ApplyExpression, resolver, runtime):
    arg_fns = [compile_expression(a, resolver, runtime) for a in e._args]
    kw_fns = {k: compile_expression(v, resolver, runtime) for k, v in e._kwargs.items()}
    return arg_fns, kw_fns


def _compile_apply(e: expr.ApplyExpression, resolver, runtime) -> EvalFn:
    arg_fns, kw_fns = _arg_columns(e, resolver, runtime)
    fun = e._fun
    propagate_none = e._propagate_none
    batched = getattr(e, "_max_batch_size", None)

    def eval_apply(keys, rows):
        arg_cols = [fn(keys, rows) for fn in arg_fns]
        kw_cols = {k: fn(keys, rows) for k, fn in kw_fns.items()}
        n = len(keys)
        if batched is not None:
            # Batched UDF: fn receives lists of args (the ≥10k docs/s lever,
            # SURVEY §7 stage 4 — reference embeds one string per call).
            out: list[Any] = []
            step = batched if batched > 0 else n
            for s in range(0, n, step):
                sl = slice(s, min(s + step, n))
                try:
                    res = fun(
                        *[c[sl] for c in arg_cols],
                        **{k: c[sl] for k, c in kw_cols.items()},
                    )
                    out.extend(res)
                except Exception:
                    out.extend([ERROR] * (sl.stop - sl.start))
            return out
        out = []
        for i in range(n):
            args = [c[i] for c in arg_cols]
            kwargs = {k: c[i] for k, c in kw_cols.items()}
            if any(a is ERROR for a in args) or any(
                v is ERROR for v in kwargs.values()
            ):
                out.append(ERROR)
                continue
            if propagate_none and (
                any(a is None for a in args) or any(v is None for v in kwargs.values())
            ):
                out.append(None)
                continue
            try:
                out.append(fun(*args, **kwargs))
            except Exception as exc:
                if runtime is not None:
                    runtime.log_data_error(
                        f"{type(exc).__name__}: {exc}", keys[i]
                    )
                out.append(ERROR)
        return out

    return eval_apply


def _compile_async_apply(e: expr.AsyncApplyExpression, resolver, runtime) -> EvalFn:
    arg_fns, kw_fns = _arg_columns(e, resolver, runtime)
    fun = e._fun

    def eval_async(keys, rows):
        arg_cols = [fn(keys, rows) for fn in arg_fns]
        kw_cols = {k: fn(keys, rows) for k, fn in kw_fns.items()}
        n = len(keys)

        async def run_all():
            async def one(i):
                try:
                    return await fun(
                        *[c[i] for c in arg_cols],
                        **{k: c[i] for k, c in kw_cols.items()},
                    )
                except Exception:
                    return ERROR

            return await asyncio.gather(*(one(i) for i in range(n)))

        if runtime is not None:
            return list(runtime.async_loop.run_until_complete(run_all()))
        return list(asyncio.run(run_all()))

    return eval_async
