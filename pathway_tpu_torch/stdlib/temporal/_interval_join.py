"""Interval join (reference:
python/pathway/stdlib/temporal/_interval_join.py, 1,619 LoC — here lowered
onto the engine's TemporalJoinNode rediff operator).

``t1.interval_join(t2, t1.t, t2.t, pw.temporal.interval(-2, 1), t1.k ==
t2.k)`` joins rows where ``other_time - self_time ∈ [lower_bound,
upper_bound]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.joins import JoinResult
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import CommonBehavior


@dataclasses.dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    if lower_bound > upper_bound:
        raise ValueError("interval lower_bound exceeds upper_bound")
    return Interval(lower_bound, upper_bound)


class IntervalJoinResult(JoinResult):
    def __init__(
        self, left, right, on, *, self_time, other_time, iv: Interval,
        how="inner", behavior: CommonBehavior | None = None,
        orig_left=None, orig_right=None,
    ):
        super().__init__(left, right, on, how=how)
        self._self_time = left._desugar(expr_mod.smart_coerce(self_time))
        self._other_time = right._desugar(expr_mod.smart_coerce(other_time))
        self._interval = iv
        self._behavior = behavior
        # behavior gating replaces the join inputs with buffered/frozen
        # copies; user select/filter expressions still reference the
        # ORIGINAL tables and are re-pointed here (reference surface:
        # interval_join(...).select(t1.x, t2.y) works with behaviors)
        self._orig_left = orig_left if orig_left is not None else left
        self._orig_right = orig_right if orig_right is not None else right

    def _fix_expr(self, e):
        e = rebind(e, self._orig_left, self._left)
        return rebind(e, self._orig_right, self._right)

    def select(self, *args, **kwargs):
        args = tuple(
            self._fix_expr(a) if hasattr(a, "_dtype") else a for a in args
        )
        kwargs = {
            k: self._fix_expr(expr_mod.smart_coerce(v))
            for k, v in kwargs.items()
        }
        return super().select(*args, **kwargs)

    def _engine_join(
        self, ctx, let, ret, lkey, rkey, how, *,
        id_from_left, id_from_right, left_id_fn, right_id_fn,
        lkey_batch=None, rkey_batch=None, nb_lkidx=None, nb_rkidx=None,
        nb_blame=(), nb_lblame=None, nb_rblame=None,
    ):
        from pathway_tpu_torch.engine.expression import compile_expression
        from pathway_tpu_torch.engine.temporal_join import TemporalJoinNode
        from pathway_tpu_torch.engine.scope import EngineTable

        left, right = self._left, self._right

        def side_resolver(table):
            def resolver(ref):
                if ref.name == "id":
                    return "id"
                return table._column_names.index(ref.name)

            return resolver

        ltf = compile_expression(
            self._self_time, side_resolver(left), ctx.runtime
        )
        rtf = compile_expression(
            self._other_time, side_resolver(right), ctx.runtime
        )
        lo, hi = self._interval.lower_bound, self._interval.upper_bound
        mode = how

        def match_fn(lefts, rights):
            out = []
            matched_right = set()
            for li, (lk, lrow, lt) in enumerate(lefts):
                hit = False
                for ri, (rk, rrow, rt) in enumerate(rights):
                    if lt is None or rt is None:
                        continue
                    diff = rt - lt
                    if lo <= diff <= hi:
                        out.append((lk, lrow, rk, rrow))
                        matched_right.add(ri)
                        hit = True
                if not hit and mode in ("left", "outer"):
                    out.append((lk, lrow, None, None))
            if mode in ("right", "outer"):
                for ri, (rk, rrow, rt) in enumerate(rights):
                    if ri not in matched_right:
                        out.append((None, None, rk, rrow))
            return out

        node = TemporalJoinNode(
            ctx.scope,
            let.node,
            ret.node,
            lambda k, row: lkey(k, row),
            lambda k, row: rkey(k, row),
            lambda k, row: ltf([k], [row])[0],
            lambda k, row: rtf([k], [row])[0],
            match_fn,
            let.width,
            ret.width,
        )
        return EngineTable(node, let.width + ret.width)


def rebind(e, old_table, new_table):
    """Re-point ColumnReferences from `old_table` to the same-named columns
    of `new_table` (gated copies keep the schema)."""
    from pathway_tpu_torch.internals import thisclass
    from pathway_tpu_torch.internals.expression import ColumnReference

    def fn(x):
        if isinstance(x, ColumnReference) and x.table is old_table:
            return new_table[x.name]
        return None

    return thisclass.rewrite(expr_mod.smart_coerce(e), fn)


def _gate_input(table, time_expr, behavior):
    """delay/cutoff gating on one join input (reference: interval join
    behavior handling)."""
    if behavior is None:
        return table
    t = table._desugar(expr_mod.smart_coerce(time_expr))
    if behavior.delay is not None:
        table2 = table._buffer(t + behavior.delay, t)
        t = rebind(t, table, table2)
        table = table2
    if behavior.cutoff is not None:
        table2 = table._freeze(t + behavior.cutoff, t)
        t = rebind(t, table, table2)
        table = table2
        if not behavior.keep_results:
            table2 = table._forget(t + behavior.cutoff, t)
            table = table2
    return table


def interval_join(
    self_table,
    other_table,
    self_time,
    other_time,
    iv: Interval,
    *on,
    behavior: CommonBehavior | None = None,
    how: str = "inner",
) -> IntervalJoinResult:
    how_str = how.value if hasattr(how, "value") else str(how)
    gated_left = _gate_input(self_table, self_time, behavior)
    gated_right = _gate_input(other_table, other_time, behavior)
    if gated_left is not self_table:
        self_time = rebind(self_time, self_table, gated_left)
        on = tuple(rebind(c, self_table, gated_left) for c in on)
    if gated_right is not other_table:
        other_time = rebind(other_time, other_table, gated_right)
        on = tuple(rebind(c, other_table, gated_right) for c in on)
    return IntervalJoinResult(
        gated_left,
        gated_right,
        on,
        self_time=self_time,
        other_time=other_time,
        iv=iv,
        how=how_str,
        behavior=behavior,
        orig_left=self_table,
        orig_right=other_table,
    )


def interval_join_inner(*args, **kwargs):
    return interval_join(*args, how="inner", **kwargs)


def interval_join_left(*args, **kwargs):
    return interval_join(*args, how="left", **kwargs)


def interval_join_right(*args, **kwargs):
    return interval_join(*args, how="right", **kwargs)


def interval_join_outer(*args, **kwargs):
    return interval_join(*args, how="outer", **kwargs)
