"""As-of join (reference: python/pathway/stdlib/temporal/_asof_join.py,
1,107 LoC): for each left row, match the temporally closest right row
(backward = latest right with t_r <= t_l, forward = earliest with
t_r >= t_l, nearest = closer of the two)."""

from __future__ import annotations

import enum

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.stdlib.temporal._interval_join import IntervalJoinResult, rebind
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import CommonBehavior


class Direction(enum.Enum):
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


class AsofJoinResult(IntervalJoinResult):
    def __init__(
        self, left, right, on, *, self_time, other_time, direction, how,
        defaults=None, orig_left=None, orig_right=None,
    ):
        super().__init__(
            left, right, on,
            self_time=self_time, other_time=other_time,
            iv=None, how=how,
            orig_left=orig_left, orig_right=orig_right,
        )
        self._direction = direction
        self._defaults = defaults or {}

    def _engine_join(
        self, ctx, let, ret, lkey, rkey, how, *,
        id_from_left, id_from_right, left_id_fn, right_id_fn,
        lkey_batch=None, rkey_batch=None, nb_lkidx=None, nb_rkidx=None,
        nb_blame=(), nb_lblame=None, nb_rblame=None,
    ):
        from pathway_tpu_torch.engine.expression import compile_expression
        from pathway_tpu_torch.engine.scope import EngineTable
        from pathway_tpu_torch.engine.temporal_join import TemporalJoinNode

        left, right = self._left, self._right

        def side_resolver(table):
            def resolver(ref):
                if ref.name == "id":
                    return "id"
                return table._column_names.index(ref.name)

            return resolver

        ltf = compile_expression(self._self_time, side_resolver(left), ctx.runtime)
        rtf = compile_expression(self._other_time, side_resolver(right), ctx.runtime)
        direction = self._direction
        mode = how

        def pick(lt, rights):
            best = None
            for rk, rrow, rt in rights:
                if rt is None:
                    continue
                if direction is Direction.BACKWARD and rt <= lt:
                    if best is None or rt > best[2] or (
                        rt == best[2] and repr(rk) > repr(best[0])
                    ):
                        best = (rk, rrow, rt)
                elif direction is Direction.FORWARD and rt >= lt:
                    if best is None or rt < best[2] or (
                        rt == best[2] and repr(rk) < repr(best[0])
                    ):
                        best = (rk, rrow, rt)
                elif direction is Direction.NEAREST:
                    d = abs(rt - lt)
                    if best is None or d < abs(best[2] - lt):
                        best = (rk, rrow, rt)
            return best

        # defaults={right_col: value} fills padded right columns on
        # unmatched left rows (reference: asof_join defaults param)
        default_row = None
        if self._defaults:
            filled = [None] * len(right._column_names)
            for col, value in self._defaults.items():
                name = col if isinstance(col, str) else col.name
                filled[right._column_names.index(name)] = value
            default_row = tuple(filled)

        def match_fn(lefts, rights):
            out = []
            matched_right = set()
            for lk, lrow, lt in lefts:
                best = pick(lt, rights) if lt is not None else None
                if best is not None:
                    out.append((lk, lrow, best[0], best[1]))
                    matched_right.add(id(best[1]))
                elif mode in ("left", "outer"):
                    out.append((lk, lrow, None, default_row))
            if mode in ("right", "outer"):
                for rk, rrow, rt in rights:
                    if id(rrow) not in matched_right:
                        out.append((None, None, rk, rrow))
            return out

        node = TemporalJoinNode(
            ctx.scope,
            let.node,
            ret.node,
            lkey,
            rkey,
            lambda k, row: ltf([k], [row])[0],
            lambda k, row: rtf([k], [row])[0],
            match_fn,
            let.width,
            ret.width,
        )
        return EngineTable(node, let.width + ret.width)


def asof_join(
    self_table,
    other_table,
    self_time,
    other_time,
    *on,
    how: str = "left",
    defaults: dict | None = None,
    direction: Direction = Direction.BACKWARD,
    behavior: CommonBehavior | None = None,
) -> AsofJoinResult:
    from pathway_tpu_torch.stdlib.temporal._interval_join import _gate_input, rebind

    how_str = how.value if hasattr(how, "value") else str(how)
    gated_left = _gate_input(self_table, self_time, behavior)
    gated_right = _gate_input(other_table, other_time, behavior)
    if gated_left is not self_table:
        self_time = rebind(self_time, self_table, gated_left)
        on = tuple(rebind(c, self_table, gated_left) for c in on)
    if gated_right is not other_table:
        other_time = rebind(other_time, other_table, gated_right)
        on = tuple(rebind(c, other_table, gated_right) for c in on)
    return AsofJoinResult(
        gated_left,
        gated_right,
        on,
        self_time=self_time,
        other_time=other_time,
        direction=direction,
        how=how_str,
        defaults=defaults,
        orig_left=self_table,
        orig_right=other_table,
    )


def asof_join_left(*args, **kwargs):
    return asof_join(*args, how="left", **kwargs)


def asof_join_right(*args, **kwargs):
    return asof_join(*args, how="right", **kwargs)


def asof_join_outer(*args, **kwargs):
    return asof_join(*args, how="outer", **kwargs)
