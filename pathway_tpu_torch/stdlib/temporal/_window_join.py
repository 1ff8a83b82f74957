"""Window join (reference:
python/pathway/stdlib/temporal/_window_join.py, 1,217 LoC): joins rows of
two tables whose times fall into the same window. Both sides get window
assignments (tumbling/sliding via the shared assignment function; session
via the concat trick), then a regular equality join on (window, *on)."""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import make_tuple
from pathway_tpu_torch.internals.joins import JoinResult
from pathway_tpu_torch.stdlib.temporal._window import (
    Window,
    _SessionWindow,
    _SlidingWindow,
)
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import apply_with_type


def _assign_side(table, time_expr, window: _SlidingWindow, name: str):
    assign = window._assign_fn()
    time_e = table._desugar(expr_mod.smart_coerce(time_expr))
    target = table.with_columns(
        _pw_window=apply_with_type(
            lambda key: assign(None, key), dt.ANY, time_e
        ),
    )
    target = target.flatten(target["_pw_window"])
    return target


class WindowJoinResult(JoinResult):
    """Remaps user references on the ORIGINAL tables onto the
    window-assigned copies (reference: WindowJoinResult, _window.py:149)."""

    def __init__(self, left, right, on, *, how, orig_left, orig_right):
        super().__init__(left, right, on, how=how)
        self._orig_left = orig_left
        self._orig_right = orig_right

    def select(self, *args, **kwargs):
        from pathway_tpu_torch.stdlib.temporal._interval_join import rebind

        def fix(e):
            e = rebind(e, self._orig_left, self._left)
            return rebind(e, self._orig_right, self._right)

        args = tuple(
            fix(a) if hasattr(a, "_dtype") else a for a in args
        )
        kwargs = {k: fix(expr_mod.smart_coerce(v)) for k, v in kwargs.items()}
        return super().select(*args, **kwargs)


def _session_cond_sides(on, self_table, other_table):
    """Split `on` equality conditions into (left_refs, right_refs) — the
    per-side instance keys sessions are computed within."""
    lrefs, rrefs = [], []
    for cond in on:
        if (
            not isinstance(cond, expr_mod.ColumnBinaryOpExpression)
            or cond._symbol != "=="
        ):
            raise ValueError(
                "session window_join accepts only col == col conditions"
            )
        a, b = cond._left, cond._right
        if (
            getattr(a, "table", None) is other_table
            or getattr(b, "table", None) is self_table
        ):
            a, b = b, a
        # a condition over a derived/aliased table would otherwise be
        # silently assigned to the left side and produce wrong session
        # instance keys — reject it instead
        if (
            getattr(a, "table", None) is not self_table
            or getattr(b, "table", None) is not other_table
        ):
            raise ValueError(
                "session window_join conditions must reference the joined "
                "tables directly (left side == right side); got a condition "
                "over a derived or aliased table"
            )
        lrefs.append(a)
        rrefs.append(b)
    return lrefs, rrefs


def _assign_session_sides(self_table, other_table, self_time, other_time,
                          window: _SessionWindow, on):
    """Session assignment over the UNION of both sides' times (reference
    semantics, _window_join.py:174-179: sessions are built by
    concatenating both tables' time columns per join-key group; every
    left record in a session joins every right record in it). Each side
    gets a `_pw_window` column holding its session's representative."""
    lrefs, rrefs = _session_cond_sides(on, self_table, other_table)
    lt = self_table._desugar(expr_mod.smart_coerce(self_time))
    rt = other_table._desugar(expr_mod.smart_coerce(other_time))
    l_inst = make_tuple(*lrefs) if lrefs else expr_mod.ColumnConstExpression(None)
    r_inst = make_tuple(*rrefs) if rrefs else expr_mod.ColumnConstExpression(None)
    lu = self_table.select(
        _pw_t=lt, _pw_inst=l_inst, _pw_orig=self_table.id, _pw_side=0
    )
    ru = other_table.select(
        _pw_t=rt, _pw_inst=r_inst, _pw_orig=other_table.id, _pw_side=1
    )
    union = lu.concat_reindex(ru)
    group_repr = window._compute_group_repr(
        union, union["_pw_t"], union["_pw_inst"]
    )
    assigned = union.with_columns(_pw_window=group_repr["_pw_window"])

    def side(table, code):
        part = assigned.filter(assigned["_pw_side"] == code)
        keyed = part.with_id(part["_pw_orig"]).with_universe_of(table)
        return table.with_columns(_pw_window=keyed["_pw_window"])

    return side(self_table, 0), side(other_table, 1)


def window_join(
    self_table, other_table, self_time, other_time, window: Window, *on,
    how: str = "inner",
) -> JoinResult:
    how_str = how.value if hasattr(how, "value") else str(how)
    from pathway_tpu_torch.stdlib.temporal._interval_join import rebind

    if isinstance(window, _SessionWindow):
        left, right = _assign_session_sides(
            self_table, other_table, self_time, other_time, window, on
        )
        # the on-keys are folded into the session instance: same session
        # implies same keys, so the join condition is the window alone
        conds = [left["_pw_window"] == right["_pw_window"]]
        return WindowJoinResult(
            left, right, conds, how=how_str,
            orig_left=self_table, orig_right=other_table,
        )
    if not isinstance(window, _SlidingWindow):
        raise NotImplementedError(
            "window_join supports tumbling/sliding/session windows"
        )
    left = _assign_side(self_table, self_time, window, "left")
    right = _assign_side(other_table, other_time, window, "right")
    conds = [left["_pw_window"] == right["_pw_window"]]
    for cond in on:
        cond = rebind(cond, self_table, left)
        cond = rebind(cond, other_table, right)
        conds.append(cond)
    return WindowJoinResult(
        left, right, conds, how=how_str,
        orig_left=self_table, orig_right=other_table,
    )


def window_join_inner(*args, **kwargs):
    return window_join(*args, how="inner", **kwargs)


def window_join_left(*args, **kwargs):
    return window_join(*args, how="left", **kwargs)


def window_join_right(*args, **kwargs):
    return window_join(*args, how="right", **kwargs)


def window_join_outer(*args, **kwargs):
    return window_join(*args, how="outer", **kwargs)
