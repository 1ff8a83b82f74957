"""Windows: tumbling / sliding / session + windowby (reference:
python/pathway/stdlib/temporal/_window.py:70,260,515, windowby :865).

Window assignment produces `_pw_window` (instance, start, end),
`_pw_window_start`, `_pw_window_end`, `_pw_instance`, `_pw_key` columns and
groups on them; behaviors gate the assigned stream with the engine's
watermark operators (engine/time_gate.py). Session windows compute
connected components of the "mergeable" relation with sort + pw.iterate,
like the reference (:82 _compute_group_repr).
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import apply_with_type, if_else, make_tuple, unwrap
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
    common_behavior,
)


class Window(ABC):
    @abstractmethod
    def _apply(self, table, key, behavior, instance):
        ...


def _zero_interval_like(value):
    import datetime

    if isinstance(value, datetime.timedelta):
        return datetime.timedelta(0)
    return 0


@dataclasses.dataclass
class _SlidingWindow(Window):
    hop: Any
    duration: Any | None
    origin: Any | None
    ratio: int | None

    def _assign_fn(self) -> Callable:
        hop = self.hop
        duration = self.duration
        ratio = self.ratio
        origin_cfg = self.origin

        def assign_windows(instance, key):
            origin = (
                origin_cfg
                if origin_cfg is not None
                else _default_origin_for(key)
            )
            last_k = int((key - origin) // hop) + 1
            if ratio is not None:
                first_k = last_k - ratio - 1
            else:
                first_k = last_k - int(duration // hop) - 1
            first_k -= 1  # off-by-one safety at window boundaries
            out = []
            for k in range(first_k, last_k + 1):
                start = k * hop + origin
                end = (
                    (k + ratio) * hop + origin
                    if ratio is not None
                    else k * hop + origin + duration
                )
                if start <= key < end and (
                    origin_cfg is None or start >= origin_cfg
                ):
                    out.append((instance, start, end))
            return tuple(out)

        return assign_windows

    def _window_duration(self):
        return self.duration if self.duration is not None else self.ratio * self.hop

    def _apply(self, table, key, behavior, instance):
        assign = self._assign_fn()
        inst_expr = (
            expr_mod.smart_coerce(instance)
            if instance is not None
            else expr_mod.ColumnConstExpression(None)
        )
        target = table.with_columns(
            _pw_window=apply_with_type(assign, dt.ANY, inst_expr, key),
            _pw_key=key,
        )
        target = target.flatten(target["_pw_window"])
        target = target.with_columns(
            _pw_instance=expr_mod.GetExpression(target["_pw_window"], 0),
            _pw_window_start=expr_mod.GetExpression(target["_pw_window"], 1),
            _pw_window_end=expr_mod.GetExpression(target["_pw_window"], 2),
        )
        target = _apply_window_behavior(
            target, behavior, self._window_duration()
        )
        return target.groupby(
            target["_pw_window"],
            target["_pw_window_start"],
            target["_pw_window_end"],
            target["_pw_instance"],
        )


def _apply_window_behavior(target, behavior, window_duration):
    """Gate an assigned-window stream (reference: _window.py:372-420)."""
    if behavior is None:
        return target
    if isinstance(behavior, ExactlyOnceBehavior):
        shift = (
            behavior.shift
            if behavior.shift is not None
            else _zero_interval_like(window_duration)
        )
        behavior = common_behavior(window_duration + shift, shift, True)
    elif not isinstance(behavior, CommonBehavior):
        raise ValueError(f"behavior {behavior} unsupported for this window")

    if behavior.cutoff is not None:
        target = target._freeze(
            target["_pw_window_end"] + behavior.cutoff, target["_pw_key"]
        )
    if behavior.delay is not None:
        target = target._buffer(
            target["_pw_window_start"] + behavior.delay, target["_pw_key"]
        )
    if behavior.cutoff is not None and not behavior.keep_results:
        target = target._forget(
            target["_pw_window_end"] + behavior.cutoff, target["_pw_key"]
        )
    return target


@dataclasses.dataclass
class _SessionWindow(Window):
    predicate: Callable | None
    max_gap: Any | None

    def _merge_expr(self, cur, nxt):
        if self.predicate is not None:
            return apply_with_type(self.predicate, dt.BOOL, cur, nxt)
        return nxt - cur < self.max_gap

    def _compute_group_repr(self, table, key, instance):
        """Connected components of consecutive mergeable events: each event
        points at its successor if mergeable, else itself; iterate pointer
        jumping to the fixpoint (reference: _window.py:82-110)."""
        from pathway_tpu_torch.internals.iterate import iterate

        inst_expr = (
            expr_mod.smart_coerce(instance)
            if instance is not None
            else expr_mod.ColumnConstExpression(None)
        )
        target = table.select(key=key, instance=inst_expr)
        target = target + target.sort(key=target.key, instance=target.instance)
        nxt = target.ix(target.next, optional=True)
        target = target.with_columns(
            _pw_window=if_else(
                nxt.key.is_not_none(),
                if_else(
                    self._merge_expr(target.key, unwrap(nxt.key)),
                    unwrap(target.next),
                    target.id,
                ),
                target.id,
            ),
        )

        def merge_ccs(data):
            return data.with_columns(
                _pw_window=data.ix(data["_pw_window"])["_pw_window"]
            )

        return iterate(merge_ccs, data=target)._unsafe_promise_universe(table)

    def _apply(self, table, key, behavior, instance):
        group_repr = self._compute_group_repr(table, key, instance)
        bounds = group_repr.groupby(group_repr["_pw_window"]).reduce(
            _pw_window_start=_reducer_min(group_repr.key),
            _pw_window_end=_reducer_max(group_repr.key),
        )
        target = table.with_columns(
            _pw_key=key,
            _pw_window=group_repr["_pw_window"],
            _pw_instance=group_repr.instance,
        )
        b = bounds.ix_ref(target["_pw_window"])
        target = target.with_columns(
            _pw_window_start=b["_pw_window_start"],
            _pw_window_end=b["_pw_window_end"],
        )
        if behavior is not None:
            raise NotImplementedError(
                "behaviors are not supported for session windows "
                "(matches reference: _window.py session _apply)"
            )
        return target.groupby(
            target["_pw_window"],
            target["_pw_window_start"],
            target["_pw_window_end"],
            target["_pw_instance"],
        )


def _reducer_min(col):
    from pathway_tpu_torch.internals import reducers

    return reducers.min(col)


def _reducer_max(col):
    from pathway_tpu_torch.internals import reducers

    return reducers.max(col)


def _default_origin_for(key):
    import datetime

    if isinstance(key, datetime.datetime):
        return datetime.datetime(1970, 1, 1, tzinfo=key.tzinfo)
    return 0


@dataclasses.dataclass
class _IntervalsOverWindow(Window):
    """One window per row of `at`, spanning [at+lower, at+upper]
    (reference: _window.py:515 — built on interval_join)."""

    at: Any
    lower_bound: Any
    upper_bound: Any
    is_outer: bool

    def _apply(self, table, key, behavior, instance):
        from pathway_tpu_torch.stdlib.temporal._interval_join import interval, interval_join

        if behavior is not None and not isinstance(behavior, CommonBehavior):
            raise NotImplementedError(
                "intervals_over accepts CommonBehavior "
                "(pw.temporal.common_behavior) only"
            )
        at = self.at
        at_table = at.table
        if at_table is table:
            at_table = at_table.copy()
            at = at_table[at.name]
        inst_expr = (
            expr_mod.smart_coerce(instance)
            if instance is not None
            else expr_mod.ColumnConstExpression(None)
        )
        joined = interval_join(
            at_table,
            table,
            at,
            key,
            interval(self.lower_bound, self.upper_bound),
            how="left" if self.is_outer else "inner",
        ).select(
            _pw_window=at_table[at.name],
            # reference surface (_window.py:558): the probe location rides
            # into the reduce as _pw_window_location
            _pw_window_location=at_table[at.name],
            _pw_window_start=at_table[at.name] + self.lower_bound,
            _pw_window_end=at_table[at.name] + self.upper_bound,
            _pw_instance=inst_expr,
            _pw_key=key,
            *table,
        )
        if behavior is not None:
            # gate the assigned stream through the engine's buffer/freeze
            # time gates (reference accepts behaviors here, _window.py:
            # 522-530; semantics mirror the sliding-window behavior path).
            # Outer rows have no right-side key, so the event time for
            # lateness is the window location itself.
            joined = joined.with_columns(
                _pw_gate_t=expr_mod.coalesce(
                    joined["_pw_key"], joined["_pw_window"]
                )
            )
            if behavior.cutoff is not None:
                joined = joined._freeze(
                    joined["_pw_window_end"] + behavior.cutoff,
                    joined["_pw_gate_t"],
                )
            if behavior.delay is not None:
                joined = joined._buffer(
                    joined["_pw_window"] + behavior.delay,
                    joined["_pw_gate_t"],
                )
            if behavior.cutoff is not None and not behavior.keep_results:
                joined = joined._forget(
                    joined["_pw_window_end"] + behavior.cutoff,
                    joined["_pw_gate_t"],
                )
        return joined.groupby(
            joined["_pw_window"],
            joined["_pw_window_location"],
            joined["_pw_window_start"],
            joined["_pw_window_end"],
            joined["_pw_instance"],
            sort_by=joined["_pw_key"],
        )


# -- public constructors (reference: _window.py:595-865) -------------------


def session(*, predicate: Callable | None = None, max_gap=None) -> Window:
    """Events in one session iff consecutive events are mergeable
    (predicate(cur, next) or next - cur < max_gap)."""
    if (predicate is None) == (max_gap is None):
        raise ValueError(
            "session window requires exactly one of predicate or max_gap"
        )
    return _SessionWindow(predicate=predicate, max_gap=max_gap)


def sliding(hop, duration=None, ratio: int | None = None, origin=None) -> Window:
    """Windows of `duration` (or ratio*hop), starting every `hop`."""
    if (duration is None) == (ratio is None):
        raise ValueError(
            "sliding window requires exactly one of duration or ratio"
        )
    if (
        not _positive(hop)
        or (duration is not None and not _positive(duration))
        or (ratio is not None and ratio <= 0)
    ):
        raise ValueError("sliding window hop/duration/ratio must be positive")
    return _SlidingWindow(hop=hop, duration=duration, origin=origin, ratio=ratio)


def _positive(span) -> bool:
    """span > 0 for ints/floats and timedeltas alike."""
    import datetime

    zero = (
        datetime.timedelta(0) if isinstance(span, datetime.timedelta) else 0
    )
    return span > zero


def tumbling(duration, origin=None) -> Window:
    """Non-overlapping windows of length `duration`."""
    if not _positive(duration):
        raise ValueError("tumbling window duration must be positive")
    return _SlidingWindow(hop=duration, duration=duration, origin=origin, ratio=None)


def intervals_over(*, at, lower_bound, upper_bound, is_outer: bool = True) -> Window:
    """A window per row of `at` covering [at+lower_bound, at+upper_bound]
    (reference: _window.py:795)."""
    return _IntervalsOverWindow(
        at=at, lower_bound=lower_bound, upper_bound=upper_bound, is_outer=is_outer
    )


def windowby(table, time_expr, *, window: Window, behavior=None, instance=None):
    """Group `table` by temporal windows of `time_expr` (reference:
    _window.py:865). Returns a GroupedTable; reduce() with
    pw.this._pw_window_start / _pw_window_end for window bounds."""
    time_e = table._desugar(expr_mod.smart_coerce(time_expr))
    inst_e = (
        table._desugar(expr_mod.smart_coerce(instance))
        if instance is not None
        else None
    )
    return window._apply(table, time_e, behavior, inst_e)
