"""Temporal behaviors (reference:
python/pathway/stdlib/temporal/temporal_behavior.py — CommonBehavior
delay/cutoff/keep_results, ExactlyOnceBehavior)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


class Behavior:
    pass


@dataclass
class CommonBehavior(Behavior):
    delay: Any | None
    cutoff: Any | None
    keep_results: bool


def common_behavior(
    delay=None, cutoff=None, keep_results: bool = True
) -> CommonBehavior:
    """delay: postpone outputs; cutoff: ignore entries older than watermark
    minus cutoff (and free state); keep_results: whether results older than
    cutoff stay in the output (reference docstring, temporal_behavior.py:29)."""
    assert not (cutoff is None and not keep_results)
    return CommonBehavior(delay, cutoff, keep_results)


@dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Any | None


def exactly_once_behavior(shift=None) -> ExactlyOnceBehavior:
    """Each non-empty window emits exactly one output, at window end+shift
    (reference: temporal_behavior.py:83)."""
    return ExactlyOnceBehavior(shift)


def apply_temporal_behavior(table, behavior: CommonBehavior | None):
    """Gate a stream carrying a `_pw_time` column (reference:
    temporal_behavior.py:101)."""
    if behavior is not None:
        t = table["_pw_time"]
        if behavior.delay is not None:
            table = table._buffer(t + behavior.delay, t)
            t = table["_pw_time"]
        if behavior.cutoff is not None:
            threshold = t + behavior.cutoff
            table = table._freeze(threshold, t)
            if not behavior.keep_results:
                t = table["_pw_time"]
                table = table._forget(t + behavior.cutoff, t)
    return table
