"""Argmin/argmax row filters (reference:
python/pathway/stdlib/utils/filtering.py)."""

from __future__ import annotations


def argmax_rows(table, *on, what):
    """Keep, per group defined by `on`, the row maximizing `what`."""
    import pathway_tpu_torch as pw

    best = table.groupby(*on).reduce(argmax_id=pw.reducers.argmax(what))
    return table._having(best.argmax_id)


def argmin_rows(table, *on, what):
    import pathway_tpu_torch as pw

    best = table.groupby(*on).reduce(argmin_id=pw.reducers.argmin(what))
    return table._having(best.argmin_id)
