"""pw.ordered (reference: python/pathway/stdlib/ordered/diff.py:123)."""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr_mod


def diff(table, timestamp, *values, instance=None):
    """Compute value differences vs the previous row in `timestamp` order
    (reference: ordered/diff.py — built on the sort prev/next operator).

    Returns a table with columns ``diff_<name>`` for each value column.
    """
    from pathway_tpu_torch.internals.expression import if_else

    ts = table._desugar(expr_mod.smart_coerce(timestamp))
    sorted_t = table.sort(ts, instance=instance)
    combined = table + sorted_t
    prev = combined.ix(combined.prev, optional=True)
    cols = {}
    for v in values:
        ref = table._desugar(expr_mod.smart_coerce(v))
        name = getattr(ref, "name", None) or "value"
        # first row per instance has no predecessor -> None, not Error
        cols[f"diff_{name}"] = if_else(
            combined.prev.is_not_none(), ref - prev[name], None
        )
    return combined.select(**cols)
