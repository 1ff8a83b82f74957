"""Global error-log table + error helpers (reference:
parse_graph.py:183 add_error_log, Graph::error_log graph.rs:983,
remove_errors_from_table graph.rs:1005)."""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ERROR
from pathway_tpu_torch.internals.expression import apply_with_type
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

def global_error_log() -> Table:
    """Table(message, origin) of per-row data errors raised by UDFs while
    the pipeline ran; rows that errored carry Error poison values."""
    cached = G.cache.get("global_error_log")
    if cached is not None:
        return cached
    out = Table(
        schema_from_types(message=dt.STR, origin=dt.STR), Universe()
    )

    def lower(ctx):
        from pathway_tpu_torch.engine import nodes as N

        node = N.SourceNode(ctx.scope, append_only=True)
        ctx.runtime.error_log_node = node
        from pathway_tpu_torch.engine.scope import EngineTable

        ctx.set_engine_table(out, EngineTable(node, 2))

    G.add_operator([], [out], lower, "global_error_log")
    G.cache["global_error_log"] = out
    return out


def remove_errors_from_table(table: Table) -> Table:
    """Drop rows containing Error poison values (reference:
    graph.rs:1005)."""
    cols = [table[c] for c in table.column_names()]

    def row_ok(*vals) -> bool:
        return not any(v is ERROR for v in vals)

    # apply short-circuits Error args to an Error mask, which the filter
    # drops — exactly the remove-errors semantics; row_ok keeps the rest
    return table.filter(apply_with_type(row_ok, dt.BOOL, *cols))