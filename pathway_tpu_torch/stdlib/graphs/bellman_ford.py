"""Bellman-Ford shortest paths via pw.iterate (reference:
python/pathway/stdlib/graphs/bellman_ford/impl.py)."""

from __future__ import annotations

import math


def bellman_ford(vertices, edges, *, source_filter=None):
    """vertices: table with column ``is_source`` (bool) unless
    `source_filter` given; edges: columns ``u``, ``v``, ``dist``.
    Returns vertices keyed like input with ``dist_from_source``."""
    import pathway_tpu_torch as pw

    if source_filter is not None:
        vertices = vertices.with_columns(is_source=source_filter)
    state = vertices.select(
        v=vertices.id,
        dist_from_source=pw.if_else(
            vertices.is_source, 0.0, math.inf
        ),
    )

    def relax(state):
        relaxed = state.join(edges, state.v == edges.u).select(
            v=edges.v,
            dist_from_source=state.dist_from_source + edges.dist,
        )
        candidates = pw.Table.concat_reindex(state, relaxed)
        return candidates.groupby(candidates.v).reduce(
            candidates.v,
            dist_from_source=pw.reducers.min(candidates.dist_from_source),
        )

    return pw.iterate(relax, state=state)
