"""PageRank via pw.iterate (reference:
python/pathway/stdlib/graphs/pagerank.py)."""

from __future__ import annotations


def pagerank(edges, steps: int = 5, damping: float = 0.85):
    """edges: columns ``u``, ``v`` (pointers or hashable vertex ids).
    Returns table keyed per vertex with float ``rank``."""
    import pathway_tpu_torch as pw

    degrees = edges.groupby(edges.u).reduce(
        v=edges.u, degree=pw.reducers.count()
    )
    verts_u = edges.select(v=edges.u)
    verts_v = edges.select(v=edges.v)
    all_verts = pw.Table.concat_reindex(verts_u, verts_v)
    vertices = all_verts.groupby(all_verts.v).reduce(all_verts.v)
    state = vertices.select(pw.this.v, rank=1.0)

    def step(state):
        with_deg = state.join(
            degrees, state.v == degrees.v
        ).select(v=state.v, rank=state.rank, degree=degrees.degree)
        flowing = with_deg.join(edges, with_deg.v == edges.u).select(
            v=edges.v,
            flow=with_deg.rank * damping / with_deg.degree,
        )
        inflow = flowing.groupby(flowing.v).reduce(
            flowing.v, total=pw.reducers.sum(flowing.flow)
        )
        return state.join(
            inflow, state.v == inflow.v, how="left", id=state.id
        ).select(
            v=state.v,
            rank=pw.coalesce(inflow.total, 0.0) + (1.0 - damping),
        )

    result = state
    for _ in range(steps):
        result = step(result)
    return result
