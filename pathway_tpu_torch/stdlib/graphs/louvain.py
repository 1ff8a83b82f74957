"""One level of Louvain community detection (reference:
python/pathway/stdlib/graphs/louvain_communities/impl.py, 385 LoC).

Single-level greedy modularity pass: each vertex adopts the community that
the plurality of its neighbors hold, iterated to a fixed point — the local
move phase of Louvain, the part the reference showcases as incremental
dataflow."""

from __future__ import annotations


def louvain_level(edges):
    """edges: columns ``u``, ``v`` (undirected; both directions expected or
    they are added here). Returns table with ``v`` -> ``community``."""
    import pathway_tpu_torch as pw

    rev = edges.select(u=edges.v, v=edges.u)
    sym = pw.Table.concat_reindex(edges, rev)
    verts_u = sym.select(v=sym.u)
    all_verts = verts_u.groupby(verts_u.v).reduce(verts_u.v)
    state = all_verts.select(pw.this.v, community=pw.this.v)

    def move(state):
        neigh = state.join(sym, state.v == sym.u).select(
            v=sym.v, community=state.community
        )
        votes = neigh.groupby(neigh.v, neigh.community).reduce(
            neigh.v, neigh.community, weight=pw.reducers.count()
        )
        # plurality community per vertex; deterministic tie-break on the
        # community id keeps the fixpoint stable
        best = votes.groupby(votes.v).reduce(
            votes.v,
            top=pw.reducers.max(
                pw.make_tuple(votes.weight, votes.community)
            ),
        )
        return best.select(pw.this.v, community=pw.this.top.get(1))

    return pw.iterate(move, iteration_limit=20, state=state)
