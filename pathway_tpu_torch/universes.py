"""pw.universes — universe promises (reference:
python/pathway/internals/universes.py: promise_are_pairwise_disjoint,
promise_is_subset_of, promise_are_equal)."""

from __future__ import annotations

from pathway_tpu_torch.internals.universe import SOLVER


def promise_is_subset_of(subset, superset) -> None:
    SOLVER.register_subset(subset._universe, superset._universe)


def promise_are_equal(*tables) -> None:
    for t in tables[1:]:
        SOLVER.register_as_equal(tables[0]._universe, t._universe)


def promise_are_pairwise_disjoint(*tables) -> None:
    """Register pairwise disjointness with the universe solver (reference:
    universes.py — the solver constrains concat validity). The engine also
    VERIFIES the promise at runtime: concat raises on id collisions, so a
    wrong promise surfaces instead of silently corrupting results."""
    import itertools

    for a, b in itertools.combinations(tables, 2):
        SOLVER.register_disjoint(a._universe, b._universe)
