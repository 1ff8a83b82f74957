"""Universes: key-set identity of tables (reference:
python/pathway/internals/universe.py + universe_solver.py).

A Universe represents "the set of row ids" of a family of tables.  The
solver tracks equality (union-find) and subset promises so the DSL can
validate operations like update_cells / with_universe_of / concat at
declaration time.
"""

from __future__ import annotations

import itertools

_counter = itertools.count()


class Universe:
    __slots__ = ("uid",)

    def __init__(self):
        self.uid = next(_counter)

    def __repr__(self):
        return f"Universe#{self.uid}"

    def subset(self) -> "Universe":
        u = Universe()
        SOLVER.register_subset(u, self)
        return u

    def superset(self) -> "Universe":
        u = Universe()
        SOLVER.register_subset(self, u)
        return u


class UniverseSolver:
    def __init__(self):
        self.parent: dict[int, int] = {}
        self.subsets: set[tuple[int, int]] = set()  # (sub, sup) roots
        self.disjoint: set[frozenset[int]] = set()  # promised-disjoint roots

    def _find(self, uid: int) -> int:
        root = uid
        while self.parent.get(root, root) != root:
            root = self.parent[root]
        while self.parent.get(uid, uid) != uid:
            self.parent[uid], uid = root, self.parent[uid]
        return root

    def register_as_equal(self, a: Universe, b: Universe) -> None:
        ra, rb = self._find(a.uid), self._find(b.uid)
        if ra != rb:
            self.parent[ra] = rb

    def register_subset(self, sub: Universe, sup: Universe) -> None:
        self.subsets.add((self._find(sub.uid), self._find(sup.uid)))

    def query_are_equal(self, a: Universe, b: Universe) -> bool:
        return self._find(a.uid) == self._find(b.uid)

    def register_disjoint(self, a: Universe, b: Universe) -> None:
        ra, rb = self._find(a.uid), self._find(b.uid)
        if ra == rb:
            raise ValueError(
                "cannot promise disjointness of equal universes"
            )
        self.disjoint.add(frozenset((ra, rb)))

    def _supersets(self, uid: int) -> set[int]:
        """All registered-superset roots reachable from uid (incl. itself)."""
        root = self._find(uid)
        seen = {root}
        frontier = [root]
        while frontier:
            cur = frontier.pop()
            for a, b in self.subsets:
                if self._find(a) == cur:
                    nb = self._find(b)
                    if nb not in seen:
                        seen.add(nb)
                        frontier.append(nb)
        return seen

    def query_are_disjoint(self, a: Universe, b: Universe) -> bool:
        """True iff some registered-disjoint pair covers (a, b) — i.e. a
        and b are (subsets of) universes promised pairwise disjoint.
        Disjointness is additionally VERIFIED at runtime: concat raises on
        actual id collisions, so this query is advisory (declaration-time
        diagnostics), not the safety mechanism."""
        ra, rb = self._find(a.uid), self._find(b.uid)
        if ra == rb:
            return False
        sups_a = self._supersets(ra)
        sups_b = self._supersets(rb)
        for pair in self.disjoint:
            pa, pb = tuple(pair)
            if (pa in sups_a and pb in sups_b) or (
                pb in sups_a and pa in sups_b
            ):
                return True
        return False

    def query_is_subset(self, sub: Universe, sup: Universe) -> bool:
        rs, rp = self._find(sub.uid), self._find(sup.uid)
        if rs == rp:
            return True
        # BFS over registered subset edges
        seen = {rs}
        frontier = [rs]
        while frontier:
            cur = frontier.pop()
            for a, b in self.subsets:
                if self._find(a) == cur:
                    nb = self._find(b)
                    if nb == rp:
                        return True
                    if nb not in seen:
                        seen.add(nb)
                        frontier.append(nb)
        return False

    def get_intersection(self, *universes: Universe) -> Universe:
        u = Universe()
        for x in universes:
            self.register_subset(u, x)
        return u

    def get_union(self, *universes: Universe) -> Universe:
        u = Universe()
        for x in universes:
            self.register_subset(x, u)
        return u

    def get_difference(self, a: Universe, b: Universe) -> Universe:
        u = Universe()
        self.register_subset(u, a)
        return u


SOLVER = UniverseSolver()
