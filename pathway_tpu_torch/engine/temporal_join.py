"""Temporal join operators: interval/asof (maintained) and asof-now
(one-shot).

Reference: python/pathway/stdlib/temporal/_interval_join.py (engine side:
buffers + joins over time-bucketed keys), _asof_join.py (prev_next-based),
_asof_now_join.py (forget-immediately plumbing). Here both maintained
variants share one node using the affected-group rediff strategy: per
equality-key group the node re-derives all matches with a pluggable
`match_fn`, so retractions and late data stay exactly correct.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.nodes import GroupDiffNode, Node
from pathway_tpu_torch.engine.stream import Delta, Key, MultisetState, Row, consolidate
from pathway_tpu_torch.internals.api import ref_scalar


class TemporalJoinNode(GroupDiffNode):
    """match_fn(lefts, rights) -> list of (lk, lrow, rk|None, rrow|None);
    lefts/rights are [(key, row, time)] with multiplicities expanded.
    Unmatched-side padding for left/right/outer modes is the match_fn's
    responsibility (it sees the mode)."""

    STATE_ATTRS = ("left", "right")

    def __init__(
        self,
        scope,
        left_node,
        right_node,
        left_key_fn,
        right_key_fn,
        left_time_fn,
        right_time_fn,
        match_fn,
        left_width: int,
        right_width: int,
    ):
        super().__init__(scope, [left_node, right_node])
        self.left_key_fn = left_key_fn
        self.right_key_fn = right_key_fn
        self.left_time_fn = left_time_fn
        self.right_time_fn = right_time_fn
        self.match_fn = match_fn
        self.left = MultisetState()
        self.right = MultisetState()
        self.left_width = left_width
        self.right_width = right_width

    def group_of(self, port, key, row):
        return (
            self.left_key_fn(key, row)
            if port == 0
            else self.right_key_fn(key, row)
        )

    def apply_updates(self, batches):
        for k, row, d in batches[0]:
            self.left.apply_one(self.left_key_fn(k, row), (k, row), d)
        for k, row, d in batches[1]:
            self.right.apply_one(self.right_key_fn(k, row), (k, row), d)

    def output_of_group(self, jk) -> list[Delta]:
        lefts = []
        for (lk, lrow), c in self.left.get(jk):
            t = self.left_time_fn(lk, lrow)
            lefts.extend([(lk, lrow, t)] * max(c, 0))
        rights = []
        for (rk, rrow), c in self.right.get(jk):
            t = self.right_time_fn(rk, rrow)
            rights.extend([(rk, rrow, t)] * max(c, 0))
        out = []
        for lk, lrow, rk, rrow in self.match_fn(lefts, rights):
            lpart = lrow if lrow is not None else (None,) * self.left_width
            rpart = rrow if rrow is not None else (None,) * self.right_width
            out.append((ref_scalar(lk, rk), lpart + rpart, 1))
        return out


class AsofNowJoinNode(Node):
    """One-shot left join: a left insertion is answered against the CURRENT
    right state and never revised; left retractions replay the memoized
    answer (reference: _asof_now_join.py semantics)."""

    STATE_ATTRS = ("right", "answers")

    def __init__(
        self,
        scope,
        left_node,
        right_node,
        left_key_fn,
        right_key_fn,
        mode: str,
        left_width: int,
        right_width: int,
        id_from_left: bool = True,
    ):
        super().__init__(scope, [left_node, right_node])
        self.left_key_fn = left_key_fn
        self.right_key_fn = right_key_fn
        self.mode = mode
        self.left_width = left_width
        self.right_width = right_width
        self.id_from_left = id_from_left
        self.right = MultisetState()
        # key -> [unit_deltas (per one left copy), live_count]
        self.answers: dict[Key, list] = {}

    def process(self, time, batches):
        left_deltas = consolidate(batches[0])
        # right updates apply FIRST: left rows at time t see right as-of t
        for k, row, d in consolidate(batches[1]):
            self.right.apply_one(self.right_key_fn(k, row), (k, row), d)
        out: list[Delta] = []
        # retractions first: an update arriving as (+new, -old) in one batch
        # must not have its fresh answer cancelled by the old row's memo
        # replay (same ordering rule as external_index.py)
        for lk, lrow, d in left_deltas:
            if d < 0:
                memo = self.answers.get(lk)
                if memo is not None:
                    unit, count = memo
                    n = min(-d, count)
                    out.extend((k, r, -dd * n) for k, r, dd in unit)
                    memo[1] -= n
                    if memo[1] <= 0:
                        del self.answers[lk]
        for lk, lrow, d in left_deltas:
            if d < 0:
                continue
            jk = self.left_key_fn(lk, lrow)
            rrows = self.right.get(jk)
            unit: list[Delta] = []
            if rrows:
                for (rk, rrow), c in rrows:
                    key = lk if self.id_from_left else ref_scalar(lk, rk)
                    unit.append((key, lrow + rrow, max(c, 0)))
            elif self.mode in ("left", "outer"):
                pad = (None,) * self.right_width
                key = lk if self.id_from_left else ref_scalar(lk, None)
                unit.append((key, lrow + pad, 1))
            self.answers[lk] = [unit, d]
            out.extend((k, r, dd * d) for k, r, dd in unit)
        return consolidate(out)
