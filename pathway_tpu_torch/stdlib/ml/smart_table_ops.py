"""Fuzzy joins (reference:
python/pathway/stdlib/ml/smart_table_ops/_fuzzy_join.py:470 —
fuzzy_match_tables :106, smart_fuzzy_match :199, fuzzy_self_match :249,
fuzzy_match :265).

Pure-dataflow token-overlap matching: rows become bags of lowercase word
features over their text columns; a pair's score is the sum of idf-style
weights (1/log(1+global count)) of shared features; each left row keeps
its best-scoring right match (mutual-best when requested)."""

from __future__ import annotations

import math
import re
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import apply_with_type, make_tuple

_WORD_RE = re.compile(r"[A-Za-z0-9]+")


def _features(row_vals) -> tuple:
    feats = []
    for v in row_vals:
        for w in _WORD_RE.findall(str(v).lower()):
            feats.append(w)
    return tuple(sorted(set(feats)))


def fuzzy_match_tables(
    left,
    right,
    *,
    by_hand_match=None,
    left_projection: dict | None = None,
    right_projection: dict | None = None,
    _exclude_same_id: bool = False,
):
    """-> table(left_id, right_id, weight): best right match per left row
    (reference: _fuzzy_join.py:106)."""
    import pathway_tpu_torch as pw

    if by_hand_match is not None:
        raise NotImplementedError(
            "by_hand_match is not supported yet; match tables directly"
        )
    if left_projection:
        left = left[[c for c in left_projection]]
    if right_projection:
        right = right[[c for c in right_projection]]

    def featurize(table):
        cols = table.column_names()
        t = table.select(
            feats=apply_with_type(
                lambda *vals: _features(vals), dt.ANY,
                *[table[c] for c in cols],
            )
        )
        t = t.with_columns(orig_id=t.id)
        return t.flatten(t.feats)

    lf = featurize(left)
    rf = featurize(right)

    # global idf-ish weights over both sides
    all_feats = pw.Table.concat_reindex(
        lf.select(f=lf.feats), rf.select(f=rf.feats)
    )
    weights = all_feats.groupby(all_feats.f).reduce(
        all_feats.f, cnt=pw.reducers.count()
    )

    pairs = lf.join(rf, lf.feats == rf.feats).select(
        left_id=lf.orig_id, right_id=rf.orig_id, f=lf.feats
    )
    if _exclude_same_id:
        pairs = pairs.filter(pairs.left_id != pairs.right_id)
    pairs = pairs.join(weights, pairs.f == weights.f).select(
        pairs.left_id,
        pairs.right_id,
        w=apply_with_type(
            lambda c: 1.0 / math.log(1.0 + c) if c > 1 else 2.0,
            dt.FLOAT,
            weights.cnt,
        ),
    )
    scored = pairs.groupby(pairs.left_id, pairs.right_id).reduce(
        pairs.left_id, pairs.right_id, weight=pw.reducers.sum(pairs.w)
    )
    best = scored.groupby(scored.left_id).reduce(
        scored.left_id,
        top=pw.reducers.max(
            make_tuple(scored.weight, scored.right_id)
        ),
    )
    return best.select(
        left_id=best.left_id,
        right_id=best.top.get(1),
        weight=best.top.get(0),
    )


def fuzzy_self_match(table, **kwargs):
    """Best non-identical match within one table (reference: :249)."""
    return fuzzy_match_tables(
        table, table.copy(), _exclude_same_id=True, **kwargs
    )


def fuzzy_match(left_col, right_col, **kwargs):
    """Column-level entry point (reference: :265)."""
    left = left_col.table.select(v=left_col)
    right = right_col.table.select(v=right_col)
    return fuzzy_match_tables(left, right, **kwargs)


def smart_fuzzy_match(left_col, right_col, **kwargs):
    """reference: :199 — fuzzy_match with automatic feature weighting."""
    return fuzzy_match(left_col, right_col, **kwargs)
