"""As-of-now join (reference:
python/pathway/stdlib/temporal/_asof_now_join.py:403): each left row is
joined against the CURRENT right-side state at its arrival time; the answer
is never revised when the right side later changes. Left retractions replay
the memoized answer (the reference builds this from _forget_immediately +
filter-out-forgetting; here it is a dedicated engine node)."""

from __future__ import annotations

from pathway_tpu_torch.internals.joins import JoinResult


class AsofNowJoinResult(JoinResult):
    def _engine_join(
        self, ctx, let, ret, lkey, rkey, how, *,
        id_from_left, id_from_right, left_id_fn, right_id_fn,
        lkey_batch=None, rkey_batch=None, nb_lkidx=None, nb_rkidx=None,
        nb_blame=(), nb_lblame=None, nb_rblame=None,
    ):
        from pathway_tpu_torch.engine.scope import EngineTable
        from pathway_tpu_torch.engine.temporal_join import AsofNowJoinNode

        node = AsofNowJoinNode(
            ctx.scope,
            let.node,
            ret.node,
            lkey,
            rkey,
            how,
            let.width,
            ret.width,
            id_from_left=id_from_left,
        )
        return EngineTable(node, let.width + ret.width)


def asof_now_join(
    self_table, other_table, *on, how: str = "left", id=None
) -> AsofNowJoinResult:
    how_str = how.value if hasattr(how, "value") else str(how)
    if how_str not in ("inner", "left"):
        raise ValueError("asof_now_join supports only inner/left modes")
    return AsofNowJoinResult(self_table, other_table, on, id=id, how=how_str)


def asof_now_join_inner(self_table, other_table, *on, id=None):
    return asof_now_join(self_table, other_table, *on, how="inner", id=id)


def asof_now_join_left(self_table, other_table, *on, id=None):
    return asof_now_join(self_table, other_table, *on, how="left", id=id)
