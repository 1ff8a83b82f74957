"""Hybrid retrieval via Reciprocal Rank Fusion (reference:
python/pathway/stdlib/indexing/hybrid_index.py:14 — RRF over N sub-indexes,
k=60 constant).

Each sub-index answers independently; replies are fused per query:
score(doc) = sum over indexes of 1 / (k + rank_in_that_index).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply_with_type,
)
from pathway_tpu_torch.stdlib.indexing.colnames import _INDEX_REPLY
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, InnerIndexFactory


@dataclass(frozen=True)
class HybridIndex(InnerIndex):
    """Fuses replies of `retrievers` with RRF (reference k=60)."""

    retrievers: Sequence[InnerIndex] = ()
    k: float = 60.0

    def make_adapter(self):  # pragma: no cover - fusion happens at DSL level
        raise NotImplementedError("HybridIndex fuses sub-index tables")

    def _fuse(self, reply_tables, number_of_matches):
        # all reply tables share the query table's universe (keyed by query
        # id), so fusing is a sequence of id-joins collecting reply columns
        joined = reply_tables[0]
        for i, t in enumerate(reply_tables[1:], start=1):
            renamed = t.select(**{f"_pw_reply_{i}": t[_INDEX_REPLY]})
            joined = joined.join(
                renamed, joined.id == renamed.id, id=joined.id
            ).select(*joined, renamed[f"_pw_reply_{i}"])
        rrf_k = self.k

        def fuse(*replies_and_limit):
            *replies, limit = replies_and_limit
            scores: dict[Any, float] = {}
            for reply in replies:
                if not reply:
                    continue
                for rank, pair in enumerate(reply):
                    doc_id = pair[0]
                    scores[doc_id] = scores.get(doc_id, 0.0) + 1.0 / (
                        rrf_k + rank + 1
                    )
            fused = sorted(scores.items(), key=lambda kv: (-kv[1], repr(kv[0])))
            return tuple((doc, s) for doc, s in fused[: int(limit)])

        cols = [joined[_INDEX_REPLY]] + [
            joined[f"_pw_reply_{i}"] for i in range(1, len(reply_tables))
        ]
        import pathway_tpu_torch.internals.expression as expr_mod

        limit_expr = expr_mod.smart_coerce(number_of_matches)
        out_cols = {
            c: joined[c]
            for c in joined.column_names()
            if c == _INDEX_REPLY or not c.startswith("_pw_reply_")
        }
        out_cols[_INDEX_REPLY] = apply_with_type(
            fuse, dt.ANY, *cols, limit_expr
        )
        return joined.select(**out_cols)

    def query(self, query_column, *, number_of_matches=3, metadata_filter=None):
        replies = [
            r.query(
                query_column,
                number_of_matches=number_of_matches,
                metadata_filter=metadata_filter,
            )
            for r in self.retrievers
        ]
        return self._fuse(replies, number_of_matches)

    def query_as_of_now(
        self, query_column, *, number_of_matches=3, metadata_filter=None
    ):
        replies = [
            r.query_as_of_now(
                query_column,
                number_of_matches=number_of_matches,
                metadata_filter=metadata_filter,
            )
            for r in self.retrievers
        ]
        return self._fuse(replies, number_of_matches)


@dataclass
class HybridIndexFactory(InnerIndexFactory):
    retriever_factories: Sequence[InnerIndexFactory] = ()
    k: float = 60.0

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        retrievers = tuple(
            f.build_inner_index(data_column, metadata_column)
            for f in self.retriever_factories
        )
        return HybridIndex(
            data_column=data_column,
            metadata_column=metadata_column,
            retrievers=retrievers,
            k=self.k,
        )
