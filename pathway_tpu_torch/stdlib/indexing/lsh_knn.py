"""LshKnn inner index (reference: stdlib/indexing/nearest_neighbors.py
LshKnn — wraps the pure-dataflow LSH classifier index into the InnerIndex
contract)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, InnerIndexFactory


@dataclass(frozen=True)
class LshKnn(InnerIndex):
    dimensions: int = 0
    n_or: int = 20
    n_and: int = 10
    bucket_length: float = 10.0
    metric: str = "euclidean"  # euclidean | cosine
    embedder: Any = None

    def make_adapter(self):  # pragma: no cover - pure dataflow, no adapter
        raise NotImplementedError

    def _lower_query(self, query_column, number_of_matches, metadata_filter, mode):
        from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
            _calculate_embeddings,
        )
        from pathway_tpu_torch.stdlib.ml.index import _build_reply_table

        if mode == "as_of_now":
            # pure-dataflow index revises by nature; as-of-now contract is
            # met by making the query transient (answered at t, retracted
            # at t+1, never revised) — the same shape DataIndex uses
            from pathway_tpu_torch.stdlib.temporal._interval_join import rebind

            qt = query_column.table
            transient = qt._forget_immediately()
            query_column = rebind(query_column, qt, transient)
            if hasattr(metadata_filter, "_dtype"):
                metadata_filter = rebind(metadata_filter, qt, transient)
            if hasattr(number_of_matches, "_dtype"):
                number_of_matches = rebind(number_of_matches, qt, transient)
        query_column = _calculate_embeddings(query_column, self.embedder)
        reply = _build_reply_table(
            self.data_column,
            self.data_column.table,
            query_column,
            n_dimensions=self.dimensions,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            distance_type=self.metric,
            metadata=self.metadata_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
        )
        return reply


@dataclass
class LshKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    n_or: int = 20
    n_and: int = 10
    bucket_length: float = 10.0
    metric: str = "euclidean"
    embedder: Any = None

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
            _calculate_embeddings,
        )

        return LshKnn(
            data_column=_calculate_embeddings(data_column, self.embedder),
            metadata_column=metadata_column,
            dimensions=self.dimensions or 0,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            metric=self.metric,
            embedder=self.embedder,
        )
