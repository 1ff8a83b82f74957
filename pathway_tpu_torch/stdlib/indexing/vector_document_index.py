"""Vector document-index presets (reference:
python/pathway/stdlib/indexing/vector_document_index.py — default_*
constructors returning a ready DataIndex). ``device=`` places the KNN
shard: None is the card, ``"cpu"`` the host."""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnn, UsearchKnn


def default_vector_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder=None,
    metadata_column: ColumnExpression | None = None,
    device=None,
) -> DataIndex:
    return default_brute_force_knn_document_index(
        data_column,
        data_table,
        dimensions=dimensions,
        embedder=embedder,
        metadata_column=metadata_column,
        device=device,
    )


def default_brute_force_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    reserved_space: int = 1024,
    embedder=None,
    metadata_column: ColumnExpression | None = None,
    metric: str = "cos",
    mesh=None,
    device=None,
) -> DataIndex:
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
        _calculate_embeddings,
    )

    inner = BruteForceKnn(
        data_column=_calculate_embeddings(data_column, embedder),
        metadata_column=metadata_column,
        dimensions=dimensions,
        reserved_space=reserved_space,
        metric=metric,
        embedder=embedder,
        mesh=mesh,
        device=device,
    )
    return DataIndex(data_table, inner)


def default_usearch_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    reserved_space: int = 1024,
    embedder=None,
    metadata_column: ColumnExpression | None = None,
    metric: str = "cos",
    mesh=None,
    device=None,
) -> DataIndex:
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
        _calculate_embeddings,
    )

    inner = UsearchKnn(
        data_column=_calculate_embeddings(data_column, embedder),
        metadata_column=metadata_column,
        dimensions=dimensions,
        reserved_space=reserved_space,
        metric=metric,
        embedder=embedder,
        mesh=mesh,
        device=device,
    )
    return DataIndex(data_table, inner)
