"""InnerIndex abstraction + shared lowering onto the engine's external-index
operator (reference: python/pathway/stdlib/indexing/retrievers.py:32
InnerIndexFactory; data_index.py InnerIndex ABC).

An InnerIndex accepts data (``data_column``) with optional JSON metadata and
answers queries with ``_pw_index_reply``: a tuple of (matched_id, score)
pairs. Concrete adapters (brute-force device KNN, BM25, hybrid) plug in via
`make_adapter`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.colnames import _INDEX_REPLY


@dataclass(frozen=True)
class InnerIndex(ABC):
    """Reference parity: stdlib/indexing/data_index.py InnerIndex."""

    data_column: ColumnReference
    metadata_column: ColumnExpression | None = None

    @abstractmethod
    def make_adapter(self):
        """Fresh ExternalIndexAdapter per run (engine/external_index.py)."""

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._lower_query(
            query_column, number_of_matches, metadata_filter, mode="revising"
        )

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._lower_query(
            query_column, number_of_matches, metadata_filter, mode="as_of_now"
        )

    # -- lowering ----------------------------------------------------------
    def _lower_query(
        self,
        query_column: ColumnReference,
        number_of_matches: ColumnExpression | int,
        metadata_filter: ColumnExpression | None,
        mode: str,
    ) -> Table:
        from pathway_tpu_torch.engine.expression import compile_expression

        index_table = self.data_column.table
        query_table = query_column.table
        data_expr = self.data_column
        meta_expr = (
            expr_mod.smart_coerce(self.metadata_column)
            if self.metadata_column is not None
            else None
        )
        limit_expr = expr_mod.smart_coerce(number_of_matches)
        filter_expr = (
            expr_mod.smart_coerce(metadata_filter)
            if metadata_filter is not None
            else None
        )

        out_types = dict(query_table.schema.typehints())
        out_types[_INDEX_REPLY] = dt.ANY
        out = Table(schema_from_types(**out_types), query_table._universe)
        inner = self
        q_names = query_table._column_names

        def lower(ctx):
            # _combined_view resolves refs to other same-universe tables
            # (e.g. metadata on the pre-embedding table) via id-joins
            index_exprs = [data_expr] + ([meta_expr] if meta_expr is not None else [])
            it, i_res = ctx._combined_view(index_table, index_exprs)
            query_exprs = [query_column, limit_expr] + (
                [filter_expr] if filter_expr is not None else []
            )
            qt, q_res = ctx._combined_view(query_table, query_exprs)
            data_fn = compile_expression(data_expr, i_res, ctx.runtime)
            meta_fn = (
                compile_expression(meta_expr, i_res, ctx.runtime)
                if meta_expr is not None
                else None
            )
            qdata_fn = compile_expression(query_column, q_res, ctx.runtime)
            limit_fn = compile_expression(limit_expr, q_res, ctx.runtime)
            filter_fn = (
                compile_expression(filter_expr, q_res, ctx.runtime)
                if filter_expr is not None
                else None
            )

            def index_fn(k, row):
                data = data_fn([k], [row])[0]
                meta = meta_fn([k], [row])[0] if meta_fn is not None else None
                return data, meta

            def query_fn(k, row):
                data = qdata_fn([k], [row])[0]
                limit = limit_fn([k], [row])[0]
                filt = (
                    filter_fn([k], [row])[0] if filter_fn is not None else None
                )
                return data, int(limit), filt

            adapter = inner.make_adapter()
            res = ctx.scope.external_index(
                it, qt, adapter, index_fn, query_fn, mode
            )

            # engine row: combined_query_row + (ids, scores) -> the query
            # table's own columns + reply (combined view may carry extra
            # joined columns past the base table's width)
            n_q = len(q_names)

            def shape_fn(keys, rows):
                return [
                    r[:n_q] + (tuple(zip(r[-2], r[-1])),) for r in rows
                ]

            ctx.set_engine_table(
                out, ctx.scope.rowwise(res, shape_fn, len(q_names) + 1)
            )

        G.add_operator([index_table, query_table], [out], lower, f"index_{mode}")
        return out


class InnerIndexFactory(ABC):
    """Builds an InnerIndex for given data/metadata columns (reference:
    retrievers.py:32 — used by DocumentStore retriever factories)."""

    @abstractmethod
    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex: ...

    def build_index(
        self,
        data_column: ColumnReference,
        data_table: Table,
        metadata_column: ColumnExpression | None = None,
    ):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex

        inner = self.build_inner_index(data_column, metadata_column)
        return DataIndex(data_table, inner)
