"""DataIndex: augment inner-index replies with data-table payloads
(reference: python/pathway/stdlib/indexing/data_index.py:46-473).

`InnerIndex.query*` answers with ``_pw_index_reply`` — a tuple of
(matched_id, score) pairs. DataIndex flattens the reply, joins matched ids
back to the data table and shapes the output either flat (one row per
match) or collapsed (one row per query, data columns as tuples ordered by
descending score). As-of-now flows route the intermediate tables through
``_forget_immediately`` so transient queries leave no state behind.
"""

from __future__ import annotations

from dataclasses import dataclass

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import (
    ColumnReference,
    GetExpression,
    apply_with_type,
    make_tuple,
)
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.colnames import (
    _INDEX_REPLY,
    _MATCHED_ID,
    _PACKED_DATA,
    _QUERY_ID,
    _SCORE,
)
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex


@dataclass
class DataIndex:
    data_table: Table
    inner_index: InnerIndex

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches=3,
        collapse_rows: bool = True,
        metadata_filter=None,
    ):
        raw = self.inner_index.query(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
        )
        return self._repack_results(
            raw, query_column.table, collapse_rows, as_of_now=False
        )

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches=3,
        collapse_rows: bool = True,
        metadata_filter=None,
    ):
        raw = self.inner_index.query_as_of_now(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
        )
        return self._repack_results(
            raw, query_column.table, collapse_rows, as_of_now=True
        )

    # -- result shaping ----------------------------------------------------
    def _repack_results(
        self,
        raw_result: Table,
        query_table: Table,
        collapse_rows: bool,
        as_of_now: bool,
    ):
        data_table = self.data_table
        data_cols = data_table.column_names()

        # reply -> one row per (query, match)
        flattened = raw_result.with_columns(
            **{_QUERY_ID: raw_result.id}
        ).flatten(raw_result[_INDEX_REPLY])
        matches = flattened.select(
            flattened[_QUERY_ID],
            **{
                _MATCHED_ID: GetExpression(flattened[_INDEX_REPLY], 0),
                _SCORE: GetExpression(flattened[_INDEX_REPLY], 1),
            },
        )

        if collapse_rows:
            return self._collapsed(matches, query_table, as_of_now)
        return self._flat(matches, query_table, as_of_now)

    def _flat(self, matches: Table, query_table: Table, as_of_now: bool):
        data_table = self.data_table
        joined = matches.join(
            data_table, matches[_MATCHED_ID] == data_table.id
        ).select(
            matches[_QUERY_ID],
            matches[_SCORE],
            *data_table,
        )
        if as_of_now:
            joined = joined._forget_immediately()
        # one OUTPUT row per match: ids derive from the (query, match) pair
        return query_table.join(
            joined,
            query_table.id == joined[_QUERY_ID],
            how="left",
        ).select(*query_table, joined[_SCORE], *[joined[c] for c in data_table.column_names()])

    def _collapsed(self, matches: Table, query_table: Table, as_of_now: bool):
        data_table = self.data_table
        data_cols = data_table.column_names()
        compacted = data_table.select(
            **{_PACKED_DATA: make_tuple(*data_table)}
        )
        joined = matches.join(
            compacted, matches[_MATCHED_ID] == compacted.id
        ).select(
            matches[_QUERY_ID],
            matches[_SCORE],
            compacted[_PACKED_DATA],
        )
        if as_of_now:
            joined = joined._forget_immediately()

        grouped = joined.groupby(id=joined[_QUERY_ID]).reduce(
            _pw_pairs=expr_mod.ReducerExpression(
                _sorted_pairs_reducer(),
                make_tuple(joined[_SCORE], joined[_PACKED_DATA]),
            )
        )

        # per data column: tuple of values ordered by descending score
        def unzip_col(i):
            def get(pairs):
                if pairs is None:
                    return ()
                return tuple(p[1][i] for p in pairs)

            return get

        cols = {}
        for i, name in enumerate(data_cols):
            cols[name] = apply_with_type(
                unzip_col(i), dt.ANY, grouped["_pw_pairs"]
            )
        cols[_SCORE] = apply_with_type(
            lambda pairs: tuple(p[0] for p in pairs) if pairs else (),
            dt.ANY,
            grouped["_pw_pairs"],
        )
        shaped = grouped.select(**cols)
        return query_table.join(
            shaped,
            query_table.id == shaped.id,
            how="left",
            id=query_table.id,
        ).select(
            *query_table, shaped[_SCORE], *[shaped[c] for c in data_cols]
        )


def _sorted_pairs_reducer():
    """Reducer: multiset of (score, packed) pairs -> tuple sorted by
    descending score (deterministic tie-break on packed data)."""
    from pathway_tpu_torch.internals.reducers import Reducer, _entries

    def factory(**kw):
        def fn(ms, slot):
            pairs = []
            for combo, count in _entries(ms, slot):
                pair = combo[0]  # the make_tuple(score, packed) arg
                for _ in range(max(count, 0)):
                    pairs.append(pair)
            pairs.sort(
                key=lambda p: (
                    -(p[0] if p[0] is not None else float("-inf")),
                    repr(p[1]),
                )
            )
            return tuple(pairs)

        return fn

    return Reducer("sorted_pairs", factory, lambda ts: dt.ANY)
