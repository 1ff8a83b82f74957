"""@pw.pandas_transformer (reference:
python/pathway/stdlib/utils/pandas_transformer.py, 178 LoC): wrap a
pandas-DataFrame function into a table-to-table transformer."""

from __future__ import annotations

import functools
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.expression import apply_with_type, make_tuple
from pathway_tpu_torch.internals.schema import Schema


def pandas_transformer(output_schema: type[Schema], output_universe: Any = None):
    """Decorator: fn(*DataFrames) -> DataFrame becomes fn(*Tables) -> Table."""

    def wrapper(fn):
        @functools.wraps(fn)
        def transformer(*tables):
            import pandas as pd

            import pathway_tpu_torch as pw
            from pathway_tpu_torch.internals import reducers

            packed_tables = []
            for t in tables:
                cols = t.column_names()
                packed = t.reduce(
                    ids=reducers.tuple(t.id),
                    **{c: reducers.tuple(t[c]) for c in cols},
                )
                packed_tables.append((packed, cols))

            out_cols = output_schema.column_names()

            # single-row join of all packed tables, then one batched call
            base, base_cols = packed_tables[0]
            joined = base
            arg_cols = [[joined[c] for c in base_cols] + [joined.ids]]
            for packed, cols in packed_tables[1:]:
                renamed = packed.with_prefix(f"t{len(arg_cols)}_")
                joined = joined.join(renamed, id=joined.id).select(
                    *joined, *renamed
                )
                arg_cols.append(
                    [joined[f"t{len(arg_cols)}_{c}"] for c in cols]
                    + [joined[f"t{len(arg_cols)}_ids"]]
                )

            names_per_table = [cols for _, cols in packed_tables]

            def run(*flat):
                dfs = []
                pos = 0
                for cols in names_per_table:
                    data = {c: list(flat[pos + i]) for i, c in enumerate(cols)}
                    ids = flat[pos + len(cols)]
                    pos += len(cols) + 1
                    dfs.append(pd.DataFrame(data, index=list(ids)))
                result = fn(*dfs)
                rows = []
                for idx, row in result.iterrows():
                    rows.append((idx,) + tuple(row[c] for c in out_cols))
                return tuple(rows)

            flat_cols = [c for group in arg_cols for c in group]
            applied = joined.select(
                rows=apply_with_type(run, dt.ANY, *flat_cols)
            )
            flat = applied.flatten(applied.rows)
            from pathway_tpu_torch.internals.expression import GetExpression

            sel = {"_pw_idx": GetExpression(flat.rows, 0)}
            for i, c in enumerate(out_cols):
                sel[c] = GetExpression(flat.rows, i + 1)
            result = flat.select(**sel)
            if output_universe is not None:
                # index carries input Pointers (DataFrames were built with
                # id indexes): key output rows by them, in that universe
                target = (
                    tables[output_universe]
                    if isinstance(output_universe, int)
                    else output_universe
                )
                result = (
                    result._with_id_unchecked(result["_pw_idx"])
                    .without("_pw_idx")
                    ._unsafe_promise_universe(target)
                )
            else:
                result = result._with_id_unchecked(
                    result.pointer_from(result["_pw_idx"])
                ).without("_pw_idx")
            return result

        return transformer

    return wrapper
