"""Column utilities (reference: python/pathway/stdlib/utils/col.py:367
unpack_col, multiapply_all_rows)."""

from __future__ import annotations

from typing import Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import (
    ColumnReference,
    GetExpression,
    apply_with_type,
)


def unpack_col(column: ColumnReference, *names, schema=None):
    """Explode a tuple column into one column per element.

    ``unpack_col(t.tup, "a", "b")`` -> table with columns a, b taken from
    positions 0, 1 of the tuple (reference: stdlib/utils/col.py unpack_col).
    """
    table = column.table
    if schema is not None:
        names = list(schema.column_names())
    if not names:
        raise ValueError("unpack_col needs names or a schema")
    cols = {
        str(name): GetExpression(column, i)
        for i, name in enumerate(names)
    }
    return table.select(**cols)


def apply_all_rows(
    *cols: ColumnReference,
    fun: Callable[..., list],
    result_col_name: str,
):
    """Apply `fun` to entire columns at once; one result per row (reference:
    col.py multiapply_all_rows). `fun` receives whole columns as lists —
    the batched-device-execution shape."""
    table = cols[0].table
    from pathway_tpu_torch.internals import reducers

    packed = table.reduce(
        ids=reducers.tuple(table.id),
        **{f"c{i}": reducers.tuple(c) for i, c in enumerate(cols)},
    )

    def apply_fun(ids, *packed_cols):
        results = fun(*[list(c) for c in packed_cols])
        return tuple(zip(ids, results))

    paired = packed.select(
        pairs=apply_with_type(
            apply_fun, dt.ANY, packed.ids,
            *[packed[f"c{i}"] for i in range(len(cols))],
        )
    )
    flat = paired.flatten(paired.pairs)
    result = flat.select(
        _pw_row_id=GetExpression(flat.pairs, 0),
        **{result_col_name: GetExpression(flat.pairs, 1)},
    )
    result = result.with_id(result._pw_row_id).without("_pw_row_id")
    return table.join(
        result, table.id == result.id, id=table.id
    ).select(*table, result[result_col_name])
