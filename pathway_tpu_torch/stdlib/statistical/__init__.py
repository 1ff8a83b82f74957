"""pw.statistical (reference:
python/pathway/stdlib/statistical/_interpolate.py:146)."""

from __future__ import annotations

import enum

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import apply_with_type, coalesce, if_else, unwrap
from pathway_tpu_torch.internals import dtype as dt


class InterpolateMode(enum.Enum):
    LINEAR = "linear"


def interpolate(table, timestamp, *values, mode=InterpolateMode.LINEAR):
    """Fill None gaps in value columns by linear interpolation along
    `timestamp` order (reference: statistical/_interpolate.py).

    For rows where a value is None, takes the nearest non-None neighbors
    (by timestamp) before and after and interpolates linearly; boundary
    rows take the single available neighbor's value.
    """
    if mode is not InterpolateMode.LINEAR:
        raise ValueError("only InterpolateMode.LINEAR is supported")
    ts = table._desugar(expr_mod.smart_coerce(timestamp))
    ts_name = getattr(ts, "name", None)

    value_names = []
    for v in values:
        ref = table._desugar(expr_mod.smart_coerce(v))
        value_names.append(ref.name)

    # whole-column interpolation in one batched UDF over the packed table:
    # correct incremental recompute via groupby rediff on the single group
    from pathway_tpu_torch.internals import reducers

    packed = table.reduce(
        ids=reducers.tuple(table.id),
        ts=reducers.tuple(ts),
        **{n: reducers.tuple(table[n]) for n in value_names},
    )

    def run(ids, tss, *cols):
        order = sorted(range(len(ids)), key=lambda i: tss[i])
        out_rows = []
        filled_cols = []
        for col in cols:
            filled = list(col)
            known = [(tss[i], col[i]) for i in order if col[i] is not None]
            for i in order:
                if col[i] is not None:
                    continue
                t = tss[i]
                before = None
                after = None
                for kt, kv in known:
                    if kt <= t:
                        before = (kt, kv)
                    elif after is None:
                        after = (kt, kv)
                        break
                if before and after:
                    t0, v0 = before
                    t1, v1 = after
                    filled[i] = v0 + (v1 - v0) * (t - t0) / (t1 - t0)
                elif before:
                    filled[i] = before[1]
                elif after:
                    filled[i] = after[1]
            filled_cols.append(filled)
        return tuple(
            (ids[i],) + tuple(c[i] for c in filled_cols)
            for i in range(len(ids))
        )

    paired = packed.select(
        rows=apply_with_type(
            run, dt.ANY, packed.ids, packed.ts,
            *[packed[n] for n in value_names],
        )
    )
    flat = paired.flatten(paired.rows)
    out_cols = {
        "_pw_row_id": expr_mod.GetExpression(flat.rows, 0),
    }
    for j, n in enumerate(value_names):
        out_cols[n] = expr_mod.GetExpression(flat.rows, j + 1)
    result = flat.select(**out_cols)
    result = (
        result._with_id_unchecked(result["_pw_row_id"])
        .without("_pw_row_id")
        ._unsafe_promise_universe(table)
    )
    return table.with_columns(**{n: result[n] for n in value_names})
