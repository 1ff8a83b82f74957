"""pw.debug — markdown tables, capture, printing (reference:
python/pathway/debug/__init__.py: table_from_markdown :429,
compute_and_print :207, table_from_pandas :343,
compute_and_print_update_stream :235).

This is the backbone of the Tier-1 test pattern (SURVEY §4).
"""

from __future__ import annotations

import re
from typing import Any, Iterable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import Pointer, ref_scalar, unsafe_make_pointer
from pathway_tpu_torch.internals.graph_runner import GraphRunner
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema, schema_from_types
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok in ("", "None"):
        return None
    if tok == "True":
        return True
    if tok == "False":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    return tok


def _markdown_rows(table_def: str, split_on_whitespace: bool = True):
    lines = [ln for ln in table_def.strip().splitlines() if ln.strip()]
    header = lines[0]
    if "|" in header:
        sep = "|"
        cols = [c.strip() for c in header.split("|")]
    else:
        sep = None
        cols = header.split()
    has_id_col = cols and cols[0] == ""
    if has_id_col:
        cols = cols[1:]
    rows = []
    for line in lines[1:]:
        if set(line.strip()) <= {"-", "|", " ", "="}:
            continue
        if sep == "|":
            toks = [t.strip() for t in line.split("|")]
        elif len(cols) == 1 and not has_id_col:
            # single unlabeled column: the whole line is one value (spaces
            # included) — matches reference table_from_markdown behavior
            toks = [line.strip()]
        else:
            toks = line.split()
        if has_id_col:
            label, toks = toks[0], toks[1:]
        else:
            label = None
        vals = [_parse_value(t) for t in toks]
        if len(vals) < len(cols):
            vals += [None] * (len(cols) - len(vals))
        rows.append((label, vals[: len(cols)]))
    return cols, rows


def table_from_rows(
    schema: type[Schema],
    rows: list[tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    """Rows are (id, *values) or (id, *values, time, diff) when is_stream."""
    col_names = schema.column_names()
    out = Table(schema, Universe())
    n = len(col_names)

    def lower(ctx):
        if is_stream:
            node_table = ctx.scope.empty_table(n)
            node = node_table.node
            from pathway_tpu_torch.internals.config import get_pathway_config

            # program-embedded rows are identical on every rank: rank 0
            # injects once and exchanges shard the work (same contract as
            # static tables, runtime.run_static distributed path)
            if (
                not ctx.scope.runtime.distributed
                or get_pathway_config().process_id == 0
            ):
                by_time: dict[int, list] = {}
                for row in rows:
                    key, vals, t, d = (
                        row[0], row[1 : 1 + n], row[1 + n], row[2 + n],
                    )
                    by_time.setdefault(int(t), []).append(
                        (key, tuple(vals), int(d))
                    )
                for t, deltas in by_time.items():
                    node.accept(t, 0, deltas)
            ctx.set_engine_table(out, node_table)
        else:
            data = [(row[0], tuple(row[1 : 1 + n])) for row in rows]
            ctx.set_engine_table(out, ctx.scope.static_table(data, n))

    G.add_operator([], [out], lower, "static_table")
    return out


def table_from_markdown(
    table_def: str,
    id_from=None,
    unsafe_trusted_ids: bool = False,
    schema: type[Schema] | None = None,
    split_on_whitespace: bool = True,
    _stacklevel: int = 1,
) -> Table:
    cols, raw_rows = _markdown_rows(table_def, split_on_whitespace)
    special = [c for c in cols if c in ("_time", "_diff")]
    value_cols = [c for c in cols if c not in ("_time", "_diff")]

    if schema is None:
        dtypes = {}
        for c in value_cols:
            idx = cols.index(c)
            vals = [vals[idx] for _, vals in raw_rows]
            dtypes[c] = dt.lub(*(dt.dtype_of_value(v) for v in vals)) if vals else dt.ANY
        schema = schema_from_types(**dtypes)
    else:
        # explicit schema: markdown may give a column subset; the rest
        # take schema defaults (reference table_from_markdown behavior)
        value_cols = schema.column_names()
    pk = schema.primary_key_columns() if id_from is None else list(id_from)
    defaults = schema.default_values()

    rows = []
    for i, (label, vals) in enumerate(raw_rows):
        by_name = dict(zip(cols, vals))
        values = tuple(
            by_name.get(c, defaults.get(c)) for c in value_cols
        )
        if pk:
            key = ref_scalar(*(by_name[c] for c in pk))
        elif label is not None:
            key = (
                unsafe_make_pointer(int(label))
                if unsafe_trusted_ids
                else ref_scalar(str(label))
            )
        else:
            key = ref_scalar(i)
        if special:
            t = int(by_name.get("_time", 0) or 0)
            d = int(by_name.get("_diff", 1) or 1)
            rows.append((key, *values, t, d))
        else:
            rows.append((key, *values))
    return table_from_rows(schema, rows, is_stream=bool(special))


# alias used throughout reference tests
parse_to_table = table_from_markdown


def table_from_pandas(df, id_from=None, unsafe_trusted_ids: bool = False, schema=None) -> Table:
    from pathway_tpu_torch.internals.schema import schema_from_pandas

    if schema is None:
        schema = schema_from_pandas(df, id_from=id_from)
    cols = schema.column_names()
    rows = []
    for i, (idx, row) in enumerate(df.iterrows()):
        vals = tuple(_np_to_py(row[c]) for c in cols)
        if id_from:
            key = ref_scalar(*(row[c] for c in id_from))
        else:
            key = unsafe_make_pointer(int(idx)) if unsafe_trusted_ids else ref_scalar(int(idx))
        rows.append((key, *vals))
    return table_from_rows(schema, rows)


def _np_to_py(v):
    import numpy as np

    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.str_):
        return str(v)
    return v


def _run_capture(*tables: Table, terminate_on_error: bool = True):
    runner = GraphRunner(terminate_on_error=terminate_on_error)
    return runner.run_tables(*tables)


def table_to_dicts(table: Table):
    [capture] = _run_capture(table)
    cols = table.column_names()
    keys = list(capture.state.rows.keys())
    data = {
        c: {k: capture.state.rows[k][i] for k in keys} for i, c in enumerate(cols)
    }
    return keys, data


def table_to_pandas(table: Table, *, include_id: bool = True):
    import pandas as pd

    [capture] = _run_capture(table)
    cols = table.column_names()
    rows = capture.state.rows
    if include_id:
        index = list(rows.keys())
        data = {c: [rows[k][i] for k in index] for i, c in enumerate(cols)}
        return pd.DataFrame(data, index=[repr(k) for k in index])
    data = {c: [r[i] for r in rows.values()] for i, c in enumerate(cols)}
    return pd.DataFrame(data)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    **kwargs,
) -> None:
    [capture] = _run_capture(table)
    cols = table.column_names()
    items = sorted(capture.state.rows.items(), key=lambda kv: repr(kv[0]))
    if n_rows is not None:
        items = items[:n_rows]
    if include_id:
        print(" " * 12 + " | ".join(cols))
        for k, row in items:
            print(f"{k!r} | " + " | ".join(str(v) for v in row))
    else:
        print(" | ".join(cols))
        for _, row in items:
            print(" | ".join(str(v) for v in row))


def compute_and_print_update_stream(
    table: Table, *, include_id: bool = True, **kwargs
) -> None:
    [capture] = _run_capture(table)
    cols = table.column_names() + ["__time__", "__diff__"]
    print(" | ".join(cols))
    for k, row, t, d in capture.updates:
        prefix = f"{k!r} | " if include_id else ""
        print(prefix + " | ".join(str(v) for v in (*row, t, d)))


def _capture_update_stream(table: Table):
    [capture] = _run_capture(table)
    return list(capture.updates)


def _capture_final_state(table: Table):
    [capture] = _run_capture(table)
    return dict(capture.state.rows)
