"""Legacy class transformers (reference:
python/pathway/internals/row_transformer.py:294 +
graph_runner/row_transformer_operator_handler.py — `@pw.transformer`
classes with lazy pointer-chasing attribute access).

The modern surface (select/apply/AsyncTransformer) covers the same ground;
this provides the decorator API for programs written against it. Each
output attribute is computed per row with a `self` proxy that can follow
pointers into other transformer tables (the reference's Computer
machinery, python_api.rs:2092)."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable


class attribute:  # noqa: N801 — reference API names
    """Marks a computed output attribute."""

    def __init__(self, fn: Callable | None = None):
        self.fn = fn

    def __call__(self, fn):
        self.fn = fn
        return self


class input_attribute:  # noqa: N801
    """Marks a column taken from the input table."""

    def __init__(self, dtype=None):
        self.dtype = dtype


class input_method:  # noqa: N801
    def __init__(self, dtype=None):
        self.dtype = dtype


class output_attribute(attribute):  # noqa: N801
    pass


class method(attribute):  # noqa: N801
    pass


class _RowProxy:
    """`self` inside transformer methods: columns + pointer navigation."""

    def __init__(self, cls_ns, tables, table_name, key, row_lookup):
        self._cls_ns = cls_ns
        self._tables = tables
        self._table = table_name
        self._key = key
        self._row_lookup = row_lookup  # (table_name, key) -> dict

    @property
    def id(self):
        return self._key

    def transformer(self):
        return SimpleNamespace(
            **{
                name: _TableProxy(self._cls_ns, self._tables, name, self._row_lookup)
                for name in self._tables
            }
        )

    def __getattr__(self, name):
        ns = self._cls_ns[self._table]
        row = self._row_lookup(self._table, self._key)
        if name in row:
            return row[name]
        spec = ns.get(name)
        if isinstance(spec, method):
            # bound method: called with extra args by other attributes
            return lambda *a, **k: spec.fn(self, *a, **k)
        if isinstance(spec, attribute):
            return spec.fn(self)
        raise AttributeError(name)


class _TableProxy:
    def __init__(self, cls_ns, tables, table_name, row_lookup):
        self._cls_ns = cls_ns
        self._tables = tables
        self._table = table_name
        self._row_lookup = row_lookup

    def __getitem__(self, key):
        return _RowProxy(
            self._cls_ns, self._tables, self._table, key, self._row_lookup
        )


def transformer(cls):
    """@pw.transformer — per-row computed attributes over one or more
    input tables; returns a factory taking the input tables and yielding a
    namespace of output tables."""
    table_specs: dict[str, dict[str, Any]] = {}
    for tname, tcls in vars(cls).items():
        if tname.startswith("_") or not isinstance(tcls, type):
            continue
        table_specs[tname] = dict(vars(tcls))

    def build(**input_tables):
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.internals import dtype as dt
        from pathway_tpu_torch.internals.expression import apply_with_type
        from pathway_tpu_torch.internals import reducers

        # materialize every input table's rows into one packed lookup;
        # internal column name must not collide with user columns
        packed = {}
        for tname, table in input_tables.items():
            cols = table.column_names()
            packed[tname] = table.reduce(
                **{"_pw_packed_ids": reducers.tuple(table.id)},
                **{c: reducers.tuple(table[c]) for c in cols},
            )

        outputs = {}
        for tname, spec in table_specs.items():
            table = input_tables[tname]
            in_cols = [
                n for n, s in spec.items() if isinstance(s, input_attribute)
            ]
            out_attrs = {
                n: s
                for n, s in spec.items()
                if isinstance(s, attribute) and not isinstance(s, method)
            }
            if not out_attrs:
                continue

            # single batched computation over all rows of all tables; the
            # packed singletons share the same (empty-groupby) key, so they
            # can be unified onto one universe for the combined view
            base = packed[tname]
            all_packed_cols = []
            layout = []
            for pname, ptable in packed.items():
                pcols = input_tables[pname].column_names()
                layout.append((pname, pcols))
                if pname != tname:
                    ptable = ptable._unsafe_promise_universe(base)
                all_packed_cols.append(ptable["_pw_packed_ids"])
                all_packed_cols.extend(ptable[c] for c in pcols)

            def compute(ids, *flat, _spec=out_attrs, _tname=tname, _layout=layout):
                data: dict[str, dict] = {}
                pos = 0
                for pname, pcols in _layout:
                    p_ids = flat[pos]
                    pos += 1
                    cols_vals = flat[pos : pos + len(pcols)]
                    pos += len(pcols)
                    data[pname] = {
                        k: dict(zip(pcols, vals))
                        for k, vals in zip(
                            p_ids, zip(*cols_vals) if cols_vals else [()] * len(p_ids)
                        )
                    }

                def row_lookup(t, k):
                    return data[t][k]

                out_rows = []
                for key in ids:
                    proxy = _RowProxy(
                        table_specs, list(input_tables), _tname, key, row_lookup
                    )
                    out_rows.append(
                        (key,)
                        + tuple(s.fn(proxy) for s in _spec.values())
                    )
                return tuple(out_rows)

            applied = base.select(
                rows=apply_with_type(
                    compute, dt.ANY, base["_pw_packed_ids"], *all_packed_cols
                )
            )
            flat = applied.flatten(applied.rows)
            from pathway_tpu_torch.internals.expression import GetExpression

            sel = {"_pw_row_id": GetExpression(flat.rows, 0)}
            for i, n in enumerate(out_attrs):
                sel[n] = GetExpression(flat.rows, i + 1)
            result = flat.select(**sel)
            result = (
                result._with_id_unchecked(result["_pw_row_id"])
                .without("_pw_row_id")
                ._unsafe_promise_universe(table)
            )
            outputs[tname] = result

        return SimpleNamespace(**outputs)

    build.__name__ = cls.__name__
    return build
