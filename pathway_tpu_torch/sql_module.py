"""pw.sql — SQL to Table-DSL translation (reference:
python/pathway/internals/sql.py:726 — sqlglot-based; no sqlglot here, so a
hand-rolled parser covers the dialect the reference documents: SELECT
projections/expressions, FROM with aliases, INNER JOIN ... ON, WHERE,
GROUP BY + aggregates (COUNT/SUM/MIN/MAX/AVG), HAVING, UNION ALL)."""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import coalesce, if_else

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+(?:\.\d+)?)"
    r"|(?P<str>'[^']*')"
    r"|(?P<op><=|>=|<>|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)"
    r"|(?P<ident>[A-Za-z_][A-Za-z0-9_]*))",
    re.S,
)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "as", "join",
    "inner", "left", "right", "outer", "on", "and", "or", "not", "union",
    "all", "distinct", "null", "true", "false", "like",
}

_AGGREGATES = {"count", "sum", "min", "max", "avg"}


def _tokenize(sql: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            rest = sql[pos:].strip()
            if not rest:
                break
            raise ValueError(f"SQL syntax error near {rest[:30]!r}")
        pos = m.end()
        for kind in ("num", "str", "op", "ident"):
            tok = m.group(kind)
            if tok is not None:
                if kind == "ident" and tok.lower() in _KEYWORDS:
                    out.append(("kw", tok.lower()))
                else:
                    out.append((kind, tok))
                break
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.pos = 0

    def peek(self, offset=0):
        i = self.pos + offset
        return self.toks[i] if i < len(self.toks) else (None, None)

    def next(self):
        tok = self.peek()
        self.pos += 1
        return tok

    def accept(self, kind, value=None):
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.pos += 1
            return v
        return None

    def expect(self, kind, value=None):
        got = self.accept(kind, value)
        if got is None:
            raise ValueError(
                f"SQL: expected {value or kind}, got {self.peek()!r}"
            )
        return got

    # -- grammar ----------------------------------------------------------
    def parse_query(self):
        q = self.parse_select()
        while self.accept("kw", "union"):
            self.expect("kw", "all")
            rhs = self.parse_select()
            q = ("union_all", q, rhs)
        return q

    def parse_select(self):
        self.expect("kw", "select")
        distinct = bool(self.accept("kw", "distinct"))
        projections = [self.parse_projection()]
        while self.accept("op", ","):
            projections.append(self.parse_projection())
        self.expect("kw", "from")
        table = self.parse_table_ref()
        joins = []
        while True:
            how = "inner"
            if self.accept("kw", "inner"):
                self.expect("kw", "join")
            elif self.accept("kw", "left"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                how = "left"
            elif self.accept("kw", "right"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                how = "right"
            elif self.accept("kw", "join"):
                pass
            else:
                break
            other = self.parse_table_ref()
            self.expect("kw", "on")
            cond = self.parse_expr()
            joins.append((how, other, cond))
        where = None
        if self.accept("kw", "where"):
            where = self.parse_expr()
        group_by = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by.append(self.parse_expr())
            while self.accept("op", ","):
                group_by.append(self.parse_expr())
        having = None
        if self.accept("kw", "having"):
            having = self.parse_expr()
        return (
            "select", projections, table, joins, where, group_by, having,
            distinct,
        )

    def parse_projection(self):
        if self.peek() == ("op", "*"):
            self.next()
            return ("star", None)
        e = self.parse_expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("ident")
        elif self.peek()[0] == "ident":
            alias = self.next()[1]
        return ("expr", e, alias)

    def parse_table_ref(self):
        name = self.expect("ident")
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("ident")
        elif self.peek()[0] == "ident":
            alias = self.next()[1]
        return (name, alias)

    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        e = self.parse_and()
        while self.accept("kw", "or"):
            e = ("or", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.accept("kw", "and"):
            e = ("and", e, self.parse_not())
        return e

    def parse_not(self):
        if self.accept("kw", "not"):
            return ("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        e = self.parse_add()
        k, v = self.peek()
        if k == "op" and v in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            return ("cmp", v, e, self.parse_add())
        return e

    def parse_add(self):
        e = self.parse_mul()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                e = ("arith", v, e, self.parse_mul())
            else:
                return e

    def parse_mul(self):
        e = self.parse_atom()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/", "%"):
                self.next()
                e = ("arith", v, e, self.parse_atom())
            else:
                return e

    def parse_atom(self):
        k, v = self.peek()
        if k == "op" and v == "(":
            self.next()
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if k == "num":
            self.next()
            return ("const", float(v) if "." in v else int(v))
        if k == "str":
            self.next()
            return ("const", v[1:-1])
        if k == "kw" and v in ("null", "true", "false"):
            self.next()
            return ("const", {"null": None, "true": True, "false": False}[v])
        if k == "ident":
            name = self.next()[1]
            if self.peek() == ("op", "("):  # function call
                self.next()
                if name.lower() == "count" and self.peek() == ("op", "*"):
                    self.next()
                    self.expect("op", ")")
                    return ("agg", "count", None)
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
                if name.lower() in _AGGREGATES:
                    return ("agg", name.lower(), args[0] if args else None)
                return ("fn", name.lower(), args)
            if self.peek() == ("op", "."):
                self.next()
                col = self.expect("ident")
                return ("col", name, col)
            return ("col", None, name)
        raise ValueError(f"SQL: unexpected token {self.peek()!r}")


def _has_agg(node) -> bool:
    if not isinstance(node, tuple):
        return False
    if node[0] == "agg":
        return True
    return any(_has_agg(c) for c in node[1:] if isinstance(c, tuple))


class _Translator:
    def __init__(self, tables: dict[str, Any]):
        self.tables = tables

    def run(self, node):
        kind = node[0]
        if kind == "union_all":
            import pathway_tpu_torch as pw

            return pw.Table.concat_reindex(self.run(node[1]), self.run(node[2]))
        return self.select(node)

    def _resolve_col(self, scope, tab, col):
        if tab is not None:
            table = scope.get(tab)
            if table is None:
                raise KeyError(f"SQL: unknown table alias {tab!r}")
            return table[col]
        for table in scope.values():
            if col in table.column_names():
                return table[col]
        raise KeyError(f"SQL: unknown column {col!r}")

    def to_expr(self, node, scope, agg_ctx=None):
        kind = node[0]
        if kind == "const":
            return expr_mod.smart_coerce(node[1])
        if kind == "col":
            return self._resolve_col(scope, node[1], node[2])
        if kind == "cmp":
            _, sym, l, r = node
            le = self.to_expr(l, scope, agg_ctx)
            re_ = self.to_expr(r, scope, agg_ctx)
            if sym == "=":
                return le == re_
            if sym in ("<>", "!="):
                return le != re_
            return {"<": le < re_, "<=": le <= re_, ">": le > re_, ">=": le >= re_}[sym]
        if kind == "arith":
            _, sym, l, r = node
            le = self.to_expr(l, scope, agg_ctx)
            re_ = self.to_expr(r, scope, agg_ctx)
            return {
                "+": le + re_, "-": le - re_, "*": le * re_,
                "/": le / re_, "%": le % re_,
            }[sym]
        if kind == "and":
            return self.to_expr(node[1], scope, agg_ctx) & self.to_expr(node[2], scope, agg_ctx)
        if kind == "or":
            return self.to_expr(node[1], scope, agg_ctx) | self.to_expr(node[2], scope, agg_ctx)
        if kind == "not":
            return ~self.to_expr(node[1], scope, agg_ctx)
        if kind == "agg":
            from pathway_tpu_torch.internals import reducers

            _, name, arg = node
            if name == "count":
                return reducers.count()
            arg_e = self.to_expr(arg, scope)
            return {
                "sum": reducers.sum, "min": reducers.min,
                "max": reducers.max, "avg": reducers.avg,
            }[name](arg_e)
        if kind == "fn":
            _, name, args = node
            exprs = [self.to_expr(a, scope, agg_ctx) for a in args]
            if name == "coalesce":
                return coalesce(*exprs)
            if name == "abs":
                return if_else(exprs[0] < 0, -exprs[0], exprs[0])
            raise ValueError(f"SQL: unsupported function {name!r}")
        raise ValueError(f"SQL: cannot translate {node!r}")

    def select(self, node):
        (_, projections, (tname, talias), joins, where, group_by, having,
         distinct) = node
        base = self.tables[tname]
        scope = {tname: base}
        if talias:
            scope[talias] = base
        current = base
        for how, (oname, oalias), cond in joins:
            other = self.tables[oname]
            scope[oname] = other
            if oalias:
                scope[oalias] = other
            cond_e = self.to_expr(cond, scope)
            joined = current.join(other, cond_e, how=how)
            # materialize join as a table carrying all columns of both sides
            cols = {}
            for t in (current, other):
                for c in t.column_names():
                    if c not in cols:
                        cols[c] = t[c]
            current = joined.select(**cols)
            # aliases now refer to the materialized join where possible
            scope = {k: current for k in scope}
            scope["__current__"] = current
        scope_final = {"__current__": current, **{
            k: (current if set(v.column_names()) <= set(current.column_names()) else v)
            for k, v in scope.items() if k != "__current__"
        }}

        if where is not None:
            current = current.filter(self.to_expr(where, scope_final))
            scope_final = {k: current for k in scope_final}

        has_aggs = group_by or any(
            _has_agg(p[1]) for p in projections if p[0] == "expr"
        )
        if has_aggs:
            group_exprs = [self.to_expr(g, scope_final) for g in group_by]
            grouped = current.groupby(*group_exprs)
            out_cols = {}
            for i, p in enumerate(projections):
                if p[0] == "star":
                    raise ValueError("SQL: SELECT * not allowed with GROUP BY")
                _, e, alias = p
                name = alias or _default_name(e, i)
                out_cols[name] = self.to_expr(e, scope_final)
            if having is not None:
                out_cols["_pw_having"] = self.to_expr(having, scope_final)
            result = grouped.reduce(**out_cols)
            if having is not None:
                result = result.filter(result["_pw_having"]).without("_pw_having")
            return result

        out_cols = {}
        for i, p in enumerate(projections):
            if p[0] == "star":
                for c in current.column_names():
                    out_cols[c] = current[c]
                continue
            _, e, alias = p
            name = alias or _default_name(e, i)
            out_cols[name] = self.to_expr(e, scope_final)
        result = current.select(**out_cols)
        if distinct:
            cols = result.column_names()
            result = result.groupby(*[result[c] for c in cols]).reduce(
                *[result[c] for c in cols]
            )
        return result


def _default_name(e, i: int) -> str:
    if isinstance(e, tuple) and e[0] == "col":
        return e[2]
    if isinstance(e, tuple) and e[0] == "agg":
        return e[1]
    return f"col_{i}"


def sql(query: str, **tables) -> Any:
    """Translate a SQL query over the given tables (reference: pw.sql,
    internals/sql.py)."""
    ast = _Parser(_tokenize(query)).parse_query()
    return _Translator(tables).run(ast)
