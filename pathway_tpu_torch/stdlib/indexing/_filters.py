"""Metadata filter expressions — JMESPath subset.

The reference filters index results with JMESPath + a custom `globmatch`
function (src/external_integration/mod.rs IndexDerivedImpl;
python side builds strings like ``contains(path, 'x') && globmatch('*.pdf',
path)`` in xpacks/llm/vector_store.py:337 merge_filters). No JMESPath
library is vendored here; this module implements the subset those call
sites use: dotted paths, literals, ==/!=/<,<=,>,>=, &&, ||, !, parentheses,
and the functions contains/starts_with/ends_with/globmatch.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Callable

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<op>&&|\|\||==|!=|<=|>=|<|>|!|\(|\)|,)"
    r"|(?P<str>'[^']*'|\"[^\"]*\")"
    r"|(?P<num>-?\d+(?:\.\d+)?)"
    r"|(?P<lit>`[^`]*`)"
    r"|(?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*))"
)


class FilterError(ValueError):
    pass


def _tokenize(s: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            if s[pos:].strip() == "":
                break
            raise FilterError(f"bad filter syntax at {s[pos:]!r}")
        pos = m.end()
        for kind in ("op", "str", "num", "lit", "ident"):
            tok = m.group(kind)
            if tok is not None:
                out.append((kind, tok))
                break
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.pos += 1
        return tok

    def expect(self, value: str):
        kind, tok = self.next()
        if tok != value:
            raise FilterError(f"expected {value!r}, got {tok!r}")

    def parse(self):
        node = self.or_expr()
        if self.pos != len(self.tokens):
            raise FilterError(f"trailing tokens: {self.tokens[self.pos:]}")
        return node

    def or_expr(self):
        node = self.and_expr()
        while self.peek()[1] == "||":
            self.next()
            rhs = self.and_expr()
            node = ("or", node, rhs)
        return node

    def and_expr(self):
        node = self.unary()
        while self.peek()[1] == "&&":
            self.next()
            rhs = self.unary()
            node = ("and", node, rhs)
        return node

    def unary(self):
        if self.peek()[1] == "!":
            self.next()
            return ("not", self.unary())
        return self.comparison()

    def comparison(self):
        left = self.primary()
        kind, tok = self.peek()
        if tok in ("==", "!=", "<", "<=", ">", ">="):
            self.next()
            right = self.primary()
            return ("cmp", tok, left, right)
        return left

    def primary(self):
        kind, tok = self.next()
        if tok == "(":
            node = self.or_expr()
            self.expect(")")
            return node
        if kind == "str":
            return ("const", tok[1:-1])
        if kind == "num":
            return ("const", float(tok) if "." in tok else int(tok))
        if kind == "lit":
            import json

            return ("const", json.loads(tok[1:-1]))
        if kind == "ident":
            if tok in ("true", "false"):
                return ("const", tok == "true")
            if tok == "null":
                return ("const", None)
            if self.peek()[1] == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.or_expr())
                    while self.peek()[1] == ",":
                        self.next()
                        args.append(self.or_expr())
                self.expect(")")
                return ("call", tok, args)
            return ("path", tok.split("."))
        raise FilterError(f"unexpected token {tok!r}")


def _lookup(doc: Any, path: list[str]) -> Any:
    cur = doc
    for part in path:
        if hasattr(cur, "value"):  # Json wrapper
            cur = cur.value
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    if hasattr(cur, "value"):
        cur = cur.value
    return cur


def _evaluate(node, doc: Any) -> Any:
    op = node[0]
    if op == "const":
        return node[1]
    if op == "path":
        return _lookup(doc, node[1])
    if op == "and":
        return bool(_evaluate(node[1], doc)) and bool(_evaluate(node[2], doc))
    if op == "or":
        return bool(_evaluate(node[1], doc)) or bool(_evaluate(node[2], doc))
    if op == "not":
        return not bool(_evaluate(node[1], doc))
    if op == "cmp":
        _, sym, l, r = node
        lv, rv = _evaluate(l, doc), _evaluate(r, doc)
        try:
            if sym == "==":
                return lv == rv
            if sym == "!=":
                return lv != rv
            if lv is None or rv is None:
                return False
            if sym == "<":
                return lv < rv
            if sym == "<=":
                return lv <= rv
            if sym == ">":
                return lv > rv
            if sym == ">=":
                return lv >= rv
        except TypeError:
            return False
    if op == "call":
        _, name, args = node
        vals = [_evaluate(a, doc) for a in args]
        if name == "contains":
            hay, needle = vals
            if hay is None:
                return False
            return needle in hay
        if name == "starts_with":
            return vals[0] is not None and str(vals[0]).startswith(str(vals[1]))
        if name == "ends_with":
            return vals[0] is not None and str(vals[0]).endswith(str(vals[1]))
        if name == "globmatch":
            pattern, value = vals
            if value is None:
                return False
            return fnmatch.fnmatch(str(value), str(pattern))
        raise FilterError(f"unknown filter function {name!r}")
    raise FilterError(f"bad node {node!r}")


def compile_filter(expression: str | None) -> Callable[[Any], bool] | None:
    """Compile a JMESPath-subset filter into a predicate over a metadata
    dict (or Json wrapper). Returns None for empty filters."""
    if expression is None or str(expression).strip() == "":
        return None
    ast = _Parser(_tokenize(str(expression))).parse()

    def predicate(doc: Any) -> bool:
        if hasattr(doc, "value"):
            doc = doc.value
        return bool(_evaluate(ast, doc))

    return predicate
