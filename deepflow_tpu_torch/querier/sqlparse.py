"""SQL subset parser for the query engine.
Port copy of deepflow_tpu/querier/sqlparse.py.

The reference parses DeepFlow-SQL with sqlparser and walks the AST into
a ClickHouse view tree (clickhouse.go:1007-1423 TransSelect/TransWhere/
TransFrom/TransGroupBy). We target our own executor instead of CK SQL,
so the parser stops at a plain expression AST:

    SELECT expr [AS alias], ...
    FROM table
    [WHERE expr] [GROUP BY expr, ...] [ORDER BY expr [ASC|DESC], ...]
    [LIMIT n] [OFFSET n]

Expressions: identifiers (optionally quoted with `backticks`), int/float
/'string' literals, function calls, unary -/NOT, binary */%//, +-, com-
parisons, IN (...), AND, OR. Pratt precedence climbing, ~150 lines.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any


class SQLError(ValueError):
    pass


# -- AST --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ident:
    name: str


@dataclasses.dataclass(frozen=True)
class Literal:
    value: Any


@dataclasses.dataclass(frozen=True)
class Func:
    name: str  # lowercased
    args: tuple


@dataclasses.dataclass(frozen=True)
class BinOp:
    op: str
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class UnaryOp:
    op: str  # "-" | "not"
    operand: Any


@dataclasses.dataclass(frozen=True)
class InList:
    expr: Any
    values: tuple
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Any
    alias: str | None


@dataclasses.dataclass(frozen=True)
class Show:
    """SHOW tables | SHOW metrics FROM t | SHOW tags FROM t — the
    db_descriptions introspection statements (querier/engine/clickhouse
    ShowSqlParse handles `show tags/metrics from ...`)."""

    what: str  # "tables" | "metrics" | "tags"
    table: str | None


@dataclasses.dataclass(frozen=True)
class Query:
    select: tuple[SelectItem, ...]
    table: str
    where: Any | None
    group_by: tuple
    order_by: tuple  # of (expr, "asc"|"desc")
    limit: int | None
    offset: int
    having: Any | None = None


# -- lexer ------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
      (?P<num>\d+\.\d+|\.\d+|\d+)
    | (?P<str>'(?:[^'\\]|\\.)*')
    | (?P<qid>`[^`]+`)
    | (?P<id>[A-Za-z_][A-Za-z0-9_.]*)
    | (?P<op><>|!=|<=|>=|=|<|>|\(|\)|,|\*|/|%|\+|-)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "group", "order", "by", "limit", "offset",
    "as", "and", "or", "not", "in", "asc", "desc", "having", "show",
}


def _lex(text: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip():
                raise SQLError(f"bad token at: {text[pos:pos+20]!r}")
            break
        pos = m.end()
        if m.lastgroup == "num":
            out.append(("num", m.group("num")))
        elif m.lastgroup == "str":
            out.append(("str", m.group("str")[1:-1].replace("\\'", "'")))
        elif m.lastgroup == "qid":
            out.append(("id", m.group("qid")[1:-1]))
        elif m.lastgroup == "id":
            word = m.group("id")
            if word.lower() in _KEYWORDS:
                out.append(("kw", word.lower()))
            else:
                out.append(("id", word))
        else:
            out.append(("op", m.group("op")))
    out.append(("eof", ""))
    return out


# -- parser -----------------------------------------------------------------

_PRECEDENCE = {
    "or": 1,
    "and": 2,
    "=": 4, "!=": 4, "<>": 4, "<": 4, ">": 4, "<=": 4, ">=": 4, "in": 4,
    "+": 5, "-": 5,
    "*": 6, "/": 6, "%": 6,
}


class _Parser:
    def __init__(self, text: str):
        self.toks = _lex(text)
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, value=None):
        k, v = self.next()
        if k != kind or (value is not None and v != value):
            raise SQLError(f"expected {value or kind}, got {v!r}")
        return v

    def accept(self, kind, value=None):
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.i += 1
            return True
        return False

    # expressions ------------------------------------------------------
    def parse_expr(self, min_prec: int = 0):
        left = self._parse_unary()
        while True:
            k, v = self.peek()
            op = v if (k == "op" and v in _PRECEDENCE) else (
                v if (k == "kw" and v in ("and", "or", "in")) else None
            )
            negated = False
            if op is None and k == "kw" and v == "not":
                # NOT IN — decide before consuming anything, so a
                # precedence break leaves both tokens for the outer level
                nk, nv = self.toks[self.i + 1]
                if nk == "kw" and nv == "in":
                    op, negated = "in", True
                else:
                    break
            if op is None or _PRECEDENCE[op] < min_prec:
                break
            if negated:
                self.next()  # NOT
            self.next()
            if op == "in":
                self.expect("op", "(")
                vals = [self._parse_value()]
                while self.accept("op", ","):
                    vals.append(self._parse_value())
                self.expect("op", ")")
                left = InList(left, tuple(vals), negated)
                continue
            right = self.parse_expr(_PRECEDENCE[op] + 1)
            left = BinOp("!=" if op == "<>" else op, left, right)
        return left

    def _parse_value(self):
        k, v = self.next()
        if k == "num":
            return Literal(float(v) if "." in v else int(v))
        if k == "str":
            return Literal(v)
        raise SQLError(f"expected literal, got {v!r}")

    def _parse_unary(self):
        k, v = self.peek()
        if k == "op" and v == "-":
            self.next()
            return UnaryOp("-", self._parse_unary())
        if k == "kw" and v == "not":
            # SQL precedence: NOT binds looser than comparisons, so
            # `NOT a = 1` is NOT(a = 1) — parse the operand at the
            # precedence level just above AND
            self.next()
            return UnaryOp("not", self.parse_expr(_PRECEDENCE["and"] + 1))
        return self._parse_primary()

    def _parse_primary(self):
        k, v = self.next()
        if k == "num":
            return Literal(float(v) if "." in v else int(v))
        if k == "str":
            return Literal(v)
        if k == "op" and v == "(":
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if k == "op" and v == "*":
            return Ident("*")
        if k == "id":
            if self.accept("op", "("):
                args = []
                if not self.accept("op", ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                    self.expect("op", ")")
                return Func(v.lower(), tuple(args))
            return Ident(v)
        raise SQLError(f"unexpected token {v!r}")

    # statement --------------------------------------------------------
    def parse_query(self) -> Query | Show:
        if self.accept("kw", "show"):
            what = self.expect("id").lower()
            if what not in ("tables", "metrics", "tags"):
                raise SQLError(f"SHOW {what!r}: expected tables/metrics/tags")
            table = None
            if self.accept("kw", "from"):
                table = self.expect("id")
            if self.peek()[0] != "eof":
                raise SQLError(f"trailing input: {self.peek()[1]!r}")
            if what != "tables" and table is None:
                raise SQLError(f"SHOW {what} needs FROM <table>")
            if what == "tables" and table is not None:
                raise SQLError("SHOW tables takes no FROM clause")
            return Show(what, table)
        self.expect("kw", "select")
        items = [self._select_item()]
        while self.accept("op", ","):
            items.append(self._select_item())
        self.expect("kw", "from")
        table = self.expect("id")
        where = None
        if self.accept("kw", "where"):
            where = self.parse_expr()
        group_by: list = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by.append(self.parse_expr())
            while self.accept("op", ","):
                group_by.append(self.parse_expr())
        having = None
        if self.accept("kw", "having"):
            having = self.parse_expr()
        order_by: list = []
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                direction = "asc"
                if self.accept("kw", "desc"):
                    direction = "desc"
                elif self.accept("kw", "asc"):
                    pass
                order_by.append((e, direction))
                if not self.accept("op", ","):
                    break
        limit = None
        offset = 0
        if self.accept("kw", "limit"):
            limit = int(self.expect("num"))
        if self.accept("kw", "offset"):
            offset = int(self.expect("num"))
        if self.peek()[0] != "eof":
            raise SQLError(f"trailing input: {self.peek()[1]!r}")
        return Query(
            select=tuple(items),
            table=table,
            where=where,
            group_by=tuple(group_by),
            order_by=tuple(order_by),
            limit=limit,
            offset=offset,
            having=having,
        )

    def _select_item(self) -> SelectItem:
        e = self.parse_expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("id")
        return SelectItem(e, alias)


def parse(text: str) -> Query:
    return _Parser(text).parse_query()
