"""SQL lexer + recursive-descent parser producing a lightweight AST.

AST nodes are plain tuples/objects lowered by lowering.py; the grammar is
the pragmatic analytics subset (see package docstring). Errors carry the
offending token position so users get actionable messages.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

__all__ = ["parse", "SqlError", "Select", "TableRef", "SubqueryRef",
           "Join", "OrderItem"]


class SqlError(ValueError):
    pass


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"(?:[^"]|"")*"|`[^`]*`)
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|>=|<=|\|\||[(),.*+\-/%<>=;])
""", re.VERBOSE)

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order",
    "limit", "join", "inner", "left", "right", "full", "outer", "cross",
    "semi", "anti", "on", "using", "as", "and", "or", "not", "in", "is",
    "null", "like", "between", "case", "when", "then", "else", "end",
    "cast", "union", "all", "with", "asc", "desc", "nulls", "first", "last",
    "date", "timestamp", "interval", "true", "false", "exists",
    "over", "partition", "rows", "range", "unbounded", "preceding",
    "following", "current", "row",
    "update", "delete", "merge", "into", "set", "values", "insert",
    "matched", "then",
    "create", "table", "drop", "show", "tables", "location",
    "if", "partitioned", "intersect", "except", "minus",
}


#: keywords that remain legal identifiers (Spark keeps these
#: non-reserved): accepted anywhere a plain identifier is expected
SOFT_IDS = frozenset({
    "left", "right", "rows", "row", "range", "current", "partition",
    "unbounded", "preceding", "following", "over", "first", "last",
    "date", "timestamp", "update", "delete", "insert", "merge", "into",
    "set", "values", "matched",
    "create", "table", "drop", "show", "tables", "location", "if",
    "partitioned", "intersect", "except", "minus",
})


class _Tok:
    __slots__ = ("kind", "val", "pos")

    def __init__(self, kind, val, pos):
        self.kind, self.val, self.pos = kind, val, pos

    def __repr__(self):
        return f"{self.kind}:{self.val}"


def _lex(text: str) -> List[_Tok]:
    out, i = [], 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise SqlError(f"unexpected character {text[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        v = m.group()
        if kind == "id":
            low = v.lower()
            if low in _KEYWORDS:
                out.append(_Tok("kw", low, m.start()))
            else:
                out.append(_Tok("id", v, m.start()))
        elif kind == "qid":
            out.append(_Tok("id", v[1:-1].replace('""', '"'), m.start()))
        elif kind == "str":
            out.append(_Tok("str", v[1:-1].replace("''", "'"), m.start()))
        elif kind == "num":
            out.append(_Tok("num", v, m.start()))
        else:
            out.append(_Tok("op", v, m.start()))
    out.append(_Tok("eof", "", len(text)))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class TableRef:
    def __init__(self, name: str, alias: Optional[str]):
        self.name, self.alias = name, alias


class SubqueryRef:
    def __init__(self, select: "Select", alias: Optional[str]):
        self.select, self.alias = select, alias


class Join:
    def __init__(self, kind: str, ref, on, using):
        self.kind, self.ref, self.on, self.using = kind, ref, on, using


class OrderItem:
    def __init__(self, expr, ascending: bool, nulls_first: Optional[bool]):
        self.expr, self.ascending, self.nulls_first = (expr, ascending,
                                                       nulls_first)


class UpdateStmt:
    def __init__(self, table, assignments, where):
        self.table = table              # TableRef
        self.assignments = assignments  # [(col_name, expr_ast)]
        self.where = where


class DeleteStmt:
    def __init__(self, table, where):
        self.table = table
        self.where = where


class MergeStmt:
    def __init__(self, target, source, on, clauses):
        self.target = target            # TableRef
        self.source = source            # TableRef | SubqueryRef
        self.on = on
        #: clauses: ("update", [(col, expr)]) | ("delete",)
        #:        | ("insert", [cols], [exprs]) | ("insert_star",)
        self.clauses = clauses


class CreateTableStmt:
    """CREATE TABLE [IF NOT EXISTS] name [USING fmt]
    [PARTITIONED BY (c, ...)] [LOCATION 'path'] [AS select]
    (ref GpuDeltaCatalogBase StagedTable / GpuCreateDataSourceTableAsSelectCommand)."""

    def __init__(self, name, format, location, partition_by, select,
                 if_not_exists):
        self.name = name
        self.format = format
        self.location = location
        self.partition_by = partition_by
        self.select = select
        self.if_not_exists = if_not_exists


class DropTableStmt:
    def __init__(self, name, if_exists):
        self.name = name
        self.if_exists = if_exists


class ShowTablesStmt:
    def __init__(self, db):
        self.db = db


class Select:
    def __init__(self):
        self.ctes: List[Tuple[str, "Select"]] = []
        self.distinct = False
        self.items = []            # list of (expr_ast, alias | None)
        self.from_ref = None       # TableRef | SubqueryRef | None
        self.joins: List[Join] = []
        self.where = None
        self.group_by = []
        self.having = None
        self.order_by: List[OrderItem] = []
        self.limit = None
        self.union_with = None  # (op, "all"/"distinct", Select)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    # -- token helpers ----------------------------------------------------
    def peek(self, k=0) -> _Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, val=None) -> Optional[_Tok]:
        t = self.peek()
        if t.kind == kind and (val is None or t.val == val):
            return self.next()
        return None

    def expect(self, kind, val=None) -> _Tok:
        t = self.accept(kind, val)
        if t is None:
            got = self.peek()
            raise SqlError(f"expected {val or kind}, got "
                           f"{got.val!r} at {got.pos}")
        return t

    def expect_ident(self) -> str:
        """An identifier, allowing non-reserved (soft) keywords."""
        t = self.peek()
        if t.kind == "id" or (t.kind == "kw" and t.val in SOFT_IDS):
            return self.next().val
        raise SqlError(f"expected identifier, got {t.val!r} at {t.pos}")

    def at_kw(self, *vals) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.val in vals

    # -- statements -------------------------------------------------------
    def parse_statement(self):
        if self.at_kw("update"):
            stmt = self._parse_update()
        elif self.at_kw("delete"):
            stmt = self._parse_delete()
        elif self.at_kw("merge"):
            stmt = self._parse_merge()
        elif self.at_kw("create"):
            stmt = self._parse_create_table()
        elif self.at_kw("drop"):
            stmt = self._parse_drop_table()
        elif self.at_kw("show"):
            stmt = self._parse_show_tables()
        else:
            stmt = self.parse_query()
        self.accept("op", ";")
        self.expect("eof")
        return stmt

    # -- catalog DDL (ref GpuDeltaCatalogBase / catalog.py) ---------------
    def _dotted_name(self) -> str:
        name = self.expect_ident()
        while self.peek().kind == "op" and self.peek().val == ".":
            self.next()
            name += "." + self.expect_ident()
        return name

    def _parse_create_table(self) -> "CreateTableStmt":
        self.expect("kw", "create")
        self.expect("kw", "table")
        if_not_exists = False
        if self.accept("kw", "if"):
            self.expect("kw", "not")
            self.expect("kw", "exists")
            if_not_exists = True
        name = self._dotted_name()
        fmt = "delta"
        if self.accept("kw", "using"):
            fmt = self.expect_ident()
        partition_by = None
        if self.accept("kw", "partitioned"):
            self.expect("kw", "by")
            self.expect("op", "(")
            partition_by = [self.expect_ident()]
            while self.accept("op", ","):
                partition_by.append(self.expect_ident())
            self.expect("op", ")")
        location = None
        if self.accept("kw", "location"):
            location = self.expect("str").val
        select = None
        if self.accept("kw", "as"):
            select = self.parse_query()
        return CreateTableStmt(name, fmt, location, partition_by, select,
                               if_not_exists)

    def _parse_drop_table(self) -> "DropTableStmt":
        self.expect("kw", "drop")
        self.expect("kw", "table")
        if_exists = False
        if self.accept("kw", "if"):
            self.expect("kw", "exists")
            if_exists = True
        return DropTableStmt(self._dotted_name(), if_exists)

    def _parse_show_tables(self) -> "ShowTablesStmt":
        self.expect("kw", "show")
        self.expect("kw", "tables")
        db = "default"
        if self.accept("kw", "in") or self.accept("kw", "from"):
            db = self.expect_ident()
        return ShowTablesStmt(db)

    # -- DML (Delta tables; ref GpuUpdateCommand / GpuDeleteCommand /
    # GpuMergeIntoCommand) ------------------------------------------------
    def _parse_update(self) -> UpdateStmt:
        self.expect("kw", "update")
        table = self.parse_table_ref()
        self.expect("kw", "set")
        assignments = []
        while True:
            col = self.expect_ident()
            self.expect("op", "=")
            assignments.append((col, self.parse_expr()))
            if not self.accept("op", ","):
                break
        where = self.parse_expr() if self.accept("kw", "where") else None
        return UpdateStmt(table, assignments, where)

    def _parse_delete(self) -> DeleteStmt:
        self.expect("kw", "delete")
        self.expect("kw", "from")
        table = self.parse_table_ref()
        where = self.parse_expr() if self.accept("kw", "where") else None
        return DeleteStmt(table, where)

    def _parse_merge(self) -> MergeStmt:
        self.expect("kw", "merge")
        self.expect("kw", "into")
        target = self.parse_table_ref()
        self.expect("kw", "using")
        source = self.parse_table_ref()
        self.expect("kw", "on")
        on = self.parse_expr()
        clauses = []
        while self.accept("kw", "when"):
            matched = True
            if self.accept("kw", "not"):
                matched = False
            self.expect("kw", "matched")
            self.expect("kw", "then")
            if matched and self.accept("kw", "update"):
                self.expect("kw", "set")
                assigns = []
                while True:
                    col = self.expect_ident()
                    self.expect("op", "=")
                    assigns.append((col, self.parse_expr()))
                    if not self.accept("op", ","):
                        break
                clauses.append(("update", assigns))
            elif matched and self.accept("kw", "delete"):
                clauses.append(("delete",))
            elif not matched and self.accept("kw", "insert"):
                if self.accept("op", "*"):
                    clauses.append(("insert_star",))
                    continue
                self.expect("op", "(")
                cols = [self.expect_ident()]
                while self.accept("op", ","):
                    cols.append(self.expect_ident())
                self.expect("op", ")")
                self.expect("kw", "values")
                self.expect("op", "(")
                vals = [self.parse_expr()]
                while self.accept("op", ","):
                    vals.append(self.parse_expr())
                self.expect("op", ")")
                clauses.append(("insert", cols, vals))
            else:
                t = self.peek()
                raise SqlError(f"bad MERGE clause at {t.pos}")
        if not clauses:
            raise SqlError("MERGE requires at least one WHEN clause")
        return MergeStmt(target, source, on, clauses)

    def parse_query(self) -> Select:
        ctes = []
        if self.accept("kw", "with"):
            while True:
                name = self.expect_ident()
                self.expect("kw", "as")
                self.expect("op", "(")
                sub = self.parse_query()
                self.expect("op", ")")
                ctes.append((name, sub))
                if not self.accept("op", ","):
                    break
        def setop_node(op, mode, left, right):
            node = Select()
            node.union_with = (op, mode, right)
            node.from_ref = SubqueryRef(left, None)
            return node

        def parse_term():
            # INTERSECT binds tighter than UNION/EXCEPT (SQL standard)
            t = self.parse_select()
            while self.at_kw("intersect"):
                self.next()
                all_ = bool(self.accept("kw", "all"))
                if not all_:
                    self.accept("kw", "distinct")   # optional explicit
                t = setop_node("intersect",
                               "all" if all_ else "distinct",
                               t, self.parse_select())
            return t

        sel = parse_term()
        sel.ctes = ctes
        while self.at_kw("union", "except", "minus"):
            op = self.next().val
            if op == "minus":
                op = "except"           # Spark alias
            all_ = bool(self.accept("kw", "all"))
            if not all_:
                self.accept("kw", "distinct")       # optional explicit
            sel = setop_node(op, "all" if all_ else "distinct",
                             sel, parse_term())
        # ORDER BY / LIMIT may follow a union chain
        if self.at_kw("order"):
            self._parse_order_by(sel)
        if self.accept("kw", "limit"):
            sel.limit = int(self.expect("num").val)
        return sel

    def parse_select(self) -> Select:
        self.expect("kw", "select")
        sel = Select()
        sel.distinct = bool(self.accept("kw", "distinct"))
        while True:
            e = self.parse_expr()
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect_ident()
            elif self.peek().kind == "id":
                alias = self.next().val
            sel.items.append((e, alias))
            if not self.accept("op", ","):
                break
        if self.accept("kw", "from"):
            sel.from_ref = self.parse_table_ref()
            while True:
                kind = self._maybe_join_kind()
                if kind is None:
                    if self.accept("op", ","):   # implicit cross join
                        kind = "cross"
                    else:
                        break
                ref = self.parse_table_ref()
                on = using = None
                if kind != "cross":
                    if self.accept("kw", "on"):
                        on = self.parse_expr()
                    elif self.accept("kw", "using"):
                        self.expect("op", "(")
                        using = [self.expect_ident()]
                        while self.accept("op", ","):
                            using.append(self.expect_ident())
                        self.expect("op", ")")
                sel.joins.append(Join(kind, ref, on, using))
        if self.accept("kw", "where"):
            sel.where = self.parse_expr()
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            sel.group_by.append(self.parse_expr())
            while self.accept("op", ","):
                sel.group_by.append(self.parse_expr())
        if self.accept("kw", "having"):
            sel.having = self.parse_expr()
        if self.at_kw("order"):
            self._parse_order_by(sel)
        if self.accept("kw", "limit"):
            sel.limit = int(self.expect("num").val)
        return sel

    def _parse_order_by(self, sel: Select):
        self.expect("kw", "order")
        self.expect("kw", "by")
        while True:
            e = self.parse_expr()
            asc = True
            if self.accept("kw", "desc"):
                asc = False
            else:
                self.accept("kw", "asc")
            nf = None
            if self.accept("kw", "nulls"):
                nf = bool(self.accept("kw", "first"))
                if nf is False:
                    self.expect("kw", "last")
            sel.order_by.append(OrderItem(e, asc, nf))
            if not self.accept("op", ","):
                break

    def _maybe_join_kind(self) -> Optional[str]:
        t = self.peek()
        if t.kind != "kw":
            return None
        kinds = {"inner": "inner", "left": "left", "right": "right",
                 "full": "full", "cross": "cross"}
        if t.val == "join":
            self.next()
            return "inner"
        if t.val in kinds:
            kind = kinds[t.val]
            self.next()
            if kind == "left" and self.at_kw("semi", "anti"):
                kind = "left" + self.next().val      # leftsemi / leftanti
            else:
                self.accept("kw", "outer")
            self.expect("kw", "join")
            return kind
        return None

    def parse_table_ref(self):
        if self.accept("op", "("):
            sub = self.parse_query()
            self.expect("op", ")")
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect_ident()
            elif self.peek().kind == "id":
                alias = self.next().val
            return SubqueryRef(sub, alias)
        name = self._dotted_name()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect_ident()
        elif self.peek().kind == "id":
            alias = self.next().val
        return TableRef(name, alias)

    # -- expressions (precedence climbing) --------------------------------
    def parse_expr(self):
        return self._or()

    def _or(self):
        e = self._and()
        while self.accept("kw", "or"):
            e = ("binop", "or", e, self._and())
        return e

    def _and(self):
        e = self._not()
        while self.accept("kw", "and"):
            e = ("binop", "and", e, self._not())
        return e

    def _not(self):
        if self.accept("kw", "not"):
            return ("unary", "not", self._not())
        return self._predicate()

    def _predicate(self):
        e = self._additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.val in ("=", "<>", "!=", "<", "<=", ">",
                                            ">="):
                self.next()
                e = ("binop", t.val, e, self._additive())
                continue
            if t.kind == "kw" and t.val == "is":
                self.next()
                neg = bool(self.accept("kw", "not"))
                self.expect("kw", "null")
                e = ("isnull", e, neg)
                continue
            neg = False
            if t.kind == "kw" and t.val == "not" \
                    and self.peek(1).kind == "kw" \
                    and self.peek(1).val in ("in", "like", "between"):
                self.next()
                neg = True
                t = self.peek()
            if t.kind == "kw" and t.val == "in":
                self.next()
                self.expect("op", "(")
                vals = [self.parse_expr()]
                while self.accept("op", ","):
                    vals.append(self.parse_expr())
                self.expect("op", ")")
                e = ("in", e, vals, neg)
                continue
            if t.kind == "kw" and t.val == "like":
                self.next()
                pat = self.expect("str").val
                e = ("like", e, pat, neg)
                continue
            if t.kind == "kw" and t.val == "between":
                self.next()
                lo = self._additive()
                self.expect("kw", "and")
                hi = self._additive()
                e = ("between", e, lo, hi, neg)
                continue
            return e

    def _additive(self):
        e = self._multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.val in ("+", "-", "||"):
                self.next()
                e = ("binop", t.val, e, self._multiplicative())
            else:
                return e

    def _multiplicative(self):
        e = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.val in ("*", "/", "%"):
                self.next()
                e = ("binop", t.val, e, self._unary())
            else:
                return e

    def _unary(self):
        if self.accept("op", "-"):
            return ("unary", "-", self._unary())
        if self.accept("op", "+"):
            return self._unary()
        return self._primary()

    def _primary(self):
        t = self.peek()
        if t.kind == "op" and t.val == "(":
            self.next()
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "num":
            self.next()
            v = t.val
            if "." in v or "e" in v.lower():
                return ("lit", float(v))
            return ("lit", int(v))
        if t.kind == "str":
            self.next()
            return ("lit", t.val)
        if t.kind == "kw":
            if t.val in ("true", "false"):
                self.next()
                return ("lit", t.val == "true")
            if t.val == "null":
                self.next()
                return ("lit", None)
            if t.val == "date":
                if self.peek(1).kind == "str":
                    self.next()
                    return ("datelit", self.next().val)
            if t.val == "timestamp":
                if self.peek(1).kind == "str":
                    self.next()
                    return ("tslit", self.next().val)
            if t.val == "interval":
                self.next()
                n = self.next()
                if n.kind == "str":
                    n = n.val
                elif n.kind == "num":
                    n = n.val
                else:
                    raise SqlError(f"bad interval at {t.pos}")
                unit = self.expect_ident().lower().rstrip("s")
                return ("interval", int(n), unit)
            if t.val == "case":
                return self._case()
            if t.val == "cast":
                self.next()
                self.expect("op", "(")
                e = self.parse_expr()
                self.expect("kw", "as")
                ty = self.next().val
                # e.g. decimal(10, 2)
                if self.accept("op", "("):
                    args = [self.expect("num").val]
                    while self.accept("op", ","):
                        args.append(self.expect("num").val)
                    self.expect("op", ")")
                    ty = f"{ty}({','.join(args)})"
                self.expect("op", ")")
                return ("cast", e, ty)
        if t.kind == "op" and t.val == "*":
            self.next()
            return ("star",)
        if t.kind == "id" or (t.kind == "kw" and t.val in SOFT_IDS):
            name = self.next().val
            if self.accept("op", "("):       # function call
                distinct = bool(self.accept("kw", "distinct"))
                args = []
                if self.accept("op", "*"):
                    args.append(("star",))
                elif not (self.peek().kind == "op"
                          and self.peek().val == ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
                fn_node = ("fn", name.lower(), args, distinct)
                if self.accept("kw", "over"):
                    return self._over(fn_node)
                return fn_node
            parts = [name]
            while self.peek().kind == "op" and self.peek().val == "." \
                    and (self.peek(1).kind == "id"
                         or (self.peek(1).kind == "kw"
                             and self.peek(1).val in SOFT_IDS)):
                self.next()
                nxt = self.next()
                if nxt.val == "*":
                    return ("qstar", parts[0])
                parts.append(nxt.val)
            if self.peek().kind == "op" and self.peek().val == "." \
                    and self.peek(1).kind == "op" \
                    and self.peek(1).val == "*":
                self.next(); self.next()
                return ("qstar", parts[0])
            return ("col", tuple(parts))
        raise SqlError(f"unexpected token {t.val!r} at {t.pos}")

    def _over(self, fn_node):
        """OVER ([PARTITION BY ...] [ORDER BY ...] [ROWS BETWEEN ...])."""
        self.expect("op", "(")
        parts, orders, frame = [], [], None
        if self.accept("kw", "partition"):
            self.expect("kw", "by")
            parts.append(self.parse_expr())
            while self.accept("op", ","):
                parts.append(self.parse_expr())
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept("kw", "desc"):
                    asc = False
                else:
                    self.accept("kw", "asc")
                nf = None
                if self.accept("kw", "nulls"):
                    nf = bool(self.accept("kw", "first"))
                    if nf is False:
                        self.expect("kw", "last")
                orders.append((e, asc, nf))
                if not self.accept("op", ","):
                    break
        if self.at_kw("rows", "range"):
            kind = self.next().val
            self.expect("kw", "between")
            lo = self._frame_bound()
            self.expect("kw", "and")
            hi = self._frame_bound()
            frame = (kind, lo, hi)
        self.expect("op", ")")
        return ("window", fn_node, parts, orders, frame)

    def _frame_bound(self):
        if self.accept("kw", "unbounded"):
            if not self.accept("kw", "preceding"):
                self.expect("kw", "following")
            return None
        if self.accept("kw", "current"):
            self.expect("kw", "row")
            return 0
        n = int(self.expect("num").val)
        if self.accept("kw", "preceding"):
            return -n
        self.expect("kw", "following")
        return n

    def _case(self):
        self.expect("kw", "case")
        # simple CASE expr WHEN v ... or searched CASE WHEN cond ...
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        branches = []
        while self.accept("kw", "when"):
            cond = self.parse_expr()
            self.expect("kw", "then")
            val = self.parse_expr()
            branches.append((cond, val))
        els = None
        if self.accept("kw", "else"):
            els = self.parse_expr()
        self.expect("kw", "end")
        if operand is not None:
            branches = [(("binop", "=", operand, c), v) for c, v in branches]
        return ("case", branches, els)


def parse(text: str) -> Select:
    return _Parser(_lex(text)).parse_statement()
