"""Lower the SQL AST onto the DataFrame API (port of
``spark_rapids_tpu/sql/lowering.py``).

Aggregation handling mirrors Spark's analyzer: aggregate calls anywhere in
SELECT/HAVING/ORDER BY are hoisted into the Aggregate node under generated
names, and the surrounding expression becomes a Project over the aggregate
output. GROUP BY accepts expressions, select aliases, and 1-based
ordinals.

Window calls (``f(...) OVER (...)``) are hoisted into one Window node
under generated names (``_hoist_windows``, the reference's): ROWS frames,
no RANGE frames and no DISTINCT inside OVER, and a window over an
aggregate only through a subquery, as in the reference.

The function tables name only what the port has. A function the
reference knows and the port does not yet have raises NotImplementedError
naming the slice that brings it (``_LATER``), as do DML and catalog
statements (slice 10); a name the reference does not know either stays
an "unknown function" SqlError. INTERSECT ALL / EXCEPT ALL lower onto
``intersect_all`` / ``except_all``. ``log(base, x)`` with two arguments
is Spark's logarithm to a base, where the reference's lowering takes the
log of its first argument (ROADMAP.md Queue C).

Numeric literals keep the reference's typing: an integer is an int (a
bigint past 2^31) and a number with a point or an exponent a double, where
Spark types ``0.05`` as DECIMAL(2,2) (ROADMAP.md Queue C). So a decimal
column beside ``1`` stays decimal (``1 - l_discount``), and beside
``0.05`` it compares as a double. ``CAST(x AS DECIMAL(p, s))`` casts to
that decimal, and a bare ``DECIMAL`` is DECIMAL(10,0), as in Spark.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..api import functions as F
from .parser import Join, OrderItem, Select, SqlError, SubqueryRef, TableRef

__all__ = ["lower_statement"]

_AGG_FNS = {
    "sum": F.sum, "count": F.count, "avg": F.avg, "mean": F.avg,
    "min": F.min, "max": F.max, "first": F.first, "last": F.last,
    "stddev": F.stddev, "stddev_samp": F.stddev,
    "stddev_pop": F.stddev_pop, "variance": F.var_samp,
    "var_samp": F.var_samp, "var_pop": F.var_pop,
}

_SCALAR_FNS = {
    "abs": F.abs, "sqrt": F.sqrt, "exp": F.exp, "ln": F.log, "log": F.log,
    "floor": F.floor, "ceil": F.ceil, "ceiling": F.ceil,
    "upper": F.upper, "ucase": F.upper, "lower": F.lower, "lcase": F.lower,
    "length": F.length, "char_length": F.length, "trim": F.trim,
    "ltrim": F.ltrim, "rtrim": F.rtrim, "reverse": F.reverse,
    "initcap": F.initcap, "year": F.year, "month": F.month,
    "day": F.dayofmonth, "dayofmonth": F.dayofmonth, "hour": F.hour,
    "minute": F.minute, "second": F.second, "quarter": F.quarter,
    "dayofweek": F.dayofweek, "dayofyear": F.dayofyear,
    "isnan": F.isnan, "isnull": F.isnull,
}

_VARARG_FNS = {"coalesce": F.coalesce, "concat": F.concat}

_STRINGS = "slice 7, strings, the rest (ROADMAP.md Queue A)"
_TIME_ZONES = ("the time-zone functions, which the reference runs on its "
               "host engine (ROADMAP.md Queue A, the host-only functions: "
               "queued with slice 13)")
#: functions of the reference's tables that arrive with a later slice
_LATER = {
    **{fn: _STRINGS for fn in ("parse_url",)},
    **{fn: _TIME_ZONES for fn in ("from_utc_timestamp",
                                  "to_utc_timestamp")},
}


def _is_agg(fn: str) -> bool:
    return fn in _AGG_FNS


def _int_lit(ast, fn: str) -> int:
    """An integer literal argument, negative ones included (the
    reference's lowering takes the ``-`` of ``substr(s, -3)`` for the
    position and fails)."""
    if isinstance(ast, tuple) and ast[0] == "unary" and ast[1] == "-":
        return -_int_lit(ast[2], fn)
    if isinstance(ast, tuple) and ast[0] == "lit" \
            and isinstance(ast[1], int) and not isinstance(ast[1], bool):
        return ast[1]
    raise SqlError(f"{fn}() takes integer literals after the string")


def _refuse(fn: str):
    raise NotImplementedError(f"{fn}() arrives with {_LATER[fn]}")


def _ast_key(ast) -> str:
    return repr(ast)


class _Lowerer:
    def __init__(self, session, views: Dict[str, object]):
        self.session = session
        self.views = dict(views)

    # ------------------------------------------------------------------
    def lower(self, sel: Select):
        for name, cte in sel.ctes:
            self.views[name.lower()] = self.lower(cte)
        if sel.union_with is not None:
            left = self._resolve_ref(sel.from_ref)
            op, mode, rhs = sel.union_with
            right = self.lower(rhs)
            if op == "union":
                df = left.union(right)
                if mode == "distinct":
                    df = df.distinct()
            elif op == "intersect":
                df = (left.intersect_all(right) if mode == "all"
                      else left.intersect(right))
            else:                       # EXCEPT / MINUS
                df = (left.except_all(right) if mode == "all"
                      else left.subtract(right))
            return self._order_limit(df, sel.order_by, sel.limit, {},
                                     df.columns)
        return self._lower_select(sel)

    # ------------------------------------------------------------------
    def _resolve_ref(self, ref):
        if ref is None:
            raise SqlError("SELECT without FROM is not supported")
        if isinstance(ref, SubqueryRef):
            return self.lower(ref.select)
        name = ref.name.lower()
        if name not in self.views:
            # the warehouse catalog, which the reference falls back to,
            # arrives with slice 10
            raise SqlError(f"table or view not found: {ref.name}")
        return self.views[name]

    def _lower_select(self, sel: Select):
        df = self._resolve_ref(sel.from_ref)
        # alias -> {original column name -> actual column name}: join
        # inputs whose names collide with columns already in the frame are
        # renamed before the join, and qualified references (t.k / r.k)
        # resolve through this map — otherwise both sides' k collapse to
        # one ambiguous name (Spark keeps attributes distinct by expr id)
        alias_cols = {}
        if isinstance(sel.from_ref, (TableRef, SubqueryRef)) \
                and sel.from_ref.alias:
            alias_cols[sel.from_ref.alias.lower()] = {c: c
                                                      for c in df.columns}
        elif isinstance(sel.from_ref, TableRef):
            alias_cols[sel.from_ref.name.lower()] = {c: c
                                                     for c in df.columns}

        # implicit joins (FROM a, b WHERE a.k = b.k): claim WHERE equality
        # conjuncts as join keys so the plan never materializes a true
        # cartesian product (Spark's planner does the same rewrite)
        conjuncts = _split_conjuncts(sel.where)
        for ji, j in enumerate(sel.joins):
            right = self._resolve_ref(j.ref)
            rname = (j.ref.alias or getattr(j.ref, "name", None))
            rmap = {c: c for c in right.columns}
            if j.using is None:
                taken = set(df.columns)
                collide = [c for c in right.columns if c in taken]
                if collide:
                    rmap = {c: (f"__j{ji}_{c}" if c in collide else c)
                            for c in right.columns}
                    right = right.select(*[
                        F.col(c).alias(rmap[c]) for c in right.columns])
            if rname:
                alias_cols[rname.lower()] = rmap
            if j.kind == "cross" and j.on is None and j.using is None \
                    and conjuncts:
                self._aliases = alias_cols
                pairs, conjuncts = self._claim_eq_pairs(
                    conjuncts, set(df.columns), set(right.columns),
                    alias_cols, rname.lower() if rname else None)
                if pairs:
                    df = df.join(right, on=pairs, how="inner")
                    continue
            df = self._lower_join(df, right, j, alias_cols)

        self._aliases = alias_cols
        remaining = _and_all(conjuncts)
        if remaining is not None:
            df = df.filter(self._expr(remaining))

        select_has_agg = any(_contains_agg(e) for e, _ in sel.items) \
            or bool(sel.group_by) or _contains_agg(sel.having)
        has_window = (any(_contains_window(e) for e, _ in sel.items)
                      or _contains_window(sel.having)
                      or any(_contains_window(o.expr)
                             for o in sel.order_by))
        if has_window:
            if select_has_agg:
                raise SqlError(
                    "window functions over aggregates need a subquery "
                    "(SELECT ... OVER ... FROM (SELECT ... GROUP BY ...))")
            df, sel = self._hoist_windows(df, sel)

        if select_has_agg:
            df, alias_map, order_handled = self._lower_aggregate(df, sel)
            if sel.distinct:
                df = df.distinct()
            if order_handled:
                if sel.limit is not None:
                    df = df.limit(sel.limit)
                return df
            return self._order_limit(df, sel.order_by, sel.limit,
                                     alias_map, df.columns)
        if sel.distinct:
            df, alias_map = self._lower_projection(df, sel)
            df = df.distinct()
            return self._order_limit(df, sel.order_by, sel.limit,
                                     alias_map, df.columns)
        # non-distinct: ORDER BY resolves against the PRE-projection frame
        # so it can reference hoisted window columns, select aliases, and
        # source columns the projection drops (SQL-legal)
        if sel.order_by:
            items = self._expand_items(df, sel.items)
            alias_ast = {a.lower(): e for e, a in items if a}
            orders = []
            for o in sel.order_by:
                e = o.expr
                if isinstance(e, tuple) and e[0] == "lit" \
                        and isinstance(e[1], int):
                    e, _ = items[_ordinal(e[1], len(items))]
                elif isinstance(e, tuple) and e[0] == "col" \
                        and len(e[1]) == 1 \
                        and e[1][0].lower() in alias_ast:
                    e = alias_ast[e[1][0].lower()]
                c = self._expr(e)
                orders.append(c.asc(o.nulls_first) if o.ascending
                              else c.desc(o.nulls_first))
            df = df.order_by(*orders)
        df, alias_map = self._lower_projection(df, sel)
        if sel.limit is not None:
            df = df.limit(sel.limit)
        return df

    # -- window functions -------------------------------------------------
    def _hoist_windows(self, df, sel: Select):
        """Replace window-call subtrees (in SELECT, HAVING, ORDER BY) with
        refs to computed columns; all hoisted calls land in ONE Window
        plan node (ref ``_hoist_windows``): the exec sorts once per
        partition and order keys, whatever the calls."""
        import copy
        from ..plan.logical import SortOrder, Window, WindowSpec

        def int_lit(ast, what):
            if isinstance(ast, tuple) and ast[0] == "lit" \
                    and isinstance(ast[1], int):
                return ast[1]
            if isinstance(ast, tuple) and ast[0] == "unary" \
                    and ast[1] == "-" and isinstance(ast[2], tuple) \
                    and ast[2][0] == "lit":
                return -ast[2][1]
            raise SqlError(f"{what} must be an integer literal")

        def scalar_lit(ast, what):
            if ast is None:
                return None
            if isinstance(ast, tuple) and ast[0] == "lit":
                return ast[1]
            if isinstance(ast, tuple) and ast[0] == "unary" \
                    and ast[1] == "-" and isinstance(ast[2], tuple) \
                    and ast[2][0] == "lit":
                return -ast[2][1]
            raise SqlError(f"{what} must be a literal")

        wins = []    # (fn, WindowSpec, name)

        def lower_win(ast):
            _, fn_node, parts, orders, frame = ast
            fname, args, distinct = fn_node[1], fn_node[2], fn_node[3]
            if distinct:
                raise SqlError(
                    f"DISTINCT is not supported in window {fname}()")
            if fname == "count" and (not args or args[0] == ("star",)):
                f = F.count_star()
            elif fname in _AGG_FNS:
                f = _AGG_FNS[fname](self._expr(args[0]))
            elif fname in _LATER:
                _refuse(fname)
            elif fname == "row_number":
                f = F.row_number()
            elif fname == "rank":
                f = F.rank()
            elif fname == "dense_rank":
                f = F.dense_rank()
            elif fname == "ntile":
                f = F.ntile(int_lit(args[0], "ntile bucket count"))
            elif fname in ("lag", "lead"):
                off = int_lit(args[1], f"{fname} offset") \
                    if len(args) > 1 else 1
                default = scalar_lit(args[2] if len(args) > 2 else None,
                                     f"{fname} default")
                mk = F.lag if fname == "lag" else F.lead
                f = mk(self._expr(args[0]), off, default)
            else:
                raise SqlError(f"{fname}() is not a window function")
            pks = [self._expr(p).expr for p in parts]
            obs = [SortOrder(self._expr(e).expr, asc, nf)
                   for e, asc, nf in orders]
            lframe = None
            if frame is not None:
                kind, lo, hi = frame
                if kind != "rows":
                    raise SqlError("only ROWS frames are supported")
                lframe = ("rows", lo, hi)
            name = f"__win{len(wins)}"
            fn = f.expr if hasattr(f, "expr") else f
            wins.append((fn, WindowSpec(pks, obs, lframe), name))
            return name

        def walk(ast):
            if ast is None or not isinstance(ast, tuple):
                return ast
            if ast[0] == "window":
                return ("col", (lower_win(ast),))
            if ast[0] == "fn":
                return ("fn", ast[1], [walk(a) for a in ast[2]], ast[3])
            if ast[0] == "case":
                return ("case", [(walk(c), walk(v)) for c, v in ast[1]],
                        walk(ast[2]) if ast[2] is not None else None)
            if ast[0] == "in":
                return ("in", walk(ast[1]), [walk(v) for v in ast[2]],
                        ast[3])
            return tuple(walk(x) if isinstance(x, tuple) else x
                         for x in ast)

        new_sel = copy.copy(sel)
        new_sel.items = [(walk(e), a) for e, a in sel.items]
        new_sel.having = walk(sel.having)
        new_sel.order_by = [OrderItem(walk(o.expr), o.ascending,
                                      o.nulls_first)
                            for o in sel.order_by]
        if wins:
            from ..api.dataframe import DataFrame
            df = DataFrame(df.session, Window(wins, df.plan))
        return df, new_sel

    # -- joins ----------------------------------------------------------
    def _side_of(self, ast, lcols, rcols, alias_cols, ralias=None):
        """Which join side a column AST belongs to, or (None, None).
        ``ralias`` is the alias of the table being joined in (the right
        side): a qualifier equal to it decides RIGHT, any other known
        qualifier decides LEFT — which keeps self-joins (identical column
        sets on both sides) unambiguous."""
        if not (isinstance(ast, tuple) and ast[0] == "col"):
            return None, None
        parts = ast[1]
        if len(parts) == 2:
            q = parts[0].lower()
            nm = alias_cols.get(q, {}).get(parts[1], parts[1])
            if ralias is not None and q == ralias:
                return ("r", nm) if nm in rcols else (None, None)
            if q in alias_cols:
                return ("l", nm) if nm in lcols else (None, None)
        nm = self._col_name(ast)
        if nm in lcols and nm not in rcols:
            return "l", nm
        if nm in rcols and nm not in lcols:
            return "r", nm
        return None, None

    def _claim_eq_pairs(self, conjuncts, lcols, rcols, alias_cols,
                        ralias=None):
        pairs, rest = [], []
        for c in conjuncts:
            if isinstance(c, tuple) and c[0] == "binop" and c[1] == "=":
                s1, n1 = self._side_of(c[2], lcols, rcols, alias_cols,
                                       ralias)
                s2, n2 = self._side_of(c[3], lcols, rcols, alias_cols,
                                       ralias)
                if s1 == "l" and s2 == "r":
                    pairs.append((n1, n2))
                    continue
                if s1 == "r" and s2 == "l":
                    pairs.append((n2, n1))
                    continue
            rest.append(c)
        return pairs, rest

    def _lower_join(self, left, right, j: Join, alias_cols):
        lcols, rcols = set(left.columns), set(right.columns)
        if j.kind == "cross":
            return left.join(right, how="cross")
        if j.using:
            # SQL USING keeps ONE copy of each key column: rename the right
            # side's keys, join, then emit coalesce(l.k, r.k) as the key
            # (for inner/left the left key suffices; right/full need the
            # coalesce so right-only rows keep their key values)
            keys = list(j.using)
            right = right.select(*[
                (F.col(c).alias(f"__using_{c}") if c in keys else F.col(c))
                for c in right.columns])
            out = left.join(right,
                            on=[(c, f"__using_{c}") for c in keys],
                            how=j.kind)
            if j.kind in ("leftsemi", "leftanti"):
                return out
            cols = []
            for c in out.columns:
                if c.startswith("__using_"):
                    continue
                if c in keys and j.kind in ("right", "full"):
                    cols.append(F.coalesce(F.col(c),
                                           F.col(f"__using_{c}")).alias(c))
                else:
                    cols.append(F.col(c))
            return out.select(*cols)
        # split conjunctive equalities into key pairs; rest is residual
        self._aliases = alias_cols
        ralias = (j.ref.alias or getattr(j.ref, "name", None))
        pairs, residual = self._claim_eq_pairs(
            _split_conjuncts(j.on), lcols, rcols, alias_cols,
            ralias.lower() if ralias else None)
        cond = None
        for r in residual:
            c = self._expr(r)
            cond = c if cond is None else (cond & c)
        if not pairs:
            raise SqlError("join requires at least one equality in ON")
        return left.join(right, on=pairs, how=j.kind, condition=cond)

    # -- projection / aggregation ---------------------------------------
    def _expand_items(self, df, items):
        out = []
        rev = {}
        for amap in getattr(self, "_aliases", {}).values():
            for orig, actual in amap.items():
                if actual != orig:
                    rev[actual] = orig
        for e, alias in items:
            if isinstance(e, tuple) and e[0] == "star":
                for c in df.columns:
                    out.append((("col", (c,)), rev.get(c)))
            elif isinstance(e, tuple) and e[0] == "qstar":
                amap = self._aliases.get(e[1].lower())
                if amap is None:
                    raise SqlError(f"unknown alias {e[1]}")
                arev = {actual: orig for orig, actual in amap.items()}
                for c in df.columns:
                    if c in arev:
                        out.append((("col", (c,)),
                                    arev[c] if arev[c] != c else None))
            else:
                out.append((e, alias))
        return out

    def _lower_projection(self, df, sel: Select):
        items = self._expand_items(df, sel.items)
        cols, alias_map = [], {}
        for e, alias in items:
            c = self._expr(e)
            name = alias or self._default_name(e, c)
            cols.append(c.alias(name))
            alias_map[name.lower()] = ("col", (name,))
        return df.select(*cols), alias_map

    def _lower_aggregate(self, df, sel: Select):
        items = self._expand_items(df, sel.items)
        alias_map = {a.lower(): e for e, a in items if a}
        # group keys: expressions, select aliases, or 1-based ordinals
        groupings = []
        for g in sel.group_by:
            if isinstance(g, tuple) and g[0] == "lit" \
                    and isinstance(g[1], int):
                e, alias = items[_ordinal(g[1], len(items))]
            elif isinstance(g, tuple) and g[0] == "col" \
                    and g[1][-1].lower() in alias_map:
                e, alias = alias_map[g[1][-1].lower()], g[1][-1]
            else:
                e, alias = g, None
            groupings.append((e, alias))

        agg_calls: Dict[str, object] = {}    # ast key -> (name, AggExpr)
        # grouping subtrees are available as values under their output
        # name (Spark analyzer semantics); filled after names are chosen
        group_map: Dict[str, str] = {}

        def hoist(ast):
            """Replace aggregate subtrees with refs to generated names."""
            if not isinstance(ast, tuple):
                return ast
            gk = group_map.get(_ast_key(ast))
            if gk is not None:
                return ("col", (gk,))
            if ast[0] == "fn" and _is_agg(ast[1]):
                k = _ast_key(ast)
                if k not in agg_calls:
                    nm = f"__agg{len(agg_calls)}"
                    agg_calls[k] = (nm, self._agg_expr(ast, nm))
                return ("col", (agg_calls[k][0],))
            if ast[0] in ("fn",):
                return (ast[0], ast[1], [hoist(a) for a in ast[2]], ast[3])
            if ast[0] == "case":
                return ("case",
                        [(hoist(c), hoist(v)) for c, v in ast[1]],
                        hoist(ast[2]) if ast[2] is not None else None)
            if ast[0] == "in":
                return ("in", hoist(ast[1]), [hoist(v) for v in ast[2]],
                        ast[3])
            return tuple(hoist(x) if isinstance(x, tuple) else x
                         for x in ast)

        gb_cols = []
        gb_names = []
        for i, (e, alias) in enumerate(groupings):
            c = self._expr(e)
            name = alias or self._default_name(e, c)
            gb_cols.append(c.alias(name))
            gb_names.append(name)
            group_map[_ast_key(e)] = name
            if alias:
                group_map[_ast_key(("col", (alias,)))] = name

        proj_items = []
        for e, alias in items:
            proj_items.append((hoist(e), alias))
        having_ast = hoist(sel.having) if sel.having is not None else None
        order_hoisted = [OrderItem(hoist(o.expr), o.ascending,
                                   o.nulls_first)
                         for o in sel.order_by]
        aggs = [v[1] for v in agg_calls.values()]
        if gb_cols:
            df = df.group_by(*gb_cols).agg(*aggs)
        else:
            df = df.agg(*aggs)

        if having_ast is not None:
            df = df.filter(self._expr(having_ast))

        # ORDER BY runs BEFORE the final projection so it may reference
        # hoisted aggregates / group keys the projection would drop
        # (Spark's analyzer resolves ORDER BY against the pre-projection
        # aggregate output the same way). DISTINCT forces the post-
        # projection path: items must then come from the select list.
        order_handled = False
        if order_hoisted and not sel.distinct:
            sel_alias_map = {al.lower(): e for e, al in proj_items if al}
            orders = []
            for o in order_hoisted:
                e = o.expr
                if isinstance(e, tuple) and e[0] == "lit" \
                        and isinstance(e[1], int):
                    e, _ = proj_items[_ordinal(e[1], len(proj_items))]
                elif isinstance(e, tuple) and e[0] == "col" \
                        and len(e[1]) == 1 \
                        and e[1][0].lower() in sel_alias_map:
                    e = sel_alias_map[e[1][0].lower()]
                c = self._expr(e)
                orders.append(c.asc(o.nulls_first) if o.ascending
                              else c.desc(o.nulls_first))
            df = df.order_by(*orders)
            order_handled = True

        # final projection restores select order/names over agg output
        out_cols, final_alias = [], {}
        for e, alias in proj_items:
            c = self._expr(e)
            name = alias or self._default_name(e, c)
            out_cols.append(c.alias(name))
            final_alias[name.lower()] = ("col", (name,))
        df = df.select(*out_cols)
        return df, final_alias, order_handled

    def _agg_expr(self, ast, name):
        fn, args, distinct = ast[1], ast[2], ast[3]
        if fn in _LATER:
            _refuse(fn)
        if fn == "count" and (not args or args[0] == ("star",)):
            return F.count_star().with_name(name)
        a = self._expr(args[0])
        if distinct:
            if fn == "count":
                return F.count_distinct(a).with_name(name)
            if fn == "sum":
                return F.sum_distinct(a).with_name(name)
            if fn in ("avg", "mean"):
                return F.avg_distinct(a).with_name(name)
            raise SqlError(f"DISTINCT not supported for {fn}")
        return _AGG_FNS[fn](a).with_name(name)

    # -- order by / limit ------------------------------------------------
    def _order_limit(self, df, order_by, limit, alias_map, names):
        if order_by:
            orders = []
            for o in order_by:
                e = o.expr
                if isinstance(e, tuple) and e[0] == "lit" \
                        and isinstance(e[1], int):
                    e = ("col", (names[_ordinal(e[1], len(names))],))
                elif isinstance(e, tuple) and e[0] == "col" \
                        and len(e[1]) == 1 \
                        and e[1][0].lower() in alias_map:
                    e = alias_map[e[1][0].lower()]
                c = self._expr(e)
                orders.append(c.asc(o.nulls_first) if o.ascending
                              else c.desc(o.nulls_first))
            df = df.order_by(*orders)
        if limit is not None:
            df = df.limit(limit)
        return df

    # -- scalar expressions ----------------------------------------------
    def _col_name(self, ast) -> str:
        parts = ast[1]
        if len(parts) == 2:
            # qualified ref: resolve through the alias map so t.k / r.k
            # reach the right (possibly collision-renamed) column
            amap = getattr(self, "_aliases", {}).get(parts[0].lower())
            if amap is not None:
                actual = amap.get(parts[1])
                if actual is None:
                    raise SqlError(
                        f"{parts[0]}.{parts[1]}: no such column (columns: "
                        f"{sorted(amap)})")
                return actual
        return parts[-1]

    def _default_name(self, ast, c) -> str:
        if isinstance(ast, tuple) and ast[0] == "col":
            return ast[1][-1]
        return c.expr.name_hint

    def _expr(self, ast) -> "F.Col":
        if not isinstance(ast, tuple):
            raise SqlError(f"bad expression node {ast!r}")
        kind = ast[0]
        if kind == "lit":
            return F.lit(ast[1])
        if kind == "datelit":
            return F.lit(np.datetime64(ast[1], "D"))
        if kind == "tslit":
            return F.lit(np.datetime64(ast[1].replace(" ", "T"), "us"))
        if kind == "col":
            return F.col(self._col_name(ast))
        if kind == "binop":
            op = ast[1]
            if op == "-" and isinstance(ast[3], tuple) \
                    and ast[3][0] == "interval":
                return self._interval_shift(ast[2], ast[3], -1)
            if op == "+" and isinstance(ast[3], tuple) \
                    and ast[3][0] == "interval":
                return self._interval_shift(ast[2], ast[3], +1)
            l, r = self._expr(ast[2]), self._expr(ast[3])
            if op == "||":
                return F.concat(l, r)
            return {
                "and": lambda: l & r, "or": lambda: l | r,
                "=": lambda: l == r, "<>": lambda: l != r,
                "!=": lambda: l != r, "<": lambda: l < r,
                "<=": lambda: l <= r, ">": lambda: l > r,
                ">=": lambda: l >= r, "+": lambda: l + r,
                "-": lambda: l - r, "*": lambda: l * r,
                "/": lambda: l / r, "%": lambda: l % r,
            }[op]()
        if kind == "unary":
            if ast[1] == "not":
                return ~self._expr(ast[2])
            return -self._expr(ast[2])
        if kind == "isnull":
            c = self._expr(ast[1]).isNull()
            return ~c if ast[2] else c
        if kind == "in":
            vals = []
            for v in ast[2]:
                if isinstance(v, tuple) and v[0] == "unary" \
                        and v[1] == "-" and isinstance(v[2], tuple) \
                        and v[2][0] == "lit":
                    vals.append(-v[2][1])
                    continue
                if not (isinstance(v, tuple) and v[0] == "lit"):
                    raise SqlError("IN list must be literals")
                vals.append(v[1])
            c = self._expr(ast[1]).isin(vals)
            return ~c if ast[3] else c
        if kind == "like":
            c = F.like(self._expr(ast[1]), ast[2])
            return ~c if ast[3] else c
        if kind == "between":
            e = self._expr(ast[1])
            c = (e >= self._expr(ast[2])) & (e <= self._expr(ast[3]))
            return ~c if ast[4] else c
        if kind == "case":
            branches = [(self._expr(c), self._expr(v)) for c, v in ast[1]]
            els = self._expr(ast[2]) if ast[2] is not None else F.lit(None)
            b = F.when(*branches[0])
            for c, v in branches[1:]:
                b = b.when(c, v)
            return b.otherwise(els)
        if kind == "cast":
            return F.cast(self._expr(ast[1]), _canon_type(ast[2]))
        if kind == "interval":
            raise SqlError("interval literal only valid in +/- with a date")
        if kind == "fn":
            fn, args, distinct = ast[1], ast[2], ast[3]
            if _is_agg(fn):
                raise SqlError(
                    f"aggregate {fn}() not allowed in this context")
            if fn in _VARARG_FNS:
                return _VARARG_FNS[fn](*[self._expr(a) for a in args])
            if fn == "substring" or fn == "substr":
                a = [self._expr(args[0])] + [_int_lit(x, fn)
                                             for x in args[1:]]
                return F.substring(*a)
            if fn == "round":
                scale = _int_lit(args[1], fn) if len(args) > 1 else 0
                return F.round(self._expr(args[0]), scale)
            if fn == "log" and len(args) == 2:
                return F.log(self._expr(args[0]), self._expr(args[1]))
            if fn == "datediff":
                if len(args) != 2:
                    raise SqlError("datediff requires (end, start)")
                return F.datediff(self._expr(args[0]), self._expr(args[1]))
            if fn == "date_add":
                return F.date_add(self._expr(args[0]),
                                  self._expr(args[1]))
            if fn == "date_sub":
                return F.date_sub(self._expr(args[0]),
                                  self._expr(args[1]))
            if fn == "nullif":
                if len(args) != 2:
                    raise SqlError("nullif requires (a, b)")
                return F.nullif(self._expr(args[0]),
                                self._expr(args[1]))
            if fn in _SCALAR_FNS:
                return _SCALAR_FNS[fn](self._expr(args[0]))
            if fn in _LATER:
                _refuse(fn)
            raise SqlError(f"unknown function {fn}()")
        if kind in ("star", "qstar"):
            raise SqlError("* only valid as a top-level select item")
        raise SqlError(f"unsupported expression {kind}")

    def _interval_shift(self, base_ast, interval, sign):
        n, unit = interval[1], interval[2]
        days = {"day": 1, "week": 7}.get(unit)
        if days is None:
            raise SqlError(f"unsupported interval unit {unit}")
        b = self._expr(base_ast)
        return (F.date_add(b, n * days * sign) if sign > 0
                else F.date_sub(b, n * days))


def _ordinal(n: int, count: int) -> int:
    """1-based SQL ordinal -> 0-based index, range-checked."""
    if not 1 <= n <= count:
        raise SqlError(f"ordinal {n} out of range (1..{count})")
    return n - 1


def _split_conjuncts(ast) -> list:
    if ast is None:
        return []
    if isinstance(ast, tuple) and ast[0] == "binop" and ast[1] == "and":
        return _split_conjuncts(ast[2]) + _split_conjuncts(ast[3])
    return [ast]


def _and_all(conjuncts):
    out = None
    for c in conjuncts:
        out = c if out is None else ("binop", "and", out, c)
    return out


def _contains_window(ast) -> bool:
    if ast is None or not isinstance(ast, tuple):
        return False
    if ast[0] == "window":
        return True
    if ast[0] == "fn":
        return any(_contains_window(a) for a in ast[2])
    if ast[0] == "case":
        return any(_contains_window(c) or _contains_window(v)
                   for c, v in ast[1]) or _contains_window(ast[2])
    if ast[0] == "in":
        return _contains_window(ast[1]) or any(_contains_window(v)
                                               for v in ast[2])
    return any(_contains_window(x) for x in ast[1:]
               if isinstance(x, tuple))


def _contains_agg(ast) -> bool:
    if ast is None or not isinstance(ast, tuple):
        return False
    if ast[0] == "window":
        return False      # agg inside OVER() is a window fn, not a groupby
    if ast[0] == "fn":
        if _is_agg(ast[1]):
            return True
        return any(_contains_agg(a) for a in ast[2])
    if ast[0] == "case":
        return any(_contains_agg(c) or _contains_agg(v)
                   for c, v in ast[1]) or _contains_agg(ast[2])
    if ast[0] == "in":
        return _contains_agg(ast[1]) or any(_contains_agg(v)
                                            for v in ast[2])
    return any(_contains_agg(x) for x in ast[1:] if isinstance(x, tuple))


def _canon_type(ty: str) -> str:
    t = ty.lower()
    return {"integer": "int", "long": "bigint", "varchar": "string",
            "char": "string", "real": "float", "numeric": "double",
            "decimal": "decimal(10,0)"}.get(t, t)


def lower_statement(session, text: str, views: Dict[str, object]):
    from .parser import (CreateTableStmt, DeleteStmt, DropTableStmt,
                         MergeStmt, ShowTablesStmt, UpdateStmt, parse)
    stmt = parse(text)
    if isinstance(stmt, (DeleteStmt, MergeStmt, UpdateStmt)):
        raise NotImplementedError(
            f"{type(stmt).__name__[:-4].upper()} needs Delta tables, which "
            "arrive with slice 10 (table formats)")
    if isinstance(stmt, (CreateTableStmt, DropTableStmt, ShowTablesStmt)):
        raise NotImplementedError(
            "CREATE/DROP/SHOW TABLES need the warehouse catalog and its "
            "writers, which arrive with slice 10 (table formats)")
    return _Lowerer(session, views).lower(stmt)
