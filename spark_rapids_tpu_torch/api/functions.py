"""Column DSL and functions (port of ``spark_rapids_tpu/api/functions.py``,
the names the slice's queries use, with the same
signatures).

    from spark_rapids_tpu_torch.api import functions as F
    df.filter(F.col("a") < F.lit(24.0)).agg(F.sum(F.col("b")))
"""
from __future__ import annotations

from typing import Optional

from .. import exprs as E
from ..exprs.aggregates import Average, Count, CountStar, Sum

__all__ = ["Col", "col", "lit", "asc", "desc", "sum", "count",
           "count_star", "avg", "startswith", "endswith", "locate", "instr"]


def _to_expr(v) -> E.Expression:
    if isinstance(v, Col):
        return v.expr
    if isinstance(v, E.Expression):
        return v
    return E.Literal(v)


class Col:
    """Wrapper giving an Expression a PySpark-like operator surface."""

    def __init__(self, expr: E.Expression):
        self.expr = expr

    def __add__(self, o): return Col(E.Add(self.expr, _to_expr(o)))
    def __radd__(self, o): return Col(E.Add(_to_expr(o), self.expr))
    def __sub__(self, o): return Col(E.Subtract(self.expr, _to_expr(o)))
    def __rsub__(self, o): return Col(E.Subtract(_to_expr(o), self.expr))
    def __mul__(self, o): return Col(E.Multiply(self.expr, _to_expr(o)))
    def __rmul__(self, o): return Col(E.Multiply(_to_expr(o), self.expr))

    def __eq__(self, o): return Col(E.EqualTo(self.expr, _to_expr(o)))
    def __lt__(self, o): return Col(E.LessThan(self.expr, _to_expr(o)))
    def __le__(self, o): return Col(E.LessThanOrEqual(self.expr, _to_expr(o)))
    def __gt__(self, o): return Col(E.GreaterThan(self.expr, _to_expr(o)))
    def __ge__(self, o):
        return Col(E.GreaterThanOrEqual(self.expr, _to_expr(o)))

    def __and__(self, o): return Col(E.And(self.expr, _to_expr(o)))
    def __or__(self, o): return Col(E.Or(self.expr, _to_expr(o)))
    def __invert__(self): return Col(E.Not(self.expr))

    def contains(self, s): return Col(E.Contains(self.expr, s))
    def startswith(self, s): return Col(E.StartsWith(self.expr, s))
    def endswith(self, s): return Col(E.EndsWith(self.expr, s))
    def like(self, pattern): return Col(E.Like(self.expr, pattern))
    def rlike(self, pattern): return Col(E.RLike(self.expr, pattern))

    def alias(self, name: str): return Col(E.Alias(self.expr, name))

    def asc(self, nulls_first: Optional[bool] = None):
        from ..plan.logical import SortOrder
        return SortOrder(self.expr, True, nulls_first)

    def desc(self, nulls_first: Optional[bool] = None):
        from ..plan.logical import SortOrder
        return SortOrder(self.expr, False, nulls_first)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return f"Col<{self.expr.name_hint}>"


def col(name: str) -> Col:
    return Col(E.ColumnRef(name))


def lit(v) -> Col:
    return Col(E.Literal(v))


def asc(name: str):
    return col(name).asc()


def desc(name: str):
    return col(name).desc()


def startswith(c, s) -> Col: return Col(E.StartsWith(_to_expr(c), s))
def endswith(c, s) -> Col: return Col(E.EndsWith(_to_expr(c), s))
def locate(substr, c) -> Col: return Col(E.StringLocate(substr, _to_expr(c)))
def instr(c, substr: str) -> Col:
    return Col(E.StringInstr(_to_expr(c), _to_expr(substr)))


def sum(c): return Sum(_to_expr(c))
def count(c): return Count(_to_expr(c))
def count_star(): return CountStar()
def avg(c): return Average(_to_expr(c))
