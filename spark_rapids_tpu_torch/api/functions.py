"""Column DSL and functions (port of ``spark_rapids_tpu/api/functions.py``,
the names the slice's queries use, with the same
signatures).

    from spark_rapids_tpu_torch.api import functions as F
    df.filter(F.col("a") < F.lit(24.0)).agg(F.sum(F.col("b")))
"""
from __future__ import annotations

import re
from typing import Optional

from .. import exprs as E
from ..exprs import window_fns as WF
from ..exprs import datetime_fns as DT
from ..exprs import hash_fns as HF
from ..exprs import math_fns as M
from ..exprs import nondeterministic as ND
from ..exprs.aggregates import (Average, CollectList, CollectSet, Count,
                                CountStar, First, Last, Max, MaxBy, Min,
                                MinBy, Percentile, StddevPop, StddevSamp,
                                Sum, VariancePop, VarianceSamp)
from ..types import (BOOL, DATE, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64,
                     STRING, TIMESTAMP, DataType, DecimalType)

__all__ = ["Col", "col", "lit", "asc", "desc", "when", "coalesce",
           "nullif", "isnull", "greatest", "least", "cast", "date_add",
           "date_sub", "like", "sum", "count",
           "count_star", "avg", "min", "max", "first", "last",
           "count_distinct", "sum_distinct", "avg_distinct",
           "countDistinct", "sumDistinct", "broadcast",
           "startswith", "endswith", "locate", "instr", "length", "upper",
           "lower", "substring", "trim", "ltrim", "rtrim", "replace",
           "lpad", "rpad", "reverse", "initcap", "substring_index",
           "concat", "concat_ws", "repeat", "translate", "ascii", "chr_",
           "bit_length", "octet_length", "rlike",
           "abs", "div", "pmod", "negative", "positive", "bitwise_not",
           "shiftleft", "shiftright", "shiftrightunsigned",
           "isnan", "nanvl", "sqrt", "cbrt", "exp", "expm1", "log", "ln",
           "log10", "log2", "log1p", "sin", "cos", "tan", "asin", "acos",
           "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh",
           "atanh", "cot", "degrees", "radians", "rint", "signum", "floor",
           "ceil", "round", "bround", "pow", "power", "hypot",
           "year", "month", "dayofmonth", "hour", "minute", "second",
           "dayofweek", "weekday", "dayofyear", "quarter", "datediff",
           "unix_date", "last_day", "add_months", "months_between",
           "timestamp_seconds", "timestamp_millis", "timestamp_micros",
           "to_unix_timestamp", "unix_timestamp", "trunc", "stddev",
           "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
           "rand", "monotonically_increasing_id", "spark_partition_id",
           "hash", "xxhash64", "size", "array_contains", "array_position",
           "element_at", "get", "sort_array", "array_min", "array_max",
           "slice", "array_reverse", "array", "sequence", "transform",
           "filter", "exists", "forall", "aggregate", "zip_with",
           "explode", "explode_outer", "posexplode", "posexplode_outer",
           "stack", "struct", "named_struct", "get_field", "create_map",
           "map_keys", "map_values", "map_entries", "map_concat",
           "map_from_arrays", "transform_keys", "transform_values",
           "map_filter", "collect_list", "collect_set", "min_by", "max_by",
           "percentile", "split", "array_join", "array_repeat",
           "arrays_zip", "concat_arrays", "flatten", "array_distinct",
           "array_union", "array_intersect", "array_except", "array_remove",
           "arrays_overlap", "str_to_map"]


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
    def __truediv__(self, o): return Col(E.Divide(self.expr, _to_expr(o)))
    def __rtruediv__(self, o): return Col(E.Divide(_to_expr(o), self.expr))
    def __mod__(self, o): return Col(E.Remainder(self.expr, _to_expr(o)))
    def __rmod__(self, o): return Col(E.Remainder(_to_expr(o), self.expr))
    def __neg__(self): return Col(E.UnaryMinus(self.expr))
    def __pos__(self): return Col(E.UnaryPositive(self.expr))

    def bitwiseAND(self, o):
        return Col(E.BitwiseAnd(self.expr, _to_expr(o)))

    def bitwiseOR(self, o):
        return Col(E.BitwiseOr(self.expr, _to_expr(o)))

    def bitwiseXOR(self, o):
        return Col(E.BitwiseXor(self.expr, _to_expr(o)))

    def __eq__(self, o): return Col(E.EqualTo(self.expr, _to_expr(o)))
    def __ne__(self, o): return Col(E.NotEqual(self.expr, _to_expr(o)))
    def __lt__(self, o): return Col(E.LessThan(self.expr, _to_expr(o)))
    def __le__(self, o): return Col(E.LessThanOrEqual(self.expr, _to_expr(o)))
    def __gt__(self, o): return Col(E.GreaterThan(self.expr, _to_expr(o)))
    def __ge__(self, o):
        return Col(E.GreaterThanOrEqual(self.expr, _to_expr(o)))

    def __and__(self, o): return Col(E.And(self.expr, _to_expr(o)))
    def __or__(self, o): return Col(E.Or(self.expr, _to_expr(o)))
    def __invert__(self): return Col(E.Not(self.expr))

    def isNull(self): return Col(E.IsNull(self.expr))
    def isNotNull(self): return Col(E.IsNotNull(self.expr))

    def contains(self, s): return Col(E.Contains(self.expr, s))
    def startswith(self, s): return Col(E.StartsWith(self.expr, s))
    def endswith(self, s): return Col(E.EndsWith(self.expr, s))
    def like(self, pattern): return Col(E.Like(self.expr, pattern))
    def rlike(self, pattern): return Col(E.RLike(self.expr, pattern))

    def isin(self, *vals):
        vals = vals[0] if len(vals) == 1 and isinstance(vals[0],
                                                        (list, tuple)) \
            else vals
        return Col(E.In(self.expr, vals))

    def alias(self, name: str): return Col(E.Alias(self.expr, name))
    def cast(self, dtype): return Col(E.Cast(self.expr, _dtype_of(dtype)))

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


_DTYPES = {"boolean": BOOL, "bool": BOOL, "tinyint": INT8, "byte": INT8,
           "smallint": INT16, "short": INT16, "int": INT32, "integer": INT32,
           "bigint": INT64, "long": INT64, "float": FLOAT32,
           "double": FLOAT64, "string": STRING, "date": DATE,
           "timestamp": TIMESTAMP}


def _dtype_of(d) -> DataType:
    if isinstance(d, DataType):
        return d
    name = str(d).lower().replace(" ", "")
    if name in ("decimal", "dec", "numeric"):
        return DecimalType(10, 0)
    m = re.fullmatch(r"(?:decimal|dec|numeric)\((\d+)(?:,(\d+))?\)", name)
    if m:
        return DecimalType(int(m.group(1)), int(m.group(2) or 0))
    return _DTYPES[name]


def col(name: str) -> Col:
    return Col(E.ColumnRef(name))


def lit(v) -> Col:
    return Col(E.Literal(v))


class _WhenBuilder:
    """``when(c, v).when(c2, v2).otherwise(e)``: a CASE WHEN."""

    def __init__(self, branches):
        self.branches = branches

    def when(self, cond, value) -> "_WhenBuilder":
        return _WhenBuilder(self.branches
                            + [(_to_expr(cond), _to_expr(value))])

    def otherwise(self, value) -> Col:
        return Col(E.CaseWhen(self.branches, _to_expr(value)))

    @property
    def col(self) -> Col:
        return Col(E.CaseWhen(self.branches, None))


def when(cond, value) -> _WhenBuilder:
    return _WhenBuilder([(_to_expr(cond), _to_expr(value))])


def coalesce(*cols) -> Col:
    return Col(E.Coalesce(*[_to_expr(c) for c in cols]))


def nullif(a, b) -> Col:
    return Col(E.NullIf(_to_expr(a), _to_expr(b)))


def isnull(c) -> Col: return Col(E.IsNull(_to_expr(c)))
def greatest(*cols) -> Col: return Col(E.Greatest(*map(_to_expr, cols)))
def least(*cols) -> Col: return Col(E.Least(*map(_to_expr, cols)))


def cast(c, dtype) -> Col:
    """A cast (exprs/cast.py): numeric, boolean, decimal, date and
    timestamp types run; casts from or to strings are refused at planning,
    naming the slice that brings them."""
    return Col(E.Cast(_to_expr(c), _dtype_of(dtype)))


def date_add(c, days) -> Col:
    return Col(E.DateAdd(_to_expr(c), _to_expr(days)))


def date_sub(c, days) -> Col:
    return Col(E.DateSub(_to_expr(c), _to_expr(days)))


def like(c, pattern) -> Col: return Col(E.Like(_to_expr(c), pattern))


def asc(name: str):
    return col(name).asc()


def desc(name: str):
    return col(name).desc()


def startswith(c, s) -> Col: return Col(E.StartsWith(_to_expr(c), s))
def endswith(c, s) -> Col: return Col(E.EndsWith(_to_expr(c), s))
def locate(substr, c) -> Col: return Col(E.StringLocate(substr, _to_expr(c)))
def instr(c, substr: str) -> Col:
    return Col(E.StringInstr(_to_expr(c), _to_expr(substr)))


# --- string transforms (reference api/functions.py:187-222) ----------------
def length(c) -> Col: return Col(E.Length(_to_expr(c)))
def upper(c) -> Col: return Col(E.Upper(_to_expr(c)))
def lower(c) -> Col: return Col(E.Lower(_to_expr(c)))
def substring(c, pos, ln=None) -> Col:
    return Col(E.Substring(_to_expr(c), pos, ln))
def replace(c, search: str, replacement: str = "") -> Col:
    return Col(E.StringReplace(_to_expr(c), search, replacement))
def trim(c) -> Col: return Col(E.StringTrim(_to_expr(c)))
def ltrim(c) -> Col: return Col(E.StringTrimLeft(_to_expr(c)))
def rtrim(c) -> Col: return Col(E.StringTrimRight(_to_expr(c)))
def lpad(c, ln, pad=" ") -> Col: return Col(E.Lpad(_to_expr(c), ln, pad))
def rpad(c, ln, pad=" ") -> Col: return Col(E.Rpad(_to_expr(c), ln, pad))
def reverse(c) -> Col: return Col(E.Reverse(_to_expr(c)))
def initcap(c) -> Col: return Col(E.InitCap(_to_expr(c)))
def concat(*cols) -> Col:
    return Col(E.ConcatStrings(*[_to_expr(c) for c in cols]))
def concat_ws(sep, *cols) -> Col:
    return Col(E.ConcatWs(_to_expr(sep), *[_to_expr(c) for c in cols]))
def repeat(c, n) -> Col: return Col(E.StringRepeat(_to_expr(c), n))
def translate(c, src: str, dst: str) -> Col:
    return Col(E.StringTranslate(_to_expr(c), src, dst))
def ascii(c) -> Col: return Col(E.Ascii(_to_expr(c)))
def chr_(c) -> Col: return Col(E.Chr(_to_expr(c)))
def bit_length(c) -> Col: return Col(E.BitLength(_to_expr(c)))
def octet_length(c) -> Col: return Col(E.OctetLength(_to_expr(c)))
def rlike(c, pattern) -> Col: return Col(E.RLike(_to_expr(c), pattern))
def substring_index(c, delim, count) -> Col:
    return Col(E.SubstringIndex(_to_expr(c), delim, count))


def abs(c) -> Col: return Col(E.Abs(_to_expr(c)))
def negative(c) -> Col: return Col(E.UnaryMinus(_to_expr(c)))
def positive(c) -> Col: return Col(E.UnaryPositive(_to_expr(c)))
def div(a, b) -> Col:
    """Spark SQL's ``a div b``: integral division into a long."""
    return Col(E.IntegralDivide(_to_expr(a), _to_expr(b)))
def pmod(a, b) -> Col: return Col(E.Pmod(_to_expr(a), _to_expr(b)))
def bitwise_not(c) -> Col: return Col(E.BitwiseNot(_to_expr(c)))
def shiftleft(c, n) -> Col:
    return Col(E.ShiftLeft(_to_expr(c), _to_expr(n)))
def shiftright(c, n) -> Col:
    return Col(E.ShiftRight(_to_expr(c), _to_expr(n)))
def shiftrightunsigned(c, n) -> Col:
    return Col(E.ShiftRightUnsigned(_to_expr(c), _to_expr(n)))


def sum(c): return Sum(_to_expr(c))
def count(c): return Count(_to_expr(c))
def count_star(): return CountStar()
def avg(c): return Average(_to_expr(c))
def count_distinct(c): return Count(_to_expr(c)).as_distinct()
def sum_distinct(c): return Sum(_to_expr(c)).as_distinct()
def avg_distinct(c): return Average(_to_expr(c)).as_distinct()


countDistinct = count_distinct
sumDistinct = sum_distinct


def min(c): return Min(_to_expr(c))
def max(c): return Max(_to_expr(c))


def first(c, ignorenulls: bool = True):
    """The value of the first row in input order; with ``ignorenulls``
    (the default, as the reference's ``first``) the first non-null one."""
    return First(_to_expr(c), ignorenulls)


def last(c, ignorenulls: bool = True):
    """The value of the last row in input order (as ``first``)."""
    return Last(_to_expr(c), ignorenulls)


# --- window ------------------------------------------------------------------
def row_number(): return WF.RowNumber()
def rank(): return WF.Rank()
def dense_rank(): return WF.DenseRank()
def ntile(n): return WF.NTile(n)
def nth_value(c, n): return WF.NthValue(_to_expr(c), n)
def percent_rank(): return WF.PercentRank()
def lag(c, offset=1, default=None):
    return WF.Lag(_to_expr(c), offset, default)
def lead(c, offset=1, default=None):
    return WF.Lead(_to_expr(c), offset, default)


# --- math (reference api/functions.py:153-165, :498-504) ------------------
def isnan(c) -> Col: return Col(E.IsNaN(_to_expr(c)))
def nanvl(a, b) -> Col: return Col(E.NaNvl(_to_expr(a), _to_expr(b)))
def sqrt(c) -> Col: return Col(M.Sqrt(_to_expr(c)))
def cbrt(c) -> Col: return Col(M.Cbrt(_to_expr(c)))
def exp(c) -> Col: return Col(M.Exp(_to_expr(c)))
def expm1(c) -> Col: return Col(M.Expm1(_to_expr(c)))


def log(a, b=None) -> Col:
    """``log(x)``, the natural logarithm, or ``log(base, x)``."""
    if b is None:
        return Col(M.Log(_to_expr(a)))
    return Col(M.Logarithm(_to_expr(a), _to_expr(b)))


def ln(c) -> Col: return Col(M.Log(_to_expr(c)))
def log10(c) -> Col: return Col(M.Log10(_to_expr(c)))
def log2(c) -> Col: return Col(M.Log2(_to_expr(c)))
def log1p(c) -> Col: return Col(M.Log1p(_to_expr(c)))
def sin(c) -> Col: return Col(M.Sin(_to_expr(c)))
def cos(c) -> Col: return Col(M.Cos(_to_expr(c)))
def tan(c) -> Col: return Col(M.Tan(_to_expr(c)))
def asin(c) -> Col: return Col(M.Asin(_to_expr(c)))
def acos(c) -> Col: return Col(M.Acos(_to_expr(c)))
def atan(c) -> Col: return Col(M.Atan(_to_expr(c)))
def atan2(a, b) -> Col: return Col(M.Atan2(_to_expr(a), _to_expr(b)))
def sinh(c) -> Col: return Col(M.Sinh(_to_expr(c)))
def cosh(c) -> Col: return Col(M.Cosh(_to_expr(c)))
def tanh(c) -> Col: return Col(M.Tanh(_to_expr(c)))
def asinh(c) -> Col: return Col(M.Asinh(_to_expr(c)))
def acosh(c) -> Col: return Col(M.Acosh(_to_expr(c)))
def atanh(c) -> Col: return Col(M.Atanh(_to_expr(c)))
def cot(c) -> Col: return Col(M.Cot(_to_expr(c)))
def degrees(c) -> Col: return Col(M.ToDegrees(_to_expr(c)))
def radians(c) -> Col: return Col(M.ToRadians(_to_expr(c)))
def rint(c) -> Col: return Col(M.Rint(_to_expr(c)))
def signum(c) -> Col: return Col(M.Signum(_to_expr(c)))
def floor(c) -> Col: return Col(M.Floor(_to_expr(c)))
def ceil(c) -> Col: return Col(M.Ceil(_to_expr(c)))
def round(c, scale: int = 0) -> Col: return Col(M.Round(_to_expr(c), scale))
def bround(c, scale: int = 0) -> Col:
    return Col(M.BRound(_to_expr(c), scale))
def pow(a, b) -> Col: return Col(M.Pow(_to_expr(a), _to_expr(b)))
def hypot(a, b) -> Col: return Col(M.Hypot(_to_expr(a), _to_expr(b)))


power = pow


# --- dates and times (reference api/functions.py:170-183, :505-524) --------
def year(c) -> Col: return Col(DT.Year(_to_expr(c)))
def month(c) -> Col: return Col(DT.Month(_to_expr(c)))
def dayofmonth(c) -> Col: return Col(DT.DayOfMonth(_to_expr(c)))
def hour(c) -> Col: return Col(DT.Hour(_to_expr(c)))
def minute(c) -> Col: return Col(DT.Minute(_to_expr(c)))
def second(c) -> Col: return Col(DT.Second(_to_expr(c)))
def dayofweek(c) -> Col: return Col(DT.DayOfWeek(_to_expr(c)))
def weekday(c) -> Col: return Col(DT.WeekDay(_to_expr(c)))
def dayofyear(c) -> Col: return Col(DT.DayOfYear(_to_expr(c)))
def quarter(c) -> Col: return Col(DT.Quarter(_to_expr(c)))
def datediff(end, start) -> Col:
    return Col(DT.DateDiff(_to_expr(end), _to_expr(start)))
def unix_date(c) -> Col: return Col(DT.UnixDate(_to_expr(c)))
def last_day(c) -> Col: return Col(DT.LastDay(_to_expr(c)))
def add_months(c, n) -> Col:
    return Col(DT.AddMonths(_to_expr(c), _to_expr(n)))
def months_between(end, start, round_off: bool = True) -> Col:
    return Col(DT.MonthsBetween(_to_expr(end), _to_expr(start), round_off))
def timestamp_seconds(c) -> Col:
    return Col(DT.SecondsToTimestamp(_to_expr(c)))
def timestamp_millis(c) -> Col:
    return Col(DT.MillisToTimestamp(_to_expr(c)))
def timestamp_micros(c) -> Col:
    return Col(DT.MicrosToTimestamp(_to_expr(c)))
def to_unix_timestamp(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Col:
    return Col(DT.ToUnixTimestamp(_to_expr(c), fmt))
def unix_timestamp(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Col:
    return Col(DT.UnixTimestamp(_to_expr(c), fmt))
def trunc(c, fmt: str) -> Col: return Col(DT.TruncDate(_to_expr(c), fmt))


# --- statistics (reference api/functions.py:437-440) -----------------------
def stddev(c): return StddevSamp(_to_expr(c))
def stddev_pop(c): return StddevPop(_to_expr(c))
def var_samp(c): return VarianceSamp(_to_expr(c))
def var_pop(c): return VariancePop(_to_expr(c))
def collect_list(c): return CollectList(_to_expr(c))
def collect_set(c): return CollectSet(_to_expr(c))
def min_by(c, ordering): return MinBy(_to_expr(c), _to_expr(ordering))
def max_by(c, ordering): return MaxBy(_to_expr(c), _to_expr(ordering))
def percentile(c, p: float): return Percentile(_to_expr(c), p)


stddev_samp = stddev
variance = var_samp


# --- task context and hashes (reference api/functions.py:345-398) ----------
def rand(seed: int = 0) -> Col: return Col(ND.Rand(seed))
def monotonically_increasing_id() -> Col:
    return Col(ND.MonotonicallyIncreasingID())
def spark_partition_id() -> Col: return Col(ND.SparkPartitionID())
def hash(*cols) -> Col:
    return Col(HF.Murmur3Hash([_to_expr(c) for c in cols]))
def xxhash64(*cols) -> Col:
    return Col(HF.XxHash64([_to_expr(c) for c in cols]))


# --- collections (exprs/collection_fns.py) ---------------------------------
def size(c) -> Col: return Col(E.Size(_to_expr(c)))
def array_contains(c, value) -> Col:
    return Col(E.ArrayContains(_to_expr(c), _to_expr(value)))
def array_position(c, value) -> Col:
    return Col(E.ArrayPosition(_to_expr(c), _to_expr(value)))
def element_at(c, extraction) -> Col:
    return Col(E.ElementAt(_to_expr(c), _to_expr(extraction)))
def get(c, index) -> Col:
    return Col(E.GetArrayItem(_to_expr(c), _to_expr(index)))
def sort_array(c, asc: bool = True) -> Col:
    return Col(E.SortArray(_to_expr(c), E.Literal(asc)))
def array_min(c) -> Col: return Col(E.ArrayMin(_to_expr(c)))
def array_max(c) -> Col: return Col(E.ArrayMax(_to_expr(c)))
def slice(c, start, length) -> Col:
    return Col(E.Slice(_to_expr(c), _to_expr(start), _to_expr(length)))
def array_reverse(c) -> Col: return Col(E.ArrayReverse(_to_expr(c)))
def array(*cols) -> Col: return Col(E.CreateArray(*map(_to_expr, cols)))
def sequence(start, stop, step=None) -> Col:
    return Col(E.Sequence(_to_expr(start), _to_expr(stop),
                          _to_expr(step) if step is not None else None))
def split(c, pattern: str, limit: int = -1) -> Col:
    return Col(E.StringSplit(_to_expr(c), pattern, limit))
def array_join(c, delimiter: str, null_replacement=None) -> Col:
    rep = E.Literal(null_replacement) if null_replacement is not None \
        else None
    return Col(E.ArrayJoin(_to_expr(c), E.Literal(delimiter), rep))
def array_repeat(c, count) -> Col:
    return Col(E.ArrayRepeat(_to_expr(c), _to_expr(count)))
def arrays_zip(*cols) -> Col:
    """A list of structs, each field named as its column is."""
    names = [c.expr.name_hint if isinstance(c, Col) else str(i)
             for i, c in enumerate(cols)]
    return Col(E.ArraysZip(*map(_to_expr, cols), names=names))
def concat_arrays(*cols) -> Col: return Col(E.Concat(*map(_to_expr, cols)))
def flatten(c) -> Col: return Col(E.Flatten(_to_expr(c)))
def array_distinct(c) -> Col: return Col(E.ArrayDistinct(_to_expr(c)))
def array_union(a, b) -> Col:
    return Col(E.ArrayUnion(_to_expr(a), _to_expr(b)))
def array_intersect(a, b) -> Col:
    return Col(E.ArrayIntersect(_to_expr(a), _to_expr(b)))
def array_except(a, b) -> Col:
    return Col(E.ArrayExcept(_to_expr(a), _to_expr(b)))
def array_remove(c, element) -> Col:
    return Col(E.ArrayRemove(_to_expr(c), _to_expr(element)))
def arrays_overlap(a, b) -> Col:
    return Col(E.ArraysOverlap(_to_expr(a), _to_expr(b)))
def str_to_map(c, pair_delim: str = ",", kv_delim: str = ":") -> Col:
    return Col(E.StringToMap(_to_expr(c), E.Literal(pair_delim),
                             E.Literal(kv_delim)))


# --- structs and maps (exprs/collection_fns.py) -----------------------------
def struct(*cols) -> Col:
    """A struct of ``cols``, each field named as its column is."""
    pairs = []
    for c in cols:
        pairs.append(E.Literal(c.expr.name_hint if isinstance(c, Col)
                               else str(c)))
        pairs.append(_to_expr(c))
    return Col(E.CreateNamedStruct(*pairs))
def named_struct(*name_col_pairs) -> Col:
    return Col(E.CreateNamedStruct(*map(_to_expr, name_col_pairs)))
def get_field(c, name: str) -> Col:
    return Col(E.GetStructField(_to_expr(c), name))
def create_map(*cols) -> Col: return Col(E.CreateMap(*map(_to_expr, cols)))
def map_keys(c) -> Col: return Col(E.MapKeys(_to_expr(c)))
def map_values(c) -> Col: return Col(E.MapValues(_to_expr(c)))
def map_entries(c) -> Col: return Col(E.MapEntries(_to_expr(c)))
def map_concat(*cols) -> Col: return Col(E.MapConcat(*map(_to_expr, cols)))
def map_from_arrays(keys, values) -> Col:
    return Col(E.MapFromArrays(_to_expr(keys), _to_expr(values)))


# --- higher-order functions (exprs/higher_order.py) -------------------------
def _make_lambda(fn, hints, min_args=1):
    """A Python callable over Cols -> (its variables, its body); the arity
    is the callable's, between ``min_args`` and ``len(hints)``."""
    import inspect
    n = len(inspect.signature(fn).parameters)
    if not min_args <= n <= len(hints):
        raise TypeError(f"lambda must take between {min_args} and "
                        f"{len(hints)} arguments, got {n}")
    args = [E.NamedLambdaVariable(hints[i]) for i in range(n)]
    return args, _to_expr(fn(*[Col(a) for a in args]))


def transform(c, fn) -> Col:
    return Col(E.ArrayTransform(_to_expr(c), *_make_lambda(fn, ["x", "i"])))
def filter(c, fn) -> Col:
    return Col(E.ArrayFilter(_to_expr(c), *_make_lambda(fn, ["x", "i"])))
def exists(c, fn) -> Col:
    return Col(E.ArrayExists(_to_expr(c), *_make_lambda(fn, ["x"])))
def forall(c, fn) -> Col:
    return Col(E.ArrayForAll(_to_expr(c), *_make_lambda(fn, ["x"])))
def aggregate(c, initial, merge, finish=None) -> Col:
    margs, mbody = _make_lambda(merge, ["acc", "x"], min_args=2)
    fargs, fbody = _make_lambda(finish, ["acc"]) if finish is not None \
        else (None, None)
    return Col(E.ArrayAggregate(_to_expr(c), _to_expr(initial), margs, mbody,
                                fargs, fbody))
def zip_with(a, b, fn) -> Col:
    return Col(E.ZipWith(_to_expr(a), _to_expr(b),
                         *_make_lambda(fn, ["x", "y"], min_args=2)))
def transform_keys(c, fn) -> Col:
    return Col(E.TransformKeys(_to_expr(c),
                               *_make_lambda(fn, ["k", "v"], min_args=2)))
def transform_values(c, fn) -> Col:
    return Col(E.TransformValues(_to_expr(c),
                                 *_make_lambda(fn, ["k", "v"], min_args=2)))
def map_filter(c, fn) -> Col:
    return Col(E.MapFilter(_to_expr(c),
                           *_make_lambda(fn, ["k", "v"], min_args=2)))


# --- generators, planned as Generate by DataFrame.select --------------------
def explode(c) -> Col: return Col(E.Explode(_to_expr(c)))
def explode_outer(c) -> Col: return Col(E.Explode(_to_expr(c), outer=True))
def posexplode(c) -> Col: return Col(E.PosExplode(_to_expr(c)))
def posexplode_outer(c) -> Col:
    return Col(E.PosExplode(_to_expr(c), outer=True))
def stack(n: int, *cols) -> Col:
    return Col(E.Stack(n, *map(_to_expr, cols)))


def broadcast(df):
    """Mark a DataFrame as the build side of its next join (Spark's
    ``functions.broadcast``): the planner broadcasts it."""
    return df.hint("broadcast")
