"""Comparison predicates (port of ``spark_rapids_tpu/exprs/comparison.py``:
=, !=, <, <=, >, >=, IN against literals, IS NULL and IS NOT NULL).

Spark's float semantics: NaN == NaN is true and NaN is greater than every
other value. Decimals compare exactly: both sides are cast to Spark's wider
decimal (``wider_decimal``; an integral side as the decimal of its digits)
and compared as int64 at its scale; a side whose cast passes the wider
type's precision makes the row NULL, as the cast does in Spark, and one
that passes int64 only is decided by its sign (no float is involved). A
decimal beside a float or double compares as its nearest double, as Spark
casts it. ``=`` and ``IN`` over a STRING column have no row-wise form
here: a filter runs them over the column's dictionary or byte rectangle
(``compiler.build_dict_filter``).
"""
from __future__ import annotations

import math

import torch

from ..types import (BOOL, FLOAT32, FLOAT64, STRING, DataType, DecimalType,
                     Schema, comparable, torch_dtype)
from .base import (ColumnRef, DVal, EvalContext, Expression, null_and,
                   promote_types, unscaled, wider_decimal)
from .decimal_arith import scale_up

__all__ = ["EqualTo", "NotEqual", "LessThan", "LessThanOrEqual",
           "GreaterThan", "GreaterThanOrEqual", "In", "IsNull", "IsNotNull",
           "IsNaN", "in_null_rule"]


def _nan_eq(l, r):
    base = l == r
    if l.is_floating_point():
        return torch.logical_or(base, torch.logical_and(torch.isnan(l),
                                                        torch.isnan(r)))
    return base


def _nan_lt(l, r):
    # Spark ordering: NaN is greater than everything
    if l.is_floating_point():
        ln, rn = torch.isnan(l), torch.isnan(r)
        return torch.where(rn, torch.logical_not(ln),
                           torch.logical_and(torch.logical_not(ln), l < r))
    return l < r


def _cast_scaled(x: torch.Tensor, k: int, p: int):
    """``x`` (unscaled) cast up ``k`` digits into a type of precision
    ``p``: (int64 value where it fits, fits int64, passes the precision
    (Spark's cast gives NULL))."""
    val, fits = scale_up(x, k)
    over = torch.zeros_like(fits)
    if p - k <= 18:
        cap = 10 ** max(p - k, 0)                  # |x| 10^k >= 10^p
        over = (x >= cap) | (x <= -cap)
    return val, fits, over


def _compare_decimals(e, l: DVal, r: DVal, v: torch.Tensor, schema):
    """A comparison's operands where a decimal meets another type (module
    doc): int64 operands whose order is the values' order, or doubles."""
    from .arithmetic import decimal_side
    from .cast import as_double
    ldt, rdt = l.dtype, r.dtype
    if ldt in (FLOAT32, FLOAT64) or rdt in (FLOAT32, FLOAT64):
        return as_double(l), as_double(r), v
    ld, rd = decimal_side(e.children[0], schema), \
        decimal_side(e.children[1], schema)
    w = wider_decimal(ld, rd)
    a, fa, oa = _cast_scaled(l.data.to(torch.int64), w.scale - ld.scale,
                             w.precision)
    b, fb, ob = _cast_scaled(r.data.to(torch.int64), w.scale - rd.scale,
                             w.precision)
    v = v & ~oa & ~ob
    # a side past int64 (the other, at the wider scale already, fits):
    # its sign against 0 decides
    a = torch.where(fa, a, torch.sign(l.data))
    b = torch.where(fa, torch.where(fb, b, torch.sign(r.data)), 0)
    a = torch.where(fb, a, 0)
    return a, b, v


class BinaryComparison(Expression):
    device_type_sig = comparable
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def data_type(self, schema: Schema) -> DataType:
        return BOOL

    def _operands(self, ctx: EvalContext):
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        ldt = self.children[0].data_type(ctx.schema)
        rdt = self.children[1].data_type(ctx.schema)
        v = null_and(l.validity, r.validity)
        if ldt != rdt and (isinstance(ldt, DecimalType)
                           or isinstance(rdt, DecimalType)):
            return _compare_decimals(self, l, r, v, ctx.schema)
        if ldt != rdt:
            wide = torch_dtype(promote_types(ldt, rdt))
            return l.data.to(wide), r.data.to(wide), v
        return l.data, r.data, v

    def key(self):
        return (f"{type(self).__name__}({self.children[0].key()},"
                f"{self.children[1].key()})")

    @property
    def name_hint(self):
        return (f"({self.children[0].name_hint} {self.symbol} "
                f"{self.children[1].name_hint})")


class EqualTo(BinaryComparison):
    symbol = "="

    def eval_device(self, ctx):
        l, r, v = self._operands(ctx)
        return DVal(_nan_eq(l, r), v, BOOL)


class NotEqual(BinaryComparison):
    symbol = "!="

    def eval_device(self, ctx):
        l, r, v = self._operands(ctx)
        return DVal(torch.logical_not(_nan_eq(l, r)), v, BOOL)


class LessThan(BinaryComparison):
    symbol = "<"

    def eval_device(self, ctx):
        l, r, v = self._operands(ctx)
        return DVal(_nan_lt(l, r), v, BOOL)


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def eval_device(self, ctx):
        l, r, v = self._operands(ctx)
        return DVal(torch.logical_or(_nan_lt(l, r), _nan_eq(l, r)), v, BOOL)


class GreaterThan(BinaryComparison):
    symbol = ">"

    def eval_device(self, ctx):
        l, r, v = self._operands(ctx)
        return DVal(torch.logical_not(torch.logical_or(_nan_lt(l, r),
                                                       _nan_eq(l, r))),
                    v, BOOL)


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def eval_device(self, ctx):
        l, r, v = self._operands(ctx)
        return DVal(torch.logical_not(_nan_lt(l, r)), v, BOOL)


def in_null_rule(hit: torch.Tensor, validity: torch.Tensor,
                 values) -> torch.Tensor:
    """Spark's three-valued IN: NULL IN (...) is NULL, and so is a value
    that matches nothing in a list holding NULL."""
    if any(v is None for v in values):
        return torch.logical_and(validity, hit)
    return validity


class In(Expression):
    """value IN (literals...) (ref ``comparison.py:In``, GpuInSet)."""

    device_type_sig = comparable

    def __init__(self, child: Expression, values):
        self.children = [child]
        self.values = tuple(values)

    def data_type(self, schema: Schema) -> DataType:
        return BOOL

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        out = torch.zeros(ctx.padded_len, dtype=torch.bool,
                          device=ctx.device)
        if isinstance(c.dtype, DecimalType):
            return self._decimal_in(c, out)
        fl = c.data.is_floating_point()
        for v in self.values:
            if v is None:
                continue
            if fl and isinstance(v, float) and math.isnan(v):
                # NaN IN (NaN) is true, as for EqualTo
                out = torch.logical_or(out, torch.isnan(c.data))
            else:
                out = torch.logical_or(out, c.data == v)
        return DVal(out, in_null_rule(out, c.validity, self.values), BOOL)

    def _decimal_in(self, c: DVal, out: torch.Tensor) -> DVal:
        """A decimal IN a list: an integer or decimal value equals the rows
        of its unscaled value at the column's scale (none where it has
        more fractional digits); a float compares with the nearest
        double."""
        from .cast import as_double
        dbl = None
        for v in self.values:
            if v is None:
                continue
            if isinstance(v, float):
                if dbl is None:
                    dbl = as_double(c)
                out = torch.logical_or(out, dbl == v)
                continue
            u = unscaled(v, c.dtype.scale)
            if u is not None and -2 ** 63 <= u < 2 ** 63:
                out = torch.logical_or(out, c.data == u)
        return DVal(out, in_null_rule(out, c.validity, self.values), BOOL)

    def key(self):
        return f"in({self.children[0].key()},{self.values!r})"

    @property
    def name_hint(self):
        vals = ", ".join(repr(v) for v in self.values)
        return f"({self.children[0].name_hint} IN ({vals}))"


def _validity_only(e: Expression, schema: Schema):
    """IS [NOT] NULL reads only its child's validity: a string column's
    is on the device, whatever its layout."""
    c = e.children[0]
    if isinstance(c, ColumnRef) and c.data_type(schema) == STRING:
        return None
    return Expression.fully_device_supported(e, schema)


def _child_validity(e: Expression, ctx) -> DVal:
    c = e.children[0].eval_device(ctx)
    if c is None:
        raise NotImplementedError(
            f"<{e.name_hint}> over a host string column (non-ASCII or "
            "over-wide) arrives with slice 7 (strings)")
    return c


class IsNull(Expression):
    """``e IS NULL``: never null itself (ref ``comparison.py:IsNull``)."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema: Schema) -> DataType:
        return BOOL

    def device_unsupported_reason(self, schema: Schema):
        return None

    def fully_device_supported(self, schema: Schema):
        return _validity_only(self, schema)

    def eval_device(self, ctx):
        c = _child_validity(self, ctx)
        # a padding row is no null row
        out = torch.logical_and(torch.logical_not(c.validity),
                                ctx.row_mask())
        return DVal(out, torch.ones_like(out), BOOL)

    def key(self):
        return f"isnull({self.children[0].key()})"

    @property
    def name_hint(self):
        return f"({self.children[0].name_hint} IS NULL)"


class IsNotNull(Expression):
    """``e IS NOT NULL``: never null itself (ref
    ``comparison.py:IsNotNull``)."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema: Schema) -> DataType:
        return BOOL

    def device_unsupported_reason(self, schema: Schema):
        return None

    def fully_device_supported(self, schema: Schema):
        return _validity_only(self, schema)

    def eval_device(self, ctx):
        c = _child_validity(self, ctx)
        return DVal(c.validity, torch.ones_like(c.validity), BOOL)

    def key(self):
        return f"isnotnull({self.children[0].key()})"

    @property
    def name_hint(self):
        return f"({self.children[0].name_hint} IS NOT NULL)"


class IsNaN(Expression):
    """``isnan(e)``: whether a float is NaN (false for other numerics);
    NULL where ``e`` is (ref ``comparison.py:IsNaN``)."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema: Schema) -> DataType:
        return BOOL

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        out = torch.isnan(c.data) if c.data.is_floating_point() \
            else torch.zeros_like(c.validity)
        return DVal(out, c.validity, BOOL)

    def key(self):
        return f"isnan({self.children[0].key()})"
