"""Comparison predicates (port of ``spark_rapids_tpu/exprs/comparison.py``:
=, !=, <, <=, >, >=, IN against literals, IS NULL and IS NOT NULL).

Spark's float semantics: NaN == NaN is true and NaN is greater than every
other value. ``=`` and ``IN`` over a STRING column have no row-wise form
here: a filter runs them over the column's dictionary or byte rectangle
(``compiler.build_dict_filter``).
"""
from __future__ import annotations

import math

import torch

from ..types import (BOOL, STRING, DataType, Schema, comparable,
                     torch_dtype)
from .base import (ColumnRef, DVal, EvalContext, Expression, null_and,
                   promote_types)

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
