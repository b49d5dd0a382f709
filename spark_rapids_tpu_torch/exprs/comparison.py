"""Comparison predicates (port of ``spark_rapids_tpu/exprs/comparison.py``:
=, <, <=, >, >=).

Spark's float semantics: NaN == NaN is true and NaN is greater than every
other value.
"""
from __future__ import annotations

import torch

from ..types import BOOL, DataType, Schema, comparable, torch_dtype
from .base import DVal, EvalContext, Expression, null_and, promote_types

__all__ = ["EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
           "GreaterThanOrEqual"]


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
