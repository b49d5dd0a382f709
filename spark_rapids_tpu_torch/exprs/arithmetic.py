"""Arithmetic with Spark semantics (port of
``spark_rapids_tpu/exprs/arithmetic.py``: the binary +, -, *).

Operands promote to the wider numeric type before the op; the result is
null where either operand is.
"""
from __future__ import annotations

from ..types import DataType, Schema, TypeSig, numeric, torch_dtype
from .base import DVal, EvalContext, Expression, null_and, promote_types

__all__ = ["Add", "Subtract", "Multiply"]


class BinaryArithmetic(Expression):
    device_type_sig: TypeSig = numeric
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def data_type(self, schema: Schema) -> DataType:
        return promote_types(self.children[0].data_type(schema),
                             self.children[1].data_type(schema))

    def _promoted_device_operands(self, ctx: EvalContext):
        dt = self.data_type(ctx.schema)
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        tdt = torch_dtype(dt)
        return (l.data.to(tdt), r.data.to(tdt),
                null_and(l.validity, r.validity), dt)

    def key(self):
        return (f"{type(self).__name__}({self.children[0].key()},"
                f"{self.children[1].key()})")

    @property
    def name_hint(self):
        return (f"({self.children[0].name_hint} {self.symbol} "
                f"{self.children[1].name_hint})")


class Add(BinaryArithmetic):
    symbol = "+"

    def eval_device(self, ctx):
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        return DVal(ld + rd, v, dt)


class Subtract(BinaryArithmetic):
    symbol = "-"

    def eval_device(self, ctx):
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        return DVal(ld - rd, v, dt)


class Multiply(BinaryArithmetic):
    symbol = "*"

    def eval_device(self, ctx):
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        return DVal(ld * rd, v, dt)
