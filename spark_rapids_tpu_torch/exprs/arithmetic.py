"""Arithmetic with Spark semantics, non-ANSI mode (port of
``spark_rapids_tpu/exprs/arithmetic.py``).

Operands promote to the wider numeric type before the op; the result is
null where either operand is. Integer results wrap in their own width, as
Java's do (byte and short included). Besides:

  * ``/`` gives a double (a float for two floats) and ``/``, ``div``,
    ``%`` and ``pmod`` give NULL for a zero divisor, floats included;
  * ``div`` truncates toward zero and ``%`` takes the dividend's sign
    (Java), where ``torch.remainder`` would take the divisor's;
  * a divisor of -1 never reaches an integer division: ``MinValue div
    -1`` is ``MinValue`` and ``MinValue % -1`` is 0, as in Java, where the
    CPU would trap and CUDA leaves the result undefined;
  * ``-MinValue`` and ``abs(MinValue)`` wrap to ``MinValue``;
  * shift counts are masked to 31 (int) or 63 (long), and byte and short
    values shift as ints, as Java's do.

One departure from the reference: its ``div`` takes the quotient of the
absolute values, and ``abs(Long.MinValue)`` wraps, so ``Long.MinValue div
n`` for ``|n| > 1`` has the wrong sign there. The port gives Java's
answer (ROADMAP.md Queue C).
"""
from __future__ import annotations

import torch

from ..types import (DataType, FLOAT32, FLOAT64, INT32, INT64, Schema,
                     TypeSig, integral, numeric, torch_dtype)
from .base import DVal, EvalContext, Expression, null_and, promote_types
from .cast import float_to_int_java

__all__ = ["Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
           "Remainder", "Pmod", "UnaryMinus", "UnaryPositive", "Abs",
           "BitwiseAnd", "BitwiseOr", "BitwiseXor", "BitwiseNot",
           "ShiftLeft", "ShiftRight", "ShiftRightUnsigned"]


class BinaryArithmetic(Expression):
    device_type_sig: TypeSig = numeric
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def data_type(self, schema: Schema) -> DataType:
        return promote_types(self.children[0].data_type(schema),
                             self.children[1].data_type(schema))

    def _operands(self, ctx: EvalContext, dt: DataType):
        """Both children's data as ``dt`` and the AND of their validity."""
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        tdt = torch_dtype(dt)
        return (l.data.to(tdt), r.data.to(tdt),
                null_and(l.validity, r.validity))

    def _promoted_device_operands(self, ctx: EvalContext):
        dt = self.data_type(ctx.schema)
        return (*self._operands(ctx, dt), dt)

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


def _nonzero_divisor(rd: torch.Tensor, v: torch.Tensor):
    """(validity with a zero divisor made null, the divisor with its
    zeros and, for integers, its -1s replaced by 1; whether it was -1).
    ``torch.fmod`` over the safe divisor is Java's ``%``: a -1 replaced
    by 1 gives 0, Java's answer for every dividend."""
    zero = rd == 0
    v = torch.logical_and(v, torch.logical_not(zero))
    if rd.is_floating_point():
        return v, torch.where(zero, torch.ones_like(rd), rd), None
    minus_one = rd == -1
    safe = torch.where(torch.logical_or(zero, minus_one),
                       torch.ones_like(rd), rd)
    return v, safe, minus_one


class Divide(BinaryArithmetic):
    """Spark ``/``: a double for non-float inputs (a float for two
    floats); a zero divisor gives NULL (ref arithmetic.scala GpuDivide)."""
    symbol = "/"

    def data_type(self, schema: Schema) -> DataType:
        base = super().data_type(schema)
        return FLOAT32 if base == FLOAT32 else FLOAT64

    def eval_device(self, ctx):
        dt = self.data_type(ctx.schema)
        ld, rd, v = self._operands(ctx, dt)
        v, safe, _ = _nonzero_divisor(rd, v)
        return DVal(ld / safe, v, dt)


def _to_long(d: torch.Tensor) -> torch.Tensor:
    """Spark's cast to bigint: floats truncate toward zero and saturate,
    NaN gives 0 (a float to int conversion out of range is undefined on
    the card)."""
    if not d.is_floating_point():
        return d.to(torch.int64)
    return float_to_int_java(d, torch.int64)


class IntegralDivide(BinaryArithmetic):
    """Spark ``div``: integral division into a long, truncating toward
    zero; a zero divisor gives NULL."""
    symbol = "div"

    def data_type(self, schema: Schema) -> DataType:
        return INT64

    def eval_device(self, ctx):
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        ld, rd = _to_long(l.data), _to_long(r.data)
        v, safe, minus_one = _nonzero_divisor(
            rd, null_and(l.validity, r.validity))
        q = torch.div(ld, safe, rounding_mode="trunc")
        # x div -1 is -x, wrapping at MinValue as Java's does
        return DVal(torch.where(minus_one, 0 - ld, q), v, INT64)


class Remainder(BinaryArithmetic):
    """Spark ``%``: the dividend's sign (Java); a zero divisor gives
    NULL."""
    symbol = "%"

    def eval_device(self, ctx):
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        v, safe, _ = _nonzero_divisor(rd, v)
        return DVal(torch.fmod(ld, safe), v, dt)


class Pmod(BinaryArithmetic):
    """Positive modulo (ref GpuPmod): ``r = a % n; r < 0 ? (r + n) % n :
    r``, so never negative for a positive divisor."""
    symbol = "pmod"

    def eval_device(self, ctx):
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        v, safe, _ = _nonzero_divisor(rd, v)
        m = torch.fmod(ld, safe)
        m = torch.where(m < 0, torch.fmod(m + safe, safe), m)
        return DVal(m, v, dt)


class _Unary(Expression):
    device_type_sig: TypeSig = numeric
    prefix = "?"

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def key(self):
        return f"{self.prefix}({self.children[0].key()})"


class UnaryMinus(_Unary):
    prefix = "neg"

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        return DVal(torch.neg(c.data), c.validity, c.dtype)


class Abs(_Unary):
    prefix = "abs"

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        return DVal(torch.abs(c.data), c.validity, c.dtype)


class UnaryPositive(_Unary):
    """``+x``: identity on numerics (ref GpuOverrides UnaryPositive
    rule)."""
    prefix = "pos"

    def eval_device(self, ctx):
        return self.children[0].eval_device(ctx)


# ---------------------------------------------------------------------------
# bitwise (ref bitwise.scala)
# ---------------------------------------------------------------------------

class _BitwiseBinary(BinaryArithmetic):
    device_type_sig = integral
    op = None

    def eval_device(self, ctx):
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        return DVal(type(self).op(ld, rd), v, dt)


class BitwiseAnd(_BitwiseBinary):
    symbol = "&"
    op = staticmethod(torch.bitwise_and)


class BitwiseOr(_BitwiseBinary):
    symbol = "|"
    op = staticmethod(torch.bitwise_or)


class BitwiseXor(_BitwiseBinary):
    symbol = "^"
    op = staticmethod(torch.bitwise_xor)


class BitwiseNot(_Unary):
    device_type_sig = integral
    prefix = "~"

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        return DVal(torch.bitwise_not(c.data), c.validity, c.dtype)


class _Shift(Expression):
    """shiftleft/shiftright/shiftrightunsigned(x, n), Java semantics: byte
    and short values shift as INT, and the count keeps only its low 5
    (int) or 6 (long) bits (ref GpuShiftLeft/Right in arithmetic.scala)."""

    device_type_sig = integral

    def __init__(self, value: Expression, amount: Expression):
        self.children = [value, amount]

    def data_type(self, schema):
        dt = self.children[0].data_type(schema)
        return dt if dt.np_dtype.itemsize >= 4 else INT32

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        a = self.children[1].eval_device(ctx)
        dt = self.data_type(ctx.schema)
        tdt = torch_dtype(dt)
        bits = 8 * dt.np_dtype.itemsize
        n = (a.data.to(torch.int32) & (bits - 1)).to(tdt)
        out = self._shift(c.data.to(tdt), n, bits)
        return DVal(out, null_and(c.validity, a.validity), dt)

    def key(self):
        return (f"{type(self).__name__}({self.children[0].key()},"
                f"{self.children[1].key()})")


class ShiftLeft(_Shift):
    @staticmethod
    def _shift(v, n, bits):
        return torch.bitwise_left_shift(v, n)


class ShiftRight(_Shift):
    """Arithmetic (sign-propagating) right shift, Java ``>>``."""

    @staticmethod
    def _shift(v, n, bits):
        return torch.bitwise_right_shift(v, n)


class ShiftRightUnsigned(_Shift):
    """Logical right shift, Java ``>>>``: the arithmetic shift with the
    copies of the sign bit masked off. The mask is ``2^(bits - n) - 1``,
    made as ``(1 << (bits - 1 - n)) * 2 - 1`` so that no shift reaches the
    type's width (for n = 0 the product wraps to 0 and the mask is all
    ones)."""

    @staticmethod
    def _shift(v, n, bits):
        one = torch.ones_like(v)
        mask = torch.bitwise_left_shift(one, (bits - 1) - n) * 2 - 1
        return torch.bitwise_and(torch.bitwise_right_shift(v, n), mask)
