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

Decimals follow Spark 3.5 (``DecimalPrecision`` with
``spark.sql.decimalOperations.allowPrecisionLoss=true``): an integral
operand is a decimal of its type's digits (an integral literal of its own
digits), a float or double operand makes both doubles. The result types:
``+``/``-`` keep the larger scale and one more integral digit, ``*`` sums
precisions plus one and scales, ``/`` takes ``max(6, s1 + p2 + 1)``
digits of scale, ``%`` the larger scale and the fewer integral digits;
past 38 digits ``adjust_precision_scale`` keeps the integral digits and
at least min(scale, 6) of the scale. Values are exact, then rounded
HALF_UP to the result's scale; a result past its precision or int64 is
NULL, and so is a zero divisor. ``*`` and ``/`` run in ``decimal_arith``
(128-bit intermediates; ``/`` rounds at scale 38 first, as Spark's
``Decimal./`` does); ``+``, ``-`` and ``%`` rescale their operands to the
larger scale in torch where both types keep that within 18 digits, and
run in ``decimal_arith`` otherwise (a rescaled operand can pass int64 and
even 2^128 where the result fits). ``div`` and ``pmod`` of decimals are
refused, naming the decimals item.
"""
from __future__ import annotations

import torch

from ..types import (DECIMAL_ITEM, DataType, DecimalType, FLOAT32, FLOAT64,
                     INT32, INT64, Schema, TypeSig, adjust_precision_scale,
                     decimal_sig, integral, integral_decimal, numeric,
                     torch_dtype)
from . import decimal_arith as DA
from .base import (DVal, EvalContext, Expression, Literal, null_and,
                   promote_types)
from .cast import as_double, float_to_int_java

__all__ = ["Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
           "Remainder", "Pmod", "UnaryMinus", "UnaryPositive", "Abs",
           "BitwiseAnd", "BitwiseOr", "BitwiseXor", "BitwiseNot",
           "ShiftLeft", "ShiftRight", "ShiftRightUnsigned"]


def decimal_side(e: Expression, schema: Schema):
    """An operand beside a decimal as a decimal type: itself, an integral
    literal as decimal(its digits, 0) (Spark's
    ``literalPickMinimumPrecision``), another integral type as its type's
    digits; None for a float, a double or another type."""
    dt = e.data_type(schema)
    if isinstance(dt, DecimalType):
        return dt
    if isinstance(e, Literal) and e.value is not None \
            and integral_decimal(dt) is not None:
        return DecimalType(max(len(str(abs(int(e.value)))), 1), 0)
    return integral_decimal(dt)


def _decimal_operands(e: Expression, schema: Schema):
    """(left, right) decimal types where the operation is a decimal one
    (a decimal beside a decimal or an integral type), else None."""
    l, r = e.children
    ldt, rdt = l.data_type(schema), r.data_type(schema)
    if not (isinstance(ldt, DecimalType) or isinstance(rdt, DecimalType)):
        return None
    ld, rd = decimal_side(l, schema), decimal_side(r, schema)
    return (ld, rd) if ld is not None and rd is not None else None


def _in_torch(ld: DecimalType, rd: DecimalType):
    """(kl, kr): each side's rescale to the larger scale, and whether both
    sides then keep within 18 digits, so that int64 holds them and their
    sum."""
    top = max(ld.scale, rd.scale)
    kl, kr = top - ld.scale, top - rd.scale
    return kl, kr, ld.precision + kl <= 18 and rd.precision + kr <= 18


def _at_top(l: DVal, r: DVal, kl: int, kr: int):
    """Both operands at the larger scale in int64 and the rows where both
    are valid and fit (a value past its type's precision may not)."""
    a, fa = DA.scale_up(l.data, kl)
    b, fb = DA.scale_up(r.data, kr)
    return a, b, null_and(l.validity, r.validity) & fa & fb


def _checked(x: torch.Tensor, ok: torch.Tensor, out: DecimalType) -> DVal:
    """``x`` as ``out``, NULL past its precision."""
    if out.precision < 19:
        ok = ok & (x.abs() < 10 ** out.precision)
    return DVal(torch.where(ok, x, 0), ok, out)


class BinaryArithmetic(Expression):
    device_type_sig: TypeSig = numeric + decimal_sig
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def data_type(self, schema: Schema) -> DataType:
        dec = _decimal_operands(self, schema)
        if dec is not None:
            return self._decimal_type(*dec)
        return promote_types(self.children[0].data_type(schema),
                             self.children[1].data_type(schema))

    def _decimal_type(self, l: DecimalType, r: DecimalType) -> DecimalType:
        """Spark's result type of the decimal operation (add and
        subtract's: the larger scale, one more integral digit)."""
        scale = max(l.scale, r.scale)
        return adjust_precision_scale(
            max(l.precision - l.scale, r.precision - r.scale) + scale + 1,
            scale)

    def device_unsupported_reason(self, schema: Schema):
        r = super().device_unsupported_reason(schema)
        if r is not None:
            return r
        dts = [c.data_type(schema) for c in self.children]
        if any(isinstance(d, DecimalType) for d in dts) and \
                _decimal_operands(self, schema) is None and \
                not any(d in (FLOAT32, FLOAT64) for d in dts):
            return f"{type(self).__name__}: {dts[0]} with {dts[1]}"
        return None

    def _operands(self, ctx: EvalContext, dt: DataType):
        """Both children's data as ``dt`` and the AND of their validity (a
        decimal beside a double as its nearest double)."""
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        tdt = torch_dtype(dt)
        if isinstance(l.dtype, DecimalType) or isinstance(r.dtype,
                                                          DecimalType):
            return (as_double(l).to(tdt), as_double(r).to(tdt),
                    null_and(l.validity, r.validity))
        return (l.data.to(tdt), r.data.to(tdt),
                null_and(l.validity, r.validity))

    def _decimal_eval(self, ctx: EvalContext):
        """(left, right DVals, their decimal types, the result type) when
        the operation is a decimal one, else None."""
        dec = _decimal_operands(self, ctx.schema)
        if dec is None:
            return None
        l, r = (DVal(v.data.to(torch.int64), v.validity, v.dtype)
                for v in (c.eval_device(ctx) for c in self.children))
        return l, r, dec, self._decimal_type(*dec)

    def _add_like(self, ctx: EvalContext, sign: int):
        """Decimal ``+`` (sign 1) or ``-`` (sign -1), or None where the
        operation is not a decimal one (module doc)."""
        got = self._decimal_eval(ctx)
        if got is None:
            return None
        l, r, (ld, rd), out = got
        kl, kr, small = _in_torch(ld, rd)
        if not small:
            data, ok = DA.add(l.data, l.validity, r.data, r.validity, kl, kr,
                              max(ld.scale, rd.scale) - out.scale,
                              out.precision, subtract=sign < 0)
            return DVal(data, ok, out)
        a, b, ok = _at_top(l, r, kl, kr)
        b = b if sign > 0 else -b
        total = a + b
        # int64 overflow of the sum: both operands' signs differ from it
        ovf = ((a ^ total) & (b ^ total)) < 0
        ok = ok & ~ovf & (r.data != -2 ** 63)
        # both within 18 digits: out keeps the larger scale
        return _checked(total, ok, out)

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
        dec = self._add_like(ctx, 1)
        if dec is not None:
            return dec
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        return DVal(ld + rd, v, dt)


class Subtract(BinaryArithmetic):
    symbol = "-"

    def eval_device(self, ctx):
        dec = self._add_like(ctx, -1)
        if dec is not None:
            return dec
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        return DVal(ld - rd, v, dt)


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _decimal_type(self, l, r):
        return adjust_precision_scale(l.precision + r.precision + 1,
                                      l.scale + r.scale)

    def eval_device(self, ctx):
        got = self._decimal_eval(ctx)
        if got is not None:
            l, r, (ld, rd), out = got
            data, ok = DA.mul(l.data, l.validity, r.data, r.validity,
                              ld.scale + rd.scale - out.scale,
                              out.precision)
            return DVal(data, ok, out)
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
        if isinstance(base, DecimalType):
            return base
        return FLOAT32 if base == FLOAT32 else FLOAT64

    def _decimal_type(self, l, r):
        scale = max(6, l.scale + r.precision + 1)
        return adjust_precision_scale(
            l.precision - l.scale + r.scale + scale, scale)

    def eval_device(self, ctx):
        got = self._decimal_eval(ctx)
        if got is not None:
            l, r, (ld, rd), out = got
            data, ok = DA.div(l.data, l.validity, r.data, r.validity,
                              out.scale + rd.scale - ld.scale,
                              38 - out.scale, out.precision)
            return DVal(data, ok, out)
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

    def device_unsupported_reason(self, schema: Schema):
        return _no_decimals(self, schema) or \
            super().device_unsupported_reason(schema)

    def eval_device(self, ctx):
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        ld, rd = _to_long(l.data), _to_long(r.data)
        v, safe, minus_one = _nonzero_divisor(
            rd, null_and(l.validity, r.validity))
        q = torch.div(ld, safe, rounding_mode="trunc")
        # x div -1 is -x, wrapping at MinValue as Java's does
        return DVal(torch.where(minus_one, 0 - ld, q), v, INT64)


def _no_decimals(e: Expression, schema: Schema):
    if any(isinstance(c.data_type(schema), DecimalType)
           for c in e.children):
        return (f"{type(e).__name__} of decimals arrives with "
                f"{DECIMAL_ITEM}")
    return None


class Remainder(BinaryArithmetic):
    """Spark ``%``: the dividend's sign (Java); a zero divisor gives
    NULL. Over decimals: both at the larger scale (module doc)."""
    symbol = "%"

    def _decimal_type(self, l, r):
        scale = max(l.scale, r.scale)
        return adjust_precision_scale(
            min(l.precision - l.scale, r.precision - r.scale) + scale,
            scale)

    def eval_device(self, ctx):
        got = self._decimal_eval(ctx)
        if got is not None:
            l, r, (ld, rd), out = got
            kl, kr, small = _in_torch(ld, rd)
            if not small:
                data, ok = DA.rem(l.data, l.validity, r.data, r.validity,
                                  kl, kr, out.precision)
                return DVal(data, ok, out)
            a, b, ok = _at_top(l, r, kl, kr)
            ok, safe, _ = _nonzero_divisor(b, ok)
            # out keeps the larger scale (its precision never passes 38)
            return _checked(torch.fmod(a, safe), ok, out)
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        v, safe, _ = _nonzero_divisor(rd, v)
        return DVal(torch.fmod(ld, safe), v, dt)


class Pmod(BinaryArithmetic):
    """Positive modulo (ref GpuPmod): ``r = a % n; r < 0 ? (r + n) % n :
    r``, so never negative for a positive divisor."""
    symbol = "pmod"

    def device_unsupported_reason(self, schema: Schema):
        return _no_decimals(self, schema) or \
            super().device_unsupported_reason(schema)

    def eval_device(self, ctx):
        ld, rd, v, dt = self._promoted_device_operands(ctx)
        v, safe, _ = _nonzero_divisor(rd, v)
        m = torch.fmod(ld, safe)
        m = torch.where(m < 0, torch.fmod(m + safe, safe), m)
        return DVal(m, v, dt)


class _Unary(Expression):
    device_type_sig: TypeSig = numeric + decimal_sig
    prefix = "?"

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def key(self):
        return f"{self.prefix}({self.children[0].key()})"


def _decimal_min_null(c: DVal, out: torch.Tensor) -> DVal:
    """A decimal's ``-x`` or ``abs(x)``: NULL for the one int64 value whose
    magnitude has no positive int64 (2^63)."""
    if not isinstance(c.dtype, DecimalType):
        return DVal(out, c.validity, c.dtype)
    ok = c.validity & (c.data != -2 ** 63)
    return DVal(torch.where(ok, out, 0), ok, c.dtype)


class UnaryMinus(_Unary):
    prefix = "neg"

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        return _decimal_min_null(c, torch.neg(c.data))


class Abs(_Unary):
    prefix = "abs"

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        return _decimal_min_null(c, torch.abs(c.data))


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
