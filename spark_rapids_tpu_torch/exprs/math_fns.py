"""Math functions (port of ``spark_rapids_tpu/exprs/math_fns.py``).

Unary double functions cast their input to double and evaluate eagerly
with torch. Domain errors give NaN, as ``java.lang.Math`` does, except
where Spark gives NULL, which the port follows where the reference
departs from Spark (ROADMAP.md Queue C):

  * ``ln``/``log10``/``log2`` of x <= 0, ``log1p`` of x <= -1 and
    ``log(base, x)`` with a base or an x <= 0 are NULL (Spark's
    ``UnaryLogExpression``), where the reference gives -inf or NaN;
  * ``floor``/``ceil`` of a double convert as Java's ``(long)`` does:
    NaN gives 0 and +-inf or a value out of range saturates to
    Long.MaxValue/MinValue, the same on the CPU and the card (a bare
    conversion differs between them); of an integer they return it
    unchanged, exact past 2**53;
  * ``round``/``bround`` of a value already integral at the scale
    (|x| * 10**d >= 2**52) return it unchanged, where scaling it first
    can overflow to inf;
  * ``pow`` follows ``Math.pow``: 1 to a NaN power and +-1 to an
    infinite power are NaN, where C's ``pow`` gives 1;
  * ``signum`` of NaN is NaN and of -0.0 is -0.0.

Left open: Spark rounds the shortest decimal form of a double
(``round(1.005, 2)`` is 1.01); the port, as the reference, rounds the
scaled double HALF_UP (1.005 * 100 is 100.49999999999999: 1.0).

Transcendentals may differ from the reference's by a few ulps: XLA's CPU
functions, glibc's (torch on the CPU) and CUDA's libdevice each round in
their own way.
"""
from __future__ import annotations

import math

import torch

from ..types import FLOAT64, INT64, Schema, numeric, torch_dtype
from .base import DVal, Expression, null_and
from .cast import float_to_int_java

__all__ = ["Sqrt", "Exp", "Log", "Log10", "Sin", "Cos", "Tan", "Asin",
           "Acos", "Atan", "Sinh", "Cosh", "Tanh", "Cbrt", "Floor", "Ceil",
           "Round", "Pow", "Signum", "Expm1", "Log1p", "Log2", "Atan2",
           "ToDegrees", "ToRadians", "Rint", "Asinh", "Acosh", "Atanh",
           "Cot", "Hypot", "Logarithm", "BRound"]

#: every double at or past this magnitude is an integer
_INTEGRAL_FROM = 2.0 ** 52


def _as_double(v: DVal) -> torch.Tensor:
    return v.data.to(torch.float64)


class _UnaryDouble(Expression):
    device_type_sig = numeric
    #: the torch function over float64
    fn = None
    #: the result is NULL where the input is at or below this (Spark's
    #: ``yAsymptote``); None: never
    null_at_or_below = None

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema: Schema):
        return FLOAT64

    def eval_device(self, ctx) -> DVal:
        c = self.children[0].eval_device(ctx)
        d = _as_double(c)
        valid = c.validity
        if self.null_at_or_below is not None:
            bad = d <= self.null_at_or_below
            valid = torch.logical_and(valid, torch.logical_not(bad))
            d = torch.where(bad, torch.ones_like(d), d)
        return DVal(type(self).fn(d), valid, FLOAT64)

    def key(self):
        return f"{type(self).__name__.lower()}({self.children[0].key()})"


def _mk(name: str, fn, null_at_or_below=None):
    return type(name, (_UnaryDouble,), {
        "fn": staticmethod(fn), "null_at_or_below": null_at_or_below,
        "__module__": __name__})


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root: |x| ** (1/3) with its sign, then one Newton
    step (1/3 is not a double, so the power alone can miss by an ulp)."""
    y = torch.copysign(torch.pow(torch.abs(x), 1.0 / 3.0), x)
    step = (y * y * y - x) / (3.0 * y * y)
    ok = torch.isfinite(y) & (y != 0) & torch.isfinite(step)
    return torch.where(ok, y - torch.where(ok, step, torch.zeros_like(y)),
                       y)


Sqrt = _mk("Sqrt", torch.sqrt)
Exp = _mk("Exp", torch.exp)
Log = _mk("Log", torch.log, 0.0)
Log10 = _mk("Log10", torch.log10, 0.0)
Log2 = _mk("Log2", torch.log2, 0.0)
Log1p = _mk("Log1p", torch.log1p, -1.0)
Expm1 = _mk("Expm1", torch.expm1)
Sin = _mk("Sin", torch.sin)
Cos = _mk("Cos", torch.cos)
Tan = _mk("Tan", torch.tan)
Asin = _mk("Asin", torch.asin)
Acos = _mk("Acos", torch.acos)
Atan = _mk("Atan", torch.atan)
Sinh = _mk("Sinh", torch.sinh)
Cosh = _mk("Cosh", torch.cosh)
Tanh = _mk("Tanh", torch.tanh)
Cbrt = _mk("Cbrt", _cbrt)
ToDegrees = _mk("ToDegrees", lambda x: x * (180.0 / math.pi))
ToRadians = _mk("ToRadians", lambda x: x * (math.pi / 180.0))
Rint = _mk("Rint", torch.round)       # half to even, as rint
Asinh = _mk("Asinh", torch.asinh)
Acosh = _mk("Acosh", torch.acosh)
Atanh = _mk("Atanh", torch.atanh)
Cot = _mk("Cot", lambda x: 1.0 / torch.tan(x))


class Signum(_UnaryDouble):
    """``Math.signum``: -1.0, 0.0 or 1.0; NaN and -0.0 give themselves."""

    @staticmethod
    def fn(x):
        return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


class Floor(Expression):
    """floor(x) -> bigint (Spark): an integer unchanged, a double floored
    and converted as Java's ``(long)``."""
    device_type_sig = numeric
    _round = staticmethod(torch.floor)

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema):
        return INT64

    def eval_device(self, ctx) -> DVal:
        c = self.children[0].eval_device(ctx)
        if not c.data.is_floating_point():
            return DVal(c.data.to(torch.int64), c.validity, INT64)
        return DVal(float_to_int_java(type(self)._round(_as_double(c)),
                                      torch.int64), c.validity, INT64)

    def key(self):
        return f"{type(self).__name__.lower()}({self.children[0].key()})"


class Ceil(Floor):
    _round = staticmethod(torch.ceil)


class Round(Expression):
    """round(x, d): HALF_UP at scale d, the input's type (Spark)."""
    device_type_sig = numeric

    def __init__(self, child: Expression, decimals: int = 0):
        self.children = [child]
        self.decimals = int(decimals)

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    @staticmethod
    def _scaled(d: torch.Tensor, scale: float) -> torch.Tensor:
        """HALF_UP: half away from zero."""
        return torch.sign(d) * torch.floor(torch.abs(d) * scale + 0.5) / scale

    def _int_round(self, x: torch.Tensor) -> torch.Tensor:
        """An integer at a negative scale, HALF_UP in integer arithmetic."""
        p = 10 ** -self.decimals
        if p > 2 ** 62:
            return torch.zeros_like(x)
        q = torch.div(torch.abs(x) + p // 2, p, rounding_mode="floor") * p
        return torch.where(x < 0, -q, q)

    def eval_device(self, ctx) -> DVal:
        c = self.children[0].eval_device(ctx)
        dt = self.data_type(ctx.schema)
        if not c.data.is_floating_point():
            if self.decimals >= 0:
                return c
            x = c.data.to(torch.int64)
            return DVal(self._int_round(x).to(c.data.dtype), c.validity, dt)
        scale = 10.0 ** self.decimals
        d = _as_double(c)
        out = self._scaled(d, scale)
        # integral at this scale already (or NaN/inf): unchanged
        keep = ~(torch.abs(d) * scale < _INTEGRAL_FROM)
        out = torch.where(keep, d, out)
        return DVal(out.to(torch_dtype(dt)), c.validity, dt)

    def key(self):
        return (f"{type(self).__name__.lower()}({self.children[0].key()},"
                f"{self.decimals})")


class BRound(Round):
    """bround(x, d): HALF_EVEN (banker's) rounding at scale d."""

    def _int_round(self, x: torch.Tensor) -> torch.Tensor:
        p = 10 ** -self.decimals
        if p > 2 ** 62:
            return torch.zeros_like(x)
        a = torch.abs(x)
        q = torch.div(a, p, rounding_mode="floor")
        r = a - q * p
        up = (2 * r > p) | ((2 * r == p) & (q % 2 == 1))
        q = (q + up.to(q.dtype)) * p
        return torch.where(x < 0, -q, q)

    @staticmethod
    def _scaled(d, scale):
        return torch.round(d * scale) / scale


class _BinaryDouble(Expression):
    device_type_sig = numeric

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def data_type(self, schema):
        return FLOAT64

    def _operands(self, ctx):
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        return _as_double(l), _as_double(r), null_and(l.validity,
                                                       r.validity)

    def key(self):
        return (f"{type(self).__name__.lower()}({self.children[0].key()},"
                f"{self.children[1].key()})")


class Pow(_BinaryDouble):
    """``Math.pow``: C's pow but for |base| = 1 with an infinite exponent
    and 1 with a NaN exponent, which are NaN."""

    def eval_device(self, ctx) -> DVal:
        b, e, v = self._operands(ctx)
        out = torch.pow(b, e)
        nan = ((torch.abs(b) == 1) & torch.isinf(e)) | \
            ((b == 1) & torch.isnan(e))
        return DVal(torch.where(nan, torch.full_like(out, math.nan), out), v,
                    FLOAT64)


class Atan2(_BinaryDouble):
    def eval_device(self, ctx) -> DVal:
        y, x, v = self._operands(ctx)
        return DVal(torch.atan2(y, x), v, FLOAT64)


class Hypot(_BinaryDouble):
    """hypot(a, b) = sqrt(a^2 + b^2) without overflow."""

    def eval_device(self, ctx) -> DVal:
        a, b, v = self._operands(ctx)
        return DVal(torch.hypot(a, b), v, FLOAT64)


class Logarithm(_BinaryDouble):
    """log(base, x) = ln(x) / ln(base); NULL where either is <= 0
    (Spark)."""

    def eval_device(self, ctx) -> DVal:
        base, x, v = self._operands(ctx)
        bad = (base <= 0) | (x <= 0)
        one = torch.ones_like(x)
        out = torch.log(torch.where(bad, one, x)) / torch.log(
            torch.where(bad, one, base))
        return DVal(out, torch.logical_and(v, torch.logical_not(bad)),
                    FLOAT64)

    def key(self):
        return f"log({self.children[0].key()},{self.children[1].key()})"
