"""Casts (port of ``spark_rapids_tpu/exprs/cast.py``: every cast the
reference runs on its device path), non-ANSI Spark semantics:

  * numeric -> numeric: Java's narrowing (an integer keeps its low bits);
    a float to int or bigint truncates toward zero, NaN gives 0 and a
    value out of range saturates at the type's MinValue/MaxValue, as
    Java's ``(int)``/``(long)`` do, and to tinyint or smallint goes
    through int and keeps the low bits, as ``(byte)(int)`` does (the
    reference saturates at the narrow type's bounds: ROADMAP.md Queue C).
    The clamp is explicit, so the CPU and the card agree (their bare
    float-to-integer conversions differ past the range);
  * numeric <-> boolean: 0 is false, anything else (NaN included) true;
    a boolean is 1 or 0;
  * date -> timestamp (midnight UTC) and timestamp -> date (the floor);
  * timestamp <-> numeric count seconds, as Spark's do: a timestamp to an
    integral type is the floor of its seconds, to a double its seconds
    with their fraction; an integer to a timestamp is that many seconds
    (saturating), a double too, NaN and +-inf giving NULL. The reference
    keeps the microseconds (ROADMAP.md Queue C);
  * date <-> numeric carry the days since the epoch, as the reference's
    do.

  * decimal <-> numeric, as Spark 3.5's non-ANSI ``Cast``: a decimal to
    an integral type truncates toward zero, then narrows as Java does (the
    low bits); to boolean it is ``x != 0``; to double it is Java's
    ``BigDecimal.doubleValue``, the nearest double (``decimal_arith``'s
    ``to_double``), and to float that double rounded to float (Java
    rounds once: the two differ only where the double lands on a float
    tie). An integral or boolean value, or another decimal, rescales
    HALF_UP to the target's scale (``decimal_arith``'s ``rescale``); a
    float or double takes Spark's ``Decimal(d)``, which reads the
    double's shortest decimal form (``Double.toString``), rounded HALF_UP:
    the result ``k`` is the integer whose midpoints bracket the double,
    ``fl((2k - 1) / 2P) <= |x| < fl((2k + 1) / 2P)`` (``P = 10^s``; one
    IEEE division each, exact operands), which equals rounding the
    shortest form while ``|x| P < 10^14``; a value past that raises at its
    batch, naming the decimals item. NaN, infinities and every overflow
    of the target's precision give NULL.

Casts from or to strings run on the reference's host engine; the port
refuses them at planning, naming the strings slice.
"""
from __future__ import annotations

import torch

from ..types import (BOOL, DATE, DECIMAL_ITEM, FLOAT32, FLOAT64, INT8, INT16,
                     INT32, INT64, STRING, TIMESTAMP, DataType, DecimalType,
                     Schema, torch_dtype)
from .base import DVal, Expression

__all__ = ["Cast", "float_to_int_java", "as_double", "to_decimal"]

_MICROS_PER_DAY = 86_400_000_000
_MICROS_PER_SECOND = 1_000_000
_LONG_MAX = 2 ** 63 - 1
_NUMERIC = (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64)


def float_to_int_java(d: torch.Tensor, to: torch.dtype) -> torch.Tensor:
    """Java's ``(int)``/``(long)`` of a float: NaN gives 0, truncation
    toward zero, saturation at the type's bounds (byte and short go
    through int, as Java's do)."""
    info = torch.iinfo(torch.int64 if to == torch.int64 else torch.int32)
    d = d.to(torch.float64)
    top = float(info.max) + 1.0              # 2**31 or 2**63: overflows
    hi = d >= top
    lo = d <= float(info.min)
    safe = torch.where(torch.isnan(d) | hi | lo, torch.zeros_like(d), d)
    wide = torch.int64 if to == torch.int64 else torch.int32
    out = torch.trunc(safe).to(wide)
    out = torch.where(hi, torch.full_like(out, info.max), out)
    out = torch.where(lo, torch.full_like(out, info.min), out)
    return out.to(to)


def _slice_for(src: DataType, dst: DataType) -> str:
    return "the strings slice (ROADMAP.md Queue A, slice 7)"


#: a float cast to a decimal is exact to Spark while |x| 10^s is below
#: this (module doc)
_SHORTEST_EXACT = 1e14


def as_double(v: DVal) -> torch.Tensor:
    """A numeric value as float64: a decimal as the nearest double (Java's
    ``BigDecimal.doubleValue``), anything else converted."""
    if isinstance(v.dtype, DecimalType):
        from .decimal_arith import to_double
        return to_double(v.data, v.validity, v.dtype.scale)[0]
    return v.data.to(torch.float64)


def _float_to_decimal(d: torch.Tensor, valid: torch.Tensor,
                      dst: DecimalType):
    """Spark's cast of a double to ``dst`` (module doc): (unscaled int64,
    validity)."""
    d = d.to(torch.float64)
    valid = torch.logical_and(valid, torch.isfinite(d))
    a = torch.where(valid, torch.abs(d), torch.zeros_like(d))
    P = 10.0 ** dst.scale
    if bool(torch.any(a * P >= _SHORTEST_EXACT)):
        raise NotImplementedError(
            f"cast of a double of {_SHORTEST_EXACT:g} or more units of "
            f"{dst.name}'s scale to {dst.name}: Spark rounds the double's "
            f"shortest decimal form, which arrives with {DECIMAL_ITEM}")
    k = torch.floor(a * P + 0.5)
    # one IEEE division each: a tensor divisor (torch divides a CUDA
    # tensor by a Python number through its reciprocal)
    two_p = torch.full_like(a, 2.0 * P)
    up = a >= (2.0 * k + 1.0) / two_p
    down = a < (2.0 * k - 1.0) / two_p
    k = k + up.to(torch.float64) - down.to(torch.float64)
    u = k.to(torch.int64)
    ok = valid & (u < 10 ** min(dst.precision, 18)) \
        if dst.precision <= 18 else valid
    u = torch.where(d < 0, -u, u)
    return torch.where(ok, u, 0), ok


def to_decimal(v: DVal, dst: DecimalType):
    """(unscaled int64 at ``dst``, validity) of a numeric or boolean value
    cast to ``dst``; NULL past its precision."""
    from .decimal_arith import rescale
    src = v.dtype
    if isinstance(src, DecimalType):
        return rescale(v.data, v.validity, dst.scale - src.scale,
                       dst.precision)
    if v.data.is_floating_point():
        return _float_to_decimal(v.data, v.validity, dst)
    return rescale(v.data.to(torch.int64), v.validity, dst.scale,
                   dst.precision)


def _from_decimal(d: torch.Tensor, valid: torch.Tensor, src: DecimalType,
                  dst: DataType):
    """A decimal cast to a numeric or boolean type (module doc)."""
    if dst == BOOL:
        return d != 0, valid
    if dst in (FLOAT32, FLOAT64):
        from .decimal_arith import to_double
        out, _ = to_double(d, valid, src.scale)
        return out.to(torch_dtype(dst)), valid
    q = torch.div(d, 10 ** src.scale, rounding_mode="trunc") \
        if src.scale <= 18 else torch.zeros_like(d)
    return q.to(torch_dtype(dst)), valid


class Cast(Expression):
    def __init__(self, child: Expression, to: DataType):
        self.children = [child]
        self.to = to

    def data_type(self, schema: Schema) -> DataType:
        return self.to

    def device_unsupported_reason(self, schema: Schema):
        src = self.children[0].data_type(schema)
        if src == self.to:
            return None
        fixed = _NUMERIC + (DATE, TIMESTAMP)
        if src in fixed and self.to in fixed:
            return None
        dec_src, dec_dst = isinstance(src, DecimalType), \
            isinstance(self.to, DecimalType)
        if dec_src or dec_dst:
            other = self.to if dec_src else src
            if other == STRING:
                return (f"cast from {src.name} to {self.to.name} arrives "
                        f"with {_slice_for(src, self.to)}: casts between "
                        "strings and decimals are left from the decimals "
                        "item")
            if not (isinstance(other, DecimalType) or other in _NUMERIC
                    or other.name == "void"):
                return (f"cast from {src.name} to {self.to.name} has no "
                        "device form (Spark's neither)")
            if dec_dst and other in (FLOAT32, FLOAT64) \
                    and self.to.scale > 22:
                return (f"cast from {src.name} to {self.to.name}: a scale "
                        f"past 22 arrives with {DECIMAL_ITEM}")
            return None
        if src.name == "void" and self.to.device_backed:
            return None
        if src == STRING or self.to == STRING or \
                not src.device_backed or not self.to.device_backed:
            return (f"cast from {src.name} to {self.to.name} arrives with "
                    f"{_slice_for(src, self.to)}")
        return (f"cast from {src.name} to {self.to.name} has no device "
                "form (the reference's neither)")

    def eval_device(self, ctx) -> DVal:
        c = self.children[0].eval_device(ctx)
        src, dst = c.dtype, self.to
        if src == dst:
            return c
        if isinstance(dst, DecimalType):
            if src.name == "void":
                return DVal(torch.zeros_like(c.validity, dtype=torch.int64),
                            c.validity, dst)
            return DVal(*to_decimal(c, dst), dst)
        if isinstance(src, DecimalType):
            return DVal(*_from_decimal(c.data, c.validity, src, dst), dst)
        d, valid = c.data, c.validity
        tdt = torch_dtype(dst)
        if dst == BOOL:
            out = d != 0
        elif src == DATE and dst == TIMESTAMP:
            out = d.to(torch.int64) * _MICROS_PER_DAY
        elif src == TIMESTAMP and dst == DATE:
            out = torch.div(d, _MICROS_PER_DAY,
                            rounding_mode="floor").to(torch.int32)
        elif src == TIMESTAMP and tdt.is_floating_point:
            out = (d.to(torch.float64) / _MICROS_PER_SECOND).to(tdt)
        elif src == TIMESTAMP:
            out = torch.div(d, _MICROS_PER_SECOND,
                            rounding_mode="floor").to(tdt)
        elif dst == TIMESTAMP and d.is_floating_point():
            d = d.to(torch.float64)
            valid = torch.logical_and(valid, torch.isfinite(d))
            out = float_to_int_java(d * _MICROS_PER_SECOND, torch.int64)
        elif dst == TIMESTAMP and src != BOOL:
            d = d.to(torch.int64)
            lim = _LONG_MAX // _MICROS_PER_SECOND
            out = torch.where(d > lim, torch.full_like(d, _LONG_MAX),
                              torch.where(d < -lim,
                                          torch.full_like(d, -_LONG_MAX - 1),
                                          d * _MICROS_PER_SECOND))
        elif d.is_floating_point() and not tdt.is_floating_point:
            out = float_to_int_java(d, tdt)
        else:
            out = d.to(tdt)
        return DVal(out, valid, dst)

    def key(self):
        return f"cast({self.children[0].key()} as {self.to.name})"

    @property
    def name_hint(self):
        return f"CAST({self.children[0].name_hint} AS {self.to.name})"
