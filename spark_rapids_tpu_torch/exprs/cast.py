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

Casts from or to strings run on the reference's host engine; the port
refuses them at planning, naming the strings slice. Decimals are refused
naming their own item (ROADMAP.md Queue A).
"""
from __future__ import annotations

import torch

from ..types import (BOOL, DATE, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64,
                     STRING, TIMESTAMP, DataType, Schema, torch_dtype)
from .base import DVal, Expression

__all__ = ["Cast", "float_to_int_java"]

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
    if "decimal" in src.name or "decimal" in dst.name:
        return "the decimals item (ROADMAP.md Queue A)"
    return "the strings slice (ROADMAP.md Queue A, slice 7)"


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
