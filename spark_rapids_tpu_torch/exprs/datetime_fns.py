"""Date and time functions (port of ``spark_rapids_tpu/exprs/datetime_fns.py``:
every class the reference evaluates on its device).

Dates are int32 days since 1970-01-01 and timestamps int64 microseconds
since the epoch, UTC. Fields come from integer civil-calendar arithmetic
(Howard Hinnant's ``civil_from_days`` / ``days_from_civil``) in int64
torch ops, which needs floor division and floor modulo throughout:
``torch.div(..., rounding_mode="floor")`` and ``torch.remainder`` (the
divisor's sign), never ``fmod``, so that dates before 1970 and negative
timestamps come out right.

The classes the reference always sends to its host engine keep a named
refusal here: ``from_utc_timestamp``/``to_utc_timestamp`` (the IANA
database), ``from_unixtime`` and ``date_format`` (strftime), and
``months_between`` (no device form in the reference); so does the string
form of ``to_unix_timestamp``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..types import (DATE, FLOAT64, INT32, INT64, NESTED_REST, STRING,
                     TIMESTAMP, DataType, Schema, TypeEnum, TypeSig)
from .base import DVal, Expression, null_and

__all__ = ["DateAdd", "DateSub", "DateAddInterval", "Year", "Month",
           "DayOfMonth", "Hour", "Minute", "Second", "DayOfWeek", "WeekDay",
           "DayOfYear", "Quarter", "DateDiff", "UnixDate", "LastDay",
           "AddMonths", "MonthsBetween", "SecondsToTimestamp",
           "MillisToTimestamp", "MicrosToTimestamp", "ToUnixTimestamp",
           "UnixTimestamp", "FromUnixTime", "DateFormatClass", "TimeAdd",
           "TruncDate", "FromUtcTimestamp", "ToUtcTimestamp",
           "civil_from_days", "days_from_civil"]

_MICROS_PER_DAY = 86_400_000_000
_date_sig = TypeSig([TypeEnum.DATE, TypeEnum.TIMESTAMP])
_int_sig = TypeSig([TypeEnum.BYTE, TypeEnum.SHORT, TypeEnum.INT])
#: where the host-only functions are queued
_HOST_ONLY = ("runs on the reference's host engine only; the port has no "
              "host engine (ROADMAP.md Queue A, the host-only functions: "
              "{})")


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _days_of(v: DVal) -> torch.Tensor:
    """A date or timestamp value as int64 days since the epoch."""
    if v.dtype == TIMESTAMP:
        return _fdiv(v.data, _MICROS_PER_DAY)
    return v.data.to(torch.int64)


def civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day), int64 tensors."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = yoe + era * 400 + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> int64 days since 1970-01-01."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m.to(torch.int64) + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    leap = (torch.remainder(y, 4) == 0) & (
        (torch.remainder(y, 100) != 0) | (torch.remainder(y, 400) == 0))
    base = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                        dtype=torch.int64, device=y.device)
    dim = base[(m - 1).clamp(0, 11)]
    return torch.where((m == 2) & leap, torch.full_like(dim, 29), dim)


class _DateExpr(Expression):
    """``device_type_sig`` names the input types; the result is a
    fixed-width type of the device."""

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        for c in self.children:
            cdt = c.data_type(schema)
            r = self.device_type_sig.reason_not_supported(cdt)
            if r is not None and cdt.name != "void":
                return f"{type(self).__name__}: input {r}"
        return None


class _Unary(_DateExpr):
    def __init__(self, child: Expression):
        self.children = [child]

    def key(self):
        return f"{type(self).__name__.lower()}({self.children[0].key()})"


class _DateField(_Unary):
    """An int field of a date or timestamp's calendar date."""
    device_type_sig = _date_sig

    def data_type(self, schema: Schema):
        return INT32

    def _field(self, y, m, d, days):
        raise NotImplementedError

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        days = _days_of(v)
        y, m, d = civil_from_days(days)
        return DVal(self._field(y, m, d, days).to(torch.int32), v.validity,
                    INT32)


class Year(_DateField):
    def _field(self, y, m, d, days):
        return y


class Month(_DateField):
    def _field(self, y, m, d, days):
        return m


class DayOfMonth(_DateField):
    def _field(self, y, m, d, days):
        return d


class Quarter(_DateField):
    def _field(self, y, m, d, days):
        return _fdiv(m + 2, 3)


class DayOfWeek(_DateField):
    """Spark's dayofweek: 1 = Sunday ... 7 = Saturday (1970-01-01 was a
    Thursday)."""

    def _field(self, y, m, d, days):
        return torch.remainder(days + 4, 7) + 1


class WeekDay(_DateField):
    """Spark's weekday: 0 = Monday ... 6 = Sunday."""

    def _field(self, y, m, d, days):
        return torch.remainder(days + 3, 7)


class DayOfYear(_DateField):
    def _field(self, y, m, d, days):
        one = torch.ones_like(y)
        return days - days_from_civil(y, one, one) + 1


class _TimeField(_Unary):
    """hour/minute/second of a timestamp's UTC time of day (a date is at
    midnight)."""
    device_type_sig = _date_sig
    divisor = 1
    modulo = 60

    def data_type(self, schema):
        return INT32

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        if v.dtype != TIMESTAMP:
            return DVal(torch.zeros_like(v.data, dtype=torch.int32),
                        v.validity, INT32)
        in_day = torch.remainder(v.data, _MICROS_PER_DAY)
        out = torch.remainder(_fdiv(in_day, self.divisor), self.modulo)
        return DVal(out.to(torch.int32), v.validity, INT32)


class Hour(_TimeField):
    divisor = 3_600_000_000
    modulo = 24


class Minute(_TimeField):
    divisor = 60_000_000


class Second(_TimeField):
    divisor = 1_000_000


class DateAdd(_DateExpr):
    """``date_add(date, days)``: a date (ref ``GpuDateAdd``); ``sub``
    subtracts the days."""

    device_type_sig = TypeSig([TypeEnum.DATE, TypeEnum.BYTE, TypeEnum.SHORT,
                               TypeEnum.INT])

    def __init__(self, date: Expression, days: Expression,
                 sub: bool = False):
        self.children = [date, days]
        self.sub = sub

    def data_type(self, schema: Schema) -> DataType:
        return DATE

    def eval_device(self, ctx) -> DVal:
        d = self.children[0].eval_device(ctx)
        n = self.children[1].eval_device(ctx)
        delta = n.data.to(torch.int32)
        out = d.data.to(torch.int32) + (-delta if self.sub else delta)
        return DVal(out, null_and(d.validity, n.validity), DATE)

    def key(self):
        op = "date_sub" if self.sub else "date_add"
        return f"{op}({self.children[0].key()},{self.children[1].key()})"


def DateSub(date: Expression, days: Expression) -> DateAdd:
    """``date_sub(date, days)``: a ``DateAdd`` of the negated days."""
    return DateAdd(date, days, sub=True)


class DateDiff(_DateExpr):
    """datediff(end, start): int days from start to end."""
    device_type_sig = _date_sig

    def __init__(self, end: Expression, start: Expression):
        self.children = [end, start]

    def data_type(self, schema):
        return INT32

    def eval_device(self, ctx) -> DVal:
        e = self.children[0].eval_device(ctx)
        s = self.children[1].eval_device(ctx)
        return DVal((_days_of(e) - _days_of(s)).to(torch.int32),
                    null_and(e.validity, s.validity), INT32)

    def key(self):
        return f"datediff({self.children[0].key()},{self.children[1].key()})"


class UnixDate(_Unary):
    """unix_date(date): int days since the epoch."""
    device_type_sig = TypeSig([TypeEnum.DATE])

    def data_type(self, schema):
        return INT32

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        return DVal(v.data.to(torch.int32), v.validity, INT32)

    def key(self):
        return f"unix_date({self.children[0].key()})"


class LastDay(_Unary):
    """last_day(date): the last day of its month."""
    device_type_sig = _date_sig

    def data_type(self, schema):
        return DATE

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        days = _days_of(v)
        y, m, d = civil_from_days(days)
        out = days + _days_in_month(y, m) - d
        return DVal(out.to(torch.int32), v.validity, DATE)

    def key(self):
        return f"last_day({self.children[0].key()})"


class AddMonths(_DateExpr):
    """add_months(date, n): calendar months, the day clamped to the
    target month's end (Spark 3)."""
    device_type_sig = _date_sig + _int_sig

    def __init__(self, date: Expression, months: Expression):
        self.children = [date, months]

    def data_type(self, schema):
        return DATE

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        n = self.children[1].eval_device(ctx)
        y, m, d = civil_from_days(_days_of(v))
        t = y * 12 + (m - 1) + n.data.to(torch.int64)
        ny = _fdiv(t, 12)
        nm = t - ny * 12 + 1
        nd = torch.minimum(d, _days_in_month(ny, nm))
        return DVal(days_from_civil(ny, nm, nd).to(torch.int32),
                    null_and(v.validity, n.validity), DATE)

    def key(self):
        return (f"add_months({self.children[0].key()},"
                f"{self.children[1].key()})")


class _HostOnly(Expression):
    """A function the reference evaluates on its host engine only."""
    queued = "?"

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        return f"{self.name_hint} " + _HOST_ONLY.format(self.queued)


class MonthsBetween(_HostOnly):
    """months_between(end, start[, roundOff]) (the reference has no device
    form)."""
    queued = "queued with " + NESTED_REST

    def __init__(self, end, start, round_off: bool = True):
        self.children = [end, start]
        self.round_off = bool(round_off)

    def data_type(self, schema):
        return FLOAT64

    def key(self):
        return (f"months_between({self.children[0].key()},"
                f"{self.children[1].key()},{self.round_off})")


class _ScaledToTimestamp(_Unary):
    """timestamp_seconds/millis/micros: an integer -> a timestamp."""
    device_type_sig = TypeSig([TypeEnum.BYTE, TypeEnum.SHORT, TypeEnum.INT,
                               TypeEnum.LONG])
    scale = 1

    def data_type(self, schema):
        return TIMESTAMP

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        return DVal(v.data.to(torch.int64) * type(self).scale, v.validity,
                    TIMESTAMP)

    def key(self):
        return f"{type(self).__name__}({self.children[0].key()})"


class SecondsToTimestamp(_ScaledToTimestamp):
    scale = 1_000_000


class MillisToTimestamp(_ScaledToTimestamp):
    scale = 1_000


class MicrosToTimestamp(_ScaledToTimestamp):
    scale = 1


class ToUnixTimestamp(_Unary):
    """to_unix_timestamp(ts): bigint seconds of a timestamp (the floor) or
    a date; a string's parse runs on the reference's host engine."""
    device_type_sig = _date_sig

    def __init__(self, child, fmt: str = "yyyy-MM-dd HH:mm:ss"):
        self.children = [child]
        self.fmt = fmt

    def data_type(self, schema):
        return INT64

    def device_unsupported_reason(self, schema):
        if self.children[0].data_type(schema) == STRING:
            return (f"{type(self).__name__} of a string parses it on the "
                    "reference's host engine; it arrives with the strings "
                    "slice (ROADMAP.md Queue A, slice 7)")
        return super().device_unsupported_reason(schema)

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        if v.dtype == TIMESTAMP:
            out = _fdiv(v.data, 1_000_000)
        else:
            out = v.data.to(torch.int64) * 86400
        return DVal(out, v.validity, INT64)

    def key(self):
        return f"{type(self).__name__}({self.children[0].key()},{self.fmt})"


class UnixTimestamp(ToUnixTimestamp):
    """unix_timestamp(...): the same as to_unix_timestamp."""


class FromUnixTime(_HostOnly):
    """from_unixtime(seconds, fmt): a string (strftime on the reference's
    host)."""
    queued = "queued with the strings slice, slice 7"

    def __init__(self, child, fmt: str = "yyyy-MM-dd HH:mm:ss"):
        self.children = [child]
        self.fmt = fmt

    def data_type(self, schema):
        return STRING

    def key(self):
        return f"from_unixtime({self.children[0].key()},{self.fmt})"


class DateFormatClass(_HostOnly):
    """date_format(ts, fmt): a string (strftime on the reference's
    host)."""
    queued = "queued with the strings slice, slice 7"

    def __init__(self, child, fmt: str):
        self.children = [child]
        self.fmt = fmt

    def data_type(self, schema):
        return STRING

    def key(self):
        return f"date_format({self.children[0].key()},{self.fmt})"


class _TzConvert(_HostOnly):
    """from/to_utc_timestamp: a named zone's offsets from the IANA
    database, on the reference's host."""
    queued = "the time-zone functions, queued with slice 13"

    def __init__(self, child: Expression, tz: str):
        self.children = [child]
        self.tz = tz

    def data_type(self, schema):
        return TIMESTAMP

    def key(self):
        return f"{type(self).__name__}({self.children[0].key()},{self.tz})"


class FromUtcTimestamp(_TzConvert):
    @property
    def name_hint(self):
        return f"from_utc_timestamp({self.children[0].name_hint},{self.tz})"


class ToUtcTimestamp(_TzConvert):
    @property
    def name_hint(self):
        return f"to_utc_timestamp({self.children[0].name_hint},{self.tz})"


class TimeAdd(_Unary):
    """timestamp + an interval of microseconds (a literal)."""
    device_type_sig = TypeSig([TypeEnum.TIMESTAMP])

    def __init__(self, child, interval_micros: int):
        self.children = [child]
        self.micros = int(interval_micros)

    def data_type(self, schema):
        return TIMESTAMP

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        return DVal(v.data + self.micros, v.validity, TIMESTAMP)

    def key(self):
        return f"time_add({self.children[0].key()},{self.micros})"


class DateAddInterval(_Unary):
    """date + an interval of days (a literal)."""
    device_type_sig = TypeSig([TypeEnum.DATE])

    def __init__(self, child, interval_days: int):
        self.children = [child]
        self.days = int(interval_days)

    def data_type(self, schema):
        return DATE

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        return DVal(v.data + self.days, v.validity, DATE)

    def key(self):
        return f"date_add_interval({self.children[0].key()},{self.days})"


class TruncDate(_Unary):
    """trunc(date, fmt): the first day of its year, quarter, month or
    (Monday) week; NULL for another format, as Spark gives."""
    device_type_sig = TypeSig([TypeEnum.DATE])

    _LEVELS = {"year": "year", "yyyy": "year", "yy": "year",
               "quarter": "quarter", "month": "month", "mon": "month",
               "mm": "month", "week": "week"}

    def __init__(self, child, fmt: str):
        self.children = [child]
        self.fmt = str(fmt).lower()

    def data_type(self, schema):
        return DATE

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        days = _days_of(v)
        level = self._LEVELS.get(self.fmt)
        if level is None:
            return DVal(torch.zeros_like(v.data), torch.zeros_like(v.validity),
                        DATE)
        if level == "week":
            out = days - torch.remainder(days + 3, 7)
        else:
            y, m, _ = civil_from_days(days)
            one = torch.ones_like(m)
            nm = {"year": one, "month": m,
                  "quarter": _fdiv(m - 1, 3) * 3 + 1}[level]
            out = days_from_civil(y, nm, one)
        return DVal(out.to(torch.int32), v.validity, DATE)

    def key(self):
        return f"trunc({self.children[0].key()},{self.fmt})"
