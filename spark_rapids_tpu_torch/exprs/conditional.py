"""Conditional expressions (port of ``spark_rapids_tpu/exprs/conditional.py``:
``If``, ``CaseWhen``, ``Coalesce``, ``NullIf``, ``Greatest``, ``Least``,
``NaNvl``, ``AtLeastNNonNulls``, the optimizer's hints ``KnownNotNull``
and ``KnownFloatingPointNormalized``, and ``NormalizeNaNAndZero``).

A NULL predicate picks the next branch (SQL: only TRUE selects), and the
first matching branch wins. An untyped ``lit(None)`` else is the absent
else: every row no branch takes is NULL. ``If`` and ``CaseWhen`` take
numeric, bool, decimal, date and timestamp results here; a string-typed
one is refused at planning until the strings slice. A decimal result
takes each branch rescaled to the common decimal type (NULL past its
precision); a double result takes a decimal branch as its nearest
double.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..types import (BOOL, NULLTYPE, STRING, DataType, DecimalType, Schema,
                     TypeSig, decimal_sig, deviceNative, torch_dtype)
from .base import DVal, Expression, promote_types

__all__ = ["If", "CaseWhen", "Coalesce", "NullIf", "Greatest", "Least",
           "NaNvl", "AtLeastNNonNulls", "KnownNotNull",
           "KnownFloatingPointNormalized", "NormalizeNaNAndZero"]


def _common_type(schema: Schema, exprs) -> DataType:
    """The promoted type of ``exprs``, untyped NULLs aside."""
    dt = None
    for e in exprs:
        edt = e.data_type(schema)
        if edt == NULLTYPE:
            continue
        dt = edt if dt is None else promote_types(dt, edt)
    return dt if dt is not None else exprs[0].data_type(schema)


def _result_reason(expr: Expression, schema: Schema) -> Optional[str]:
    dt = expr.data_type(schema)
    if dt == STRING:
        return (f"{type(expr).__name__} with a string result arrives with "
                "slice 7 (string expressions)")
    if not dt.device_backed:
        return f"{type(expr).__name__}: result type {dt.name} is host-only"
    return None


#: the types a conditional takes and gives on the device
_SIG: TypeSig = deviceNative + decimal_sig


def _as(v: DVal, dt: DataType, tdt: torch.dtype):
    """(data, validity) of a branch's value in the result type ``dt``: a
    decimal result rescales it (NULL past the precision), a decimal
    branch of a numeric result is its nearest double."""
    from .cast import as_double, to_decimal
    if isinstance(dt, DecimalType) and v.dtype != dt:
        return to_decimal(v, dt)
    if isinstance(v.dtype, DecimalType) and not isinstance(dt, DecimalType):
        return as_double(v).to(tdt), v.validity
    return v.data.to(tdt), v.validity


def _select(branches, data, validity, dt, tdt, ctx):
    """Apply (predicate, value) branches in reverse, so the first match
    wins; a NULL predicate selects nothing."""
    for pred, val in reversed(branches):
        p = pred.eval_device(ctx)
        vd, vv = _as(val.eval_device(ctx), dt, tdt)
        cond = torch.logical_and(p.data, p.validity)
        data = torch.where(cond, vd, data)
        validity = torch.where(cond, vv, validity)
    return data, validity


class If(Expression):
    """``if(pred, t, f)`` (ref ``conditional.py:If``)."""

    device_type_sig = _SIG

    def __init__(self, pred: Expression, if_true: Expression,
                 if_false: Expression):
        self.children = [pred, if_true, if_false]

    def data_type(self, schema: Schema) -> DataType:
        return _common_type(schema, self.children[1:])

    def device_unsupported_reason(self, schema: Schema):
        return _result_reason(self, schema) \
            or super().device_unsupported_reason(schema)

    def eval_device(self, ctx) -> DVal:
        dt = self.data_type(ctx.schema)
        tdt = torch_dtype(dt)
        f = self.children[2].eval_device(ctx)
        data, validity = _select([(self.children[0], self.children[1])],
                                 *_as(f, dt, tdt), dt, tdt, ctx)
        return DVal(data, validity, dt)

    def key(self):
        return "if(" + ",".join(c.key() for c in self.children) + ")"


class CaseWhen(Expression):
    """``CASE WHEN p1 THEN v1 ... [ELSE e] END`` (ref
    ``conditional.py:CaseWhen``)."""

    device_type_sig = _SIG

    def __init__(self, branches, else_value: Optional[Expression] = None):
        self.branches = [tuple(b) for b in branches]
        self.else_value = else_value
        self.children = [e for p, v in self.branches for e in (p, v)] + (
            [else_value] if else_value is not None else [])

    def data_type(self, schema: Schema) -> DataType:
        vals = [v for _, v in self.branches] + (
            [self.else_value] if self.else_value is not None else [])
        return _common_type(schema, vals)

    def device_unsupported_reason(self, schema: Schema):
        return _result_reason(self, schema) \
            or super().device_unsupported_reason(schema)

    def _typed_else(self, schema: Schema) -> Optional[Expression]:
        """The else value; an untyped NULL literal (``otherwise(None)``)
        counts as absent, its value being the all-NULL default."""
        ev = self.else_value
        if ev is not None and ev.data_type(schema) == NULLTYPE:
            return None
        return ev

    def eval_device(self, ctx) -> DVal:
        dt = self.data_type(ctx.schema)
        tdt = torch_dtype(dt)
        ev = self._typed_else(ctx.schema)
        if ev is not None:
            data, validity = _as(ev.eval_device(ctx), dt, tdt)
        else:
            data = torch.zeros(ctx.padded_len, dtype=tdt, device=ctx.device)
            validity = torch.zeros(ctx.padded_len, dtype=torch.bool,
                                   device=ctx.device)
        data, validity = _select(self.branches, data, validity, dt, tdt,
                                 ctx)
        return DVal(data, validity, dt)

    def key(self):
        parts = [f"{p.key()}->{v.key()}" for p, v in self.branches]
        if self.else_value is not None:
            parts.append(f"else {self.else_value.key()}")
        return "casewhen(" + ",".join(parts) + ")"

    @property
    def name_hint(self):
        parts = " ".join(f"WHEN {p.name_hint} THEN {v.name_hint}"
                         for p, v in self.branches)
        if self.else_value is not None:
            parts += f" ELSE {self.else_value.name_hint}"
        return f"CASE {parts} END"


class Coalesce(Expression):
    """The first non-null of the children, row by row; untyped NULLs take
    no part in the type."""

    device_type_sig = _SIG

    def __init__(self, *exprs: Expression):
        self.children = list(exprs)

    def data_type(self, schema: Schema) -> DataType:
        return _common_type(schema, self.children)

    def eval_device(self, ctx) -> DVal:
        dt = self.data_type(ctx.schema)
        tdt = torch_dtype(dt)
        data = torch.zeros(ctx.padded_len, dtype=tdt, device=ctx.device)
        valid = torch.zeros(ctx.padded_len, dtype=torch.bool,
                            device=ctx.device)
        for child in reversed(self.children):
            cd, cv = _as(child.eval_device(ctx), dt, tdt)
            data = torch.where(cv, cd, data)
            valid = torch.logical_or(valid, cv)
        return DVal(data, valid, dt)


class NullIf(Expression):
    """``nullif(a, b)``: NULL where ``a = b`` (both non-null), else ``a``
    (ref ``conditional.py:NullIf``). The test is Spark's ``=``: the types
    promoted, NaN equal to NaN."""

    device_type_sig = _SIG

    def __init__(self, a: Expression, b: Expression):
        self.children = [a, b]

    def data_type(self, schema: Schema) -> DataType:
        return self.children[0].data_type(schema)

    def eval_device(self, ctx) -> DVal:
        from .comparison import EqualTo
        a = self.children[0].eval_device(ctx)
        e = EqualTo(*self.children).eval_device(ctx)
        eq = torch.logical_and(e.data, e.validity)
        return DVal(a.data, torch.logical_and(a.validity,
                                              torch.logical_not(eq)),
                    self.data_type(ctx.schema))

    def key(self):
        return (f"nullif({self.children[0].key()},"
                f"{self.children[1].key()})")


class _NarySelect(Expression):
    """``greatest``/``least`` (ref ``conditional.py:_NarySelect``): n-ary,
    NULL operands skipped, NULL only where every operand is; NaN is the
    greatest value (Spark's total order)."""

    device_type_sig = _SIG
    _is_max = True

    def __init__(self, *children: Expression):
        if len(children) < 2:
            raise ValueError("greatest/least take at least two arguments")
        self.children = list(children)

    def data_type(self, schema: Schema) -> DataType:
        return _common_type(schema, self.children)

    def _skip(self, tdt: torch.dtype):
        """The value an operand that takes no part holds."""
        if tdt.is_floating_point:
            return -math.inf if self._is_max else math.inf
        if tdt == torch.bool:
            return not self._is_max
        info = torch.iinfo(tdt)
        return info.min if self._is_max else info.max

    def eval_device(self, ctx) -> DVal:
        dt = self.data_type(ctx.schema)
        tdt = torch_dtype(dt)
        skip = self._skip(tdt)
        acc = any_valid = any_nan = any_num = None
        for c in self.children:
            d, vv = _as(c.eval_device(ctx), dt, tdt)
            v = DVal(d, vv, dt)
            if tdt.is_floating_point:
                nan = torch.isnan(d)
                nan_here = torch.logical_and(nan, v.validity)
                num_here = torch.logical_and(torch.logical_not(nan),
                                             v.validity)
                any_nan = nan_here if any_nan is None else \
                    torch.logical_or(any_nan, nan_here)
                any_num = num_here if any_num is None else \
                    torch.logical_or(any_num, num_here)
                d = torch.where(nan, torch.full_like(d, skip), d)
            d = torch.where(v.validity, d, torch.full_like(d, skip))
            acc = d if acc is None else (torch.maximum(acc, d)
                                         if self._is_max
                                         else torch.minimum(acc, d))
            any_valid = v.validity if any_valid is None else \
                torch.logical_or(any_valid, v.validity)
        if any_nan is not None:
            # greatest: any NaN wins; least: NaN only where no operand is
            # a number (a real +inf must not pass for the skip value)
            take = any_nan if self._is_max else torch.logical_and(
                any_nan, torch.logical_not(any_num))
            acc = torch.where(take, torch.full_like(acc, math.nan), acc)
        return DVal(acc, any_valid, dt)

    def key(self):
        kids = ",".join(c.key() for c in self.children)
        return f"{type(self).__name__}({kids})"


class Greatest(_NarySelect):
    _is_max = True


class Least(_NarySelect):
    _is_max = False


class NaNvl(Expression):
    """``nanvl(a, b)``: ``b`` where ``a`` is NaN, else ``a``."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def data_type(self, schema: Schema) -> DataType:
        return _common_type(schema, self.children)

    def eval_device(self, ctx) -> DVal:
        dt = self.data_type(ctx.schema)
        tdt = torch_dtype(dt)
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        ld, rd = l.data.to(tdt), r.data.to(tdt)
        nan = torch.isnan(ld)
        return DVal(torch.where(nan, rd, ld),
                    torch.where(nan, r.validity, l.validity), dt)

    def key(self):
        return f"nanvl({self.children[0].key()},{self.children[1].key()})"


class AtLeastNNonNulls(Expression):
    """True where at least ``n`` children are non-null and not NaN
    (``df.na.drop``'s predicate); never NULL."""

    def __init__(self, n: int, *children: Expression):
        self.n = int(n)
        self.children = list(children)

    def data_type(self, schema: Schema) -> DataType:
        return BOOL

    def eval_device(self, ctx) -> DVal:
        cnt = torch.zeros(ctx.padded_len, dtype=torch.int32,
                          device=ctx.device)
        for c in self.children:
            v = c.eval_device(ctx)
            good = v.validity
            if isinstance(v.data, torch.Tensor) \
                    and v.data.is_floating_point():
                good = torch.logical_and(good,
                                         torch.logical_not(
                                             torch.isnan(v.data)))
            cnt = cnt + good.to(torch.int32)
        return DVal(cnt >= self.n, torch.ones(ctx.padded_len,
                                              dtype=torch.bool,
                                              device=ctx.device), BOOL)

    def key(self):
        kids = ",".join(c.key() for c in self.children)
        return f"AtLeastNNonNulls({self.n};{kids})"


class _IdentityHint(Expression):
    """An optimizer hint: the child's value unchanged."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema: Schema) -> DataType:
        return self.children[0].data_type(schema)

    def eval_device(self, ctx) -> DVal:
        return self.children[0].eval_device(ctx)

    def key(self):
        return f"{type(self).__name__}({self.children[0].key()})"


class KnownNotNull(_IdentityHint):
    pass


class KnownFloatingPointNormalized(_IdentityHint):
    pass


class NormalizeNaNAndZero(Expression):
    """-0.0 as 0.0 and every NaN as one NaN, so that keys compare as
    Spark's do."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self, schema: Schema) -> DataType:
        return self.children[0].data_type(schema)

    def eval_device(self, ctx) -> DVal:
        v = self.children[0].eval_device(ctx)
        d = v.data
        if d.is_floating_point():
            d = torch.where(torch.isnan(d), torch.full_like(d, math.nan),
                            torch.where(d == 0, torch.zeros_like(d), d))
        return DVal(d, v.validity, v.dtype)

    def key(self):
        return f"normnanzero({self.children[0].key()})"
