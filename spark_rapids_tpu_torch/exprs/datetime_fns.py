"""Date arithmetic (port of ``spark_rapids_tpu/exprs/datetime_fns.py``,
``DateAdd`` and ``DateSub`` only: the SQL lowering turns ``date ± interval
n day`` into them). The other date and time functions arrive with slice 9.
"""
from __future__ import annotations

import torch

from ..types import DATE, DataType, Schema, TypeEnum, TypeSig
from .base import DVal, Expression, null_and

__all__ = ["DateAdd", "DateSub"]


class DateAdd(Expression):
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
