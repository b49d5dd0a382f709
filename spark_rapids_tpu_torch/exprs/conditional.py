"""Conditional expressions (port of ``spark_rapids_tpu/exprs/conditional.py``:
``Coalesce``, which a USING-style full join projects its keys through).
"""
from __future__ import annotations

import torch

from ..types import DataType, Schema, torch_dtype
from .base import DVal, Expression, promote_types

__all__ = ["Coalesce"]


class Coalesce(Expression):
    """The first non-null of the children, row by row."""

    def __init__(self, *exprs: Expression):
        self.children = list(exprs)

    def data_type(self, schema: Schema) -> DataType:
        dt = self.children[0].data_type(schema)
        for c in self.children[1:]:
            dt = promote_types(dt, c.data_type(schema))
        return dt

    def eval_device(self, ctx) -> DVal:
        dt = self.data_type(ctx.schema)
        tdt = torch_dtype(dt)
        data = torch.zeros(ctx.padded_len, dtype=tdt, device=ctx.device)
        valid = torch.zeros(ctx.padded_len, dtype=torch.bool,
                            device=ctx.device)
        for child in reversed(self.children):
            c = child.eval_device(ctx)
            data = torch.where(c.validity, c.data.to(tdt), data)
            valid = torch.logical_or(valid, c.validity)
        return DVal(data, valid, dt)
