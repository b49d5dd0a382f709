"""Casts (port of ``spark_rapids_tpu/exprs/cast.py``, the widening numeric
casts the plan rewrites make: any numeric or bool value to bigint or
double). The other casts arrive with slice 9.
"""
from __future__ import annotations

from ..types import BOOL, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, \
    DataType, Schema, torch_dtype
from .base import DVal, Expression

__all__ = ["Cast"]

_FROM = (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64)


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
        if self.to == FLOAT64 and src in _FROM or \
                self.to == INT64 and src in _FROM[:5]:
            return None
        return (f"cast from {src.name} to {self.to.name} arrives with "
                "slice 9 (the rest of exprs/cast.py)")

    def eval_device(self, ctx) -> DVal:
        c = self.children[0].eval_device(ctx)
        return DVal(c.data.to(torch_dtype(self.to)), c.validity, self.to)

    def key(self):
        return f"cast({self.children[0].key()} as {self.to.name})"

    @property
    def name_hint(self):
        return f"CAST({self.children[0].name_hint} AS {self.to.name})"
