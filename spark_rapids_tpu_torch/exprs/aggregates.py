"""Aggregate functions (port of ``spark_rapids_tpu/exprs/aggregates.py``:
Sum, Count, CountStar, Average over one segment).

Each aggregate declares
  update   : per-row values  -> partials     (per batch)
  merge    : partials        -> partials     (across batches)
  finalize : partials        -> result
with Spark's null semantics: sum/avg ignore nulls and are null over no
rows; count is never null.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..types import DataType, FLOAT64, INT64, Schema
from .base import DVal, Expression, Literal

__all__ = ["AggregateExpression", "Sum", "Count", "CountStar", "Average"]


def _seg_sum(data, valid, seg):
    """(sum of the valid live values, count of them)."""
    return seg.sum(data, valid), seg.count(valid)


class AggregateExpression:
    """Not an Expression: it appears only in Aggregate nodes."""

    def __init__(self, child: Optional[Expression],
                 name: Optional[str] = None):
        self.child = child
        self._name = name

    @property
    def name_hint(self) -> str:
        if self._name:
            return self._name
        cn = self.child.name_hint if self.child is not None else "*"
        return f"{type(self).__name__.lower()}({cn})"

    def with_name(self, name: str) -> "AggregateExpression":
        self._name = name
        return self

    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        if self.child is None:
            return None
        r = self.child.fully_device_supported(schema)
        if r:
            return r
        dt = self.child.data_type(schema)
        if not dt.device_backed:
            return f"{self.name_hint}: input type {dt.name} is host-only"
        return None

    def input_exprs(self) -> List[Expression]:
        return [self.child] if self.child is not None else []

    def partial_types(self, schema: Schema) -> List[DataType]:
        raise NotImplementedError

    def update(self, vals: List[DVal], seg, row_mask):
        """per-row DVals -> list of (data, validity) partials."""
        raise NotImplementedError

    def merge(self, partials: List[DVal], seg):
        raise NotImplementedError

    def finalize(self, partials: List[DVal]) -> DVal:
        raise NotImplementedError

    def key(self) -> str:
        c = self.child.key() if self.child is not None else "*"
        return f"{type(self).__name__}({c})"


class Sum(AggregateExpression):
    def data_type(self, schema):
        dt = self.child.data_type(schema)
        if dt.name in ("tinyint", "smallint", "int", "bigint"):
            return INT64
        return FLOAT64 if dt.name in ("float", "double") else dt

    def partial_types(self, schema):
        return [self.data_type(schema)]

    def update(self, vals, seg, row_mask):
        v = vals[0]
        acc = torch.int64 if not v.data.is_floating_point() \
            else torch.float64
        s, cnt = _seg_sum(v.data.to(acc), v.validity, seg)
        return [(s, cnt > 0)]

    def merge(self, partials, seg):
        p = partials[0]
        s, cnt = _seg_sum(p.data, p.validity, seg)
        return [(s, cnt > 0)]

    def finalize(self, partials):
        return partials[0]


class Count(AggregateExpression):
    def data_type(self, schema):
        return INT64

    def partial_types(self, schema):
        return [INT64]

    def update(self, vals, seg, row_mask):
        cnt = seg.count(vals[0].validity)
        return [(cnt, torch.ones_like(cnt, dtype=torch.bool))]

    def merge(self, partials, seg):
        p = partials[0]
        s, _ = _seg_sum(p.data, p.validity, seg)
        return [(s, torch.ones_like(s, dtype=torch.bool))]

    def finalize(self, partials):
        p = partials[0]
        return DVal(torch.where(p.validity, p.data, torch.zeros_like(p.data)),
                    torch.ones_like(p.validity), INT64)


class CountStar(Count):
    def __init__(self, name: Optional[str] = None):
        super().__init__(None, name)

    @property
    def name_hint(self):
        return self._name or "count(1)"

    def input_exprs(self):
        return [Literal(1)]

    def update(self, vals, seg, row_mask):
        cnt = seg.count(row_mask)
        return [(cnt, torch.ones_like(cnt, dtype=torch.bool))]


class Average(AggregateExpression):
    def data_type(self, schema):
        return FLOAT64

    def partial_types(self, schema):
        return [FLOAT64, INT64]      # sum, count

    def update(self, vals, seg, row_mask):
        v = vals[0]
        s, cnt = _seg_sum(v.data.to(torch.float64), v.validity, seg)
        return [(s, cnt > 0), (cnt, torch.ones_like(cnt, dtype=torch.bool))]

    def merge(self, partials, seg):
        s, _ = _seg_sum(partials[0].data, partials[0].validity, seg)
        c, _ = _seg_sum(partials[1].data, partials[1].validity, seg)
        return [(s, c > 0), (c, torch.ones_like(c, dtype=torch.bool))]

    def finalize(self, partials):
        s, c = partials[0], partials[1]
        ok = torch.logical_and(s.validity, c.data > 0)
        denom = torch.where(c.data > 0, c.data, torch.ones_like(c.data))
        return DVal(s.data / denom.to(torch.float64), ok, FLOAT64)
