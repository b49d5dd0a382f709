"""Aggregate functions (port of ``spark_rapids_tpu/exprs/aggregates.py``:
Sum, Count, CountStar, Average, keyless and keyed).

Each aggregate declares
  update   : per-row values  -> partials     (per batch)
  merge    : partials        -> partials     (across batches)
  finalize : partials        -> result
with Spark's null semantics: sum/avg ignore nulls and are null over no
rows; count is never null.

Every update here reduces to ``_seg_sum``: per group, the sum of a
column over its valid live rows and the count of those rows. So each
aggregate names those columns (``sum_inputs``) and builds its partials
from their (sum, count) pairs (``from_sums``). ``update`` reduces them
over a segment context (columnar/segmented.py); the dense groupby path
reduces every aggregate's columns in one kernel launch and hands each
aggregate its pairs (exec/aggregate.py).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..types import DataType, FLOAT64, INT64, Schema
from .base import DVal, Expression, Literal

__all__ = ["AggregateExpression", "Sum", "Count", "CountStar", "Average"]

#: a column to reduce: (data or None, validity or None). No data: only
#: the count is needed. No validity: every live row counts.
SumInput = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _seg_sum(data, valid, seg):
    """(sum of the valid live values, count of them) per segment of
    ``seg``; the sum is None when ``data`` is."""
    if valid is None:
        valid = seg.live
    s = None if data is None else seg.sum(data, valid)
    return s, seg.count(valid)


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

    def sum_inputs(self, vals: List[DVal]) -> List[SumInput]:
        """The columns whose per-group (sum, count) the update needs."""
        raise NotImplementedError

    def from_sums(self, sums: list) -> list:
        """(sum, count) per column of ``sum_inputs`` -> list of
        (data, validity) partials."""
        raise NotImplementedError

    def update(self, vals: List[DVal], seg):
        """per-row DVals -> list of (data, validity) partials over the
        segments of ``seg`` (its live rows)."""
        return self.from_sums([_seg_sum(d, v, seg)
                               for d, v in self.sum_inputs(vals)])

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

    def sum_inputs(self, vals):
        v = vals[0]
        acc = torch.int64 if not v.data.is_floating_point() \
            else torch.float64
        return [(v.data.to(acc), v.validity)]

    def from_sums(self, sums):
        s, cnt = sums[0]
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

    def sum_inputs(self, vals):
        return [(None, vals[0].validity)]

    def from_sums(self, sums):
        cnt = sums[0][1]
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

    def sum_inputs(self, vals):
        return [(None, None)]


class Average(AggregateExpression):
    def data_type(self, schema):
        return FLOAT64

    def partial_types(self, schema):
        return [FLOAT64, INT64]      # sum, count

    def sum_inputs(self, vals):
        v = vals[0]
        return [(v.data.to(torch.float64), v.validity)]

    def from_sums(self, sums):
        s, cnt = sums[0]
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
