"""Window function expressions (port of
``spark_rapids_tpu/exprs/window_fns.py``).

These are markers consumed by exec/window.py; they do not evaluate
standalone, as in the reference, where window functions exist only
inside a window exec.
"""
from __future__ import annotations

from typing import Optional

from ..types import FLOAT64, INT32, DataType, Schema
from .base import Expression

__all__ = ["WindowFunction", "RowNumber", "Rank", "DenseRank",
           "PercentRank", "NthValue", "NTile", "Lag", "Lead"]


class WindowFunction:
    """Base marker. data_type(schema) like aggregates."""

    #: the value column the function reads, if any
    child: Optional[Expression] = None

    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    @property
    def name_hint(self) -> str:
        return type(self).__name__.lower()

    def device_unsupported_reason(self, schema) -> Optional[str]:
        return None


class RowNumber(WindowFunction):
    def data_type(self, schema):
        return INT32


class Rank(WindowFunction):
    def data_type(self, schema):
        return INT32


class DenseRank(WindowFunction):
    def data_type(self, schema):
        return INT32


class PercentRank(WindowFunction):
    """(rank - 1) / (partition rows - 1); 0.0 for 1-row partitions
    (ref GpuPercentRank)."""

    def data_type(self, schema):
        return FLOAT64


class NthValue(WindowFunction):
    """nth_value(e, n): the value of the n-th row of the row's frame;
    NULL while the frame holds fewer than n rows (ref GpuNthValue)."""

    def __init__(self, child: Expression, n: int):
        self.child = child
        self.n = int(n)
        if self.n < 1:
            raise ValueError("nth_value offset must be >= 1")

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def name_hint(self):
        return f"nth_value({self.child.name_hint},{self.n})"

    def device_unsupported_reason(self, schema):
        return self.child.fully_device_supported(schema)


class NTile(WindowFunction):
    def __init__(self, n: int):
        self.n = n

    def data_type(self, schema):
        return INT32


class Lag(WindowFunction):
    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.child = child
        self.offset = offset
        self.default = default

    @property
    def signed_offset(self) -> int:
        """Shift distance with direction baked in (+N looks back).
        Lead overrides — call sites must use THIS, not an isinstance
        ternary: Lead subclasses Lag, so a Lag-first check silently
        gives lead() lag semantics."""
        return self.offset

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def name_hint(self):
        return f"lag({self.child.name_hint},{self.offset})"

    def device_unsupported_reason(self, schema):
        return self.child.fully_device_supported(schema)


class Lead(Lag):
    def __init__(self, child: Expression, offset: int = 1, default=None):
        super().__init__(child, offset, default)

    @property
    def signed_offset(self) -> int:
        return -self.offset

    @property
    def name_hint(self):
        return f"lead({self.child.name_hint},{self.offset})"
