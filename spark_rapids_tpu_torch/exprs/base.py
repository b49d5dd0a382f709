"""Expression core (port of ``spark_rapids_tpu/exprs/base.py``).

Values travel as (data, validity) tensor pairs and evaluate eagerly on
the batch's device: the reference traces an operator's expressions into
one jitted XLA kernel, PyTorch runs each op as it comes. Null semantics
follow Spark: most expressions are null-propagating (validity = AND of
the children's); AND/OR use Kleene logic (logical.py).
"""
from __future__ import annotations

import datetime
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..types import (BOOL, DATE, DataType, FLOAT32, FLOAT64, INT8, INT16,
                     INT32, INT64, NULLTYPE, STRING, Schema, TIMESTAMP,
                     TypeSig, deviceNative, from_numpy_dtype, torch_dtype)

__all__ = ["DVal", "StrVal", "EvalContext", "Expression", "ColumnRef",
           "Literal", "Alias", "Unsupported",
           "promote_types", "null_and"]


class Unsupported(Exception):
    """An expression cannot run on the device."""


class StrVal(NamedTuple):
    """A STRING value as a byte rectangle (columnar/strrect.py):
    bytes_[P, W] uint8 zero past each row's length, lengths[P] int32."""
    bytes_: torch.Tensor
    lengths: torch.Tensor


class DVal(NamedTuple):
    """A device value: data (or a StrVal) + validity mask + dtype."""
    data: object
    validity: torch.Tensor
    dtype: DataType


class EvalContext:
    """Context handed to Expression.eval_device: the input DVals by
    ordinal, the true row count and the padded length, the device, and
    the values of a filter's dictionary slots (compiler.py _DictSlot)."""

    def __init__(self, schema: Schema, columns: Sequence[Optional[DVal]],
                 num_rows: int, padded_len: int, device,
                 slots: Sequence[DVal] = ()):
        self.schema = schema
        self.columns = list(columns)
        self.num_rows = num_rows
        self.padded_len = padded_len
        self.device = device
        self.slots = slots

    def row_mask(self) -> torch.Tensor:
        """bool[P]: True for real rows, False for padding."""
        return torch.arange(self.padded_len,
                            device=self.device) < self.num_rows


class Expression:
    children: List["Expression"] = []

    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    @property
    def name_hint(self) -> str:
        return str(self)

    def references(self) -> List[str]:
        out: List[str] = []
        for c in self.children:
            out.extend(c.references())
        return out

    #: types this expression supports on the device (child and output)
    device_type_sig: TypeSig = deviceNative

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        """None if this node (children aside) can run on the device."""
        dt = self.data_type(schema)
        r = self.device_type_sig.reason_not_supported(dt)
        if r is not None:
            return f"{type(self).__name__}: output {r}"
        for c in self.children:
            cdt = c.data_type(schema)
            if cdt == NULLTYPE:
                continue
            cr = self.device_type_sig.reason_not_supported(cdt)
            if cr is not None:
                return f"{type(self).__name__}: input {cr}"
        return None

    def fully_device_supported(self, schema: Schema) -> Optional[str]:
        r = self.device_unsupported_reason(schema)
        if r:
            return r
        for c in self.children:
            r = c.fully_device_supported(schema)
            if r:
                return r
        return None

    def eval_device(self, ctx: EvalContext) -> DVal:
        raise Unsupported(f"{type(self).__name__} has no device form")

    def key(self) -> str:
        kids = ",".join(c.key() for c in self.children)
        return f"{type(self).__name__}({kids})"

    def __repr__(self):
        return self.key()


class ColumnRef(Expression):
    """Named attribute reference."""

    def __init__(self, name: str):
        self.name = name
        self.children = []

    def data_type(self, schema: Schema) -> DataType:
        return schema[self.name].dtype

    def references(self):
        return [self.name]

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        dt = schema[self.name].dtype
        if dt.device_backed:
            return None
        return f"column {self.name}: {dt.name} is host-only"

    def eval_device(self, ctx: EvalContext) -> DVal:
        return ctx.columns[ctx.schema.index_of(self.name)]

    def key(self):
        return f"col({self.name})"

    @property
    def name_hint(self):
        return self.name


def _literal_type(value) -> DataType:
    if value is None:
        return NULLTYPE
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return INT32 if -(2**31) <= value < 2**31 else INT64
    if isinstance(value, float):
        return FLOAT64
    if isinstance(value, str):
        return STRING
    if isinstance(value, np.datetime64):
        unit = np.datetime_data(value.dtype)[0]
        return DATE if unit in ("D", "W", "M", "Y") else TIMESTAMP
    if isinstance(value, datetime.datetime):
        return TIMESTAMP
    if isinstance(value, datetime.date):
        return DATE
    if isinstance(value, np.generic):
        return from_numpy_dtype(value.dtype)
    raise TypeError(f"cannot infer literal type for {value!r}")


def _canonical_literal(value, dtype: DataType):
    """Date/timestamp literals as their device value (DATE int32 days,
    TIMESTAMP int64 microseconds)."""
    if value is None:
        return None
    if dtype == DATE and not isinstance(value, (int, np.integer)):
        return int(np.datetime64(value, "D").astype(np.int64))
    if dtype == TIMESTAMP and not isinstance(value, (int, np.integer)):
        return int(np.datetime64(value, "us").astype(np.int64))
    if isinstance(value, np.generic):
        return value.item()
    return value


class Literal(Expression):
    def __init__(self, value, dtype: Optional[DataType] = None):
        self.dtype = dtype if dtype is not None else _literal_type(value)
        self.value = _canonical_literal(value, self.dtype)
        self.children = []

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        if self.value is None:
            return None
        if not self.dtype.device_backed:
            return f"literal of host-only type {self.dtype.name}"
        return None

    def eval_device(self, ctx: EvalContext) -> DVal:
        p = ctx.padded_len
        if self.value is None:
            tdt = torch_dtype(self.dtype) if self.dtype.device_backed \
                else torch.int32
            return DVal(torch.zeros(p, dtype=tdt, device=ctx.device),
                        torch.zeros(p, dtype=torch.bool, device=ctx.device),
                        self.dtype)
        data = torch.full((p,), self.value, dtype=torch_dtype(self.dtype),
                          device=ctx.device)
        return DVal(data, torch.ones(p, dtype=torch.bool, device=ctx.device),
                    self.dtype)

    def key(self):
        return f"lit({self.value!r}:{self.dtype.name})"

    @property
    def name_hint(self):
        return repr(self.value)


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = [child]
        self.name = name

    def data_type(self, schema: Schema) -> DataType:
        return self.children[0].data_type(schema)

    def device_unsupported_reason(self, schema):
        return None

    def eval_device(self, ctx: EvalContext) -> DVal:
        return self.children[0].eval_device(ctx)

    def key(self):
        return self.children[0].key()

    @property
    def name_hint(self):
        return self.name


_NUMERIC_ORDER = [INT8, INT16, INT32, INT64, FLOAT32, FLOAT64]


def promote_types(l: DataType, r: DataType) -> DataType:
    if l == r:
        return l
    try:
        li, ri = _NUMERIC_ORDER.index(l), _NUMERIC_ORDER.index(r)
    except ValueError:
        raise TypeError(f"cannot promote {l} and {r}")
    return _NUMERIC_ORDER[max(li, ri)]


def null_and(*validities):
    out = validities[0]
    for v in validities[1:]:
        out = torch.logical_and(out, v)
    return out
