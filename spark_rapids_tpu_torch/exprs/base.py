"""Expression core (port of ``spark_rapids_tpu/exprs/base.py``).

Values travel as (data, validity) tensor pairs and evaluate eagerly on
the batch's device: the reference traces an operator's expressions into
one jitted XLA kernel, PyTorch runs each op as it comes. Null semantics
follow Spark: most expressions are null-propagating (validity = AND of
the children's); AND/OR use Kleene logic (logical.py).
"""
from __future__ import annotations

import datetime
import decimal
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..types import (BOOL, DATE, DataType, DecimalType, FLOAT32, FLOAT64,
                     INT8, INT16, INT32, INT64, NULLTYPE, STRING, Schema,
                     TIMESTAMP, TypeSig, deviceNative, from_numpy_dtype,
                     integral_decimal, torch_dtype)

__all__ = ["DVal", "StrVal", "ListVal", "MapVal", "StructVal", "EvalContext",
           "Expression",
           "ColumnRef",
           "Literal", "Alias", "Unsupported",
           "promote_types", "null_and", "wider_decimal",
           "decimal_literal_type", "unscaled"]


class Unsupported(Exception):
    """An expression cannot run on the device."""


class StrVal(NamedTuple):
    """A STRING value as a byte rectangle (columnar/strrect.py):
    bytes_[P, W] uint8 zero past each row's length, lengths[P] int32."""
    bytes_: torch.Tensor
    lengths: torch.Tensor


class ListVal(NamedTuple):
    """An ARRAY value as a rectangle (columnar/nested.py): values[P, W],
    elem_valid[P, W] (False past each row's length), lengths[P] int32."""
    values: torch.Tensor
    elem_valid: torch.Tensor
    lengths: torch.Tensor


class MapVal(NamedTuple):
    """A MAP value (or a map's entries) as two rectangles over one set of
    lengths (columnar/nested.py): the keys' ListVal, whose slots are all
    valid up to each row's length, and the values'."""
    keys: ListVal
    values: ListVal


class StructVal(NamedTuple):
    """A STRUCT value: its fields' device columns (columnar/nested.py),
    each in its own layout and validity; the struct's row validity is the
    DVal's."""
    fields: tuple


class DVal(NamedTuple):
    """A device value: data (or a StrVal, ListVal, MapVal or StructVal) +
    validity mask + dtype. ``column`` is the string column a STRING value
    was read from (a column reference, a string field of a struct), for
    what needs its layout and not its value: a string put into a struct
    keeps its dictionary or byte rectangle (exprs/compiler.py
    ``column_dval``, ``dval_column``)."""
    data: object
    validity: torch.Tensor
    dtype: DataType
    column: object = None


class EvalContext:
    """Context handed to Expression.eval_device: the input DVals by
    ordinal, the true row count and the padded length, the device, the
    values of a filter's dictionary slots (compiler.py _DictSlot), the
    batch's partition and the hosting operator's task state (a dict the
    operator makes anew for each execution, where ``rand`` and the row
    ids keep their running row counts: exprs/nondeterministic.py; None
    where no operator hosts them). ``live``, when given, marks the rows
    that are real where they are not a prefix (a lambda's element rows,
    exprs/higher_order.py). ``use_kernel``: a string predicate over a
    byte rectangle takes the hand-written match kernel
    (``spark.rapids.tpu.sql.pallas.enabled``, exprs/rect_match.py)."""

    def __init__(self, schema: Schema, columns: Sequence[Optional[DVal]],
                 num_rows: int, padded_len: int, device,
                 slots: Sequence[DVal] = (), partition_id: int = 0,
                 task_state: Optional[dict] = None,
                 live: Optional[torch.Tensor] = None,
                 use_kernel: bool = False):
        self.use_kernel = use_kernel
        self.schema = schema
        self.columns = list(columns)
        self.num_rows = num_rows
        self.padded_len = padded_len
        self.device = device
        self.slots = slots
        self.partition_id = partition_id
        self.task_state = task_state
        self.live = live

    def row_mask(self) -> torch.Tensor:
        """bool[P]: True for real rows, False for padding."""
        if self.live is not None:
            return self.live
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
        from ..types import (device_list_ok, device_map_ok,
                             device_struct_ok, nested_reason)
        dt = schema[self.name].dtype
        if dt.device_backed or device_list_ok(dt) or device_map_ok(dt) \
                or device_struct_ok(dt):
            return None
        return f"column {self.name}: " + (nested_reason(dt) or
                                          f"{dt.name} is host-only")

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
    if isinstance(value, decimal.Decimal):
        return decimal_literal_type(value)
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


def decimal_literal_type(value: decimal.Decimal) -> DecimalType:
    """Spark's type of a ``BigDecimal`` literal: decimal(max(digits,
    scale), scale); an exponent above 0 is scale 0."""
    if not value.is_finite():
        raise ValueError(f"a decimal literal must be finite: {value!r}")
    sign, digits, exp = value.as_tuple()
    scale = max(-exp, 0)
    ndigits = len(digits) + max(exp, 0)
    return DecimalType(min(max(ndigits, scale, 1), 38), scale)


def unscaled(value, scale: int) -> Optional[int]:
    """A number's unscaled value at ``scale``, or None where it has more
    fractional digits than the scale holds (it equals no decimal of that
    scale)."""
    d = decimal.Decimal(value) if not isinstance(value, float) \
        else decimal.Decimal(repr(value))
    if not d.is_finite():
        return None
    q = d.scaleb(scale, decimal.Context(prec=80))
    if q != q.to_integral_value():
        return None
    return int(q)


def _canonical_literal(value, dtype: DataType):
    """Date/timestamp literals as their device value (DATE int32 days,
    TIMESTAMP int64 microseconds), a decimal as its unscaled int."""
    if value is None:
        return None
    if isinstance(dtype, DecimalType):
        u = unscaled(value, dtype.scale)
        if u is None or abs(u) >= 10 ** dtype.precision:
            raise ValueError(f"{value!r} is no {dtype.name}")
        if not -2 ** 63 <= u < 2 ** 63:
            from ..types import DECIMAL128
            raise NotImplementedError(
                f"decimal literal {value!r} passes the 64-bit unscaled "
                f"lane: {DECIMAL128}")
        return u
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
        if isinstance(self.dtype, DecimalType) and self.value is not None:
            return str(decimal.Decimal(self.value).scaleb(-self.dtype.scale))
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


def wider_decimal(l: DecimalType, r: DecimalType) -> DecimalType:
    """Spark's ``widerDecimalType``: the integral digits of the wider and
    the larger scale, bounded at 38 digits."""
    scale = max(l.scale, r.scale)
    rng = max(l.precision - l.scale, r.precision - r.scale)
    return DecimalType(min(rng + scale, 38), min(scale, 38))


def promote_types(l: DataType, r: DataType) -> DataType:
    """The common type of two operands (Spark's type coercion): numeric
    types widen; a decimal with a float or double gives double, with an
    integral type or another decimal the wider decimal (an integral type
    as decimal(3,0), (5,0), (10,0) or (20,0))."""
    if l == r:
        return l
    if isinstance(l, DecimalType) or isinstance(r, DecimalType):
        if l in (FLOAT32, FLOAT64) or r in (FLOAT32, FLOAT64):
            return FLOAT64
        ld = l if isinstance(l, DecimalType) else integral_decimal(l)
        rd = r if isinstance(r, DecimalType) else integral_decimal(r)
        if ld is None or rd is None:
            raise TypeError(f"cannot promote {l} and {r}")
        return wider_decimal(ld, rd)
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
