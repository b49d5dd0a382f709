"""Logical data types, schemas and their numpy / torch / Arrow mappings.

Port of ``spark_rapids_tpu/types.py`` (the parts the port's slice needs).
A device column is a torch tensor per column plus a bool validity tensor;
STRING and BINARY have no fixed-width device layout of their own (strings
ride as dictionary codes or byte rectangles, columnar/). A DECIMAL is its
unscaled value in an int64 lane, for every declared precision up to 38
(``DecimalType``, as the reference holds it). An ARRAY of a fixed-width element lives on the device
as a rectangle, and so does an ARRAY of strings or of structs of
fixed-width and string fields (its elements a flat column of the
rectangle's slots); a MAP of such keys and values is two rectangles over
one set of lengths, and a STRUCT its fields' device columns
(columnar/nested.py). Lists of lists, and the other nested forms, are
types the planner refuses (``NESTED_REST``).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DataType", "BOOL", "INT8", "INT16",
    "INT32", "INT64", "FLOAT32", "FLOAT64", "STRING", "BINARY", "DATE",
    "TIMESTAMP", "NULLTYPE", "StructField", "Schema", "TypeSig", "TypeEnum",
    "from_numpy_dtype", "from_arrow", "to_arrow", "torch_dtype",
    "ArrayType", "MapType", "StructType", "device_list_ok", "NESTED_REST",
    "device_map_ok", "device_struct_ok", "device_column_ok", "map_parts",
    "entries_type", "nested_reason", "DecimalType", "DECIMAL_ITEM",
    "DECIMAL128", "integral_decimal", "adjust_precision_scale",
]

#: where the decimals the port refuses arrive (Queue A's decimals item,
#: its leftovers)
DECIMAL_ITEM = "the decimals item (ROADMAP.md Queue A)"
#: decimals whose unscaled value passes int64 need a 128-bit lane
DECIMAL128 = ("a decimal128 lane, for unscaled values past int64 (the "
              "decimals item's leftovers, ROADMAP.md Queue A)")

#: where the nested constructs the port refuses arrive (lists of lists and
#: ``flatten``, lists past the rectangle's caps, a struct of host strings,
#: nested keys, JSON, nested Parquet columns)
NESTED_REST = "slice 9b, the rest (ROADMAP.md Queue A)"


class DataType:
    """Base logical type. Immutable and hashable."""

    name: str = "?"
    #: numpy dtype of the device buffer, or None if the type has no
    #: fixed-width device layout
    np_dtype: Optional[np.dtype] = None

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.name == getattr(
            other, "name", None)

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.name))

    @property
    def device_backed(self) -> bool:
        return self.np_dtype is not None


class _Simple(DataType):
    def __init__(self, name: str, np_dtype):
        self.name = name
        self.np_dtype = np.dtype(np_dtype) if np_dtype is not None else None


BOOL = _Simple("boolean", np.bool_)
INT8 = _Simple("tinyint", np.int8)
INT16 = _Simple("smallint", np.int16)
INT32 = _Simple("int", np.int32)
INT64 = _Simple("bigint", np.int64)
FLOAT32 = _Simple("float", np.float32)
FLOAT64 = _Simple("double", np.float64)
#: days since epoch, int32 on device (Spark DateType physical form)
DATE = _Simple("date", np.int32)
#: microseconds since epoch UTC, int64 on device (Spark TimestampType)
TIMESTAMP = _Simple("timestamp", np.int64)
STRING = _Simple("string", None)
BINARY = _Simple("binary", None)
NULLTYPE = _Simple("void", None)


class DecimalType(DataType):
    """DECIMAL(precision, scale) held as its unscaled value in one int64
    lane, for every declared precision up to 38 (the reference's
    ``DecimalType``, spark_rapids_tpu/types.py:95): exact for unscaled
    magnitudes below 2^63, a loud error at ingest past that. Arithmetic
    whose result passes its precision or int64 is NULL
    (exprs/decimal_arith.py)."""

    def __init__(self, precision: int = 10, scale: int = 0):
        if precision < 1 or precision > 38:
            raise ValueError(f"bad decimal precision {precision}")
        if scale < 0 or scale > precision:
            raise ValueError(f"bad decimal scale {scale} for precision "
                             f"{precision}")
        self.precision = precision
        self.scale = scale
        self.name = f"decimal({precision},{scale})"
        self.np_dtype = np.dtype(np.int64)

    def __eq__(self, other):
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self):
        return hash(("decimal", self.precision, self.scale))


def integral_decimal(dt: DataType) -> Optional[DecimalType]:
    """The decimal an integral type widens to beside a decimal (Spark's
    ``DecimalType.forType``), else None."""
    return {"tinyint": DecimalType(3, 0), "smallint": DecimalType(5, 0),
            "int": DecimalType(10, 0),
            "bigint": DecimalType(20, 0)}.get(dt.name)


def adjust_precision_scale(precision: int, scale: int) -> DecimalType:
    """Spark's ``DecimalType.adjustPrecisionScale`` (allowPrecisionLoss):
    past 38 digits, keep the integral digits and at least
    min(scale, 6) of the scale."""
    if precision <= 38:
        return DecimalType(precision, scale)
    int_digits = precision - scale
    min_scale = min(scale, 6)
    return DecimalType(38, max(38 - int_digits, min_scale))

_TORCH = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64, np.dtype(np.uint8): torch.uint8,
}


def torch_dtype(dt: DataType) -> torch.dtype:
    """torch dtype of a device-backed logical type's data tensor."""
    if dt.np_dtype is None:
        raise TypeError(f"{dt.name} has no fixed-width device layout")
    return _TORCH[dt.np_dtype]


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    dtype: DataType
    nullable: bool = True


class StructType(DataType):
    def __init__(self, fields: Iterable[StructField]):
        self.fields: Tuple[StructField, ...] = tuple(fields)
        self.name = "struct<" + ",".join(f"{f.name}:{f.dtype.name}"
                                         for f in self.fields) + ">"
        self.np_dtype = None

    def names(self):
        return [f.name for f in self.fields]

    def index_of(self, name: str) -> int:
        return self.names().index(name)

    def __eq__(self, other):
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self):
        return hash(("struct", self.fields))


class ArrayType(DataType):
    def __init__(self, element: DataType):
        self.element = element
        self.name = f"array<{element.name}>"
        self.np_dtype = None     # a rectangle of several tensors

    def __eq__(self, other):
        return isinstance(other, ArrayType) and other.element == self.element

    def __hash__(self):
        return hash(("array", self.element))


class MapType(DataType):
    def __init__(self, key: DataType, value: DataType):
        self.key = key
        self.value = value
        self.name = f"map<{key.name},{value.name}>"
        self.np_dtype = None

    def __eq__(self, other):
        return isinstance(other, MapType) and other.key == self.key \
            and other.value == self.value

    def __hash__(self):
        return hash(("map", self.key, self.value))


def _flat_element_ok(dt: DataType) -> bool:
    """A list element, map key or value, or a struct element's field that
    has a device slot: fixed-width (decimals aside), a string or
    NULL-typed."""
    return (dt.np_dtype is not None and not isinstance(dt, DecimalType)) \
        or dt == STRING or dt == NULLTYPE


def device_list_ok(dt: DataType) -> bool:
    """``dt`` is an array of a fixed-width or string element, or of a
    struct whose fields are fixed-width or strings: a device rectangle
    (columnar/nested.py)."""
    if not isinstance(dt, ArrayType):
        return False
    e = dt.element
    if isinstance(e, StructType):
        return all(_flat_element_ok(f.dtype) for f in e.fields)
    return _flat_element_ok(e)


def entries_type(key: DataType, value: DataType) -> "ArrayType":
    """``map_entries``' type: an array of (key, value) structs."""
    return ArrayType(StructType([StructField("key", key, False),
                                 StructField("value", value)]))


def map_parts(dt: DataType):
    """(key type, value type) of a map, else None."""
    if isinstance(dt, MapType):
        return dt.key, dt.value
    return None


def device_map_ok(dt: DataType) -> bool:
    """``dt`` is a map whose keys and values are fixed-width or strings:
    two rectangles over one set of lengths."""
    kv = map_parts(dt)
    return kv is not None and all(_flat_element_ok(t) for t in kv)


def device_struct_ok(dt: DataType) -> bool:
    """``dt`` is a struct whose every field has a device column."""
    return isinstance(dt, StructType) and all(
        device_column_ok(f.dtype) for f in dt.fields)


def device_column_ok(dt: DataType) -> bool:
    """``dt`` has a device column: a fixed-width type, a string (a
    dictionary or a byte rectangle), a list, a map or a struct of them."""
    return (dt.device_backed or dt == STRING or device_list_ok(dt)
            or device_map_ok(dt) or device_struct_ok(dt))


def nested_reason(dt: DataType) -> Optional[str]:
    """Why a nested type has no device column (naming its queue entry),
    None when it has one or is not nested."""
    if _holds_decimal(dt):
        return f"{dt.name}: decimals inside nested values arrive with " \
            f"{NESTED_REST}"
    if isinstance(dt, MapType) and not device_map_ok(dt):
        return (f"a map of {dt.key.name} keys and {dt.value.name} values "
                f"arrives with {NESTED_REST}")
    if isinstance(dt, ArrayType) and not device_list_ok(dt):
        return f"an array of {dt.element.name} arrives with {NESTED_REST}"
    if isinstance(dt, StructType):
        for f in dt.fields:
            r = nested_reason(f.dtype)
            if r:
                return f"struct field {f.name}: {r}"
    return None


def _holds_decimal(dt: DataType) -> bool:
    """A list, map or struct with a decimal somewhere inside."""
    if isinstance(dt, ArrayType):
        return isinstance(dt.element, DecimalType) \
            or _holds_decimal(dt.element)
    if isinstance(dt, MapType):
        return any(isinstance(t, DecimalType) or _holds_decimal(t)
                   for t in (dt.key, dt.value))
    if isinstance(dt, StructType):
        return any(isinstance(f.dtype, DecimalType)
                   or _holds_decimal(f.dtype) for f in dt.fields)
    return False


class TypeEnum:
    BOOLEAN = "BOOLEAN"
    BYTE = "BYTE"
    SHORT = "SHORT"
    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    DATE = "DATE"
    TIMESTAMP = "TIMESTAMP"
    STRING = "STRING"
    BINARY = "BINARY"
    DECIMAL = "DECIMAL"
    NULL = "NULL"


_ENUM = {
    "boolean": TypeEnum.BOOLEAN, "tinyint": TypeEnum.BYTE,
    "smallint": TypeEnum.SHORT, "int": TypeEnum.INT, "bigint": TypeEnum.LONG,
    "float": TypeEnum.FLOAT, "double": TypeEnum.DOUBLE,
    "date": TypeEnum.DATE, "timestamp": TypeEnum.TIMESTAMP,
    "string": TypeEnum.STRING, "binary": TypeEnum.BINARY,
    "void": TypeEnum.NULL,
}


def _enum_of(dt: DataType) -> Optional[str]:
    if isinstance(dt, DecimalType):
        return TypeEnum.DECIMAL
    return _ENUM.get(dt.name)


class TypeSig:
    """The set of type enums an expression supports on the device (the
    reference's TypeSig, without nesting or notes)."""

    def __init__(self, initial: Iterable[str] = ()):
        self.types: FrozenSet[str] = frozenset(initial)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.types | other.types)

    def reason_not_supported(self, dt: DataType) -> Optional[str]:
        enum = _enum_of(dt)
        if enum is None or enum not in self.types:
            return f"{enum or dt.name} is not supported"
        return None


integral = TypeSig([TypeEnum.BYTE, TypeEnum.SHORT, TypeEnum.INT,
                    TypeEnum.LONG])
fp = TypeSig([TypeEnum.FLOAT, TypeEnum.DOUBLE])
numeric = integral + fp
decimal_sig = TypeSig([TypeEnum.DECIMAL])
comparable = numeric + decimal_sig + TypeSig([TypeEnum.BOOLEAN, TypeEnum.DATE,
                                          TypeEnum.TIMESTAMP,
                                          TypeEnum.STRING])
#: types with a dense device layout
deviceNative = numeric + TypeSig([TypeEnum.BOOLEAN, TypeEnum.DATE,
                                  TypeEnum.TIMESTAMP])


def from_numpy_dtype(dt) -> DataType:
    """numpy dtype -> logical type, as Arrow infers it from a numpy array
    (``datetime64[D]`` is a DATE, finer datetime units a TIMESTAMP,
    ``S``/``U``/``O`` arrays are strings)."""
    dt = np.dtype(dt)
    mapping = {
        np.dtype(np.bool_): BOOL, np.dtype(np.int8): INT8,
        np.dtype(np.int16): INT16, np.dtype(np.int32): INT32,
        np.dtype(np.int64): INT64, np.dtype(np.float32): FLOAT32,
        np.dtype(np.float64): FLOAT64,
    }
    if dt in mapping:
        return mapping[dt]
    if dt.kind in ("U", "S", "O"):
        return STRING
    if dt.kind == "M":
        unit = np.datetime_data(dt)[0]
        return DATE if unit == "D" else TIMESTAMP
    raise TypeError(f"unsupported numpy dtype {dt}")


def from_arrow(at) -> DataType:
    import pyarrow as pa
    checks = [(pa.types.is_boolean, BOOL), (pa.types.is_int8, INT8),
              (pa.types.is_int16, INT16), (pa.types.is_int32, INT32),
              (pa.types.is_int64, INT64), (pa.types.is_float32, FLOAT32),
              (pa.types.is_float64, FLOAT64), (pa.types.is_date32, DATE),
              (pa.types.is_timestamp, TIMESTAMP),
              (pa.types.is_string, STRING),
              (pa.types.is_large_string, STRING),
              (pa.types.is_binary, BINARY), (pa.types.is_null, NULLTYPE)]
    for check, dt in checks:
        if check(at):
            return dt
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow(at.value_type))
    if pa.types.is_map(at):
        return MapType(from_arrow(at.key_type), from_arrow(at.item_type))
    if pa.types.is_struct(at):
        return StructType(StructField(at.field(i).name,
                                      from_arrow(at.field(i).type))
                          for i in range(at.num_fields))
    raise TypeError(f"unsupported arrow type {at}")


def to_arrow(dt: DataType):
    import pyarrow as pa
    m = {"boolean": pa.bool_(), "tinyint": pa.int8(), "smallint": pa.int16(),
         "int": pa.int32(), "bigint": pa.int64(), "float": pa.float32(),
         "double": pa.float64(), "date": pa.date32(),
         "timestamp": pa.timestamp("us", tz="UTC"), "string": pa.string(),
         "binary": pa.binary(), "void": pa.null()}
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, ArrayType):
        return pa.list_(to_arrow(dt.element))
    if isinstance(dt, MapType):
        return pa.map_(to_arrow(dt.key), to_arrow(dt.value))
    if isinstance(dt, StructType):
        return pa.struct([pa.field(f.name, to_arrow(f.dtype), f.nullable)
                          for f in dt.fields])
    return m[dt.name]


class Schema:
    """Ordered named, typed columns."""

    def __init__(self, fields: Iterable[StructField]):
        self.fields: Tuple[StructField, ...] = tuple(fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.fields[key]
        return self.fields[self._index[key]]

    def index_of(self, name: str) -> int:
        return self._index[name]

    def names(self):
        return [f.name for f in self.fields]

    def __repr__(self):
        return "Schema(" + ", ".join(f"{f.name}:{f.dtype.name}"
                                     for f in self.fields) + ")"

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields
