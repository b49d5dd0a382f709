"""Logical data types, schemas and their numpy / torch / Arrow mappings.

Port of ``spark_rapids_tpu/types.py`` (the parts the port's slice needs).
A device column is a torch tensor per column plus a bool validity tensor;
STRING and BINARY have no fixed-width device layout of their own (strings
ride as dictionary codes or byte rectangles, columnar/), and decimals wait
for a later slice.
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
]


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
    NULL = "NULL"


_ENUM = {
    "boolean": TypeEnum.BOOLEAN, "tinyint": TypeEnum.BYTE,
    "smallint": TypeEnum.SHORT, "int": TypeEnum.INT, "bigint": TypeEnum.LONG,
    "float": TypeEnum.FLOAT, "double": TypeEnum.DOUBLE,
    "date": TypeEnum.DATE, "timestamp": TypeEnum.TIMESTAMP,
    "string": TypeEnum.STRING, "binary": TypeEnum.BINARY,
    "void": TypeEnum.NULL,
}


class TypeSig:
    """The set of type enums an expression supports on the device (the
    reference's TypeSig, without nesting, notes or decimals)."""

    def __init__(self, initial: Iterable[str] = ()):
        self.types: FrozenSet[str] = frozenset(initial)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.types | other.types)

    def reason_not_supported(self, dt: DataType) -> Optional[str]:
        enum = _ENUM[dt.name]
        if enum not in self.types:
            return f"{enum} is not supported"
        return None


integral = TypeSig([TypeEnum.BYTE, TypeEnum.SHORT, TypeEnum.INT,
                    TypeEnum.LONG])
fp = TypeSig([TypeEnum.FLOAT, TypeEnum.DOUBLE])
numeric = integral + fp
comparable = numeric + TypeSig([TypeEnum.BOOLEAN, TypeEnum.DATE,
                                TypeEnum.TIMESTAMP, TypeEnum.STRING])
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
    raise TypeError(f"unsupported arrow type {at}")


def to_arrow(dt: DataType):
    import pyarrow as pa
    m = {"boolean": pa.bool_(), "tinyint": pa.int8(), "smallint": pa.int16(),
         "int": pa.int32(), "bigint": pa.int64(), "float": pa.float32(),
         "double": pa.float64(), "date": pa.date32(),
         "timestamp": pa.timestamp("us", tz="UTC"), "string": pa.string(),
         "binary": pa.binary(), "void": pa.null()}
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
