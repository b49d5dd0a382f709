"""A Parquet file's footer, schema and row-group statistics, read without
pyarrow (the reference reads them through ``pyarrow.parquet``,
``spark_rapids_tpu/io/parquet.py:59,71,99``).

The footer is the file's last 8 bytes (its length, then ``PAR1``) and
the thrift ``FileMetaData`` before them (io/thrift.py). The schema maps
to the port's types as pyarrow and the reference's ``from_arrow`` map it:

  * BOOLEAN, FLOAT, DOUBLE; INT32 (INT_8, INT_16 and DATE annotations
    included), INT64; BYTE_ARRAY with a UTF8/STRING annotation;
  * INT64 timestamps in millis, micros or nanos and INT96 (Spark's
    default ``outputTimestampType``) as TIMESTAMP in microseconds;
  * a DECIMAL (converted or logical type) in each physical type Parquet
    allows for it, as its unscaled int64: INT32 and INT64 (Spark writes
    precision up to 9 and 18 so), FIXED_LEN_BYTE_ARRAY and BYTE_ARRAY of
    big-endian two's complement (a value past int64 raises, as ingest
    does). Its statistics compare as ``Decimal``s at the column's scale.

Anything else (unsigned ints, times, binary, nested and map columns)
keeps its place in the schema as an ``UnsupportedType`` that names the
slice which brings it; the planner refuses a scan that selects one.
"""
from __future__ import annotations

import decimal
import struct
from typing import Dict, List, Optional, Tuple

from ..types import (BOOL, DATE, DECIMAL128, DataType, DecimalType, FLOAT32,
                     FLOAT64, INT8, INT16, INT32, INT64, NESTED_REST, STRING,
                     Schema, StructField, TIMESTAMP)
from .thrift import FileMetaData, SchemaElement, parse_file_metadata

__all__ = ["MAGIC", "ParquetFooter", "LeafColumn", "UnsupportedType",
           "read_footer", "parquet_schema", "row_group_stats"]

MAGIC = b"PAR1"

# physical types (parquet.thrift Type)
BOOLEAN, INT32_, INT64_, INT96, FLOAT, DOUBLE, BYTE_ARRAY, \
    FIXED_LEN_BYTE_ARRAY = range(8)
# converted types (ConvertedType)
_UTF8, _ENUM, _DECIMAL, _DATE = 0, 4, 5, 6
_TS_MILLIS, _TS_MICROS = 9, 10
_INT_8, _INT_16, _INT_32, _INT_64 = 15, 16, 17, 18
_JSON = 19
# LogicalType union members
_LT_STRING, _LT_ENUM, _LT_DECIMAL, _LT_DATE = 1, 4, 5, 6
_LT_TIMESTAMP, _LT_INTEGER, _LT_JSON = 8, 10, 12
# repetition (FieldRepetitionType; 0 is REQUIRED)
_OPTIONAL, _REPEATED = 1, 2

#: where each refused kind of column arrives (ROADMAP.md Queue A)
_NESTED_SLICE = f"nested and map columns arrive with {NESTED_REST}"
_OTHER_SLICE = "arrives with slice 10 (other I/O, ROADMAP.md Queue A)"


class UnsupportedType(DataType):
    """A column the port cannot read yet; ``reason`` names the slice."""

    def __init__(self, what: str, reason: str):
        self.name = f"unsupported<{what}>"
        self.np_dtype = None
        self.reason = reason


class LeafColumn:
    """A flat column of the file: its schema element, definition level,
    port type and, for timestamps, the unit its values count."""

    __slots__ = ("name", "element", "max_def", "dtype", "ts_unit")

    def __init__(self, name: str, element: SchemaElement, max_def: int,
                 dtype: DataType, ts_unit: Optional[str] = None):
        self.name = name
        self.element = element
        self.max_def = max_def
        self.dtype = dtype
        self.ts_unit = ts_unit

    @property
    def physical(self) -> int:
        return self.element.type


def _int_annotation(e: SchemaElement) -> Optional[Tuple[int, bool]]:
    """(bit width, signed) of an INT annotation, logical or converted."""
    if e.logical and e.logical[0] == _LT_INTEGER:
        d = e.logical[1]
        return d.get(1, 32), d.get(2, True)
    ct = e.converted_type
    if ct in (_INT_8, _INT_16, _INT_32, _INT_64):
        return {_INT_8: 8, _INT_16: 16, _INT_32: 32, _INT_64: 64}[ct], True
    if ct in (11, 12, 13, 14):
        return {11: 8, 12: 16, 13: 32, 14: 64}[ct], False
    return None


def _timestamp_unit(e: SchemaElement) -> Optional[str]:
    if e.logical and e.logical[0] == _LT_TIMESTAMP:
        unit = e.logical[1].get(2, {})
        return {1: "ms", 2: "us", 3: "ns"}.get(next(iter(unit), 2))
    return {_TS_MILLIS: "ms", _TS_MICROS: "us"}.get(e.converted_type)


def _decimal_type(e: SchemaElement) -> DataType:
    """A DECIMAL column's type: precision and scale from its logical type
    (``DecimalType`` {1: scale, 2: precision}), else from the element."""
    lt = e.logical
    if lt and lt[0] == _LT_DECIMAL:
        scale, prec = lt[1].get(1, 0), lt[1].get(2)
    else:
        scale, prec = e.scale or 0, e.precision
    if e.type not in (INT32_, INT64_, FIXED_LEN_BYTE_ARRAY, BYTE_ARRAY):
        return UnsupportedType(f"decimal in physical type {e.type}",
                               _OTHER_SLICE)
    if prec is None or not 1 <= prec <= 38 or not 0 <= scale <= prec:
        return UnsupportedType(f"decimal({prec},{scale})", DECIMAL128)
    return DecimalType(prec, scale)


def _leaf_type(e: SchemaElement) -> Tuple[DataType, Optional[str]]:
    """(port type, timestamp unit) of a flat column."""
    lt = e.logical[0] if e.logical else None
    if e.converted_type == _DECIMAL or lt == _LT_DECIMAL:
        return _decimal_type(e), None
    p = e.type
    if p == BOOLEAN:
        return BOOL, None
    if p in (INT32_, INT64_):
        if e.converted_type == _DATE or lt == _LT_DATE:
            return (DATE, None) if p == INT32_ else (
                UnsupportedType("int64 date", _OTHER_SLICE), None)
        unit = _timestamp_unit(e)
        if unit is not None and p == INT64_:
            return TIMESTAMP, unit
        ann = _int_annotation(e)
        if ann is not None:
            width, signed = ann
            if not signed:
                return UnsupportedType(f"uint{width}", _OTHER_SLICE), None
            return {8: INT8, 16: INT16, 32: INT32, 64: INT64}[width], None
        if e.converted_type is not None or lt is not None:
            return UnsupportedType(f"annotated int (converted "
                                   f"{e.converted_type}, logical {lt})",
                                   _OTHER_SLICE), None
        return (INT32 if p == INT32_ else INT64), None
    if p == INT96:
        return TIMESTAMP, "int96"
    if p == FLOAT:
        return FLOAT32, None
    if p == DOUBLE:
        return FLOAT64, None
    if p == BYTE_ARRAY:
        if e.converted_type in (_UTF8, _ENUM, _JSON) or lt in (
                _LT_STRING, _LT_ENUM, _LT_JSON):
            return STRING, None
        return UnsupportedType("binary", "binary columns arrive with "
                               "slice 7 (strings, ROADMAP.md Queue A)"
                               ), None
    return UnsupportedType(f"physical type {p}", _OTHER_SLICE), None


class ParquetFooter:
    """A file's metadata with its flat columns by name (top-level fields
    in schema order; a nested or repeated field is one unsupported
    column)."""

    def __init__(self, path: str, meta: FileMetaData):
        self.path = path
        self.meta = meta
        self.columns: Dict[str, LeafColumn] = {}
        #: top-level field name -> index of its leaf in a row group's
        #: column chunks (None for a nested field)
        self.chunk_index: Dict[str, Optional[int]] = {}
        els = meta.schema
        i, leaf = 1, 0
        n_top = els[0].num_children if els else 0
        for _ in range(n_top):
            e = els[i]
            if e.num_children:
                # a group: skip its subtree, counting its leaves
                stack, j, leaves = [e.num_children], i + 1, 0
                while stack:
                    stack[-1] -= 1
                    c = els[j]
                    j += 1
                    if c.num_children:
                        stack.append(c.num_children)
                    else:
                        leaves += 1
                    while stack and stack[-1] == 0:
                        stack.pop()
                self.columns[e.name] = LeafColumn(
                    e.name, e, 0, UnsupportedType("nested", _NESTED_SLICE))
                self.chunk_index[e.name] = None
                i, leaf = j, leaf + leaves
                continue
            if e.repetition == _REPEATED:
                dt, unit = UnsupportedType("repeated", _NESTED_SLICE), None
            else:
                dt, unit = _leaf_type(e)
            self.columns[e.name] = LeafColumn(
                e.name, e, 1 if e.repetition == _OPTIONAL else 0, dt, unit)
            self.chunk_index[e.name] = leaf
            i += 1
            leaf += 1

    def schema(self) -> Schema:
        return Schema([StructField(c.name, c.dtype, True)
                       for c in self.columns.values()])


def read_footer(path: str) -> ParquetFooter:
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size < 12:
            raise ValueError(f"{path}: {size} bytes is too short for a "
                             "Parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ValueError(f"{path}: not a Parquet file (no PAR1 at its "
                             "end)")
        (n,) = struct.unpack("<I", tail[:4])
        if n + 12 > size:
            raise ValueError(f"{path}: footer length {n} exceeds the file")
        f.seek(size - 8 - n)
        buf = f.read(n)
    return ParquetFooter(path, parse_file_metadata(buf))


def parquet_schema(path: str) -> Schema:
    return read_footer(path).schema()


_SIGNED_CERTAIN = (BOOLEAN, INT32_, INT64_, FLOAT, DOUBLE)
_PLAIN_FMT = {INT32_: "<i", INT64_: "<q", FLOAT: "<f", DOUBLE: "<d"}


def _stat_value(raw: bytes, col: LeafColumn):
    """A statistic's bytes as a value comparable with the port's literals
    (ints, floats, bools, UTF-8 bytes for strings, days for DATE,
    microseconds for TIMESTAMP, a ``Decimal`` at its scale for a decimal),
    or None."""
    p = col.physical
    if isinstance(col.dtype, DecimalType):
        if p in (INT32_, INT64_):
            if len(raw) != struct.calcsize(_PLAIN_FMT[p]):
                return None
            (u,) = struct.unpack(_PLAIN_FMT[p], raw)
        elif raw:
            u = int.from_bytes(bytes(raw), "big", signed=True)
        else:
            return None
        return decimal.Decimal(u).scaleb(-col.dtype.scale)
    if p == BOOLEAN:
        return bool(raw[0]) if raw else None
    if p in _PLAIN_FMT:
        if len(raw) != struct.calcsize(_PLAIN_FMT[p]):
            return None
        (v,) = struct.unpack(_PLAIN_FMT[p], raw)
        if isinstance(v, float) and v != v:
            return None                          # NaN orders nothing
        if col.ts_unit == "ms":
            v *= 1000
        elif col.ts_unit == "ns":
            v //= 1000
        return v
    if p == BYTE_ARRAY and col.dtype == STRING:
        return bytes(raw)
    return None


def row_group_stats(footer: ParquetFooter, rg: int,
                    names: List[str]) -> Dict[str, tuple]:
    """name -> (min, max) of row group ``rg`` for the columns ``names``
    whose statistics are certain: ``min_value``/``max_value``, or the
    deprecated ``min``/``max`` where their order was signed (numeric and
    boolean columns without an unsigned annotation). A column without
    them is missing, and so never excludes the group."""
    out = {}
    chunks = footer.meta.row_groups[rg].columns
    for name in names:
        col = footer.columns.get(name)
        j = footer.chunk_index.get(name)
        if col is None or j is None or isinstance(col.dtype,
                                                  UnsupportedType):
            continue
        st = chunks[j].statistics
        if st is None:
            continue
        lo, hi = st.min_value, st.max_value
        if lo is None or hi is None:
            if col.physical not in _SIGNED_CERTAIN or col.ts_unit:
                continue
            lo, hi = st.min, st.max
            if lo is None or hi is None:
                continue
        lo, hi = _stat_value(lo, col), _stat_value(hi, col)
        if lo is not None and hi is not None:
            out[name] = (lo, hi)
    return out
