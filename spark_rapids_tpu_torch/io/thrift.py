"""Thrift compact-protocol reader for Parquet's footer and page headers.

The reader (``Compact``) is a copy of the reference's
``spark_rapids_tpu/io/device_decode.py:_Compact`` (varints, zigzag ints,
binary, nested structs, lists), extended with ``read_value``: a struct
read whole into a ``{field id: value}`` dict, nested structs and lists
included. On top of it, the Parquet structs the port reads (field ids
from parquet.thrift): ``FileMetaData`` with its schema elements
(converted and logical types), row groups and column chunks, and
``ColumnMetaData`` with codec, encodings, offsets and statistics; and
the page headers (``PageHeader``, data pages v1 and v2, dictionary
pages).
"""
from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

__all__ = ["Compact", "FileMetaData", "SchemaElement", "RowGroup",
           "ColumnMeta", "Statistics", "PageHeader", "parse_file_metadata",
           "parse_page_header"]

# thrift compact-protocol wire types
_CT_STOP = 0
_CT_TRUE = 1
_CT_FALSE = 2
_CT_BYTE = 3
_CT_I16 = 4
_CT_I32 = 5
_CT_I64 = 6
_CT_DOUBLE = 7
_CT_BINARY = 8
_CT_LIST = 9
_CT_SET = 10
_CT_MAP = 11
_CT_STRUCT = 12


class Compact:
    """Thrift compact-protocol reader over ``buf`` from ``pos``."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_value(self, ctype: int):
        """One value of wire type ``ctype``: ints, bytes, floats, bools,
        lists (as lists), maps (as dicts) and structs (as ``{field id:
        value}`` dicts)."""
        if ctype in (_CT_TRUE, _CT_FALSE):
            # a bool list element is a byte; a bool field's value is in
            # its header (read_struct handles it)
            b = self.buf[self.pos]
            self.pos += 1
            return b == _CT_TRUE
        if ctype == _CT_BYTE:
            b = self.buf[self.pos]
            self.pos += 1
            return b - 256 if b > 127 else b
        if ctype in (_CT_I16, _CT_I32, _CT_I64):
            return self.zigzag()
        if ctype == _CT_DOUBLE:
            (v,) = struct.unpack_from("<d", self.buf, self.pos)
            self.pos += 8
            return v
        if ctype == _CT_BINARY:
            # NOT `self.pos += self.varint()`: the augmented assignment
            # loads the OLD pos before varint() advances it
            n = self.varint()
            out = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return out
        if ctype in (_CT_LIST, _CT_SET):
            head = self.buf[self.pos]
            self.pos += 1
            n = head >> 4
            et = head & 0x0F
            if n == 15:
                n = self.varint()
            return [self.read_value(et) for _ in range(n)]
        if ctype == _CT_MAP:
            n = self.varint()
            out = {}
            if n:
                kv = self.buf[self.pos]
                self.pos += 1
                for _ in range(n):
                    k = self.read_value(kv >> 4)
                    out[k] = self.read_value(kv & 0x0F)
            return out
        if ctype == _CT_STRUCT:
            return self.read_struct()
        raise ValueError(f"thrift compact type {ctype}")

    def read_struct(self) -> Dict[int, object]:
        fields: Dict[int, object] = {}
        fid = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            if b == _CT_STOP:
                return fields
            delta = b >> 4
            ctype = b & 0x0F
            if delta:
                fid += delta
            else:
                fid = self.zigzag()
            if ctype in (_CT_TRUE, _CT_FALSE):
                fields[fid] = ctype == _CT_TRUE
            else:
                fields[fid] = self.read_value(ctype)


class Statistics:
    """Column-chunk statistics: ``min_value``/``max_value`` (raw bytes
    in the physical type's PLAIN form), the deprecated ``min``/``max``,
    ``null_count``."""

    __slots__ = ("min_value", "max_value", "min", "max", "null_count")

    def __init__(self, d: Dict[int, object]):
        self.max = d.get(1)
        self.min = d.get(2)
        self.null_count = d.get(3)
        self.max_value = d.get(5)
        self.min_value = d.get(6)


class ColumnMeta:
    """A column chunk's ``ColumnMetaData``."""

    __slots__ = ("type", "encodings", "path", "codec", "num_values",
                 "total_uncompressed_size", "total_compressed_size",
                 "data_page_offset", "dictionary_page_offset",
                 "statistics")

    def __init__(self, d: Dict[int, object]):
        self.type = d.get(1)
        self.encodings = list(d.get(2, []))
        self.path = [p.decode("utf-8") for p in d.get(3, [])]
        self.codec = d.get(4, 0)
        self.num_values = d.get(5, 0)
        self.total_uncompressed_size = d.get(6, 0)
        self.total_compressed_size = d.get(7, 0)
        self.data_page_offset = d.get(9)
        self.dictionary_page_offset = d.get(11)
        st = d.get(12)
        self.statistics = Statistics(st) if st is not None else None

    @property
    def chunk_offset(self) -> int:
        """Where the chunk's first page starts: its dictionary page when
        it has one."""
        dp = self.dictionary_page_offset
        if dp is not None and 0 < dp < self.data_page_offset:
            return dp
        return self.data_page_offset


class RowGroup:
    __slots__ = ("columns", "num_rows", "total_byte_size")

    def __init__(self, d: Dict[int, object]):
        # ColumnChunk: 3 = meta_data
        self.columns = [ColumnMeta(c.get(3, {})) for c in d.get(1, [])]
        self.total_byte_size = d.get(2, 0)
        self.num_rows = d.get(3, 0)


class SchemaElement:
    """One node of the flattened schema tree. ``logical`` is the
    ``LogicalType`` union as ``(member field id, member dict)``."""

    __slots__ = ("type", "type_length", "repetition", "name",
                 "num_children", "converted_type", "scale", "precision",
                 "logical")

    def __init__(self, d: Dict[int, object]):
        self.type = d.get(1)
        self.type_length = d.get(2)
        self.repetition = d.get(3)
        self.name = d.get(4, b"").decode("utf-8")
        self.num_children = d.get(5, 0)
        self.converted_type = d.get(6)
        self.scale = d.get(7)
        self.precision = d.get(8)
        lt = d.get(10)
        self.logical: Optional[Tuple[int, dict]] = \
            next(iter(lt.items())) if lt else None


class FileMetaData:
    __slots__ = ("version", "schema", "num_rows", "row_groups",
                 "created_by")

    def __init__(self, d: Dict[int, object]):
        self.version = d.get(1)
        self.schema = [SchemaElement(e) for e in d.get(2, [])]
        self.num_rows = d.get(3, 0)
        self.row_groups = [RowGroup(g) for g in d.get(4, [])]
        cb = d.get(6)
        self.created_by = cb.decode("utf-8", "replace") if cb else None


def parse_file_metadata(buf: bytes) -> FileMetaData:
    return FileMetaData(Compact(buf).read_struct())


class PageHeader:
    """A page header: ``type`` (0 data v1, 2 dictionary, 3 data v2),
    sizes, and the data or dictionary page's fields."""

    __slots__ = ("type", "uncompressed_size", "compressed_size",
                 "num_values", "encoding", "def_encoding", "num_nulls",
                 "def_len", "rep_len", "is_compressed")

    def __init__(self, d: Dict[int, object]):
        self.type = d.get(1)
        self.uncompressed_size = d.get(2, 0)
        self.compressed_size = d.get(3, 0)
        self.num_values = 0
        self.encoding = None
        self.def_encoding = None
        self.num_nulls = None
        self.def_len = 0
        self.rep_len = 0
        self.is_compressed = True
        if 5 in d:                         # DataPageHeader
            h = d[5]
            self.num_values = h.get(1, 0)
            self.encoding = h.get(2)
            self.def_encoding = h.get(3)
        elif 7 in d:                       # DictionaryPageHeader
            h = d[7]
            self.num_values = h.get(1, 0)
            self.encoding = h.get(2)
        elif 8 in d:                       # DataPageHeaderV2
            h = d[8]
            self.num_values = h.get(1, 0)
            self.num_nulls = h.get(2)
            self.encoding = h.get(4)
            self.def_len = h.get(5, 0)
            self.rep_len = h.get(6, 0)
            self.is_compressed = h.get(7, True)


def parse_page_header(buf, pos: int) -> Tuple[PageHeader, int]:
    """The page header at ``buf[pos:]`` and the offset of its page's
    bytes."""
    r = Compact(buf, pos)
    return PageHeader(r.read_struct()), r.pos
