"""ColumnarBatch and host-table ingest (port of
``spark_rapids_tpu/columnar/batch.py``, the parts the slice reaches).

Input tables live on the host as a ``HostTable`` of numpy arrays; Arrow
and pandas are optional inputs (imported only when given). Ingest is one
host->device copy per column. Batches are not padded to shape buckets:
``padded_len`` equals ``num_rows`` after ingest, and exceeds it only for
batches carried across from the reference (``batch_from_reference``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import (DATE, STRING, TIMESTAMP, Schema, StructField,
                     from_arrow, from_numpy_dtype)
from .column import DeviceColumn, DictColumn, HostColumn
from .strrect import ByteRectColumn, encode_string_rect, utf8_bytes

__all__ = ["ColumnarBatch", "HostTable", "batch_from_reference",
           "concat_batches", "DICT_ENCODE_MAX_FRACTION",
           "DICT_ENCODE_MAX_CARD"]

#: dictionary-encode a string column when its cardinality is at most
#: min(rows * fraction + 1, card); above that the byte rectangle takes
#: over (the reference's thresholds, batch.py:38-39)
DICT_ENCODE_MAX_FRACTION = 0.5
DICT_ENCODE_MAX_CARD = 1 << 16


class HostTable:
    """A host table: per column numpy ``values`` and bool ``validity``.
    Values hold the device representation (DATE as int32 days, TIMESTAMP
    as int64 microseconds); strings stay ``S``/``U``/object arrays."""

    def __init__(self, columns: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 schema: Schema):
        self.columns = columns
        self.schema = schema
        self.num_rows = len(next(iter(columns.values()))[0]) \
            if columns else 0

    @staticmethod
    def from_dict(data: dict) -> "HostTable":
        cols, fields = {}, []
        for name, v in data.items():
            valid = None
            if isinstance(v, np.ma.MaskedArray):
                valid = ~np.ma.getmaskarray(v)
                v = v.data
            v = np.asarray(v)
            dt = from_numpy_dtype(v.dtype)
            if v.dtype.kind == "O":
                ok = np.array([x is not None for x in v], bool)
                valid = ok if valid is None else valid & ok
            if valid is None:
                valid = np.ones(len(v), bool)
            if dt == DATE:
                v = v.astype("datetime64[D]").astype(np.int64) \
                    .astype(np.int32)
            elif dt == TIMESTAMP:
                v = v.astype("datetime64[us]").astype(np.int64)
            cols[name] = (v, valid)
            fields.append(StructField(name, dt, True))
        return HostTable(cols, Schema(fields))

    @staticmethod
    def from_arrow(table) -> "HostTable":
        import pyarrow as pa
        cols, fields = {}, []
        for name, col in zip(table.column_names, table.columns):
            if isinstance(col, pa.ChunkedArray):
                col = col.combine_chunks()
            dt = from_arrow(col.type)
            valid = ~np.asarray(col.is_null())
            if dt.device_backed:
                if dt == DATE:
                    col = col.cast(pa.int32())
                elif dt == TIMESTAMP:
                    col = col.cast(pa.int64())
                fill = False if pa.types.is_boolean(col.type) else 0
                v = col.fill_null(fill).to_numpy(zero_copy_only=False)
            else:
                v = col.to_numpy(zero_copy_only=False).astype(object)
            cols[name] = (v, valid)
            fields.append(StructField(name, dt, True))
        return HostTable(cols, Schema(fields))

    def select(self, names: Sequence[str]) -> "HostTable":
        return HostTable({n: self.columns[n] for n in names},
                         Schema([self.schema[n] for n in names]))

    def slice(self, offset: int, length: int) -> "HostTable":
        return HostTable({n: (v[offset:offset + length],
                              m[offset:offset + length])
                          for n, (v, m) in self.columns.items()},
                         self.schema)



def _row_hashes(s: np.ndarray) -> np.ndarray:
    """uint64 hash of every value of an ``S`` array (8-byte words folded
    by multiply-xor). Equal values hash equal, so the count of distinct
    hashes never exceeds the count of distinct values."""
    n, k = len(s), s.dtype.itemsize
    raw = np.ascontiguousarray(s).view(np.uint8).reshape(n, k)
    pad = -k % 8
    if pad:
        raw = np.concatenate([raw, np.zeros((n, pad), np.uint8)], axis=1)
    words = raw.view(np.uint64)
    h = np.zeros(n, np.uint64)
    mul = np.uint64(0x9E3779B97F4A7C15)
    for j in range(words.shape[1]):
        h = (h * mul) ^ words[:, j]
    return h


def _try_dict_encode(s: np.ndarray, valid: np.ndarray, n: int):
    """UTF-8 ``S`` array -> (codes int32[n], sorted dictionary) or None
    when the cardinality is above the threshold. Codes index the
    dictionary sorted in byte order, which is codepoint order."""
    if n == 0 or DICT_ENCODE_MAX_FRACTION <= 0:
        return None
    limit = min(n * DICT_ENCODE_MAX_FRACTION + 1, DICT_ENCODE_MAX_CARD)
    vals = s[valid]
    # cheap proof of high cardinality: count distinct hashes by a sort
    # (np.unique may take a hash-table path that is far slower on 1M rows)
    h = np.sort(_row_hashes(vals))
    if len(h) and 1 + np.count_nonzero(h[1:] != h[:-1]) > limit:
        return None
    uniq, inv = np.unique(vals, return_inverse=True)
    if len(uniq) > limit:
        return None
    codes = np.zeros(n, np.int32)
    codes[valid] = inv.astype(np.int32)
    if len(uniq):
        # null slots hold the first value's code, as the reference's do
        codes[~valid] = codes[np.argmax(valid)]
    dictionary = np.char.decode(uniq, "utf-8").astype(object) \
        if len(uniq) else np.zeros(0, object)
    return codes, dictionary


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _ingest_string(values, valid, n, device, rect_cap):
    s = utf8_bytes(values, valid)
    enc = _try_dict_encode(s, valid, n)
    if enc is not None:
        codes, dictionary = enc
        return DictColumn(_to_device(codes, device), _to_device(valid, device),
                          STRING, dictionary)
    renc = encode_string_rect(s, valid, n, rect_cap)
    if renc is not None:
        rect, lens, v, asc = renc
        return ByteRectColumn(_to_device(rect, device), _to_device(v, device),
                              _to_device(lens, device), ascii_only=asc)
    strs = np.array([x.decode("utf-8") for x in s], dtype=object) \
        if values.dtype.kind == "S" else np.asarray(values, object)
    return HostColumn(strs, valid, STRING)


class ColumnarBatch:
    __slots__ = ("columns", "num_rows", "schema")

    def __init__(self, columns: Sequence, num_rows: int, schema: Schema):
        assert len(columns) == len(schema), (len(columns), len(schema))
        self.columns = list(columns)
        self.num_rows = int(num_rows)
        self.schema = schema

    @property
    def padded_len(self) -> int:
        for c in self.columns:
            if isinstance(c, DeviceColumn):
                return c.padded_len
        return self.num_rows

    def column_by_name(self, name: str):
        return self.columns[self.schema.index_of(name)]

    def device_size_bytes(self) -> int:
        return sum(c.nbytes() for c in self.columns
                   if isinstance(c, DeviceColumn))

    @staticmethod
    def from_host(table: HostTable, device, rect_cap: int) -> "ColumnarBatch":
        """Host table -> device batch: fixed-width columns copy over as
        (data, validity) with nulls at the dtype default; strings become
        dictionary codes (low cardinality), byte rectangles (up to
        ``rect_cap`` bytes wide) or stay host."""
        n = table.num_rows
        cols: List = []
        for f in table.schema.fields:
            values, valid = table.columns[f.name]
            if f.dtype.device_backed:
                d = np.asarray(values).astype(f.dtype.np_dtype, copy=False)
                if not valid.all():
                    d = np.where(valid, d, f.dtype.np_dtype.type(0))
                cols.append(DeviceColumn(_to_device(d, device),
                                         _to_device(valid, device), f.dtype))
            elif f.dtype == STRING:
                cols.append(_ingest_string(values, valid, n, device,
                                           rect_cap))
            else:
                cols.append(HostColumn(values, valid, f.dtype))
        return ColumnarBatch(cols, n, table.schema)

    def slice(self, offset: int, length: int) -> "ColumnarBatch":
        """Rows ``offset`` to ``offset + length`` (within num_rows), as
        views."""
        end = offset + length
        cols: List = []
        for c in self.columns:
            if isinstance(c, ByteRectColumn):
                cols.append(ByteRectColumn(c.data[offset:end],
                                           c.validity[offset:end],
                                           c.lengths[offset:end],
                                           c.ascii_only))
            elif isinstance(c, DeviceColumn):
                cols.append(c.with_arrays(c.data[offset:end],
                                          c.validity[offset:end]))
            else:
                cols.append(HostColumn(c.values[offset:end],
                                       c.validity[offset:end], c.dtype))
        return ColumnarBatch(cols, length, self.schema)

    def to_numpy(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(values, validity) per column, truncated to num_rows."""
        return [c.to_numpy(self.num_rows) for c in self.columns]

    def __repr__(self):
        return (f"ColumnarBatch(rows={self.num_rows}, "
                f"padded={self.padded_len}, {self.schema})")


def batch_from_reference(columns: Sequence[dict], schema: Schema, device,
                         num_rows: Optional[int] = None) -> ColumnarBatch:
    """A port batch from the arrays of a reference ColumnarBatch, given
    as numpy: per column a dict with ``data`` and ``validity``, plus
    ``dictionary`` (DictColumn) or ``lengths`` (ByteRectColumn, whose
    rectangle is ``bytes_``, or ``data`` as the reference stores it).
    Padding rows are kept, with validity False; ``num_rows`` is the
    reference batch's row count (default: every row)."""
    cols = []
    for c, f in zip(columns, schema.fields):
        data = np.asarray(c["bytes_"] if "bytes_" in c else c["data"])
        valid = np.asarray(c["validity"], bool)
        if "lengths" in c:
            cols.append(ByteRectColumn(
                _to_device(data.astype(np.uint8), device),
                _to_device(valid, device),
                _to_device(np.asarray(c["lengths"], np.int32), device),
                ascii_only=bool((data < 0x80).all())))
        elif "dictionary" in c:
            cols.append(DictColumn(
                _to_device(data.astype(np.int32), device),
                _to_device(valid, device), STRING,
                np.asarray(c["dictionary"], object)))
        else:
            cols.append(DeviceColumn(
                _to_device(data.astype(f.dtype.np_dtype), device),
                _to_device(valid, device), f.dtype))
    if num_rows is None:
        num_rows = len(np.asarray(columns[0]["validity"])) if columns else 0
    return ColumnarBatch(cols, num_rows, schema)


def _concat_dict(parts: List[DictColumn], rows: List[int]) -> DictColumn:
    """Dictionary columns over one dictionary: the sorted union of theirs,
    each part's codes remapped into it."""
    first = parts[0].dictionary
    if all(p.dictionary is first for p in parts):
        union, remaps = first, [None] * len(parts)
    else:
        union = np.unique(np.concatenate([p.dictionary for p in parts]))
        remaps = [np.searchsorted(union, p.dictionary).astype(np.int32)
                  for p in parts]
    codes = []
    for p, n, remap in zip(parts, rows, remaps):
        c = p.data[:n]
        if remap is not None:
            if len(remap):
                table = torch.from_numpy(remap).to(c.device)
                c = table[c.clamp(0, len(remap) - 1).long()]
            else:
                c = torch.zeros_like(c)
        codes.append(c)
    return DictColumn(torch.cat(codes),
                      torch.cat([p.validity[:n] for p, n in zip(parts, rows)]),
                      parts[0].dtype, union)


def _concat_rect(parts: List[ByteRectColumn],
                 rows: List[int]) -> ByteRectColumn:
    """Byte rectangles, narrower ones padded with zeros to the widest."""
    w = max(p.width for p in parts)
    data = [torch.nn.functional.pad(p.data[:n], (0, w - p.width))
            for p, n in zip(parts, rows)]
    return ByteRectColumn(
        torch.cat(data), torch.cat([p.validity[:n] for p, n in zip(parts,
                                                                   rows)]),
        torch.cat([p.lengths[:n] for p, n in zip(parts, rows)]),
        ascii_only=all(p.ascii_only for p in parts))


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """The rows of ``batches`` (one schema) in order, padding dropped, in
    one batch (port of the reference's ``concat_batches``): device columns
    concatenate on the device; dictionary columns over the sorted union of
    their dictionaries; byte rectangles at the widest width."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    rows = [b.num_rows for b in batches]
    cols: List = []
    for i, f in enumerate(schema.fields):
        parts = [b.columns[i] for b in batches]
        kinds = {type(p) for p in parts}
        if kinds == {DictColumn}:
            cols.append(_concat_dict(parts, rows))
        elif kinds == {ByteRectColumn}:
            cols.append(_concat_rect(parts, rows))
        elif kinds == {DeviceColumn}:
            cols.append(DeviceColumn(
                torch.cat([p.data[:n] for p, n in zip(parts, rows)]),
                torch.cat([p.validity[:n] for p, n in zip(parts, rows)]),
                f.dtype))
        elif kinds == {HostColumn}:
            cols.append(HostColumn(
                np.concatenate([p.values[:n] for p, n in zip(parts, rows)]),
                np.concatenate([p.validity[:n] for p, n in zip(parts,
                                                               rows)]),
                f.dtype))
        else:
            raise NotImplementedError(
                f"column {f.name} arrives in different layouts "
                f"({sorted(k.__name__ for k in kinds)}); concatenating a "
                "dictionary with a byte rectangle or host strings arrives "
                "with the strings slice")
    return ColumnarBatch(cols, sum(rows), schema)
