"""ColumnarBatch and host-table ingest (port of
``spark_rapids_tpu/columnar/batch.py``, the parts the slice reaches).

Input tables live on the host as a ``HostTable`` of numpy arrays; Arrow
and pandas are optional inputs (imported only when given). Ingest is one
host->device copy per column. Batches are not padded to shape buckets:
``padded_len`` equals ``num_rows`` after ingest, and exceeds it only for
batches carried across from the reference (``batch_from_reference``).
A list column is a ``HostList`` on the host (from numpy offsets, Python
lists or an Arrow ListArray) and a ``ListColumn`` rectangle on the
device; a map column a ``HostMap`` (numpy offsets, Python dicts or lists
of (key, value) pairs, an Arrow MapArray) and a ``MapColumn``; a struct
column a ``HostStruct`` (a ``HostTable`` of its fields, Python dicts, an
Arrow StructArray) and a ``StructColumn`` of its fields' device columns
(columnar/nested.py).
"""
from __future__ import annotations

import decimal
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import (DATE, NESTED_REST, STRING, TIMESTAMP, ArrayType,
                     DecimalType, MapType, Schema, StructField, StructType,
                     device_list_ok, from_arrow, from_numpy_dtype,
                     nested_reason)
from .column import DeviceColumn, DictColumn, HostColumn
from .column import to_device as _to_device
from .nested import (HostList, HostMap, HostStruct, ListColumn, MapColumn,
                     StructColumn, concat_lists, concat_maps, slice_rows,
                     to_device_list, to_device_map)
from .strrect import (ByteRectColumn, HostStrings, encode_string_rect,
                      utf8_bytes)

__all__ = ["ColumnarBatch", "HostTable", "DictStrings",
           "batch_from_reference", "py_column", "decimal_unscaled_int64",
           "decimal_values",
           "concat_batches", "dict_limit", "rect_to_dict", "dict_to_rect",
           "union_dictionary", "to_dictionary", "pad_rect",
           "DICT_ENCODE_MAX_FRACTION", "DICT_ENCODE_MAX_CARD"]

#: dictionary-encode a string column when its cardinality is at most
#: min(rows * fraction + 1, card); above that the byte rectangle takes
#: over (the reference's thresholds, batch.py:38-39)
DICT_ENCODE_MAX_FRACTION = 0.5
DICT_ENCODE_MAX_CARD = 1 << 16


class DictStrings:
    """A host string column as int32 ``indices`` into ``dictionary``, a
    ``HostStrings`` of UTF-8 values (as a dictionary-encoded Parquet chunk
    holds it; entries may repeat across chunks). Null rows hold index 0.
    Sliced like an array; ``encode`` gives a batch's codes and sorted
    dictionary from the entries it uses, without a pass over the
    strings."""

    __slots__ = ("indices", "dictionary")

    def __init__(self, indices: np.ndarray, dictionary: HostStrings):
        self.indices = indices
        self.dictionary = dictionary

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, sl: slice) -> "DictStrings":
        return DictStrings(self.indices[sl], self.dictionary)

    def decode(self) -> HostStrings:
        """The values, row by row."""
        if not len(self.dictionary):
            return HostStrings(np.zeros(len(self.indices), "S1"),
                               np.zeros(len(self.indices), np.int32))
        return self.dictionary[self.indices]

    @staticmethod
    def concat(parts: Sequence["DictStrings"]) -> "DictStrings":
        offs = np.cumsum([0] + [len(p.dictionary) for p in parts[:-1]])
        return DictStrings(
            np.concatenate([p.indices + np.int32(o)
                            for p, o in zip(parts, offs)]),
            HostStrings.concat([p.dictionary for p in parts]))

    def encode(self, valid: np.ndarray, n: int):
        """(codes int32[n], sorted dictionary), exactly what
        ``_try_dict_encode`` gives over ``decode()``, or None above the
        threshold: only the entries the valid rows use are sorted."""
        if n == 0 or DICT_ENCODE_MAX_FRACTION <= 0:
            return None
        limit = dict_limit(n)
        used = np.zeros(len(self.dictionary), bool)
        used[self.indices[valid]] = True
        dictionary, inv = _unique_strings(self.dictionary[used])
        if len(dictionary) > limit:
            return None
        remap = np.zeros(len(self.dictionary), np.int32)
        remap[used] = inv.astype(np.int32)
        codes = remap[self.indices] if len(remap) else \
            np.zeros(n, np.int32)
        if len(dictionary):
            # null slots hold the first value's code, as the reference's do
            codes[~valid] = codes[np.argmax(valid)]
        return codes, dictionary


def _unique_strings(hs: HostStrings):
    """(sorted distinct values as an object array of str, each value's
    index among them): byte order, which is code point order. Values that
    differ only in trailing 0x00 bytes, which numpy's ``unique`` over the
    ``S`` array would merge, are told apart by a key of the value's bytes
    and then its length (big-endian), whose order is byte order: equal
    buffers differ only in trailing zeros, and the shorter sorts first."""
    cut = hs.cut()
    if cut is None:
        uniq, inv = np.unique(hs.s, return_inverse=True)
        dictionary = np.char.decode(uniq, "utf-8").astype(object) \
            if len(uniq) else np.zeros(0, object)
        return dictionary, inv
    n, k = len(hs), hs.s.dtype.itemsize
    key = np.zeros((n, k + 4), np.uint8)
    key[:, :k] = np.ascontiguousarray(hs.s).view(np.uint8).reshape(n, k)
    key[:, k:] = hs.lengths.astype(">u4").view(np.uint8).reshape(n, 4)
    _, first, inv = np.unique(key.view(f"S{k + 4}").reshape(n),
                              return_index=True, return_inverse=True)
    return hs[first].to_objects(), inv


_UNSCALED_RANGE = ("decimal value exceeds the device's 64-bit unscaled "
                   "range (|unscaled| >= 2^63); such magnitudes arrive with "
                   "a decimal128 lane (the decimals item's leftovers, "
                   "ROADMAP.md Queue A)")


def decimal_unscaled_range_error() -> ValueError:
    """The error of a decimal value past the int64 lane, at ingest."""
    return ValueError(_UNSCALED_RANGE)


def decimal_unscaled_int64(arr, valid: np.ndarray) -> np.ndarray:
    """A decimal Arrow array -> its unscaled int64 values (invalid rows
    0), from the decimal128 buffer (a narrower decimal widens first): a
    value fits the lane where the high word is the sign extension of the
    low one; past that it raises, as the reference's ingest does
    (spark_rapids_tpu/columnar/batch.py:43)."""
    import pyarrow as pa
    if arr.type.bit_width != 128:
        arr = arr.cast(pa.decimal128(38, arr.type.scale))
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64)
    off = arr.offset
    lo = words[2 * off::2][:len(arr)]
    hi = words[2 * off + 1::2][:len(arr)]
    if not (hi == np.where(lo < 0, -1, 0))[valid].all():
        raise ValueError(_UNSCALED_RANGE)
    return np.where(valid, lo, 0)


def decimal_values(values) -> Optional[Tuple[np.ndarray, np.ndarray,
                                             DecimalType]]:
    """(unscaled int64 values, validity, type) of a column of Python
    ``Decimal``s and Nones, typed as pyarrow infers it (the largest scale,
    and the integral digits of the widest value beside it); None where
    the values are not all decimals."""
    present = [x for x in values if x is not None]
    if not present or not all(isinstance(x, decimal.Decimal)
                              for x in present):
        return None
    if not all(x.is_finite() for x in present):
        raise ValueError("non-finite decimal values cannot be ingested")
    scale = max(max(-x.as_tuple().exponent, 0) for x in present)
    exact = decimal.Context(prec=80)
    units = [int(x.scaleb(scale, exact)) for x in present]
    digits = max(len(str(abs(u))) for u in units)
    prec = max(digits, scale, 1)
    if prec > 38 or any(not -2 ** 63 <= u < 2 ** 63 for u in units):
        raise ValueError(_UNSCALED_RANGE)
    valid = np.array([x is not None for x in values], bool)
    out = np.zeros(len(values), np.int64)
    out[valid] = units
    return out, valid, DecimalType(prec, scale)


def _concat_values(parts: list) -> object:
    if isinstance(parts[0], (HostList, HostMap, HostStruct)):
        return type(parts[0]).concat(parts)
    if all(isinstance(p, np.ndarray) and p.dtype.kind == "O"
           for p in parts):
        return np.concatenate(parts)
    if all(isinstance(p, DictStrings) for p in parts):
        return DictStrings.concat(parts)
    if any(isinstance(p, (DictStrings, HostStrings)) for p in parts):
        return HostStrings.concat([
            p.decode() if isinstance(p, DictStrings)
            else utf8_bytes(p, np.ones(len(p), bool)) for p in parts])
    return np.concatenate(parts)


class HostTable:
    """A host table: per column numpy ``values`` and bool ``validity``.
    Values hold the device representation (DATE as int32 days, TIMESTAMP
    as int64 microseconds); strings stay ``S``/``U``/object arrays, or
    ``HostStrings``/``DictStrings`` from a Parquet file; a list column is
    a ``HostList``, a map column a ``HostMap`` and a struct column a
    ``HostStruct``, each with the rows' validity."""

    def __init__(self, columns: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 schema: Schema):
        self.columns = columns
        self.schema = schema
        self.num_rows = len(next(iter(columns.values()))[0]) \
            if columns else 0

    @staticmethod
    def from_dict(data: dict) -> "HostTable":
        """Columns from numpy arrays (masked arrays give NULLs); a
        ``HostList``, ``HostMap`` or ``HostStruct`` (every row valid) or
        such a (column, row validity) pair; or an object array (or list)
        of Python values, NULL rows and elements as None: lists, maps as
        lists of (key, value) tuples or as dicts of non-string keys,
        structs as dicts of string keys."""
        cols, fields = {}, []
        for name, v in data.items():
            nested = _as_host_nested(v)
            if nested is not None:
                cols[name] = nested
                fields.append(StructField(name, _host_type(nested[0]), True))
                continue
            dec = decimal_values(v) if isinstance(v, (list, np.ndarray)) \
                and np.asarray(v).dtype.kind == "O" else None
            if dec is not None:
                cols[name] = dec[:2]
                fields.append(StructField(name, dec[2], True))
                continue
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
            if isinstance(dt, ArrayType):
                v, valid = HostList.from_arrow(col)
            elif isinstance(dt, MapType):
                v, valid = HostMap.from_arrow(col)
            elif isinstance(dt, StructType):
                v, valid = HostStruct.from_arrow(col)
                dt = v.dtype
            elif isinstance(dt, DecimalType):
                v = decimal_unscaled_int64(col, valid)
            elif dt.device_backed:
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

    @property
    def nbytes(self) -> int:
        """Host bytes of the values and validities (a string column's
        array as numpy holds it)."""
        return sum((v.indices.nbytes + v.dictionary.nbytes
                    if isinstance(v, DictStrings) else v.nbytes) + m.nbytes
                   for v, m in self.columns.values())

    def select(self, names: Sequence[str]) -> "HostTable":
        return HostTable({n: self.columns[n] for n in names},
                         Schema([self.schema[n] for n in names]))

    @staticmethod
    def concat(tables: Sequence["HostTable"]) -> "HostTable":
        """The rows of ``tables`` (one schema) in order."""
        if len(tables) == 1:
            return tables[0]
        return HostTable(
            {n: (_concat_values([t.columns[n][0] for t in tables]),
                 np.concatenate([t.columns[n][1] for t in tables]))
             for n in tables[0].columns}, tables[0].schema)

    def slice(self, offset: int, length: int) -> "HostTable":
        return HostTable({n: (v[offset:offset + length],
                              m[offset:offset + length])
                          for n, (v, m) in self.columns.items()},
                         self.schema)


_HOST_NESTED = (HostList, HostMap, HostStruct)


def _host_type(v):
    return ArrayType(v.element) if isinstance(v, HostList) else v.dtype


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2


def _as_host_nested(v):
    """(HostList, HostMap or HostStruct, row validity) when ``v`` is a
    nested column (module doc of ``from_dict``), else None."""
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0],
                                                           _HOST_NESTED):
        return v[0], np.asarray(v[1], bool)
    if isinstance(v, _HOST_NESTED):
        return v, np.ones(len(v), bool)
    if isinstance(v, np.ndarray) and v.dtype != object:
        return None
    if not isinstance(v, (list, np.ndarray)):
        return None
    rows = [x for x in v if x is not None]
    if not rows:
        return None
    if all(isinstance(x, dict) for x in rows):
        if all(isinstance(k, str) for x in rows for k in x):
            return HostStruct.from_pylist(list(v))
        return HostMap.from_pylist(list(v))
    if all(isinstance(x, (list, tuple)) for x in rows):
        elems = [e for x in rows for e in x]
        if elems and all(_is_pair(e) for e in elems):
            return HostMap.from_pylist(list(v))
        return HostList.from_pylist(list(v))
    return None


def py_column(values: list):
    """A column of ``from_dict`` from Python values (None for NULL):
    nested values as ``_as_host_nested`` takes them, numbers as a masked
    numpy array of their type, strings as an object array."""
    nested = _as_host_nested(values)
    if nested is not None:
        return nested
    present = [x for x in values if x is not None]
    kind = np.asarray(present).dtype if present else np.dtype(np.int64)
    if kind.kind in "OUS":
        return np.array(values, dtype=object)
    fill = kind.type(0) if kind.kind != "M" else np.datetime64(0, "D")
    data = np.array([fill if x is None else x for x in values], kind)
    return np.ma.MaskedArray(data, mask=[x is None for x in values])


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


def dict_limit(rows: int) -> float:
    """The most distinct values a string column of ``rows`` rows may have
    and still be dictionary-coded (the reference's thresholds)."""
    return min(rows * DICT_ENCODE_MAX_FRACTION + 1, DICT_ENCODE_MAX_CARD)


def _try_dict_encode(s: HostStrings, valid: np.ndarray, n: int,
                     limit: Optional[float] = None):
    """UTF-8 ``HostStrings`` -> (codes int32[n], sorted dictionary) or
    None when the cardinality is above ``limit`` (default
    ``dict_limit(n)``). Codes index the dictionary sorted in byte order,
    which is codepoint order."""
    if n == 0 or DICT_ENCODE_MAX_FRACTION <= 0:
        return None
    if limit is None:
        limit = dict_limit(n)
    vals = s[valid]
    # cheap proof of high cardinality: count distinct hashes by a sort
    # (np.unique may take a hash-table path that is far slower on 1M rows);
    # values apart only in trailing NULs hash alike, which only lowers
    # the count
    h = np.sort(_row_hashes(vals.s))
    if len(h) and 1 + np.count_nonzero(h[1:] != h[:-1]) > limit:
        return None
    dictionary, inv = _unique_strings(vals)
    if len(dictionary) > limit:
        return None
    codes = np.zeros(n, np.int32)
    codes[valid] = inv.astype(np.int32)
    if len(dictionary):
        # null slots hold the first value's code, as the reference's do
        codes[~valid] = codes[np.argmax(valid)]
    return codes, dictionary


def rect_to_dict(col: ByteRectColumn, n: int,
                 limit: float) -> Optional[DictColumn]:
    """The first ``n`` rows of a byte-rectangle column as a dictionary
    column over their sorted distinct values (codes and dictionary as
    ingest would give them over the same strings), or None when they
    number more than ``limit``. The rectangle is read back to the host:
    one that ``limit`` admits is a short batch."""
    rect = np.ascontiguousarray(col.data[:n].cpu().numpy())
    valid = col.validity[:n].cpu().numpy()
    s = HostStrings(rect.view(f"S{col.width}").reshape(n),
                    col.lengths[:n].cpu().numpy().astype(np.int32))
    enc = _try_dict_encode(s, valid, n, limit)
    if enc is None:
        return None
    codes, dictionary = enc
    return DictColumn(_to_device(codes, col.data.device), col.validity[:n],
                      STRING, dictionary)


def dict_to_rect(col: DictColumn, n: int) -> ByteRectColumn:
    """The first ``n`` rows of a dictionary column as a byte rectangle:
    the dictionary's entries encoded once, gathered by code."""
    d = col.dictionary
    ent = utf8_bytes(np.asarray(d, object), np.ones(len(d), bool)) \
        if len(d) else HostStrings(np.zeros(1, "S1"), np.zeros(1, np.int32))
    rect, lens, _, asc = encode_string_rect(ent, np.ones(len(ent), bool),
                                            len(ent), 1 << 30)
    dev = col.data.device
    codes = col.data[:n].clamp(0, len(ent) - 1).long()
    valid = col.validity[:n]
    keep = valid.unsqueeze(1)
    return ByteRectColumn(
        torch.where(keep, _to_device(rect, dev)[codes], 0), valid,
        torch.where(valid, _to_device(lens, dev)[codes], 0),
        ascii_only=asc)


def _encode_string(values, valid, n, rect_cap):
    """A host string column's device layout, still on the host:
    ("dict", codes, dictionary) at low cardinality, ("rect", rect,
    lengths, validity, ascii_only) up to ``rect_cap`` bytes wide, else
    ("host", values as str objects)."""
    if isinstance(values, DictStrings):
        enc = values.encode(valid, n)
        if enc is not None:
            return ("dict",) + enc
        values = values.decode()
    s = utf8_bytes(values, valid)
    enc = _try_dict_encode(s, valid, n)
    if enc is not None:
        return ("dict",) + enc
    renc = encode_string_rect(s, valid, n, rect_cap)
    if renc is not None:
        return ("rect",) + renc
    strs = np.asarray(values, object) if isinstance(values, np.ndarray) \
        and values.dtype.kind != "S" else s.to_objects()
    return ("host", strs)


def _nested_to_device(f: StructField, values, valid: np.ndarray, device,
                      rect_cap: int):
    """A map or struct host column on ``device``: a map as its two list
    rectangles, a struct as its fields' columns, each laid out as ingest
    lays out a column of its type. Refused, naming the queue, where the
    type or a field has no device column."""
    r = nested_reason(f.dtype)
    if r:
        raise NotImplementedError(f"column {f.name}: {r}")
    if isinstance(f.dtype, MapType):
        return to_device_map(values, valid, f.dtype, device,
                             f"column {f.name}", rect_cap)
    kids = ColumnarBatch.from_host(values.table, device, rect_cap,
                                   encode=False)
    for sf, c in zip(f.dtype.fields, kids.columns):
        if isinstance(c, HostColumn):
            raise NotImplementedError(
                f"column {f.name}: field {sf.name} holds strings past the "
                f"byte rectangle's {rect_cap} bytes; a struct of host "
                f"strings arrives with {NESTED_REST}")
    return StructColumn(kids.columns, _to_device(valid, device), f.dtype)


class ColumnarBatch:
    __slots__ = ("columns", "num_rows", "schema", "partition_id")

    def __init__(self, columns: Sequence, num_rows: int, schema: Schema,
                 partition_id: int = 0):
        assert len(columns) == len(schema), (len(columns), len(schema))
        self.columns = list(columns)
        self.num_rows = int(num_rows)
        self.schema = schema
        #: the input partition the rows came from (a scan's table or
        #: file); projections and filters pass it on
        self.partition_id = partition_id

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
    def from_host(table: HostTable, device, rect_cap: int,
                  encode: bool = True,
                  timings: Optional[dict] = None) -> "ColumnarBatch":
        """Host table -> device batch: fixed-width columns copy over as
        (data, validity) with nulls at the dtype default; strings become
        dictionary codes (low cardinality), byte rectangles (up to
        ``rect_cap`` bytes wide) or stay host. With ``encode``, the
        fixed-width columns and codes go through the transfer encode when
        it pays (columnar/transfer.py). ``timings``, when given, gains the
        seconds of the host string encode (``encode_s``) and of the copy
        with its decode (``copy_s``, waited for on a card)."""
        from .transfer import (copy_to_device, decode_columns,
                               encode_columns, may_pay, worthwhile)
        t0 = time.perf_counter()
        n = table.num_rows
        cols: List = [None] * len(table.schema)
        staged, pairs, rects, lists, nested = [], [], [], [], []
        for i, f in enumerate(table.schema.fields):
            values, valid = table.columns[f.name]
            if f.dtype.device_backed:
                d = np.asarray(values).astype(f.dtype.np_dtype, copy=False)
                if not valid.all():
                    d = np.where(valid, d, f.dtype.np_dtype.type(0))
                staged.append((i, f.dtype, None))
                pairs.append((d, valid))
            elif device_list_ok(f.dtype):
                lists.append((i, values, valid))
            elif isinstance(f.dtype, (MapType, StructType)):
                nested.append((i, values, valid))
            elif f.dtype == STRING:
                enc = _encode_string(values, valid, n, rect_cap)
                if enc[0] == "dict":
                    staged.append((i, STRING, enc[2]))
                    pairs.append((enc[1], valid))
                elif enc[0] == "rect":
                    rects.append((i, enc[1:]))
                else:
                    cols[i] = HostColumn(enc[1], valid, STRING)
            else:
                cols[i] = HostColumn(values, valid, f.dtype)
        t1 = time.perf_counter()
        put = None
        if encode and pairs and may_pay(pairs):
            flat, specs, params, ratio, raw = encode_columns(pairs)
            if worthwhile(ratio, raw):
                put = decode_columns(copy_to_device(flat, device), specs,
                                     params, n, device)
        if put is None:
            put = [(_to_device(d, device), _to_device(v, device))
                   for d, v in pairs]
        for (i, dt, dictionary), (d, v) in zip(staged, put):
            cols[i] = DeviceColumn(d, v, dt) if dictionary is None \
                else DictColumn(d, v, dt, dictionary)
        for i, (rect, lens, v, asc) in rects:
            cols[i] = ByteRectColumn(_to_device(rect, device),
                                     _to_device(v, device),
                                     _to_device(lens, device),
                                     ascii_only=asc)
        for i, values, valid in lists:
            f = table.schema.fields[i]
            cols[i] = to_device_list(values, valid, f.dtype, device,
                                     f"column {f.name}", rect_cap)
        for i, values, valid in nested:
            cols[i] = _nested_to_device(table.schema.fields[i], values,
                                        valid, device, rect_cap)
        if timings is not None:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            timings["encode_s"] = timings.get("encode_s", 0.0) + t1 - t0
            timings["copy_s"] = timings.get("copy_s", 0.0) + t2 - t1
        return ColumnarBatch(cols, n, table.schema)

    def slice(self, offset: int, length: int) -> "ColumnarBatch":
        """Rows ``offset`` to ``offset + length`` (within num_rows), as
        views."""
        end = offset + length
        cols: List = []
        for c in self.columns:
            if isinstance(c, DeviceColumn):
                cols.append(slice_rows(c, offset, end))
            else:
                cols.append(HostColumn(c.values[offset:end],
                                       c.validity[offset:end], c.dtype))
        return ColumnarBatch(cols, length, self.schema, self.partition_id)

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
    reference batch's row count (default: every row). A list, map or
    struct column, which the reference keeps on its host as Arrow, is
    given as ``arrow`` (its Arrow array) and laid out as ingest lays it
    out, padding rows NULL."""
    padded = next((len(c["validity"]) for c in columns if "validity" in c),
                  None)
    if padded is None:
        # every column is Arrow (or there are none): its length is the
        # batch's, padding included
        padded = next((len(c["arrow"]) for c in columns), num_rows)
    cols = []
    for c, f in zip(columns, schema.fields):
        if "arrow" in c:
            cols.append(_arrow_column(c["arrow"], f, device, padded))
            continue
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
        if padded is None:
            raise ValueError("batch_from_reference: a batch of no columns "
                             "needs num_rows")
        num_rows = padded
    return ColumnarBatch(cols, num_rows, schema)


def _arrow_column(arr, f: StructField, device, padded: Optional[int]):
    """One Arrow column, padded with NULL rows to ``padded``, as ingest
    lays it out on ``device``."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if padded is not None and padded > len(arr):
        arr = pa.concat_arrays([arr, pa.nulls(padded - len(arr), arr.type)])
    table = HostTable.from_arrow(pa.table({f.name: arr}))
    return ColumnarBatch.from_host(table, device, 1 << 30,
                                   encode=False).columns[0]


def union_dictionary(dictionaries: Sequence[np.ndarray]) -> np.ndarray:
    """The sorted union of sorted dictionaries (the first itself when
    they are all one object)."""
    first = dictionaries[0]
    if all(d is first for d in dictionaries):
        return first
    return np.unique(np.concatenate(list(dictionaries)))


def to_dictionary(col: DictColumn, union: np.ndarray) -> DictColumn:
    """``col`` over ``union``, a sorted superset of its dictionary: its
    codes remapped on the device."""
    if col.dictionary is union:
        return col
    remap = np.searchsorted(union, col.dictionary).astype(np.int32)
    c = col.data
    if len(remap):
        c = torch.from_numpy(remap).to(c.device)[c.clamp(0, len(remap) - 1)
                                                 .long()]
    else:
        c = torch.zeros_like(c)
    return DictColumn(c, col.validity, col.dtype, union)


def pad_rect(col: ByteRectColumn, width: int) -> ByteRectColumn:
    """``col`` padded with zero bytes to ``width`` (at least its own)."""
    if width == col.width:
        return col
    if width < col.width:
        raise ValueError(f"a {col.width}-byte rectangle cannot pad to "
                         f"{width} bytes")
    return ByteRectColumn(
        torch.nn.functional.pad(col.data, (0, width - col.width)),
        col.validity, col.lengths, ascii_only=col.ascii_only)


def _concat_dict(parts: List[DictColumn], rows: List[int]) -> DictColumn:
    """Dictionary columns over one dictionary: the sorted union of theirs,
    each part's codes remapped into it."""
    union = union_dictionary([p.dictionary for p in parts])
    parts = [to_dictionary(p.with_arrays(p.data[:n], p.validity[:n]), union)
             for p, n in zip(parts, rows)]
    return DictColumn(torch.cat([p.data for p in parts]),
                      torch.cat([p.validity for p in parts]),
                      parts[0].dtype, union)


def _concat_rect(parts: List[ByteRectColumn],
                 rows: List[int]) -> ByteRectColumn:
    """Byte rectangles, narrower ones padded with zeros to the widest."""
    w = max(p.width for p in parts)
    parts = [pad_rect(ByteRectColumn(p.data[:n], p.validity[:n],
                                     p.lengths[:n], p.ascii_only), w)
             for p, n in zip(parts, rows)]
    return ByteRectColumn(
        torch.cat([p.data for p in parts]),
        torch.cat([p.validity for p in parts]),
        torch.cat([p.lengths for p in parts]),
        ascii_only=all(p.ascii_only for p in parts))


def _concat_mixed(parts: List, rows: List[int]):
    """A string column that arrives as dictionaries in some batches and as
    byte rectangles in others (a short batch of a low-cardinality column
    is a rectangle): one dictionary column when the union of the values
    stays under the dictionary threshold for all the rows, else one byte
    rectangle."""
    limit = dict_limit(sum(rows))
    dicts = [rect_to_dict(p, n, limit) if isinstance(p, ByteRectColumn)
             else p for p, n in zip(parts, rows)]
    if all(d is not None for d in dicts) and len(
            set().union(*(d.dictionary for d in dicts))) <= limit:
        return _concat_dict([d.with_arrays(d.data[:n], d.validity[:n])
                             for d, n in zip(dicts, rows)], rows)
    return _concat_rect([dict_to_rect(p, n) if isinstance(p, DictColumn)
                         else p for p, n in zip(parts, rows)], rows)


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """The rows of ``batches`` (one schema) in order, padding dropped, in
    one batch (port of the reference's ``concat_batches``): device columns
    concatenate on the device; dictionary columns over the sorted union of
    their dictionaries; byte rectangles at the widest width; a string column
    in both layouts as one of them (``_concat_mixed``); list rectangles at
    the widest W; maps as their two rectangles; structs field by
    field."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    rows = [b.num_rows for b in batches]
    cols = [_concat_column([b.columns[i] for b in batches], rows, f.name)
            for i, f in enumerate(schema.fields)]
    return ColumnarBatch(cols, sum(rows), schema)


def _concat_column(parts: List, rows: List[int], name: Optional[str]):
    """One column's parts (``rows`` each) in one column (``name`` for an
    error; a list's flat elements have none)."""
    kinds = {type(p) for p in parts}
    dtype = parts[0].dtype
    if kinds == {DictColumn}:
        return _concat_dict(parts, rows)
    if kinds == {ByteRectColumn}:
        return _concat_rect(parts, rows)
    if kinds == {ListColumn}:
        return concat_lists(parts, rows)
    if kinds == {MapColumn}:
        return concat_maps(parts, rows)
    if kinds == {StructColumn}:
        return StructColumn(
            [_concat_column([p.children[k] for p in parts], rows,
                            f"{name}.{sf.name}")
             for k, sf in enumerate(dtype.fields)],
            torch.cat([p.validity[:n] for p, n in zip(parts, rows)]),
            dtype)
    if kinds == {DeviceColumn}:
        return DeviceColumn(
            torch.cat([p.data[:n] for p, n in zip(parts, rows)]),
            torch.cat([p.validity[:n] for p, n in zip(parts, rows)]),
            dtype)
    if kinds == {DictColumn, ByteRectColumn}:
        return _concat_mixed(parts, rows)
    if kinds == {HostColumn}:
        return HostColumn(
            np.concatenate([p.values[:n] for p, n in zip(parts, rows)]),
            np.concatenate([p.validity[:n] for p, n in zip(parts, rows)]),
            dtype)
    raise NotImplementedError(
        f"column {name} arrives in different layouts "
        f"({sorted(k.__name__ for k in kinds)}); concatenating "
        "host strings with device strings arrives with the strings "
        "slice")
