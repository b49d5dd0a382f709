"""Decode of a Parquet column chunk into the host arrays a ``HostTable``
holds, through the port's host library ``csrc/parquet_host.cpp`` (built
by g++ at first use, under the lock of ``native.build_host``).

Pages are walked here (their thrift headers read by io/thrift.py); their
bytes go to the library for SNAPPY decompression, the RLE/bit-packed
hybrid of definition levels and dictionary indices, the PLAIN byte-array
split, the dictionary gather and the null scatter. GZIP pages inflate
through ``zlib``; UNCOMPRESSED needs nothing; another codec raises,
naming the file, the column and the codec. Data pages v1 and v2 (v2
levels never compressed), PLAIN and both dictionary encodings, and a
chunk that falls back from its dictionary to PLAIN partway are read.

A DECIMAL chunk becomes its unscaled int64 values: INT32 and INT64
widen; FIXED_LEN_BYTE_ARRAY and BYTE_ARRAY values, big-endian two's
complement, are right-aligned into 8-byte words (a wider value must be the
sign extension of its low 8 bytes, else it raises, as ingest does).

A string chunk whose every data page is dictionary-encoded stays in its
dictionary form (``DictStrings``): ingest takes a batch's codes from the
entries it uses rather than from the strings.

ctypes releases the interpreter lock for each library call (and zlib
for each inflate), so threads decode files in parallel. A missing
library or a malformed chunk raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from .. import native
from ..columnar.batch import DictStrings
from ..columnar.strrect import HostStrings
from ..types import BOOL, INT8, INT16, STRING, DecimalType
from . import parquet_meta as M
from .thrift import ColumnMeta, parse_page_header

__all__ = ["library", "decode_chunk", "CODECS", "ENCODINGS",
           "snappy_decompress", "rle_decode"]

CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
          4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
_PLAIN, _PLAIN_DICT, _RLE, _RLE_DICT = 0, 2, 3, 8
_DATA, _INDEX, _DICT_PAGE, _DATA_V2 = 0, 1, 2, 3

_FIXED = {M.INT32_: np.dtype("<i4"), M.INT64_: np.dtype("<i8"),
          M.FLOAT: np.dtype("<f4"), M.DOUBLE: np.dtype("<f8")}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed; raises where it
    cannot be built."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path = native.build_host("parquet_host")
            if path is None:
                raise RuntimeError(
                    "the Parquet host library (csrc/parquet_host.cpp) did "
                    "not build: g++ is missing or failed")
            lib = ctypes.CDLL(str(path))
            lib.pq_snappy_length.argtypes = [_P, _I64]
            lib.pq_snappy_length.restype = _I64
            lib.pq_snappy_decompress.argtypes = [_P, _I64, _P, _I64]
            lib.pq_snappy_decompress.restype = _I64
            lib.pq_rle_decode.argtypes = [_P, _I64, ctypes.c_int32, _I64, _P]
            lib.pq_rle_decode.restype = _I64
            lib.pq_byte_array_split.argtypes = [_P, _I64, _I64, _P, _P, _P]
            lib.pq_byte_array_split.restype = _I64
            lib.pq_fill_fixed.argtypes = [_P, _P, _P, _I64, _I64, _P]
            lib.pq_fill_fixed.restype = None
            lib.pq_gather.argtypes = [_P, _I64, _I64, _P, _I64, _P]
            lib.pq_gather.restype = _I64
            lib.pq_scatter.argtypes = [_P, _I64, _P, _I64, _P]
            lib.pq_scatter.restype = _I64
            _LIB = lib
        return _LIB


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class ChunkError(ValueError):
    """A column chunk the reader cannot decode."""


def snappy_decompress(src: np.ndarray, expect: Optional[int] = None
                      ) -> np.ndarray:
    lib = library()
    n = lib.pq_snappy_length(_ptr(src), len(src))
    if n < 0 or (expect is not None and n != expect):
        raise ChunkError(f"SNAPPY block of length {n}, expected {expect}")
    out = np.empty(max(n, 1), np.uint8)
    got = lib.pq_snappy_decompress(_ptr(src), len(src), _ptr(out), n)
    if got != n:
        raise ChunkError("malformed SNAPPY block")
    return out[:n]


def rle_decode(src: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE/bit-packed hybrid; raises when
    ``src`` runs out first."""
    out = np.empty(max(count, 1), np.int32)
    used = library().pq_rle_decode(_ptr(src), len(src), bit_width, count,
                                   _ptr(out))
    if used < 0:
        raise ChunkError(f"malformed RLE/bit-packed run (width "
                         f"{bit_width}, {count} values)")
    return out[:count]


class _Chunk:
    """One column chunk's decode state."""

    def __init__(self, cm: ColumnMeta, col: M.LeafColumn, where: str,
                 rates: Optional[Dict[str, list]]):
        self.col = col
        self.where = where
        self.rates = rates
        self.codec = CODECS.get(cm.codec, str(cm.codec))
        if self.codec not in ("UNCOMPRESSED", "SNAPPY", "GZIP"):
            raise NotImplementedError(
                f"{where}: codec {self.codec} is not supported (the port "
                "reads UNCOMPRESSED, SNAPPY and GZIP)")

    def _rate(self, what: str, nbytes: int, t0: float) -> None:
        if self.rates is not None:
            r = self.rates.setdefault(what, [0, 0.0])
            r[0] += nbytes
            r[1] += time.perf_counter() - t0

    def inflate(self, body: np.ndarray, size: int) -> np.ndarray:
        if self.codec == "UNCOMPRESSED":
            return body
        t0 = time.perf_counter()
        if self.codec == "SNAPPY":
            out = snappy_decompress(body, size)
        else:
            out = np.frombuffer(zlib.decompress(body.tobytes(), 47),
                                np.uint8)
            if len(out) != size:
                raise ChunkError(f"GZIP page of {len(out)} bytes, "
                                 f"expected {size}")
        self._rate(self.codec, size, t0)
        return out

    def levels(self, data: np.ndarray, count: int) -> np.ndarray:
        """bool[count]: which rows hold a value."""
        t0 = time.perf_counter()
        lv = rle_decode(data, self.col.max_def.bit_length(), count)
        self._rate("RLE levels", lv.nbytes, t0)
        return lv == self.col.max_def

    def plain(self, data: np.ndarray, count: int) -> np.ndarray:
        """``count`` PLAIN values: the port's host dtype (INT96 as int64
        microseconds, strings as ``HostStrings``)."""
        t0 = time.perf_counter()
        p = self.col.physical
        if p == M.BOOLEAN:
            nb = (count + 7) // 8
            if len(data) < nb:
                raise ChunkError("short BOOLEAN page")
            out = np.unpackbits(data[:nb], bitorder="little")[:count] \
                .astype(bool)
            what, nbytes = "PLAIN boolean", nb
        elif p in _FIXED:
            dt = _FIXED[p]
            nbytes = count * dt.itemsize
            if len(data) < nbytes:
                raise ChunkError("short PLAIN page")
            out = data[:nbytes].view(dt)
            what = f"PLAIN {dt.itemsize}-byte"
        elif p == M.INT96:
            nbytes = count * 12
            if len(data) < nbytes:
                raise ChunkError("short INT96 page")
            rec = data[:nbytes].view(np.dtype([("ns", "<i8"),
                                               ("jd", "<i4")]))
            # Julian day 2440588 is 1970-01-01
            out = (rec["jd"].astype(np.int64) - 2440588) * 86_400_000_000 \
                + rec["ns"] // 1000
            what = "PLAIN int96"
        elif p == M.BYTE_ARRAY and isinstance(self.col.dtype, DecimalType):
            hs, nbytes = self._byte_array(data, count)
            out = _be_decimals(hs.s.view(np.uint8).reshape(count, -1)
                               if count else np.zeros((0, 1), np.uint8),
                               hs.lengths)
            what = "PLAIN byte array decimal"
        elif p == M.BYTE_ARRAY:
            out, nbytes = self._byte_array(data, count)
            what = "PLAIN byte array"
        elif p == M.FIXED_LEN_BYTE_ARRAY and isinstance(self.col.dtype,
                                                        DecimalType):
            w = self.col.element.type_length or 0
            nbytes = count * w
            if w < 1 or len(data) < nbytes:
                raise ChunkError("short FIXED_LEN_BYTE_ARRAY page")
            out = _be_decimals(data[:nbytes].reshape(count, w),
                               np.full(count, w, np.int32))
            what = "PLAIN fixed decimal"
        else:
            raise ChunkError(f"physical type {p}")
        self._rate(what, nbytes, t0)
        return out

    def rle_booleans(self, data: np.ndarray, count: int) -> np.ndarray:
        """BOOLEAN values in RLE encoding (data pages v2): a 4-byte
        length, then the hybrid at bit width 1."""
        t0 = time.perf_counter()
        ln = int(data[:4].view("<u4")[0])
        out = rle_decode(data[4:4 + ln], 1, count).astype(bool)
        self._rate("RLE boolean", out.nbytes, t0)
        return out

    def _byte_array(self, data: np.ndarray, count: int):
        lib = library()
        starts = np.empty(max(count, 1), np.int64)
        lens = np.empty(max(count, 1), np.int32)
        longest = np.zeros(1, np.int32)
        used = lib.pq_byte_array_split(_ptr(data), len(data), count,
                                       _ptr(starts), _ptr(lens),
                                       _ptr(longest))
        if used < 0:
            raise ChunkError("malformed PLAIN BYTE_ARRAY page")
        w = max(int(longest[0]), 1)
        out = np.empty(count, f"S{w}")
        lib.pq_fill_fixed(_ptr(data), _ptr(starts), _ptr(lens), count, w,
                          _ptr(out.view(np.uint8)))
        # the page's lengths stay beside the values: an S array drops a
        # value's trailing 0x00 bytes
        return HostStrings(out, lens[:count].copy()), used

    def indices(self, data: np.ndarray, count: int) -> np.ndarray:
        """``count`` dictionary indices: a bit width byte, then the
        hybrid."""
        t0 = time.perf_counter()
        if not len(data):
            if count:
                raise ChunkError("empty dictionary-index page")
            return np.zeros(0, np.int32)
        out = rle_decode(data[1:], int(data[0]), count)
        self._rate("RLE_DICTIONARY indices", out.nbytes, t0)
        return out


def _be_decimals(raw: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Big-endian two's complement values (row i: the first ``lens[i]``
    bytes of ``raw[i]``) as int64; raises where one passes int64."""
    from ..columnar.batch import decimal_unscaled_range_error
    n, w = raw.shape
    W = max(w, 8)
    lens = lens.astype(np.int64)
    neg = (lens > 0) & ((raw[:, 0] & 0x80) != 0) if n else \
        np.zeros(0, bool)
    k = np.arange(W)[None, :] - (W - lens[:, None])  # source byte
    inside = (k >= 0) & (k < lens[:, None])
    src = np.take_along_axis(np.pad(raw, ((0, 0), (0, W - w))),
                             np.clip(k, 0, W - 1), axis=1)
    fill = np.where(neg, 0xFF, 0).astype(np.uint8)[:, None]
    aligned = np.where(inside, src, fill).astype(np.uint8)
    if W > 8 and not (aligned[:, :W - 8] == fill).all():
        raise decimal_unscaled_range_error()
    out = np.ascontiguousarray(aligned[:, W - 8:]).view(">i8") \
        .reshape(n).astype(np.int64)
    if not ((out < 0) == neg).all():
        raise decimal_unscaled_range_error()
    return out


def _gather(dictionary, idx: np.ndarray):
    if isinstance(dictionary, HostStrings):
        s = _gather(dictionary.s, idx)
        return HostStrings(s, dictionary.lengths[idx])
    out = np.empty(len(idx), dictionary.dtype)
    if not len(idx):
        return out
    elem = dictionary.dtype.itemsize
    d = np.ascontiguousarray(dictionary)
    if library().pq_gather(_ptr(d.view(np.uint8)), len(d), elem, _ptr(idx),
                           len(idx), _ptr(out.view(np.uint8))) < 0:
        raise ChunkError("dictionary index out of range")
    return out


def _scatter(dense, valid: np.ndarray):
    if isinstance(dense, HostStrings):
        s = _scatter(dense.s, valid)
        lens = np.zeros(len(valid), np.int32)
        lens[valid] = dense.lengths
        return HostStrings(s, lens)
    out = np.empty(len(valid), dense.dtype)
    if not len(valid):
        return out
    dense = np.ascontiguousarray(dense)
    v = np.ascontiguousarray(valid).view(np.uint8)
    used = library().pq_scatter(_ptr(dense.view(np.uint8)),
                                dense.dtype.itemsize, _ptr(v), len(valid),
                                _ptr(out.view(np.uint8)))
    if used != len(dense):
        raise ChunkError(f"{len(dense)} values for {used} valid rows")
    return out


def _empty(col: M.LeafColumn) -> np.ndarray:
    if isinstance(col.dtype, DecimalType):
        return np.zeros(0, np.int64)
    if col.dtype == STRING:
        return HostStrings(np.zeros(0, "S1"), np.zeros(0, np.int32))
    if col.physical == M.BOOLEAN:
        return np.zeros(0, bool)
    return np.zeros(0, _FIXED.get(col.physical, np.dtype("<i8")))


def decode_chunk(raw: np.ndarray, cm: ColumnMeta, col: M.LeafColumn,
                 num_rows: int, where: str,
                 rates: Optional[Dict[str, list]] = None):
    """(values, validity) of a flat column chunk of ``num_rows`` rows, in
    the port's host layout (DATE as int32 days, TIMESTAMP as int64
    microseconds, strings as ``HostStrings`` or ``DictStrings``).
    ``rates``, when given, gains [bytes, seconds] per encoding and codec
    (bytes out of the step: decompressed, decoded values, gathered and
    scattered rows; PLAIN steps count their input)."""
    ch = _Chunk(cm, col, where, rates)
    dictionary = None
    parts: List[tuple] = []          # ("dict", indices) / ("plain", values)
    valids: List[np.ndarray] = []
    pos = got = 0
    buf = memoryview(raw)            # thrift reads Python ints from it
    try:
        while got < num_rows:
            if pos >= len(raw):
                raise ChunkError(f"chunk ends after {got} of {num_rows} "
                                 "values")
            h, start = parse_page_header(buf, pos)
            body = raw[start:start + h.compressed_size]
            pos = start + h.compressed_size
            if h.type == _DICT_PAGE:
                data = ch.inflate(body, h.uncompressed_size)
                dictionary = ch.plain(data, h.num_values)
                continue
            if h.type == _INDEX:
                continue
            n = h.num_values
            if h.type == _DATA:
                data = ch.inflate(body, h.uncompressed_size)
                off = 0
                if col.max_def:
                    if h.def_encoding != _RLE:
                        raise NotImplementedError(
                            f"{where}: definition levels in "
                            f"{ENCODINGS.get(h.def_encoding)} encoding")
                    ln = int(data[:4].view("<u4")[0])
                    valid = ch.levels(data[4:4 + ln], n)
                    off = 4 + ln
                else:
                    valid = np.ones(n, bool)
                data = data[off:]
            elif h.type == _DATA_V2:
                lv = h.def_len + h.rep_len
                if h.rep_len:
                    raise NotImplementedError(
                        f"{where}: repetition levels (a nested column)")
                valid = ch.levels(body[:h.def_len], n) if col.max_def \
                    else np.ones(n, bool)
                data = body[lv:]
                if h.is_compressed:
                    data = ch.inflate(data, h.uncompressed_size - lv)
            else:
                raise ChunkError(f"page type {h.type}")
            k = int(valid.sum())
            if h.encoding in (_PLAIN_DICT, _RLE_DICT):
                if dictionary is None:
                    raise ChunkError("dictionary-encoded page before its "
                                     "dictionary")
                parts.append(("dict", ch.indices(data, k)))
            elif h.encoding == _PLAIN:
                parts.append(("plain", ch.plain(data, k)))
            elif h.encoding == _RLE and col.physical == M.BOOLEAN:
                parts.append(("plain", ch.rle_booleans(data, k)))
            else:
                raise NotImplementedError(
                    f"{where}: {ENCODINGS.get(h.encoding, h.encoding)} "
                    "pages are not supported (the port reads PLAIN, "
                    "PLAIN_DICTIONARY, RLE_DICTIONARY and RLE booleans)")
            valids.append(valid)
            got += n
    except (IndexError, ValueError) as e:
        if isinstance(e, (ChunkError, NotImplementedError)):
            raise ChunkError(f"{where}: {e}") from e
        raise ChunkError(f"{where}: malformed chunk ({e!r})") from e
    if got != num_rows:
        raise ChunkError(f"{where}: {got} values for {num_rows} rows")
    valid = np.concatenate(valids) if valids else np.zeros(0, bool)
    t0 = time.perf_counter()
    if col.dtype == STRING and parts and all(k == "dict" for k, _ in parts):
        dense = np.concatenate([p for _, p in parts])
        idx = dense if valid.all() else _scatter(dense, valid)
        ch._rate("assembly (pages joined, gather, null scatter)", idx.nbytes,
                 t0)
        return DictStrings(idx, dictionary), valid
    pieces = [_gather(dictionary, p) if kind == "dict" else p
              for kind, p in parts]
    # the pages' values in one aligned array: concatenate promotes S
    # arrays to the widest, and copies a lone page out of the chunk's
    # bytes, where it may sit at any offset
    if not pieces:
        dense = _empty(col)
    elif isinstance(pieces[0], HostStrings):
        dense = HostStrings.concat(pieces)
    else:
        dense = np.concatenate(pieces)
    values = dense if valid.all() else _scatter(dense, valid)
    ch._rate("assembly (pages joined, gather, null scatter)", values.nbytes,
             t0)
    return _port_values(values, col), valid



def _port_values(v: np.ndarray, col: M.LeafColumn) -> np.ndarray:
    """Physical values -> the port's host representation."""
    if col.dtype == BOOL:
        return v.astype(bool, copy=False)
    if col.dtype in (INT8, INT16) or isinstance(col.dtype, DecimalType):
        return v.astype(col.dtype.np_dtype)
    if col.ts_unit == "ms":
        return v.astype(np.int64) * 1000
    if col.ts_unit == "ns":
        return v.astype(np.int64) // 1000
    return v
