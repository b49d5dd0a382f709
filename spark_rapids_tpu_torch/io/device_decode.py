"""Opt-in raw-byte ingest of Parquet columns (port of
``spark_rapids_tpu/io/device_decode.py``, same key, same eligibility,
off by default).

For UNCOMPRESSED, PLAIN-encoded, fixed-width, null-free column chunks
the host reads only the page headers: the value bytes go to the device
in one copy per column and become the typed column there by a ``.view``
(the reference bitcasts them with a jitted kernel). The host never
decodes these columns. It engages only with the PERFILE reader and no
pushed predicate, as in the reference; a file in which any requested
column does not qualify takes the standard path.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from ..columnar import ColumnarBatch, DeviceColumn
from ..config import register
from ..types import torch_dtype
from .parquet_meta import DOUBLE, FLOAT, INT32_, INT64_, read_footer
from .thrift import ColumnMeta, parse_page_header

__all__ = ["DEVICE_DECODE_ENABLED", "chunk_eligible", "decode_chunk_values",
           "device_decode_scan"]

DEVICE_DECODE_ENABLED = register(
    "spark.rapids.tpu.io.parquet.deviceDecode.enabled", False,
    "EXPERIMENTAL: decode eligible parquet column chunks on the device "
    "(uncompressed, PLAIN, fixed-width, null-free): the host parses "
    "only page headers and ships raw value bytes, which become the typed "
    "column on the device (io/device_decode.py). Engages only with "
    "format.parquet.reader.type=PERFILE and no pushed-down predicate; "
    "ineligible files use the standard path.")

#: physical type -> numpy dtype of its PLAIN values
_PHYS = {INT32_: np.dtype("<i4"), INT64_: np.dtype("<i8"),
         FLOAT: np.dtype("<f4"), DOUBLE: np.dtype("<f8")}
#: engine types whose bitcast is exactly the decoded result (dates and
#: timestamps excluded, as in the reference)
_DD_TYPES = frozenset(["int", "bigint", "float", "double"])
_PLAIN, _RLE = 0, 3
_PAGE_DATA, _PAGE_DATA_V2 = 0, 3


def chunk_eligible(cm: ColumnMeta) -> Optional[np.dtype]:
    """The chunk's value dtype when it qualifies for the raw path, else
    None."""
    if cm.codec != 0 or cm.dictionary_page_offset is not None:
        return None
    # BIT_PACKED def levels have no length prefix: only RLE levels
    if not set(cm.encodings) <= {_PLAIN, _RLE}:
        return None
    st = cm.statistics
    if st is None or st.null_count is None or st.null_count != 0:
        return None
    return _PHYS.get(cm.type)


def decode_chunk_values(raw, num_values: int, dtype: np.dtype,
                        max_def_level: int) -> Optional[np.ndarray]:
    """The value bytes of every data page of a raw chunk, concatenated
    (uint8), or None if anything in the chunk surprises the parser."""
    width = dtype.itemsize
    buf = memoryview(raw)
    pos = got = 0
    parts: List[np.ndarray] = []
    try:
        while got < num_values:
            h, data_pos = parse_page_header(buf, pos)
            if h.encoding != _PLAIN:
                return None
            if h.type == _PAGE_DATA:
                off = data_pos
                if max_def_level > 0:
                    # v1 RLE def-level block: u32 length prefix
                    (lv_len,) = struct.unpack_from("<I", buf, off)
                    off += 4 + lv_len
            elif h.type == _PAGE_DATA_V2:
                off = data_pos + h.def_len + h.rep_len
            else:
                return None          # dictionary/index page: ineligible
            parts.append(raw[off:off + h.num_values * width])
            got += h.num_values
            pos = data_pos + h.compressed_size
    except (IndexError, struct.error):
        return None
    out = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    if got != num_values or len(out) != num_values * width:
        return None
    return out


def _device_columns(scan, path: str, device):
    """[(raw bytes on the device as the column's dtype)] for every
    requested column of the file, or None when one does not qualify."""
    footer = read_footer(path)
    schema = scan.output_schema()
    plan = []
    for f in schema.fields:
        col = footer.columns.get(f.name)
        j = footer.chunk_index.get(f.name)
        if f.dtype.name not in _DD_TYPES or col is None or j is None:
            return None
        chunks = []
        for rg in footer.meta.row_groups:
            cm = rg.columns[j]
            dt = chunk_eligible(cm)
            if dt is None or dt != f.dtype.np_dtype.newbyteorder("<"):
                return None
            chunks.append(cm)
        plan.append((f, col.max_def, chunks))
    out = []
    with open(path, "rb") as fh:
        for f, max_def, chunks in plan:
            parts = []
            for cm in chunks:
                fh.seek(cm.chunk_offset)
                raw = np.frombuffer(fh.read(cm.total_compressed_size),
                                    np.uint8)
                vals = decode_chunk_values(raw, cm.num_values,
                                           f.dtype.np_dtype, max_def)
                if vals is None:
                    return None
                parts.append(vals)
            host = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
            dev = torch.from_numpy(host).to(device)
            out.append(dev.view(torch_dtype(f.dtype)))
    return out


def device_decode_scan(scan, ctx):
    """The scan's batches, each eligible file through the raw path and
    the others through the standard one."""
    schema = scan.output_schema()
    batch_rows = ctx.conf.batch_size_rows
    for pid, path in enumerate(scan.paths):
        with ctx.semaphore.held():
            cols = _device_columns(scan, path, ctx.device)
        if cols is None:
            yield from scan._emit_file(ctx, scan._read_file(path), pid)
            continue
        n = int(cols[0].shape[0]) if cols else 0
        for off in range(0, max(n, 1), batch_rows):
            cnt = min(batch_rows, n - off)
            yield ColumnarBatch(
                [DeviceColumn(c[off:off + cnt],
                              torch.ones(cnt, dtype=torch.bool,
                                         device=ctx.device), f.dtype)
                 for c, f in zip(cols, schema.fields)], cnt, schema, pid)
