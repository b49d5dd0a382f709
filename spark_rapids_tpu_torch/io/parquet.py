"""Parquet scan (port of ``spark_rapids_tpu/io/parquet.py``), with a
reader of the port's own in place of ``pyarrow.parquet``.

The footer, schema and statistics come from io/parquet_meta.py; each
kept row group's column chunks are read from the file and decoded on the
host by io/host_decode.py (the g++ library ``csrc/parquet_host.cpp``)
into a ``HostTable``, whose batches then take the port's ingest to the
device (columnar/batch.py). The three reader strategies are
io/file_scan.py's.

Row-group pruning (the reference's ``_filter_row_groups`` and
``_maybe_matches``, ref GpuParquetScan filterBlocks:670) drops a row
group only when its statistics prove no row can match a pushed
predicate; a column without certain statistics never excludes one.
Against the reference: it compares DATE and TIMESTAMP statistics too
(the reference's come from pyarrow as ``datetime`` objects that do not
compare with its literals, so it keeps every row group there); and it
never drops a float column's group on ``>`` or ``>=`` or a NaN literal,
since NaN is greater than every value in Spark and the statistics leave
NaN out (the reference drops such groups). Decimal statistics compare
with a decimal or integral literal exactly and with a double as their
nearest doubles (a double column's with a decimal literal as its nearest
double), as the card compares the rows.

With ``spark.rapids.tpu.io.parquet.deviceDecode.enabled`` (off by
default) a file whose every requested column qualifies takes the raw
bitcast of io/device_decode.py instead.
"""
from __future__ import annotations

import decimal
import time
from typing import Dict, List, Optional

import numpy as np

from ..columnar import HostTable
from ..config import PARQUET_READER_TYPE
from ..exprs import (And, ColumnRef, EqualTo, GreaterThan,
                     GreaterThanOrEqual, LessThan, LessThanOrEqual, Literal,
                     Or)
from ..types import DecimalType, Schema
from .file_scan import FileScanBase, apply_path_rules, expand_paths
from .host_decode import decode_chunk
from .parquet_meta import (ParquetFooter, UnsupportedType, read_footer,
                           row_group_stats)

__all__ = ["ParquetScanExec", "parquet_files", "unsupported_columns"]


def parquet_files(conf, paths) -> List[str]:
    """The files a ``read_parquet`` of ``paths`` scans: path rules
    applied, directories searched for ``*.parquet``."""
    return expand_paths(apply_path_rules(conf, paths), suffix=".parquet")


def unsupported_columns(schema: Schema) -> List[str]:
    """Why each column of ``schema`` the reader cannot give is refused."""
    return [f"column {f.name}: {f.dtype.reason}" for f in schema.fields
            if isinstance(f.dtype, UnsupportedType)]


class ParquetScanExec(FileScanBase):
    FORMAT = "parquet"
    READER_TYPE_KEY = PARQUET_READER_TYPE

    def do_execute(self, ctx):
        from .device_decode import DEVICE_DECODE_ENABLED, device_decode_scan
        if (bool(ctx.conf.get(DEVICE_DECODE_ENABLED))
                and self.mode == "PERFILE" and self.predicate is None):
            yield from device_decode_scan(self, ctx)
            return
        yield from super().do_execute(ctx)

    def _read_file(self, path: str) -> List[HostTable]:
        """The file's kept row groups as host tables, one each."""
        t0 = time.perf_counter()
        footer = read_footer(path)
        groups = self._filter_row_groups(footer)
        if groups is None:
            groups = range(len(footer.meta.row_groups))
        names = self._schema.names()
        for name in names:
            col = footer.columns.get(name)
            if col is None or col.dtype != self._schema[name].dtype:
                raise ValueError(
                    f"{path}: column {name} is "
                    f"{'missing' if col is None else col.dtype} where the "
                    f"scan's schema has {self._schema[name].dtype}")
        rates: Optional[Dict[str, list]] = \
            None if self.timings is None else {}
        read_s, nbytes, tables = time.perf_counter() - t0, 0, []
        t_dec = 0.0
        with open(path, "rb") as f:
            for g in groups:
                rg = footer.meta.row_groups[g]
                if not rg.num_rows:
                    continue
                cols = {}
                for name in names:
                    cm = rg.columns[footer.chunk_index[name]]
                    t1 = time.perf_counter()
                    f.seek(cm.chunk_offset)
                    raw = np.empty(cm.total_compressed_size, np.uint8)
                    if f.readinto(raw) != len(raw):
                        raise ValueError(f"{path}: column {name}, row group "
                                         f"{g} runs past the end of the "
                                         "file")
                    t2 = time.perf_counter()
                    cols[name] = decode_chunk(
                        raw, cm, footer.columns[name], rg.num_rows,
                        f"{path}, column {name}, row group {g}", rates)
                    t_dec += time.perf_counter() - t2
                    read_s += t2 - t1
                    nbytes += len(raw)
                tables.append(HostTable(cols, self._schema))
        self._add_timings({"read_s": read_s, "decode_s": t_dec,
                           "file_bytes": nbytes, "files": 1,
                           "row_groups_read": len(tables),
                           "row_groups": len(footer.meta.row_groups),
                           **(rates or {})})
        return tables

    def _filter_row_groups(self, footer: ParquetFooter) -> Optional[List[int]]:
        """The row groups the pushed predicate may match, from their
        statistics; None without a predicate."""
        if self.predicate is None:
            return None
        refs = sorted(set(self.predicate.references()))
        return [i for i in range(len(footer.meta.row_groups))
                if _maybe_matches(self.predicate,
                                  row_group_stats(footer, i, refs))]


_FLIP = {GreaterThan: LessThan, LessThan: GreaterThan,
         GreaterThanOrEqual: LessThanOrEqual,
         LessThanOrEqual: GreaterThanOrEqual, EqualTo: EqualTo}


def _maybe_matches(pred, stats) -> bool:
    """Conservative interval check: False only if the predicate provably
    excludes the row group. Understands And/Or and binary comparisons of
    a column with a literal."""
    if isinstance(pred, And):
        return all(_maybe_matches(c, stats) for c in pred.children)
    if isinstance(pred, Or):
        return any(_maybe_matches(c, stats) for c in pred.children)
    if type(pred) not in _FLIP:
        return True
    l, r = pred.children
    if isinstance(l, Literal) and isinstance(r, ColumnRef):
        return _maybe_matches(_FLIP[type(pred)](r, l), stats)
    if not (isinstance(l, ColumnRef) and isinstance(r, Literal)):
        return True
    if l.name not in stats or r.value is None:
        return True
    mn, mx = stats[l.name]
    v = r.value
    if isinstance(v, float) and v != v:
        return True
    if isinstance(mn, float) and isinstance(pred, (GreaterThan,
                                                   GreaterThanOrEqual)):
        # NaN is greater than every value in Spark, and the statistics
        # leave NaN out: a group may hold NaN rows above its max
        return True
    if isinstance(v, str):
        v = v.encode("utf-8")          # string statistics are UTF-8 bytes
    if isinstance(r.dtype, DecimalType):
        # a decimal literal holds its unscaled value; decimal statistics
        # are Decimals, which compare exactly with ints
        v = decimal.Decimal(v).scaleb(-r.dtype.scale)
    if isinstance(mn, decimal.Decimal) and isinstance(v, float):
        # the card compares a decimal with a double as its nearest double
        # (Spark's cast); float(Decimal) is correctly rounded, as Java's
        # doubleValue is
        mn, mx = float(mn), float(mx)
    elif isinstance(mn, float) and isinstance(v, decimal.Decimal):
        v = float(v)
    try:
        if isinstance(pred, EqualTo):
            return mn <= v <= mx
        if isinstance(pred, GreaterThan):
            return mx > v
        if isinstance(pred, GreaterThanOrEqual):
            return mx >= v
        if isinstance(pred, LessThan):
            return mn < v
        return mn <= v
    except TypeError:
        return True
