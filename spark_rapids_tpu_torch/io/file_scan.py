"""Shared file-scan machinery (port of ``spark_rapids_tpu/io/file_scan.py``):
the reference's three reader strategies, path expansion and the path
replacement rules.

A format subclass supplies ``_read_file(path) -> [HostTable]`` (the host
read and decode, one table per row group it keeps) and the base turns
the tables into device batches of at most ``batchSizeRows`` rows:

  * PERFILE       -- the files one after another;
  * COALESCING    -- small files' row groups stitched into tables of at
                     least ``batchSizeRows`` rows before the copy;
  * MULTITHREADED -- the files read and decoded on a thread pool
                     (``spark.rapids.tpu.sql.multiThreadedRead.numThreads``)
                     feeding the device in file order.

AUTO takes MULTITHREADED for several files and PERFILE for one, as the
reference does. A file that yields no row (an empty file, every row
group pruned) yields one empty batch, as the reference's does. Batches
follow row groups (the reference follows files), so the rows come in
the same order.
"""
from __future__ import annotations

import concurrent.futures as cf
import glob as _glob
import os
import threading
from typing import Iterator, List, Optional

from ..columnar import ColumnarBatch, HostTable
from ..columnar.strrect import RECT_MAX_BYTES
from ..columnar.transfer import TRANSFER_ENCODE
from ..config import (IO_PATH_REPLACEMENT, MULTITHREADED_READ_THREADS,
                      TpuConf, register)
from ..exec.base import ExecContext, TpuExec
from ..types import Schema

__all__ = ["FileScanBase", "expand_paths", "apply_path_rules",
           "SCAN_TIMINGS"]

SCAN_TIMINGS = register(
    "spark.rapids.tpu.io.scanTimings.enabled", False,
    "Record a file scan's stage times (file read, host decode, string "
    "encode, host-to-device copy) in its exec's ``timings``; the copy is "
    "waited for batch by batch, so only a measurement turns it on.")


def apply_path_rules(conf: TpuConf, paths) -> List[str]:
    """Rewrite paths through spark.rapids.tpu.io.pathReplacementRules
    (semicolon-separated ``prefix->replacement``; the first matching rule
    applies). A rule without ``->`` is rejected."""
    rules = []
    raw = str(conf.get(IO_PATH_REPLACEMENT))
    for r in filter(None, raw.split(";")):
        prefix, sep, repl = r.partition("->")
        if not sep or not prefix:
            raise ValueError(
                f"malformed path replacement rule {r!r} "
                "(expected 'prefix->replacement')")
        rules.append((prefix, repl))
    if not rules:
        return list(paths)
    out = []
    for p in paths:
        for prefix, repl in rules:
            if p.startswith(prefix):
                p = repl + p[len(prefix):]
                break
        out.append(p)
    return out


def expand_paths(paths, suffix: str) -> List[str]:
    """Files of ``paths``: a directory gives every file below it whose name
    ends in ``suffix``, recursively; a glob its matches; a file itself."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(_glob.glob(os.path.join(p, "**", f"*{suffix}"),
                                         recursive=True)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files for {paths}")
    return out


class FileScanBase(TpuExec):
    FORMAT = "file"
    READER_TYPE_KEY = None  # ConfEntry; None -> AUTO resolution only

    def __init__(self, paths: List[str], schema: Schema,
                 columns: Optional[List[str]], conf: TpuConf,
                 predicate=None):
        super().__init__([])
        self.paths = list(paths)
        self.columns = columns
        self._schema = schema if columns is None else Schema(
            [schema[c] for c in columns])
        self.conf = conf
        self.predicate = predicate
        mode = "AUTO"
        if self.READER_TYPE_KEY is not None:
            mode = str(conf.get(self.READER_TYPE_KEY)).upper()
        if mode == "AUTO":
            mode = "MULTITHREADED" if len(self.paths) > 1 else "PERFILE"
        if mode not in ("PERFILE", "COALESCING", "MULTITHREADED"):
            raise ValueError(f"unknown {self.FORMAT} reader type {mode}")
        self.mode = mode
        #: with spark.rapids.tpu.io.scanTimings.enabled: seconds and bytes
        #: of the latest execution's stages (file read, host decode, string
        #: encode, copy), summed over threads, and [bytes, seconds] per
        #: encoding
        self.timings: Optional[dict] = None
        self._timings_lock = threading.Lock()

    def output_schema(self) -> Schema:
        return self._schema

    def set_predicate(self, pred) -> None:
        """Planner pushdown hook (skipping is conservative; the filter
        above still runs)."""
        self.predicate = pred

    def _read_file(self, path: str) -> List[HostTable]:
        raise NotImplementedError

    def _add_timings(self, part: Optional[dict]) -> None:
        if part is None or self.timings is None:
            return
        with self._timings_lock:
            for k, v in part.items():
                if isinstance(v, list):
                    r = self.timings.setdefault("rates", {}).setdefault(
                        k, [0, 0.0])
                    r[0] += v[0]
                    r[1] += v[1]
                else:
                    self.timings[k] = self.timings.get(k, 0) + v

    # ------------------------------------------------------------- modes
    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        self.timings = {} if ctx.conf.get(SCAN_TIMINGS) else None
        if self.mode == "COALESCING":
            yield from self._coalescing(ctx)
        elif self.mode == "MULTITHREADED":
            yield from self._multithreaded(ctx)
        else:
            for pid, path in enumerate(self.paths):
                yield from self._emit_file(ctx, self._read_file(path), pid)

    def _emit_file(self, ctx, tables: List[HostTable], pid: int = 0):
        """A file's batches, as partition ``pid`` (the file's place in
        the scan)."""
        if not tables:
            tables = [self._empty_table()]
        for t in tables:
            yield from self._emit(ctx, t, pid)

    def _empty_table(self) -> HostTable:
        import numpy as np
        return HostTable(
            {f.name: (np.zeros(0, f.dtype.np_dtype if f.dtype.device_backed
                               else "S1"), np.zeros(0, bool))
             for f in self._schema.fields}, self._schema)

    def _emit(self, ctx, table: HostTable, pid: int = 0):
        batch_rows = ctx.conf.batch_size_rows
        cap = int(ctx.conf.get(RECT_MAX_BYTES))
        encode = bool(ctx.conf.get(TRANSFER_ENCODE))
        n = table.num_rows
        for off in range(0, max(n, 1), batch_rows):
            part = None if self.timings is None else {"batches": 1}
            with ctx.semaphore.held():
                b = ColumnarBatch.from_host(
                    table.slice(off, batch_rows), ctx.device, cap,
                    encode=encode, timings=part)
            self._add_timings(part)
            b.partition_id = pid
            yield b

    def _coalescing(self, ctx):
        batch_rows = ctx.conf.batch_size_rows
        pending, rows, emitted = [], 0, False
        for path in self.paths:
            for t in self._read_file(path):
                pending.append(t)
                rows += t.num_rows
                if rows >= batch_rows:
                    yield from self._emit(ctx, HostTable.concat(pending))
                    pending, rows, emitted = [], 0, True
        if pending or not emitted:
            yield from self._emit(ctx, HostTable.concat(pending)
                                  if pending else self._empty_table())

    def _multithreaded(self, ctx):
        nthreads = max(int(self.conf.get(MULTITHREADED_READ_THREADS)), 1)
        with cf.ThreadPoolExecutor(max_workers=nthreads) as pool:
            futures = [pool.submit(self._read_file, p) for p in self.paths]
            try:
                for pid, fut in enumerate(futures):  # file order
                    yield from self._emit_file(ctx, fut.result(), pid)
            finally:
                for fut in futures:
                    fut.cancel()

    def describe(self):
        name = type(self).__name__.replace("Exec", "")
        return (f"{name}[{len(self.paths)} files, {self.mode}"
                + (f", pushdown={self.predicate.name_hint}" if self.predicate
                   else "") + "]")
