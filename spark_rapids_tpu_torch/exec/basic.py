"""Scan, project and filter operators (port of
``spark_rapids_tpu/exec/basic.py``: InMemoryScanExec, TpuProjectExec,
TpuFilterExec).
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from ..columnar import (ByteRectColumn, ColumnarBatch, DeviceColumn,
                        DictColumn)
from ..columnar.strrect import RECT_MAX_BYTES
from ..config import register
from ..exprs.base import Alias, ColumnRef, Expression
from ..exprs.compiler import (DeviceProjector, compile_rect_chain,
                              filter_batch_by_mask)
from ..types import Schema, StructField
from .base import ExecContext, TpuExec

__all__ = ["InMemoryScanExec", "TpuProjectExec", "TpuFilterExec",
           "SCAN_CACHE_MAX_BYTES"]

SCAN_CACHE_MAX_BYTES = register(
    "spark.rapids.tpu.sql.scanCache.maxBytes", 2 * 1024 * 1024 * 1024,
    "Device-memory budget for cached in-memory-table scan batches; "
    "least-recently-used entries evict first. 0 disables the cache.")

#: device batches of earlier scans of the same host table: a re-run skips
#: the host encode and the host->device copy. Keyed on the table's id,
#: released when the table is collected, LRU-bounded by bytes.
_SCAN_CACHE: Dict[tuple, list] = {}
_SCAN_LRU: Dict[tuple, int] = {}
_SCAN_TABLES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_TICK = [0]
#: guards the four above: queries on several threads share the cache
_SCAN_LOCK = threading.RLock()


def _cache_evict_table(tid: int) -> None:
    with _SCAN_LOCK:
        for k in [k for k in _SCAN_CACHE if k[0] == tid]:
            del _SCAN_CACHE[k]
            _SCAN_LRU.pop(k, None)


def _cache_get(table, key):
    with _SCAN_LOCK:
        if _SCAN_TABLES.get(id(table)) is not table:
            return None
        k = (id(table),) + key
        got = _SCAN_CACHE.get(k)
        if got is not None:
            _TICK[0] += 1
            _SCAN_LRU[k] = _TICK[0]
        return got


def _cache_put(table, key, batches, limit: int) -> None:
    size = sum(b.device_size_bytes() for b in batches)
    if limit <= 0 or size > limit:
        return
    with _SCAN_LOCK:
        while _SCAN_CACHE and size + sum(
                b.device_size_bytes() for bs in _SCAN_CACHE.values()
                for b in bs) > limit:
            coldest = min(_SCAN_LRU, key=_SCAN_LRU.get)
            del _SCAN_CACHE[coldest]
            del _SCAN_LRU[coldest]
        tid = id(table)
        if _SCAN_TABLES.get(tid) is not table:
            _cache_evict_table(tid)
            _SCAN_TABLES[tid] = table
            weakref.finalize(table, _cache_evict_table, tid)
        k = (tid,) + key
        _SCAN_CACHE[k] = batches
        _TICK[0] += 1
        _SCAN_LRU[k] = _TICK[0]


class InMemoryScanExec(TpuExec):
    """Scan over host tables (one per partition), cut into batches of at
    most ``batch_rows`` rows and moved to the device."""

    def __init__(self, tables, schema: Schema, batch_rows: int = 1 << 20,
                 columns=None):
        super().__init__([])
        self.tables = list(tables)
        self._schema = schema if columns is None else Schema(
            [schema[c] for c in columns])
        self.columns = list(columns) if columns is not None else None
        self.batch_rows = batch_rows

    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        names = tuple(self._schema.names())
        cap = int(ctx.conf.get(RECT_MAX_BYTES))
        limit = int(ctx.conf.get(SCAN_CACHE_MAX_BYTES))
        for t in self.tables:
            key = (self.batch_rows, names, str(ctx.device), cap)
            cached = _cache_get(t, key)
            if cached is not None:
                yield from cached
                continue
            src = t.select(names)
            built = []
            for off in range(0, max(src.num_rows, 1), self.batch_rows):
                b = ColumnarBatch.from_host(
                    src.slice(off, self.batch_rows), ctx.device, cap)
                built.append(b)
                yield b
            _cache_put(t, key, built, limit)

    def describe(self):
        return f"InMemoryScan[{len(self.tables)} partitions]"


class TpuProjectExec(TpuExec):
    """Projection. Device-supported expressions evaluate as torch ops;
    literal string predicates over a STRING column take the rect chain:
    the match kernel over an ASCII byte rectangle, or over a dictionary
    column one host match per dictionary entry, gathered by code."""

    def __init__(self, exprs: Sequence[Expression], child: TpuExec):
        super().__init__([child])
        self.exprs = list(exprs)
        in_schema = child.output_schema()
        self._schema = Schema([
            StructField(e.name_hint, e.data_type(in_schema), True)
            for e in self.exprs])
        self.device_idx: List[int] = []
        self.passthrough: Dict[int, str] = {}
        #: out ordinal -> (predicate, leaf column name)
        self.rect_chain: Dict[int, tuple] = {}
        from ..exprs.string_rect import rect_chain_leaf
        for i, e in enumerate(self.exprs):
            inner = e.children[0] if isinstance(e, Alias) else e
            if isinstance(inner, ColumnRef):
                self.passthrough[i] = inner.name
            elif e.fully_device_supported(in_schema) is None:
                self.device_idx.append(i)
            else:
                leaf = rect_chain_leaf(inner, in_schema)
                if leaf is None:
                    raise NotImplementedError(
                        f"<{e.name_hint}> has no device form in the port")
                self.rect_chain[i] = (inner, leaf)
        self._projector: Optional[DeviceProjector] = None
        #: out ordinal -> (dictionary, its match table on the device)
        self._dict_cache: Dict[int, tuple] = {}

    def output_schema(self) -> Schema:
        return self._schema

    def _rect_eval(self, i: int, src, use_kernel: bool):
        expr, leaf = self.rect_chain[i]
        dt = self._schema.fields[i].dtype
        if isinstance(src, ByteRectColumn) and src.ascii_only:
            data, valid = compile_rect_chain(expr, use_kernel)(
                src.data, src.lengths, src.validity)
            return DeviceColumn(data, valid, dt)
        if isinstance(src, DictColumn):
            return self._dict_eval(i, src, dt)
        raise NotImplementedError(
            f"<{self.exprs[i].name_hint}> over {leaf} ({src!r}): string "
            "predicates over non-ASCII or over-wide strings arrive with "
            "the strings slice")

    def _dict_eval(self, i: int, src: DictColumn, dt):
        """A low-cardinality column: the predicate over each dictionary
        entry once, on the host, then gathered by code on the device."""
        from ..exprs.string_rect import match_dictionary
        expr, _ = self.rect_chain[i]
        got = self._dict_cache.get(i)
        if got is None or got[0] is not src.dictionary:
            table = torch.from_numpy(match_dictionary(expr, src.dictionary))
            got = self._dict_cache[i] = (src.dictionary,
                                         table.to(src.data.device))
        table = got[1]
        if not len(table):           # no values: every row is null
            return DeviceColumn(torch.zeros(src.padded_len, dtype=table.dtype,
                                            device=table.device),
                                src.validity, dt)
        vals = table[src.data.clamp(0, len(table) - 1).long()]
        return DeviceColumn(torch.where(src.validity, vals,
                                        torch.zeros_like(vals)),
                            src.validity, dt)

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from ..exprs.rect_match import PALLAS_ENABLED
        use_kernel = bool(ctx.conf.get(PALLAS_ENABLED))
        child_schema = self.children[0].output_schema()
        if self._projector is None and self.device_idx:
            self._projector = DeviceProjector(
                [self.exprs[i] for i in self.device_idx], child_schema)
        for batch in self.children[0].execute(ctx):
            out: List = [None] * len(self.exprs)
            for i, name in self.passthrough.items():
                out[i] = batch.column_by_name(name)
            with ctx.semaphore.held():
                if self.device_idx:
                    for i, c in zip(self.device_idx,
                                    self._projector.run(batch)):
                        out[i] = c
                for i, (_, leaf) in self.rect_chain.items():
                    out[i] = self._rect_eval(i, batch.column_by_name(leaf),
                                             use_kernel)
            yield ColumnarBatch(out, batch.num_rows, self._schema)

    def describe(self):
        tag = ""
        if self.rect_chain:
            tag = (" rect_device="
                   f"{[self.exprs[i].name_hint for i in self.rect_chain]}")
        return ("Project[" + ", ".join(e.name_hint for e in self.exprs)
                + "]" + tag)


class TpuFilterExec(TpuExec):
    """Device filter: keep-mask from the condition, then compaction. A
    condition holding string predicates over STRING columns runs through
    the dictionary route (``compiler.DictFilterEvaluator``): each
    predicate over the column's dictionary once, or over its ASCII byte
    rectangle through the rect chain (the match kernel when
    ``spark.rapids.tpu.sql.pallas.enabled`` is on)."""

    def __init__(self, condition: Expression, child: TpuExec):
        super().__init__([child])
        self.condition = condition
        schema = child.output_schema()
        self._dict_eval = None
        self._projector: Optional[DeviceProjector] = None
        if condition.fully_device_supported(schema) is None:
            self._projector = DeviceProjector([condition], schema)
        else:
            from ..exprs.compiler import build_dict_filter
            self._dict_eval = build_dict_filter(condition, schema)
            if self._dict_eval is None:
                raise NotImplementedError(
                    f"filter <{condition.name_hint}> has no device form in "
                    "the port")

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from ..exprs.rect_match import PALLAS_ENABLED
        use_kernel = bool(ctx.conf.get(PALLAS_ENABLED))
        for batch in self.children[0].execute(ctx):
            with ctx.semaphore.held():
                if self._dict_eval is not None:
                    keep = self._dict_eval.keep_mask(batch, use_kernel)
                else:
                    col = self._projector.run(batch)[0]
                    keep = torch.logical_and(col.data, col.validity)
                out = filter_batch_by_mask(batch, keep)
            yield out

    def describe(self):
        tag = " dict_eval" if self._dict_eval is not None else ""
        return f"Filter[{self.condition.name_hint}]{tag}"
