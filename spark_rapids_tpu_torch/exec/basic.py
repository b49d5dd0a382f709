"""Scan, range, project, filter, sample, limit, union, expand and
branch-alignment operators (port of ``spark_rapids_tpu/exec/basic.py``:
InMemoryScanExec, TpuRangeExec, TpuProjectExec, TpuFilterExec,
TpuSampleExec, LimitExec, UnionExec, TpuExpandExec, BranchAlignExec).

A projection and a filter keep a task state for the expressions that
number their rows (``rand``, ``monotonically_increasing_id``:
exprs/nondeterministic.py), made anew at the start of each execution.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import (ByteRectColumn, ColumnarBatch, DeviceColumn,
                        DictColumn, HostTable)
from ..columnar.strrect import RECT_MAX_BYTES
from ..columnar.transfer import TRANSFER_ENCODE
from ..config import register
from ..exprs.base import Alias, ColumnRef, Expression, StrVal
from ..exprs.collection_fns import STRINGS_REST
from ..exprs.compiler import (DeviceProjector, compile_rect_chain,
                              filter_batch_by_mask)
from ..types import INT64, STRING, Schema, StructField
from .base import ExecContext, TpuExec
from .rect_transform import MAX_LITERAL, MAX_WIDTH

__all__ = ["InMemoryScanExec", "TpuRangeExec", "TpuProjectExec",
           "TpuFilterExec", "TpuSampleExec", "LimitExec", "UnionExec",
           "TpuExpandExec", "BranchAlignExec", "SCAN_CACHE_MAX_BYTES",
           "range_count"]

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


def _in_partition(b: ColumnarBatch, pid: int) -> ColumnarBatch:
    """``b`` as a batch of partition ``pid`` (a cached batch is shared
    by the queries that scan its table, so it is not changed)."""
    if b.partition_id == pid:
        return b
    return ColumnarBatch(b.columns, b.num_rows, b.schema, pid)


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
        encode = bool(ctx.conf.get(TRANSFER_ENCODE))
        for pid, t in enumerate(self.tables):
            key = (self.batch_rows, names, str(ctx.device), cap)
            cached = _cache_get(t, key)
            if cached is not None:
                yield from (_in_partition(b, pid) for b in cached)
                continue
            src = t.select(names)
            built = []
            for off in range(0, max(src.num_rows, 1), self.batch_rows):
                b = ColumnarBatch.from_host(
                    src.slice(off, self.batch_rows), ctx.device, cap,
                    encode=encode)
                built.append(b)
                yield _in_partition(b, pid)
            _cache_put(t, key, built, limit)

    def describe(self):
        return f"InMemoryScan[{len(self.tables)} partitions]"


class TpuProjectExec(TpuExec):
    """Projection. Device-supported expressions evaluate as torch ops. A
    string chain over one STRING column (value-wise transforms, then an
    optional ``Length`` or literal match: exprs/string_rect.py) runs by
    the column's layout in each batch:

      * an ASCII byte rectangle: the chain's transforms as one
        ``rect_transform`` launch (a STRING result stays a byte
        rectangle), its terminal through the match kernel or the
        lengths;
      * a dictionary column: the chain over each dictionary entry once,
        on the host. A STRING result is a dictionary column over the
        transformed entries, de-duplicated and re-sorted (``upper('a') ==
        upper('A')``), the codes remapped by one gather on the device;
        an INT or BOOL result is a table of the entries' values gathered
        by code."""

    #: transformed dictionaries kept per exec (each batch of a scan has its
    #: own dictionary object)
    _DICT_CACHE_MAX = 64

    def __init__(self, exprs: Sequence[Expression], child: TpuExec):
        super().__init__([child])
        self.exprs = list(exprs)
        in_schema = child.output_schema()
        self._schema = Schema([
            StructField(e.name_hint, e.data_type(in_schema), True)
            for e in self.exprs])
        self.device_idx: List[int] = []
        self.passthrough: Dict[int, str] = {}
        #: out ordinal -> (chain, leaf column name, whether the byte
        #: rectangle path takes it); the dictionary path takes them all
        self.chains: Dict[int, tuple] = {}
        from ..exprs.string_rect import chain_leaf, rect_chain_leaf
        for i, e in enumerate(self.exprs):
            inner = e.children[0] if isinstance(e, Alias) else e
            if isinstance(inner, ColumnRef):
                self.passthrough[i] = inner.name
            elif e.fully_device_supported(in_schema) is None:
                self.device_idx.append(i)
            else:
                leaf = chain_leaf(inner, in_schema)
                if leaf is None:
                    raise NotImplementedError(
                        f"<{e.name_hint}> has no device form in the port")
                self.chains[i] = (inner, leaf, rect_chain_leaf(
                    inner, in_schema) is not None)
        self._projector: Optional[DeviceProjector] = None
        #: (out ordinal, id(dictionary)) -> (dictionary, its result)
        self._dict_cache: Dict[tuple, tuple] = {}

    def output_schema(self) -> Schema:
        return self._schema

    def _chain_eval(self, i: int, batch: ColumnarBatch, use_kernel: bool,
                    cap: int):
        expr, leaf, on_rect = self.chains[i]
        src = batch.column_by_name(leaf)
        dt = self._schema.fields[i].dtype
        if isinstance(src, DictColumn):
            return self._dict_transform(i, src) if dt == STRING \
                else self._dict_eval(i, src, dt)
        if isinstance(src, ByteRectColumn) and src.ascii_only and on_rect:
            data, valid = compile_rect_chain(expr, use_kernel, cap)(
                src.data, src.lengths, src.validity)
            if isinstance(data, StrVal):
                return ByteRectColumn(data.bytes_, valid, data.lengths,
                                      ascii_only=True)
            return DeviceColumn(data, valid, dt)
        raise NotImplementedError(
            f"<{self.exprs[i].name_hint}> over {leaf} ({src!r}): string "
            "expressions over non-ASCII strings or strings wider than "
            "spark.rapids.tpu.sql.string.rect.maxBytes, and chains the "
            f"byte-rectangle kernel does not take (a pad past its "
            f"{MAX_WIDTH}-byte rows, a literal past {MAX_LITERAL} bytes, a "
            f"trim of other characters), arrive with the strings slice: "
            f"{STRINGS_REST}")

    def _entries(self, i: int, src: DictColumn, make):
        """``make(values of the chain over the dictionary's entries)``,
        kept for this dictionary object."""
        from ..exprs.string_rect import dictionary_values
        key = (i, id(src.dictionary))
        got = self._dict_cache.get(key)
        if got is None or got[0] is not src.dictionary:
            if len(self._dict_cache) >= self._DICT_CACHE_MAX:
                self._dict_cache.clear()
            expr = self.chains[i][0]
            got = self._dict_cache[key] = (src.dictionary, make(
                dictionary_values(expr, src.dictionary)))
        return got[1]

    def _dict_eval(self, i: int, src: DictColumn, dt):
        """An INT or BOOL chain over a dictionary column: each entry's
        value once, gathered by code on the device."""
        table = self._entries(i, src, lambda v: torch.from_numpy(
            np.ascontiguousarray(v)).to(src.data.device))
        if not len(table):           # no values: every row is null
            return DeviceColumn(torch.zeros(src.padded_len, dtype=table.dtype,
                                            device=table.device),
                                src.validity, dt)
        vals = table[src.data.clamp(0, len(table) - 1).long()]
        return DeviceColumn(torch.where(src.validity, vals,
                                        torch.zeros_like(vals)),
                            src.validity, dt)

    def _dict_transform(self, i: int, src: DictColumn) -> DictColumn:
        """A STRING chain over a dictionary column: a dictionary column
        over the transformed entries, sorted and unique (the reference's
        ``_dict_transform``), the codes remapped by one gather."""
        def make(vals):
            if not len(vals):
                return np.zeros(0, object), None
            uniq, inv = np.unique(vals, return_inverse=True)
            rank = torch.from_numpy(inv.astype(np.int32).reshape(-1))
            return uniq.astype(object), rank.to(src.data.device)
        uniq, rank = self._entries(i, src, make)
        if rank is None:
            codes = torch.zeros_like(src.data)
        else:
            codes = rank[src.data.clamp(0, len(rank) - 1).long()]
        return DictColumn(codes, src.validity, STRING, uniq)

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from ..exprs.rect_match import PALLAS_ENABLED
        use_kernel = bool(ctx.conf.get(PALLAS_ENABLED))
        cap = int(ctx.conf.get(RECT_MAX_BYTES))
        child_schema = self.children[0].output_schema()
        if self._projector is None and self.device_idx:
            self._projector = DeviceProjector(
                [self.exprs[i] for i in self.device_idx], child_schema)
        task_state: dict = {}
        for batch in self.children[0].execute(ctx):
            out: List = [None] * len(self.exprs)
            for i, name in self.passthrough.items():
                out[i] = batch.column_by_name(name)
            with ctx.semaphore.held():
                if self.device_idx:
                    for i, c in zip(self.device_idx, self._projector.run(
                            batch, task_state=task_state,
                            use_kernel=use_kernel)):
                        out[i] = c
                for i in self.chains:
                    out[i] = self._chain_eval(i, batch, use_kernel, cap)
            yield ColumnarBatch(out, batch.num_rows, self._schema,
                                batch.partition_id)

    def describe(self):
        tags = []
        xf = [i for i in self.chains
              if self._schema.fields[i].dtype == STRING]
        if xf:
            tags.append("dict_transform="
                        f"{[self.exprs[i].name_hint for i in xf]}")
        rect_only = [i for i, c in self.chains.items()
                     if c[2] and i not in xf]
        if rect_only:
            tags.append("rect_device="
                        f"{[self.exprs[i].name_hint for i in rect_only]}")
        return ("Project[" + ", ".join(e.name_hint for e in self.exprs)
                + "]" + (" " + " ".join(tags) if tags else ""))


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
        cap = int(ctx.conf.get(RECT_MAX_BYTES))
        task_state: dict = {}
        for batch in self.children[0].execute(ctx):
            with ctx.semaphore.held():
                if self._dict_eval is not None:
                    keep = self._dict_eval.keep_mask(batch, use_kernel, cap)
                else:
                    col = self._projector.run(batch, task_state=task_state,
                                              use_kernel=use_kernel)[0]
                    keep = torch.logical_and(col.data, col.validity)
                out = filter_batch_by_mask(batch, keep)
            yield out

    def describe(self):
        tag = " dict_eval" if self._dict_eval is not None else ""
        return f"Filter[{self.condition.name_hint}]{tag}"


def range_count(start: int, end: int, step: int) -> int:
    """How many values ``range(start, end, step)`` holds (Spark's: the
    step's sign decides the direction; none when it points away)."""
    if step == 0:
        raise ValueError("the step of a range cannot be 0")
    if step > 0:
        return max(0, -(-(end - start) // step))
    return max(0, -(-(start - end) // -step))


class TpuRangeExec(TpuExec):
    """``range(start, end, step)`` made on the device with ``torch.arange``
    in batches of ``batch_rows`` (ref ``TpuRangeExec``): one int64 column
    ``id``; an empty range is one batch of no rows. The reference counts
    no values for a negative step; the port follows Spark (ROADMAP.md
    Queue C)."""

    def __init__(self, start: int, end: int, step: int, name: str = "id",
                 batch_rows: int = 1 << 20):
        super().__init__([])
        self.start, self.end, self.step = int(start), int(end), int(step)
        self.name = name
        self.batch_rows = max(int(batch_rows), 1)
        self._schema = Schema([StructField(name, INT64, False)])

    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        total = range_count(self.start, self.end, self.step)
        for first in range(0, max(total, 1), self.batch_rows):
            n = min(self.batch_rows, total - first)
            with ctx.semaphore.held():
                ids = torch.arange(n, dtype=torch.int64, device=ctx.device)
                data = ids * self.step + (self.start + first * self.step)
                col = DeviceColumn(data, torch.ones(n, dtype=torch.bool,
                                                    device=ctx.device),
                                   INT64)
            yield ColumnarBatch([col], n, self._schema)

    def describe(self):
        return f"Range[{self.start},{self.end},{self.step}]"


class TpuSampleExec(TpuExec):
    """A Bernoulli sample (ref ``TpuSampleExec``): a row is kept where the
    next draw of one ``numpy.random.RandomState(seed)`` stream, drawn
    across the batches in order, is below ``fraction``, so the port keeps
    the reference's rows. The draws are made on the host and copied to
    the device as one mask a batch."""

    def __init__(self, fraction: float, seed: int, child: TpuExec):
        super().__init__([child])
        self.fraction = float(fraction)
        self.seed = int(seed)

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        rng = np.random.RandomState(self.seed)
        for batch in self.children[0].execute(ctx):
            draw = rng.random_sample(batch.num_rows) < self.fraction
            mask = np.zeros(batch.padded_len, dtype=bool)
            mask[:batch.num_rows] = draw
            keep = torch.from_numpy(mask)
            if ctx.device.type == "cuda":
                keep = keep.pin_memory().to(ctx.device, non_blocking=True)
            with ctx.semaphore.held():
                out = filter_batch_by_mask(batch, keep.to(ctx.device))
            yield out

    def describe(self):
        return f"Sample[{self.fraction}, seed={self.seed}]"


class LimitExec(TpuExec):
    """The first ``n`` rows of the child (ref ``LimitExec``): it stops
    pulling batches once it has them, and cuts the last one."""

    def __init__(self, n: int, child: TpuExec):
        super().__init__([child])
        self.n = n

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        remaining = self.n
        if remaining <= 0:
            return
        for batch in self.children[0].execute(ctx):
            if batch.num_rows < remaining:
                remaining -= batch.num_rows
                yield batch
                continue
            yield batch.slice(0, remaining)
            return

    def describe(self):
        return f"Limit[{self.n}]"


class UnionExec(TpuExec):
    """UNION ALL: the children's batches, child by child."""

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        schema = self.output_schema()
        for c in self.children:
            for b in c.execute(ctx):
                # the later children's names give way to the first's
                yield ColumnarBatch(b.columns, b.num_rows, schema,
                                    b.partition_id)

    def describe(self):
        return f"Union[{len(self.children)}]"


class TpuExpandExec(TpuExec):
    """Each input row emits one row per projection list (ref
    GpuExpandExec): a batch a projection list, in list order."""

    def __init__(self, projections, names, child: TpuExec):
        super().__init__([child])
        self.projections = [list(p) for p in projections]
        self.names = list(names)
        cs = child.output_schema()
        self._schema = Schema([StructField(n, e.data_type(cs), True)
                               for n, e in zip(self.names,
                                               self.projections[0])])

    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        cs = self.children[0].output_schema()
        projectors = [DeviceProjector(p, cs) for p in self.projections]
        for batch in self.children[0].execute(ctx):
            for proj in projectors:
                with ctx.semaphore.held():
                    cols = proj.run(batch)
                yield ColumnarBatch(cols, batch.num_rows, self._schema)

    def describe(self):
        return f"Expand[{len(self.projections)} x ({', '.join(self.names)})]"


class BranchAlignExec(TpuExec):
    """The union-of-aggregates result (plan/rewrites.py): the child's rows
    are keyed by a branch id in its first column; the output is exactly
    ``n`` rows in branch order, a branch without rows holding the empty
    aggregate's values (0 where ``fill_zero``, else NULL), without the
    id. At most ``n`` rows: assembled on the host in numpy, then one
    batch on the device."""

    def __init__(self, n: int, fill_zero: Sequence[bool], child: TpuExec):
        super().__init__([child])
        self.n = n
        self.fill_zero = list(fill_zero)
        self._schema = Schema(list(child.output_schema().fields)[1:])

    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        cols = self.children[0].collect(ctx)
        bid, bid_ok = cols[0]
        rows = np.full(self.n, -1, np.int64)
        live = bid_ok & (bid >= 0) & (bid < self.n)
        rows[bid[live].astype(np.int64)] = np.flatnonzero(live)
        have = rows >= 0
        take = np.where(have, rows, 0)
        out = {}
        for f, (vals, ok), zero in zip(self._schema.fields, cols[1:],
                                       self.fill_zero):
            if len(vals):
                v, m = vals[take], ok[take] & have
            else:
                v = np.zeros(self.n, vals.dtype)
                m = np.zeros(self.n, bool)
            if zero:
                v = np.where(m, v, np.zeros((), v.dtype))
                m = np.ones(self.n, bool)
            out[f.name] = (v, m)
        yield ColumnarBatch.from_host(HostTable(out, self._schema),
                                      ctx.device,
                                      int(ctx.conf.get(RECT_MAX_BYTES)),
                                      encode=False)

    def describe(self):
        return f"BranchAlign[n={self.n}]"
