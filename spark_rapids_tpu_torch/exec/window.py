"""Window exec (port of ``spark_rapids_tpu/exec/window.py``:
``TpuWindowExec`` with ``_build_window_kernel`` ``:61``,
``_windowed_agg`` ``:209`` and ``_bounded_minmax`` ``:559``).

The spilled input batches are concatenated into one batch (a window
needs whole partitions, as in the reference) inside
``with_retry_no_split`` under the device semaphore. The window
expressions that share a ``WindowSpec``'s partition and order keys share
one stable sort by (partition operands, order operands)
(exec/encoding.py; padding rows are dropped first, so none sorts into a
partition). On the sorted rows the partition runs and the peer runs
(rows with equal order keys) are found by comparing neighbours, and
every function is computed in sorted order, then scattered back to the
input's row order:

  row_number, rank, dense_rank, percent_rank, ntile
      positions within the partition and its peer runs (ntile by Spark's
      rule: the first ``rows % n`` buckets take one row more);
  lag, lead
      the row ``offset`` away, NULL outside the partition, where the
      default (if any) is taken; a NULL value stays NULL;
  nth_value, sum, count, count(*), avg, min, max over a frame:

    ======================================  ===========================
    frame                                   computed as
    ======================================  ===========================
    whole partition (no ORDER BY, or        the forward scan read at the
    UNBOUNDED both ways)                    partition's end
    UNBOUNDED PRECEDING .. h                the forward scan at
                                            min(end, i + h)
    l .. UNBOUNDED FOLLOWING                the reverse scan at
                                            max(start, i + l)
    l .. h, both finite                     the ``window_frame`` kernel
                                            (exec/window_frame.py)
    none, with ORDER BY                     Spark's RANGE UNBOUNDED
                                            PRECEDING .. CURRENT ROW: the
                                            forward scan read at the end
                                            of the row's peer run
    ======================================  ===========================

The scans are ``columnar/segmented.py:SegmentScan``, restarting at each
partition. Two places where the reference departs from Spark are
followed as Spark has them (ROADMAP.md Queue C): no frame result is a
difference of two prefix sums over the table (the reference's is, so one
+inf turns every later frame NaN), and a window with ORDER BY and no
frame takes Spark's RANGE default, under which peers share one value
(the reference takes ROWS, ``window.py:228``). A RANGE frame is taken in
the two forms that need no offset arithmetic (UNBOUNDED PRECEDING ..
CURRENT ROW and UNBOUNDED both ways); others raise at planning. Spark's
NaN and NULL rules hold: sums skip NULLs and carry NaN and +-inf, a frame
with no valid value is NULL, a count never is, max is NaN when the frame
holds one and min only when it holds nothing else.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from ..columnar import ColumnarBatch, DeviceColumn
from ..columnar.batch import concat_batches
from ..columnar.segmented import SegmentScan, _float_from_key, _float_key
from ..exprs.aggregates import (AggregateExpression, Average, Count,
                                CountStar, Max, Min, Sum)
from ..exprs.base import DVal, EvalContext, StrVal
from ..exprs.compiler import batch_device, batch_dvals
from ..exprs.window_fns import (DenseRank, Lag, NthValue, NTile,
                                PercentRank, Rank, RowNumber)
from ..mem.retry import with_retry_no_split, wrap_spillables
from ..types import DecimalType, Schema, StructField, torch_dtype
from .base import ExecContext, TpuExec
from .encoding import (grouping_operands, lexsort_permutation,
                       order_key_operands)
from .window_frame import window_frame

__all__ = ["TpuWindowExec", "resolve_frame", "frame_reason"]

#: the slice that brings what the port still refuses here
_LATER = "a later windows slice (ROADMAP.md Queue A, slice 8's rest)"
_AGGS = (Sum, Count, CountStar, Average, Min, Max)


def resolve_frame(spec) -> Tuple[str, Optional[int], Optional[int]]:
    """The frame a window expression reads: ("rows", lo, hi) with None
    for unbounded, ("peers", None, 0) for Spark's RANGE UNBOUNDED
    PRECEDING .. CURRENT ROW (the default with ORDER BY)."""
    frame = spec.frame
    if frame is None:
        return ("peers", None, 0) if spec.order_by else ("rows", None, None)
    kind, lo, hi = frame
    if kind == "range":
        if lo is None and hi is None:
            return ("rows", None, None)
        if lo is None and hi == 0:
            return ("peers", None, 0)
    return kind, lo, hi


def frame_reason(fn, spec, schema: Schema) -> Optional[str]:
    """Why the port cannot compute ``fn`` over ``spec``'s frame over
    ``schema``, or None. A decimal window value is refused: the reference
    takes it through float64 (spark_rapids_tpu/exec/window.py:940-951);
    Spark keeps it a decimal."""
    child = getattr(fn, "child", None)
    if child is not None and isinstance(child.data_type(schema),
                                        DecimalType):
        return (f"a decimal window value ({child.data_type(schema).name}) "
                f"arrives with {_LATER}")
    kind, lo, hi = resolve_frame(spec)
    if kind not in ("rows", "peers"):
        return (f"RANGE frame ({lo}, {hi}) with offsets arrives with "
                f"{_LATER}")
    if isinstance(fn, AggregateExpression) and not isinstance(fn, _AGGS):
        return (f"{type(fn).__name__} over a window arrives with {_LATER}")
    return None


class _Sorted:
    """One spec's sort of the batch: the permutation, and per sorted row
    its partition's first and last row and its peer run's."""

    def __init__(self, spec, ectx: EvalContext, n: int, dev):
        part: List[torch.Tensor] = []
        for pk in spec.partition_by:
            part.extend(grouping_operands(_device_value(pk, ectx)))
        order: List[torch.Tensor] = []
        for o in spec.order_by:
            order.extend(order_key_operands(_device_value(o.expr, ectx),
                                            o.ascending, o.nulls_first))
        self.n = n
        self.idx = torch.arange(n, device=dev)
        self.perm = lexsort_permutation(part + order) if part + order \
            else self.idx
        self._order = order
        self.pflags = _run_starts([op[self.perm] for op in part], n, dev)
        self.start, self.end = _run_bounds(self.pflags, self.idx)
        self._peers = None
        self._scans = {}

    @property
    def peers(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(peer run start flags, each row's run start, its run end)."""
        if self._peers is None:
            f = _run_starts([op[self.perm] for op in self._order], self.n,
                            self.idx.device)
            f = torch.logical_or(f, self.pflags)
            self._peers = (f,) + _run_bounds(f, self.idx)
        return self._peers

    def scan(self, reverse: bool) -> SegmentScan:
        if reverse not in self._scans:
            ends = torch.ones_like(self.pflags)
            ends[:-1] = self.pflags[1:]
            self._scans[reverse] = SegmentScan(ends if reverse
                                               else self.pflags, reverse)
        return self._scans[reverse]

    def sorted(self, v: DVal) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(v.data, StrVal):
            raise NotImplementedError(
                f"a window value over a string byte rectangle arrives with "
                f"{_LATER}")
        return v.data[self.perm], v.validity[self.perm]

    def unsort(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        out[self.perm] = x
        return out


def _device_value(e, ectx: EvalContext) -> DVal:
    v = e.eval_device(ectx)
    if v is None:
        raise NotImplementedError(
            f"window key or value <{e.name_hint}> is a host column: host "
            f"strings in windows arrive with {_LATER}")
    return v


def _run_starts(ops: List[torch.Tensor], n: int, dev) -> torch.Tensor:
    """bool per sorted row: the first row of a run of equal ``ops``."""
    f = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        f[0] = True
    for op in ops:
        f[1:] |= op[1:] != op[:-1]
    return f


def _run_bounds(flags: torch.Tensor, idx: torch.Tensor):
    """Each row's run's first and last row: the runs' first rows, read
    through each row's run number (a prefix count of the flags; a
    running maximum of row numbers, ``cummax``, took 17.6 ms over 6 M
    rows on an NVIDIA H100 80GB HBM3 at 700 W)."""
    n = idx.shape[0]
    if not n:
        return idx, idx
    run = torch.cumsum(flags, 0) - 1
    first = torch.nonzero(flags, as_tuple=True)[0]
    last = torch.cat([first[1:] - 1, first.new_full((1,), n - 1)])
    return first[run], last[run]


class TpuWindowExec(TpuExec):
    def __init__(self, window_exprs, child: TpuExec):
        super().__init__([child])
        self.window_exprs = list(window_exprs)
        cs = child.output_schema()
        fields = list(cs.fields)
        for e, spec, name in self.window_exprs:
            fields.append(StructField(name, e.data_type(cs), True))
        self._schema = Schema(fields)

    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        spill = wrap_spillables(self.children[0].execute(ctx), ctx.memory)
        if not spill:
            return

        def run():
            with ctx.semaphore.held():
                return self._compute(concat_batches([s.get()
                                                     for s in spill]))

        try:
            out = with_retry_no_split(run, ctx=ctx, op="Window")
        finally:
            for s in spill:
                s.close()
        yield out

    def _compute(self, batch: ColumnarBatch) -> ColumnarBatch:
        n = batch.num_rows
        if batch.padded_len != n:
            batch = batch.slice(0, n)
        cs = self.children[0].output_schema()
        dev = batch_device(batch)
        ectx = EvalContext(cs, batch_dvals(batch), n, n, dev)
        groups = {}
        for k, (fn, spec, name) in enumerate(self.window_exprs):
            groups.setdefault(spec.key(), []).append(k)
        results: List = [None] * len(self.window_exprs)
        for ks in groups.values():
            geo = _Sorted(self.window_exprs[ks[0]][1], ectx, n, dev)
            for k in ks:
                fn, spec, name = self.window_exprs[k]
                d, v = _compute_one(fn, spec, geo, ectx)
                results[k] = (geo.unsort(d), geo.unsort(v))
            del geo
        cols = list(batch.columns)
        for (fn, spec, name), (d, v) in zip(self.window_exprs, results):
            dt = fn.data_type(cs)
            cols.append(DeviceColumn(d.to(torch_dtype(dt)), v, dt))
        return ColumnarBatch(cols, n, self._schema)

    def describe(self):
        return "Window[" + ", ".join(n for _, _, n in self.window_exprs) \
            + "]"


def _compute_one(fn, spec, geo: _Sorted, ectx: EvalContext):
    """(data, validity) of one window expression, in sorted row order."""
    idx, start, end = geo.idx, geo.start, geo.end
    ones = torch.ones(geo.n, dtype=torch.bool, device=idx.device)
    if isinstance(fn, RowNumber):
        return (idx - start + 1).to(torch.int32), ones
    if isinstance(fn, (Rank, PercentRank)):
        rank = geo.peers[1] - start + 1
        if isinstance(fn, Rank):
            return rank.to(torch.int32), ones
        cnt = (end - start + 1).to(torch.float64)
        pr = (rank - 1).to(torch.float64) / torch.clamp(cnt - 1, min=1.0)
        return torch.where(cnt > 1, pr, torch.zeros_like(pr)), ones
    if isinstance(fn, DenseRank):
        c = torch.cumsum(geo.peers[0].to(torch.int64), 0)
        return (c - c[start] + 1).to(torch.int32), ones
    if isinstance(fn, NTile):
        return _ntile(fn.n, idx - start, end - start + 1), ones
    if isinstance(fn, Lag):
        return _shifted(fn, geo, ectx)
    if isinstance(fn, NthValue):
        return _nth_value(fn, spec, geo, ectx)
    if isinstance(fn, AggregateExpression):
        return _frame_agg(fn, spec, geo, ectx)
    raise NotImplementedError(f"{type(fn).__name__} over a window arrives "
                              f"with {_LATER}")


def _ntile(n: int, rn: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Spark's NTile: ``cnt % n`` buckets of ``cnt // n + 1`` rows first,
    then buckets of ``cnt // n`` (fewer rows than n: a bucket a row)."""
    base, rem = cnt // n, cnt % n
    big = rem * (base + 1)
    out = torch.where(rn < big, rn // torch.clamp(base + 1, min=1),
                      rem + (rn - big) // torch.clamp(base, min=1))
    return (out + 1).to(torch.int32)


def _shifted(fn: Lag, geo: _Sorted, ectx: EvalContext):
    """lag/lead: the row ``signed_offset`` back (negative: ahead) in the
    partition; outside it NULL, or the default."""
    sd, sv = geo.sorted(_device_value(fn.child, ectx))
    src = geo.idx - fn.signed_offset
    inside = (src >= geo.start) & (src <= geo.end)
    safe = src.clamp(0, max(geo.n - 1, 0))
    data = torch.where(inside, sd[safe], torch.zeros((), dtype=sd.dtype,
                                                     device=sd.device))
    valid = inside & sv[safe]
    if fn.default is not None:
        if not isinstance(fn.default, (bool, int, float)):
            raise NotImplementedError(
                f"a {type(fn.default).__name__} default of "
                f"{fn.name_hint} arrives with {_LATER}")
        dflt = torch.tensor(fn.default, device=sd.device).to(sd.dtype)
        data = torch.where(inside, data, dflt)
        valid = valid | ~inside
    return data, valid


def _frame_rows(spec, geo: _Sorted):
    """(first, last) row of each row's frame (empty where first > last),
    for a frame that is not both-ways finite ROWS."""
    kind, lo, hi = resolve_frame(spec)
    if kind == "peers":
        return geo.start, geo.peers[2]
    first = geo.start if lo is None else torch.maximum(geo.start,
                                                       geo.idx + lo)
    last = geo.end if hi is None else torch.minimum(geo.end, geo.idx + hi)
    return first, last


def _nth_value(fn: NthValue, spec, geo: _Sorted, ectx: EvalContext):
    """The value of the frame's n-th row; NULL when the frame has fewer
    rows (Spark's nth_value, not ignoring NULLs)."""
    sd, sv = geo.sorted(_device_value(fn.child, ectx))
    first, last = _frame_rows(spec, geo)
    src = first + (fn.n - 1)
    ok = src <= last
    safe = src.clamp(0, max(geo.n - 1, 0))
    data = torch.where(ok, sd[safe], torch.zeros((), dtype=sd.dtype,
                                                 device=sd.device))
    return data, ok & sv[safe]


def _agg_inputs(fn, geo: _Sorted, ectx: EvalContext):
    """(op, values, valid, how the result converts back) for one
    aggregate: values int64 or float64 in sorted order."""
    if isinstance(fn, CountStar):
        ones = torch.ones(geo.n, dtype=torch.bool, device=geo.idx.device)
        return "count", None, ones, None
    v = _device_value(fn.child, ectx)
    if isinstance(fn, Count):           # the validity alone, any layout
        return "count", None, v.validity[geo.perm], None
    sd, sv = geo.sorted(v)
    if isinstance(fn, Average):
        return "avg", sd.to(torch.float64), sv, None
    wide = torch.float64 if sd.is_floating_point() else torch.int64
    # Max subclasses Min: test it first
    op = "sum" if isinstance(fn, Sum) else \
        ("max" if isinstance(fn, Max) else "min")
    return op, sd.to(wide), sv, sd.dtype


def _frame_agg(fn, spec, geo: _Sorted, ectx: EvalContext):
    op, vals, valid, back = _agg_inputs(fn, geo, ectx)
    kind, lo, hi = resolve_frame(spec)
    if kind == "rows" and lo is not None and hi is not None:
        if vals is None:
            vals = torch.empty(geo.n, dtype=torch.int64,
                               device=geo.idx.device)
        d, v = window_frame(vals, valid, geo.pflags, lo, hi, op)
    else:
        d, v = _scanned(op, vals, valid, spec, geo)
    if op in ("min", "max") and back is not None:
        d = d.to(back)
    return d, v


def _scanned(op: str, vals, valid, spec, geo: _Sorted):
    """An aggregate over a frame with an unbounded end (or the peers'
    frame) from the forward or reverse scan, read at one row a row."""
    kind, lo, hi = resolve_frame(spec)
    first, last = _frame_rows(spec, geo)
    n = geo.n
    empty = first > last
    if kind == "rows" and lo is not None:
        at = first                 # [first, end]: the reverse scan
        scan = geo.scan(True)
    else:
        at = last                  # [start, last]: the forward scan
        scan = geo.scan(False)
    at = at.clamp(0, max(n - 1, 0))
    count = scan.scan(valid.to(torch.int64), "sum")[at]
    count = torch.where(empty, torch.zeros_like(count), count)
    ok = count > 0
    if op == "count":
        return count, torch.ones_like(ok)
    if op in ("min", "max"):
        is_f = vals.is_floating_point()
        keys = _float_key(vals) if is_f else vals
        info = torch.iinfo(torch.int64)
        neutral = info.max if op == "min" else info.min
        keys = torch.where(valid, keys, torch.full_like(keys, neutral))
        m = scan.scan(keys, op, neutral)[at]
        m = torch.where(ok, m, torch.zeros_like(m))
        out = _float_from_key(m, vals.dtype) if is_f else m
        return torch.where(ok, out, torch.zeros_like(out)), ok
    s = scan.scan(torch.where(valid, vals, torch.zeros_like(vals)),
                  "sum")[at]
    s = torch.where(ok, s, torch.zeros_like(s))
    if op == "avg":
        return s / torch.where(ok, count, torch.ones_like(count)) \
            .to(torch.float64), ok
    return s, ok
