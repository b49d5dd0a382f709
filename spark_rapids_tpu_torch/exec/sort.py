"""Sort exec (port of ``spark_rapids_tpu/exec/sort.py``: the in-memory
global sort, the out-of-core sample sort and the per-batch sort).

Each sort order becomes a null rank and a total-order key
(exec/encoding.py); the rows sort by them in stable passes and every
column is gathered once by the permutation. ``sort_batch_device`` takes
the place of the reference's ``_build_sort_kernel`` and
``sort_batch_device`` both, and ``sort_operands`` of its
``_build_keyenc_kernel``: eager torch ops need no kernel to build.

A global sort wraps its inputs as spillable batches. When their device
bytes are within ``spark.rapids.tpu.sql.batchSizeBytes`` it concatenates
and sorts them inside ``with_retry_no_split`` under the device semaphore
(ref ``exec/sort.py:200-225``). A larger input takes the out-of-core
sample sort (ref ``_out_of_core`` ``:231-330``), in three passes:

1. each batch is sorted into a spillable run that carries its encoded
   sort operands as trailing columns (they spill with it), and the
   operands are sampled in proportion to its rows;
2. K - 1 splitters are picked on the host from the pooled samples, in
   the operands the rows are bucketed and sorted by, widened to int64
   (``exec/sort_bucket.py:key_words``), so a boundary never splits rows
   that sort equal;
3. each run is bucketed by the ``sort_bucket`` kernel over its carried
   operands (exec/sort_bucket.py) and split by bucket
   (``shuffle/partitioning.py`` ``_split`` and ``scatter_spillables``);
   each bucket's slices are concatenated, sorted by their carried
   operands and yielded in bucket order without them, so the stream is
   globally sorted while about 1/K of the rows are resident at once.

With ``global_sort`` False (``sort_within_partitions``) each batch is
sorted alone.

A dictionary string column sorts by its codes: dictionaries are sorted,
so code order is string order within a batch (``concat_batches`` keeps
that across batches). Batches hold their own dictionaries, so before the
out-of-core sort encodes a string key it brings the key to one form
across the batches (``_string_forms``): every batch's codes into the
sorted union of their dictionaries, or where any batch holds the key as
a byte rectangle, every batch as a rectangle of the widest width. The
runs' operands then compare across runs as the strings do.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from ..columnar import (ByteRectColumn, ColumnarBatch, DeviceColumn,
                        DictColumn, HostColumn)
from ..columnar.batch import (concat_batches, dict_to_rect, pad_rect,
                              to_dictionary, union_dictionary)
from ..columnar.nested import take_rows
from ..columnar.strrect import rect_width_bucket
from ..config import BATCH_SIZE_BYTES
from ..exprs.base import ColumnRef, EvalContext
from ..exprs.compiler import batch_device, batch_dvals
from ..mem.retry import with_retry_no_split, wrap_spillables
from ..mem.spillable import SpillableBatch
from ..types import INT8, INT16, INT32, INT64, STRING, Schema, StructField
from .base import ExecContext, TpuExec
from .encoding import lexsort_permutation, order_key_operands
from .sort_bucket import key_words, sort_bucket

__all__ = ["TpuSortExec", "sort_batch_device", "sort_operands"]


def sort_operands(orders, batch: ColumnarBatch) -> List[torch.Tensor]:
    """The encoded sort operands of ``batch``'s padded rows: per order its
    null rank, then its key (the reference's ``_build_keyenc_kernel``)."""
    ctx = EvalContext(batch.schema, batch_dvals(batch), batch.num_rows,
                      batch.padded_len, batch_device(batch))
    operands: List[torch.Tensor] = []
    for o in orders:
        v = o.expr.eval_device(ctx)
        if v is None:
            raise NotImplementedError(
                f"sort key <{o.expr.name_hint}> is a host column: host "
                "string keys arrive with the strings slice")
        operands.extend(order_key_operands(v, o.ascending, o.nulls_first))
    return operands


def _permutation(batch: ColumnarBatch, ops: List[torch.Tensor]
                 ) -> torch.Tensor:
    """The stable permutation sorting ``batch``'s rows by ``ops``,
    padding rows last."""
    pad = torch.arange(batch.padded_len, device=batch_device(batch)) \
        >= batch.num_rows
    return lexsort_permutation([pad.to(torch.uint8)] + ops)


def _gather(batch: ColumnarBatch, perm: torch.Tensor, schema: Schema
            ) -> ColumnarBatch:
    """The first ``len(schema)`` columns of ``batch`` gathered by
    ``perm``."""
    cols: List = []
    np_perm = None
    for c in batch.columns[:len(schema)]:
        if isinstance(c, DeviceColumn):
            cols.append(take_rows(c, perm))
        else:
            if np_perm is None:
                np_perm = perm.cpu().numpy()
            cols.append(HostColumn(c.values[np_perm], c.validity[np_perm],
                                   c.dtype))
    return ColumnarBatch(cols, batch.num_rows, schema)


def sort_batch_device(orders, batch: ColumnarBatch,
                      with_keys: bool = False):
    """``batch`` sorted by ``orders`` (plan/logical.py SortOrder), stable,
    padding rows last. With ``with_keys``: (the sorted batch, its sort
    operands in sorted order)."""
    ops = sort_operands(orders, batch)
    perm = _permutation(batch, ops)
    out = _gather(batch, perm, batch.schema)
    if with_keys:
        return out, [op[perm] for op in ops]
    return out


#: a carried sort operand's element type -> its column type (a uint8 null
#: rank rides as int8: 0 and 1 order alike)
_OPERAND_TYPES = {torch.int8: INT8, torch.int16: INT16, torch.int32: INT32,
                  torch.int64: INT64}


def _with_operands(run: ColumnarBatch, ops: List[torch.Tensor]
                   ) -> ColumnarBatch:
    """``run`` with its sort operands appended as device columns
    (``__sort_op<k>``), so they spill and split with its rows."""
    cols, fields = list(run.columns), list(run.schema.fields)
    valid = None
    for k, op in enumerate(ops):
        if op.dtype == torch.uint8:
            op = op.view(torch.int8)
        if valid is None:
            valid = torch.ones(op.shape[0], dtype=torch.bool,
                               device=op.device)
        dt = _OPERAND_TYPES[op.dtype]
        cols.append(DeviceColumn(op, valid, dt))
        fields.append(StructField(f"__sort_op{k}", dt, False))
    return ColumnarBatch(cols, run.num_rows, Schema(fields))


class TpuSortExec(TpuExec):
    """Global sort (in memory or out of core), or with ``global_sort``
    False a sort of each batch alone."""

    #: splitter-sample rows taken per sorted run per target bucket
    OVERSAMPLE = 8
    #: most buckets of the out-of-core sort
    MAX_BUCKETS = 256

    def __init__(self, orders, child: TpuExec, global_sort: bool = True):
        super().__init__([child])
        self.orders = list(orders)
        self.global_sort = global_sort
        #: buckets of the latest out-of-core sort (0: in memory)
        self.last_buckets = 0

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        if not self.global_sort:
            for batch in self.children[0].execute(ctx):
                def sort_one(batch=batch):
                    with ctx.semaphore.held():
                        return sort_batch_device(self.orders, batch)
                yield with_retry_no_split(sort_one, ctx=ctx, op="Sort")
            return
        keys = self._string_keys()
        layouts: List[Dict[int, object]] = []

        def noted(batches):
            # each batch's string keys' layout, for the out-of-core sort
            for b in batches:
                layouts.append({i: _layout(b.columns[i]) for i in keys})
                yield b
        spillables = wrap_spillables(noted(self.children[0].execute(ctx)),
                                     ctx.memory)
        if not spillables:
            return
        total = sum(sb.device_bytes() for sb in spillables)
        limit = int(ctx.conf.get(BATCH_SIZE_BYTES))
        if total > limit:
            computed = self._computed_string_key()
            if computed is not None:
                for sb in spillables:
                    sb.close()
                raise NotImplementedError(
                    f"sort key <{computed}> is a computed string over "
                    f"{total} B, past batchSizeBytes ({limit} B): the "
                    "out-of-core sort takes string keys that are columns")
            yield from self._out_of_core(ctx, spillables, total, limit,
                                         _string_forms(layouts))
            return
        self.last_buckets = 0

        def do_sort():
            with ctx.semaphore.held():
                big = concat_batches([sb.get() for sb in spillables])
                return sort_batch_device(self.orders, big)

        try:
            out = with_retry_no_split(do_sort, ctx=ctx, op="Sort")
        finally:
            for sb in spillables:
                sb.close()
        yield out

    def _string_orders(self) -> list:
        schema = self.output_schema()
        return [o for o in self.orders if o.expr.data_type(schema) == STRING]

    def _string_keys(self) -> List[int]:
        """Ordinals of the string columns the orders sort by."""
        names = self.output_schema().names()
        return [names.index(o.expr.name) for o in self._string_orders()
                if isinstance(o.expr, ColumnRef)]

    def _computed_string_key(self):
        """The name of a string sort key that is not a column (the planner
        projects a string chain into a column of its own), or None."""
        return next((o.expr.name_hint for o in self._string_orders()
                     if not isinstance(o.expr, ColumnRef)), None)

    # ------------------------------------------------------------------
    def _out_of_core(self, ctx: ExecContext, spillables, total: int,
                     target: int, forms) -> Iterator[ColumnarBatch]:
        from ..shuffle.partitioning import (PartitionedBatches, _split,
                                            scatter_spillables)
        n_buckets = min(-(-total // max(target, 1)), self.MAX_BUCKETS)
        self.last_buckets = n_buckets
        runs, samples = self._sorted_runs(ctx, spillables, n_buckets, forms)
        if not samples:
            for r in runs:
                r.close()
            return
        splitters = self._splitters(samples, n_buckets)
        schema = self.output_schema()

        def bucket_run(run: ColumnarBatch) -> PartitionedBatches:
            ops = [c.data for c in run.columns[len(schema):]]
            pid = sort_bucket(ops, splitters.to(ops[0].device),
                              run.num_rows)
            return PartitionedBatches(*_split(run, pid, n_buckets))

        slots = scatter_spillables(ctx, runs, bucket_run, n_buckets)
        try:
            for parts in slots:
                if not parts:
                    continue

                def merge_bucket(parts=parts):
                    with ctx.semaphore.held():
                        big = concat_batches([p.get() for p in parts])
                        ops = [c.data for c in big.columns[len(schema):]]
                        return _gather(big, _permutation(big, ops), schema)
                try:
                    out = with_retry_no_split(merge_bucket, ctx=ctx,
                                              op="Sort")
                finally:
                    for p in parts:
                        p.close()
                yield out
        except BaseException:
            # a failed merge or an abandoned consumer: the later buckets'
            # slices still hold memory (close() is idempotent)
            for slot in slots:
                for p in slot:
                    p.close()
            raise

    def _sorted_runs(self, ctx: ExecContext, spillables, n_buckets: int,
                     forms):
        """Pass 1: every batch, its string keys in ``forms``, sorted into
        a spillable run carrying its operands, and the operands sampled
        (host numpy int64 [K, k]) in proportion to its rows, so a small
        run cannot skew the pooled quantiles."""
        total_rows = max(sum(sb.num_rows for sb in spillables), 1)
        budget = n_buckets * self.OVERSAMPLE * len(spillables)
        runs: List[SpillableBatch] = []
        samples: List[np.ndarray] = []
        try:
            for sb in spillables:
                def sort_one(sb=sb):
                    with ctx.semaphore.held():
                        batch = _in_forms(sb.get(), forms)
                        run, ops = sort_batch_device(self.orders, batch,
                                                     with_keys=True)
                        carried = SpillableBatch(_with_operands(run, ops),
                                                 ctx.memory)
                        n = run.num_rows
                        if n == 0:
                            return carried, None
                        k = max(min(n, -(-budget * n // total_rows)), 1)
                        idx = torch.from_numpy(np.linspace(
                            0, n - 1, num=k).astype(np.int64)).to(
                                ops[0].device)
                        samp = key_words([op[idx] for op in ops])
                        return carried, samp.cpu().numpy()
                run_sb, samp = with_retry_no_split(sort_one, ctx=ctx,
                                                   op="Sort")
                sb.close()
                runs.append(run_sb)
                if samp is not None:
                    samples.append(samp)
        except BaseException:
            # close() is idempotent: inputs already consumed are no-ops
            for x in runs + spillables:
                x.close()
            raise
        return runs, samples

    @staticmethod
    def _splitters(samples: List[np.ndarray], n_buckets: int
                   ) -> torch.Tensor:
        """Pass 2: the K - 1 splitters (int64 [operands, K - 1]) at the
        pooled samples' quantiles, ordered as the device orders the
        operands (signed, the first operand first)."""
        pooled = np.concatenate(samples, axis=1)
        order = np.lexsort(tuple(pooled[::-1]))
        m = len(order)
        # ascending, as the kernel's binary search needs (fewer samples
        # than buckets repeat the first)
        cut = [order[max(int(m * (b + 1) / n_buckets) - 1, 0)]
               for b in range(n_buckets - 1)]
        return torch.from_numpy(np.ascontiguousarray(pooled[:, cut]))

    def describe(self):
        g = "" if self.global_sort else ", local"
        return f"Sort[{', '.join(map(repr, self.orders))}{g}]"


def _layout(col) -> object:
    """A string column's layout: its dictionary, its rectangle's width,
    or None for host strings."""
    if isinstance(col, DictColumn):
        return col.dictionary
    if isinstance(col, ByteRectColumn):
        return col.width
    return None


def _string_forms(layouts: List[Dict[int, object]]) -> Dict[int, object]:
    """One form per string key column across the batches (``layouts``, a
    map a batch): the sorted union of the dictionaries when every batch
    holds the column as a dictionary, else the width of a byte rectangle
    that holds every batch's values. Host strings keep their layout (the
    sort refuses them)."""
    forms: Dict[int, object] = {}
    for i in (layouts[0] if layouts else {}):
        got = [lay[i] for lay in layouts]
        if any(g is None for g in got):
            continue
        if all(isinstance(g, np.ndarray) for g in got):
            forms[i] = union_dictionary(got)
            continue
        widths = [g if isinstance(g, int) else rect_width_bucket(
            max((len(str(x).encode("utf-8")) for x in g), default=0),
            1 << 30) for g in got]
        forms[i] = max(widths)
    return forms


def _in_forms(batch: ColumnarBatch, forms: Dict[int, object]
              ) -> ColumnarBatch:
    """``batch`` with its string key columns in ``forms``
    (``_string_forms``)."""
    if not forms:
        return batch
    cols = list(batch.columns)
    for i, form in forms.items():
        c = cols[i]
        if isinstance(form, np.ndarray):
            cols[i] = to_dictionary(c, form)
        else:
            if isinstance(c, DictColumn):
                c = dict_to_rect(c, batch.padded_len)
            cols[i] = pad_rect(c, form)
    return ColumnarBatch(cols, batch.num_rows, batch.schema)
