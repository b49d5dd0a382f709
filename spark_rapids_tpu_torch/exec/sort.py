"""Sort exec (port of ``spark_rapids_tpu/exec/sort.py``: the in-memory
global sort).

Each sort order becomes a null rank and a total-order key
(exec/encoding.py); the rows sort by them in stable passes and every
column is gathered once by the permutation. ``sort_batch_device`` takes
the place of the reference's ``_build_sort_kernel`` and
``sort_batch_device`` both: eager torch ops need no kernel to build.

The in-memory sort wraps its inputs as spillable batches and sorts
inside ``with_retry_no_split`` under the device semaphore (ref
``exec/sort.py:200-225``): the inputs come back to the device inside the
retried closure.

A dictionary string column sorts by its codes: dictionaries are sorted,
so code order is string order (``concat_batches`` keeps that across
batches). A key in byte-rectangle form waits for the strings slice, and
an input larger than ``spark.rapids.tpu.sql.batchSizeBytes`` for the
out-of-core sort of slice 8.
"""
from __future__ import annotations

from typing import Iterator, List

import torch

from ..columnar import ByteRectColumn, ColumnarBatch, DeviceColumn, HostColumn
from ..columnar.batch import concat_batches
from ..config import BATCH_SIZE_BYTES
from ..exprs.base import EvalContext
from ..exprs.compiler import batch_device, batch_dvals
from ..mem.retry import with_retry_no_split, wrap_spillables
from ..types import Schema
from .base import ExecContext, TpuExec
from .encoding import lexsort_permutation, order_key_operands

__all__ = ["TpuSortExec", "sort_batch_device"]


def sort_batch_device(orders, batch: ColumnarBatch) -> ColumnarBatch:
    """``batch`` sorted by ``orders`` (plan/logical.py SortOrder), stable,
    padding rows last."""
    ctx = EvalContext(batch.schema, batch_dvals(batch), batch.num_rows,
                      batch.padded_len, batch_device(batch))
    operands = [torch.logical_not(ctx.row_mask()).to(torch.uint8)]
    for o in orders:
        v = o.expr.eval_device(ctx)
        if v is None:
            raise NotImplementedError(
                f"sort key <{o.expr.name_hint}> is a host column: host "
                "string keys arrive with the strings slice")
        operands.extend(order_key_operands(v, o.ascending, o.nulls_first))
    perm = lexsort_permutation(operands)
    cols: List = []
    np_perm = None
    for c in batch.columns:
        if isinstance(c, ByteRectColumn):
            cols.append(c.gather(perm))
        elif isinstance(c, DeviceColumn):
            cols.append(c.with_arrays(c.data[perm], c.validity[perm]))
        else:
            if np_perm is None:
                np_perm = perm.cpu().numpy()
            cols.append(HostColumn(c.values[np_perm], c.validity[np_perm],
                                   c.dtype))
    return ColumnarBatch(cols, batch.num_rows, batch.schema)


class TpuSortExec(TpuExec):
    """Global sort: every input batch concatenated, then one sort."""

    def __init__(self, orders, child: TpuExec):
        super().__init__([child])
        self.orders = list(orders)

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        spillables = wrap_spillables(self.children[0].execute(ctx),
                                     ctx.memory)
        if not spillables:
            return

        def do_sort():
            with ctx.semaphore.held():
                big = concat_batches([sb.get() for sb in spillables])
                return sort_batch_device(self.orders, big)

        try:
            total = sum(sb.device_bytes() for sb in spillables)
            limit = int(ctx.conf.get(BATCH_SIZE_BYTES))
            if total > limit:
                raise NotImplementedError(
                    f"sort input of {total} device bytes exceeds "
                    f"spark.rapids.tpu.sql.batchSizeBytes ({limit}): the "
                    "out-of-core sort arrives with slice 8 (ROADMAP.md)")
            out = with_retry_no_split(do_sort, ctx=ctx, op="Sort")
        finally:
            for sb in spillables:
                sb.close()
        yield out

    def describe(self):
        return f"Sort[{', '.join(map(repr, self.orders))}]"
