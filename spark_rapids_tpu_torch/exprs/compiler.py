"""Expression evaluation over batches (port of
``spark_rapids_tpu/exprs/compiler.py``: projection, row compaction and
the rect-chain entry).

The reference traces an operator's expressions into one jitted XLA kernel
per shape bucket; here they run eagerly as torch ops on the batch's
device, with no kernel cache. Compaction keeps the surviving rows in
order with one index gather per column.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..columnar import ByteRectColumn, ColumnarBatch, DeviceColumn, HostColumn
from ..types import STRING, Schema
from .base import DVal, EvalContext, Expression, StrVal

__all__ = ["DeviceProjector", "batch_dvals", "filter_batch_by_mask",
           "compile_rect_chain"]


def batch_dvals(batch: ColumnarBatch) -> List:
    """Per column a DVal (a StrVal for a byte rectangle), None for host
    columns."""
    out = []
    for c in batch.columns:
        if isinstance(c, ByteRectColumn):
            out.append(DVal(StrVal(c.data, c.lengths), c.validity, STRING))
        elif isinstance(c, DeviceColumn):
            out.append(DVal(c.data, c.validity, c.dtype))
        else:
            out.append(None)
    return out


class DeviceProjector:
    """Evaluates device-supported expressions against batches of one
    input schema."""

    def __init__(self, exprs: Sequence[Expression], schema: Schema):
        self.exprs = list(exprs)
        self.schema = schema
        self.out_types = [e.data_type(schema) for e in self.exprs]

    def run(self, batch: ColumnarBatch) -> List[DeviceColumn]:
        ctx = EvalContext(self.schema, batch_dvals(batch), batch.num_rows,
                          batch.padded_len, batch_device(batch))
        mask = ctx.row_mask()
        out = []
        for e, dt in zip(self.exprs, self.out_types):
            v = e.eval_device(ctx)
            # padding rows are always invalid
            out.append(DeviceColumn(v.data, torch.logical_and(v.validity,
                                                              mask), dt))
        return out


def batch_device(batch: ColumnarBatch):
    for c in batch.columns:
        if isinstance(c, DeviceColumn):
            return c.data.device
    return torch.device("cpu")


def filter_batch_by_mask(batch: ColumnarBatch,
                         keep: torch.Tensor) -> ColumnarBatch:
    """The rows where ``keep`` (bool over padded rows, False on padding)
    holds, moved to the front in order."""
    idx = torch.nonzero(keep, as_tuple=True)[0]
    np_idx = None
    cols = []
    for c in batch.columns:
        if isinstance(c, ByteRectColumn):
            cols.append(c.gather(idx))
        elif isinstance(c, DeviceColumn):
            cols.append(c.with_arrays(c.data[idx], c.validity[idx]))
        else:
            if np_idx is None:
                np_idx = idx.cpu().numpy()
            cols.append(HostColumn(c.values[np_idx], c.validity[np_idx],
                                   c.dtype))
    return ColumnarBatch(cols, int(idx.shape[0]), batch.schema)


def compile_rect_chain(expr: Expression, use_kernel: bool = False):
    """(bytes, lengths, validity) -> (data, validity) for a rect chain
    over one byte-rectangle column."""
    from .string_rect import eval_rect_chain

    def fn(bytes_, lengths, validity):
        out = eval_rect_chain(expr, DVal(StrVal(bytes_, lengths), validity,
                                         STRING), use_kernel)
        return out.data, out.validity
    return fn
