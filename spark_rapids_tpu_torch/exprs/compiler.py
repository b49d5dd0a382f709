"""Expression evaluation over batches (port of
``spark_rapids_tpu/exprs/compiler.py``: projection, row compaction, the
rect-chain entry and the filter over string predicates).

The reference traces an operator's expressions into one jitted XLA kernel
per shape bucket; here they run eagerly as torch ops on the batch's
device, with no kernel cache. Compaction keeps the surviving rows in
order with one index gather per column.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import (ByteRectColumn, ColumnarBatch, DeviceColumn,
                        DictColumn, HostColumn)
from ..types import BOOL, STRING, Schema
from .base import ColumnRef, DVal, EvalContext, Expression, StrVal

__all__ = ["DeviceProjector", "batch_dvals", "filter_batch_by_mask",
           "compile_rect_chain", "DictFilterFallback", "DictFilterEvaluator",
           "build_dict_filter"]


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

    def run(self, batch: ColumnarBatch,
            slots: Sequence[DVal] = ()) -> List[DeviceColumn]:
        ctx = EvalContext(self.schema, batch_dvals(batch), batch.num_rows,
                          batch.padded_len, batch_device(batch), slots)
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


# ---------------------------------------------------------------------------
# filter conditions holding string predicates
# ---------------------------------------------------------------------------

class _DictSlot(Expression):
    """Placeholder for a string predicate inside a filter condition: its
    value for the batch is computed before the condition runs (over the
    dictionary once, or over the byte rectangle) and read here."""

    def __init__(self, slot: int, ordinal: int, form: str):
        self.children = []
        self.slot = slot
        self.ordinal = ordinal
        self.form = form

    def data_type(self, schema):
        return BOOL

    def device_unsupported_reason(self, schema):
        return None

    def key(self):
        return f"dictslot({self.slot},{self.ordinal},{self.form})"

    def eval_device(self, ctx):
        return ctx.slots[self.slot]


class DictFilterFallback(NotImplementedError):
    """A string column of a filter condition arrives neither dictionary
    coded nor as an ASCII byte rectangle (a host column: non-ASCII or
    over-wide strings). The reference filters such a batch on the host;
    the port has no host engine."""


class DictFilterEvaluator:
    """Keep-mask evaluation for conditions mixing device expressions with
    string predicates over STRING columns. Per batch, each predicate
    becomes a device value by the column's form:

      * a dictionary column: the predicate over every dictionary entry
        once (on the host, ``string_rect.match_dictionary``), then on the
        device a code range (``dict_form == "range"``, a prefix over the
        sorted dictionary) or one lookup in the entries' mask;
      * an ASCII byte rectangle: the literal match over every row, the
        hand-written kernel when ``use_kernel`` (the reference's per-batch
        host fallback, on the device here)."""

    def __init__(self, cond: Expression, schema: Schema, rewritten,
                 preds):
        self.cond = cond
        self.rewritten = rewritten
        self.preds = preds            # [(pred, ordinal, form)]
        self._projector = DeviceProjector([rewritten], schema)
        #: (pred key, id(dictionary)) -> (dictionary, device operands);
        #: the dictionary object is kept so a recycled id() never serves
        #: another dictionary's mask
        self._mask_cache: Dict[Tuple, tuple] = {}

    def _dict_operands(self, pred, form: str, col: DictColumn):
        """("range", lo, hi) or ("mask", bool table on the device)."""
        from .string_rect import match_dictionary
        ck = (pred.key(), id(col.dictionary))
        got = self._mask_cache.get(ck)
        if got is not None and got[0] is col.dictionary:
            return got[1]
        m = np.asarray(match_dictionary(pred, col.dictionary), dtype=bool)
        idx = np.flatnonzero(m)
        if form == "range" and (not len(idx)
                                or len(idx) == idx[-1] + 1 - idx[0]):
            ops = ("range", int(idx[0]) if len(idx) else 0,
                   int(idx[-1]) + 1 if len(idx) else 0)
        else:
            # a mask form, or a dictionary whose matches are not one span
            # (not sorted): the same rows through the table
            table = np.zeros(max(len(m), 1), dtype=bool)
            table[:len(m)] = m
            ops = ("mask", torch.from_numpy(table).to(col.data.device))
        self._mask_cache[ck] = (col.dictionary, ops)
        return ops

    def _slot_value(self, batch: ColumnarBatch, pred, ordinal: int,
                    form: str, use_kernel: bool) -> DVal:
        col = batch.columns[ordinal]
        if isinstance(col, DictColumn):
            ops = self._dict_operands(pred, form, col)
            if ops[0] == "range":
                data = torch.logical_and(col.data >= ops[1],
                                         col.data < ops[2])
            else:
                data = ops[1][col.data.clamp(0, len(ops[1]) - 1).long()]
            return DVal(data, col.validity, BOOL)
        if isinstance(col, ByteRectColumn) and col.ascii_only:
            from .string_rect import eval_rect_expr
            return eval_rect_expr(pred, DVal(StrVal(col.data, col.lengths),
                                             col.validity, STRING),
                                  use_kernel)
        raise DictFilterFallback(
            f"filter <{self.cond.name_hint}> over "
            f"{batch.schema.fields[ordinal].name} ({col!r}): string "
            "predicates over non-ASCII or over-wide strings arrive with "
            "the strings slice")

    def keep_mask(self, batch: ColumnarBatch,
                  use_kernel: bool = False) -> torch.Tensor:
        slots = [self._slot_value(batch, pred, ordinal, form, use_kernel)
                 for pred, ordinal, form in self.preds]
        col = self._projector.run(batch, slots)[0]
        return torch.logical_and(col.data, col.validity)


def build_dict_filter(cond: Expression,
                      schema: Schema) -> Optional[DictFilterEvaluator]:
    """Rewrite ``cond`` replacing literal-match predicates over STRING
    column refs with _DictSlot placeholders; an evaluator when the
    remainder is fully device-supported, else None."""
    from .string_fns import _PatternPredicate
    from .string_rect import match_form
    names = schema.names()
    preds: list = []

    def rewrite(e):
        if isinstance(e, _PatternPredicate):
            child = e.children[0]
            if isinstance(child, ColumnRef) and child.name in names \
                    and schema[child.name].dtype == STRING \
                    and match_form(e) is not None:
                ordinal = names.index(child.name)
                preds.append((e, ordinal, e.dict_form))
                return _DictSlot(len(preds) - 1, ordinal, e.dict_form)
            return None
        if not e.children:
            return e
        kids = [rewrite(c) for c in e.children]
        if any(k is None for k in kids):
            return None
        if all(k is o for k, o in zip(kids, e.children)):
            return e
        clone = copy.copy(e)
        clone.children = kids
        return clone

    new = rewrite(cond)
    if new is None or not preds \
            or new.fully_device_supported(schema) is not None:
        return None
    return DictFilterEvaluator(cond, schema, new, preds)
