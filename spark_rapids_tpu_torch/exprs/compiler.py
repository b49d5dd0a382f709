"""Expression evaluation over batches (port of
``spark_rapids_tpu/exprs/compiler.py``: projection, row compaction, the
rect-chain entry and the filter over string predicates).

The reference traces an operator's expressions into one jitted XLA kernel
per shape bucket; here they run eagerly as torch ops on the batch's
device, with no kernel cache. Compaction keeps the surviving rows in
order with one index gather per column; a list column's rows move as
rows of its rectangle, a map's as rows of its two, a struct's as its
fields' rows (columnar/nested.py).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import (ByteRectColumn, ColumnarBatch, DeviceColumn,
                        DictColumn, HostColumn, ListColumn)
from ..columnar.nested import (MapColumn, StructColumn, list_column,
                               map_column, null_rows, take_rows, zero_rows)
from ..columnar.strrect import RECT_MAX_BYTES
from ..types import BOOL, STRING, Schema
from .base import (ColumnRef, DVal, EvalContext, Expression, ListVal,
                   Literal, MapVal, StrVal, StructVal)
from .comparison import EqualTo, In, in_null_rule

__all__ = ["DeviceProjector", "batch_dvals", "filter_batch_by_mask",
           "gather_batch", "dval_column", "column_dval",
           "compile_rect_chain", "DictFilterFallback", "DictFilterEvaluator",
           "build_dict_filter"]


def column_dval(c) -> Optional[DVal]:
    """A column's DVal: a StrVal for a byte rectangle, a ListVal for a
    list column, a MapVal for a map, a StructVal (its fields' columns)
    for a struct; None for a host column. A string column's DVal carries
    the column too."""
    if isinstance(c, MapColumn):
        k, v = c.keys, c.values
        return DVal(MapVal(ListVal(k.data, k.elem_valid, k.lengths),
                           ListVal(v.data, v.elem_valid, v.lengths)),
                    c.validity, c.dtype)
    if isinstance(c, StructColumn):
        return DVal(StructVal(tuple(c.children)), c.validity, c.dtype)
    if isinstance(c, ListColumn):
        return DVal(ListVal(c.data, c.elem_valid, c.lengths), c.validity,
                    c.dtype)
    if isinstance(c, ByteRectColumn):
        return DVal(StrVal(c.data, c.lengths), c.validity, STRING, c)
    if isinstance(c, DictColumn):
        return DVal(c.data, c.validity, STRING, c)
    if isinstance(c, DeviceColumn):
        return DVal(c.data, c.validity, c.dtype)
    return None


def batch_dvals(batch: ColumnarBatch) -> List:
    """Per column its DVal (``column_dval``), None for host columns."""
    return [column_dval(c) for c in batch.columns]


def dval_column(v: DVal, valid: torch.Tensor, dtype):
    """The column of a value (validity ``valid``): a list, map or struct
    value as its nested column, a string value's column (``DVal.column``)
    with its validity, else a DeviceColumn."""
    d = v.data
    if isinstance(d, ListVal):
        return list_column(*d, valid, dtype)
    if isinstance(d, MapVal):
        return map_column(d.keys.values, d.keys.elem_valid, d.values.values,
                          d.values.elem_valid, d.keys.lengths, valid, dtype)
    if isinstance(d, StructVal):
        return StructColumn(list(d.fields), valid, dtype)
    if v.column is not None:
        return null_rows(v.column, valid)
    return DeviceColumn(d, valid, dtype)


class DeviceProjector:
    """Evaluates device-supported expressions against batches of one
    input schema."""

    def __init__(self, exprs: Sequence[Expression], schema: Schema):
        self.exprs = list(exprs)
        self.schema = schema
        self.out_types = [e.data_type(schema) for e in self.exprs]

    def run(self, batch: ColumnarBatch, slots: Sequence[DVal] = (),
            task_state: Optional[dict] = None,
            use_kernel: bool = False) -> List[DeviceColumn]:
        ctx = EvalContext(self.schema, batch_dvals(batch), batch.num_rows,
                          batch.padded_len, batch_device(batch), slots,
                          batch.partition_id, task_state,
                          use_kernel=use_kernel)
        mask = ctx.row_mask()
        out = []
        for e, dt in zip(self.exprs, self.out_types):
            v = e.eval_device(ctx)
            # padding rows are always invalid
            out.append(dval_column(v, torch.logical_and(v.validity, mask),
                                   dt))
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
        if isinstance(c, DeviceColumn):
            cols.append(take_rows(c, idx))
        else:
            if np_idx is None:
                np_idx = idx.cpu().numpy()
            cols.append(HostColumn(c.values[np_idx], c.validity[np_idx],
                                   c.dtype))
    return ColumnarBatch(cols, int(idx.shape[0]), batch.schema,
                         batch.partition_id)


def gather_batch(batch: ColumnarBatch, idx: torch.Tensor,
                 schema: Optional[Schema] = None) -> ColumnarBatch:
    """The rows ``idx`` (int64, on the batch's device) of ``batch``; -1
    gives a null row: validity false, the dtype's default value, a
    dictionary code or rectangle row that is in range (a list row of
    length 0). Dictionary columns keep their dictionary."""
    n = int(idx.shape[0])
    null = idx < 0
    src_rows = batch.num_rows
    safe = idx.clamp(0, max(src_rows - 1, 0))
    np_idx = None
    cols = []
    for c in batch.columns:
        if isinstance(c, HostColumn):
            if np_idx is None:
                np_idx = idx.cpu().numpy()
            ok = np_idx >= 0
            take = np_idx.clip(0, max(src_rows - 1, 0))
            vals = c.values[take] if src_rows else \
                np.zeros(n, c.values.dtype)
            valid = (c.validity[take] if src_rows else
                     np.zeros(n, bool)) & ok
            cols.append(HostColumn(vals, valid, c.dtype))
        elif not src_rows:
            cols.append(zero_rows(c, n))
        else:
            cols.append(null_rows(take_rows(c, safe), ~null))
    return ColumnarBatch(cols, n, schema if schema is not None
                         else batch.schema)


def compile_rect_chain(expr: Expression, use_kernel: bool = False,
                       cap: int = RECT_MAX_BYTES.default):
    """(bytes, lengths, validity) -> (data, validity) for a rect chain
    over one byte-rectangle column: data is a ``StrVal`` for a STRING
    result (its transforms one ``rect_transform`` call), a tensor for a
    terminal's INT or BOOL."""
    from .string_rect import eval_rect_chain

    def fn(bytes_, lengths, validity):
        out = eval_rect_chain(expr, DVal(StrVal(bytes_, lengths), validity,
                                         STRING), use_kernel, cap)
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
        hand-written kernel when ``use_kernel``; any other LIKE or RLIKE
        through its DFA and ``rect_dfa`` (the reference's per-batch host
        fallback, on the device here)."""

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
        from .string_rect import dictionary_values
        ck = (pred.key(), id(col.dictionary))
        got = self._mask_cache.get(ck)
        if got is not None and got[0] is col.dictionary:
            return got[1]
        m = np.asarray(dictionary_values(pred, col.dictionary), dtype=bool)
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
                    form: str, use_kernel: bool, cap: int) -> DVal:
        from .collection_fns import STRINGS_REST
        from .string_rect import eval_rect_chain, rect_chain_leaf
        col = batch.columns[ordinal]
        if isinstance(col, DictColumn):
            ops = self._dict_operands(pred, form, col)
            if ops[0] == "range":
                data = torch.logical_and(col.data >= ops[1],
                                         col.data < ops[2])
            else:
                data = ops[1][col.data.clamp(0, len(ops[1]) - 1).long()]
            valid = col.validity
            if isinstance(pred, In):
                valid = in_null_rule(data, valid, pred.values)
            return DVal(data, valid, BOOL)
        if isinstance(col, ByteRectColumn) and col.ascii_only \
                and isinstance(pred, In):
            from .string_rect import eval_rect_in
            hit = eval_rect_in(pred.values, DVal(StrVal(
                col.data, col.lengths), col.validity, STRING), use_kernel)
            return DVal(hit, in_null_rule(hit, col.validity, pred.values),
                        BOOL)
        if isinstance(col, ByteRectColumn) and col.ascii_only \
                and rect_chain_leaf(pred, batch.schema) is not None:
            return eval_rect_chain(pred, DVal(StrVal(col.data, col.lengths),
                                              col.validity, STRING),
                                   use_kernel, cap)
        raise DictFilterFallback(
            f"filter <{self.cond.name_hint}> over "
            f"{batch.schema.fields[ordinal].name} ({col!r}): string "
            f"predicates over non-ASCII or over-wide strings arrive with "
            f"the strings slice: {STRINGS_REST}")

    def keep_mask(self, batch: ColumnarBatch, use_kernel: bool = False,
                  cap: int = RECT_MAX_BYTES.default) -> torch.Tensor:
        slots = [self._slot_value(batch, pred, ordinal, form, use_kernel,
                                  cap)
                 for pred, ordinal, form in self.preds]
        col = self._projector.run(batch, slots, use_kernel=use_kernel)[0]
        return torch.logical_and(col.data, col.validity)


def _string_set_match(e: Expression, schema: Schema):
    """``e`` as ``In(column, literals)`` when it is ``=`` or ``IN`` between
    a STRING column and string (or NULL) literals, else None."""
    names = schema.names()

    def string_col(c):
        return isinstance(c, ColumnRef) and c.name in names \
            and schema[c.name].dtype == STRING

    def literal(c):
        return isinstance(c, Literal) and (c.value is None
                                           or isinstance(c.value, str))
    if isinstance(e, In) and string_col(e.children[0]) and all(
            v is None or isinstance(v, str) for v in e.values):
        return e
    if isinstance(e, EqualTo):
        a, b = e.children
        if string_col(b) and literal(a):
            a, b = b, a
        if string_col(a) and literal(b):
            return In(a, (b.value,))
    return None


def build_dict_filter(cond: Expression,
                      schema: Schema) -> Optional[DictFilterEvaluator]:
    """Rewrite ``cond`` replacing literal-match predicates over STRING
    column refs (the pattern family, and ``=``/``IN`` against string
    literals, as ``In`` in the mask form) with _DictSlot placeholders; an
    evaluator when the remainder is fully device-supported, else None."""
    from .string_fns import _PatternPredicate
    from .string_rect import chain_leaf, match_form
    names = schema.names()
    preds: list = []

    def rewrite(e):
        in_form = _string_set_match(e, schema)
        if in_form is not None:
            ordinal = names.index(in_form.children[0].name)
            preds.append((in_form, ordinal, "mask"))
            return _DictSlot(len(preds) - 1, ordinal, "mask")
        if isinstance(e, _PatternPredicate):
            # over a STRING column or a chain of transforms of one
            leaf = chain_leaf(e, schema) \
                if match_form(e) is not None else None
            if leaf is None:
                return None
            ordinal = names.index(leaf)
            form = e.dict_form if isinstance(e.children[0], ColumnRef) \
                else "mask"
            preds.append((e, ordinal, form))
            return _DictSlot(len(preds) - 1, ordinal, form)
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
