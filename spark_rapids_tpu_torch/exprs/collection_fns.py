"""Collection expressions over device list rectangles (port of
``spark_rapids_tpu/exprs/collection_fns.py``, its device path).

A list value is a ``ListVal`` (values[P, W] -- a tensor, or the
``Slots`` of string or struct elements --, elem_valid[P, W], lengths[P],
columnar/nested.py) and every function below is ops over axis 1, masked
past each row's length (the ``slot_*`` helpers rearrange either form;
strings order by their codes or by their rank in the batch,
``slot_key``; a string literal is sought by its code or by
``rect_match``'s equals mode): ``size``, ``array_contains``, ``array_position``,
``element_at``, ``get``, ``sort_array``, ``array_min``/``array_max``,
``slice``, ``array_reverse``, ``array`` and ``sequence`` (a rectangle as
wide as its widest row, which the reference runs on its host engine).
Null semantics are Spark 3.4's with ANSI off:

  * ``size(NULL)`` is -1;
  * ``array_contains`` is three-valued (a NULL element makes a miss NULL);
  * ``element_at`` is 1-based, negative from the end, NULL out of range;
    index 0 raises (a literal 0 at planning, a column's at its batch);
  * ``sort_array`` puts NULLs first ascending and last descending;
  * elements compare as Spark's ordering does: NaN equals NaN and is the
    greatest, -0.0 equals 0.0 (``array_contains``, ``array_position``,
    ``sort_array``, ``array_min``/``array_max``), where the reference
    compares with ``==`` (ROADMAP.md Queue C).

Structs (``named_struct``/``struct``, ``get_field``) are their fields'
device columns; maps (``map``, ``map_from_arrays``, ``map_concat``,
``map_keys``, ``map_values``, ``map_entries``, ``map[key]``,
``element_at`` and ``size`` of a map) are two rectangles over one set of
lengths, keys compared as the elements are. A map built here follows
Spark's ``mapKeyDedupPolicy`` EXCEPTION, its default: a key twice in a
row raises, as does a NULL key; the reference keeps the last value
(``map``, ``map_concat``) or both (``map_from_arrays``) (ROADMAP.md Queue
C). ``map_entries`` is a list of ``struct<key, value>``.

The array functions the reference runs only on its host engine run here
on the device: ``array_join`` (of strings, over their bytes),
``array_repeat``, ``arrays_zip`` (a list of structs), ``concat`` of
arrays, ``array_distinct``, ``array_union``/``array_intersect``/
``array_except`` (NaN equal to NaN, as Spark's; the reference compares
with ``==``), ``array_remove``, ``arrays_overlap``, and ``str_to_map``
(literal delimiters, a repeated key raising). A result wider than the
rectangle raises at its batch, naming the queue. ``flatten`` waits for
lists of lists (``NESTED_REST``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..columnar.nested import (WIDTH_BUCKETS, Slots, StructColumn,
                               elem_torch_dtype, joint_keys, null_rows,
                               slot_hcat, slot_key, slot_pad, slot_pick,
                               slot_take, take_rows, too_long, width_bucket)
from ..types import (BOOL, INT32, INT64, NESTED_REST, NULLTYPE, STRING,
                     ArrayType, DataType, MapType, Schema, StructField,
                     StructType, device_column_ok, device_list_ok,
                     device_map_ok, device_struct_ok, entries_type,
                     map_parts, nested_reason)
from .base import (ColumnRef, DVal, Expression, ListVal, Literal, MapVal,
                   StructVal, Unsupported, promote_types)

__all__ = [
    "Size", "ArrayContains", "ArrayPosition", "ElementAt", "GetArrayItem",
    "SortArray", "ArrayMin", "ArrayMax", "Slice", "ArrayReverse",
    "CreateArray", "Sequence", "GetMapValue", "GetStructField",
    "duplicate_keys", "check_map_keys",
    "ArrayJoin", "ArrayRepeat", "ArraysZip", "Concat", "Flatten",
    "ArrayDistinct", "ArrayUnion", "ArrayIntersect", "ArrayExcept",
    "ArrayRemove", "ArraysOverlap", "MapKeys", "MapValues", "MapEntries",
    "MapConcat", "MapFromArrays", "StringToMap", "CreateMap",
    "CreateNamedStruct", "in_list", "element_key", "sequence_counts",
    "string_arg_reason", "string_column", "value_dval", "compact_slots",
    "distinct_keep", "STRINGS_REST",
]

#: where the string work the port does not take arrives: regex patterns,
#: casts to string, results past the byte rectangle
STRINGS_REST = "slice 7, strings, the rest (ROADMAP.md Queue A)"


def in_list(lv: ListVal) -> torch.Tensor:
    """bool[P, W]: the slots before each row's length."""
    w = lv.values.shape[1]
    return torch.arange(w, device=lv.lengths.device)[None, :] \
        < lv.lengths[:, None]


def element_key(x: torch.Tensor) -> torch.Tensor:
    """Values whose ``==`` and order are Spark's for the elements: floats
    as their total-order key (NaN equal to NaN and greatest, -0.0 equal to
    0.0), bools as int8, integers as they are."""
    from ..exec.encoding import _float_order_key
    if x.is_floating_point():
        return _float_order_key(x)
    if x.dtype == torch.bool:
        return x.to(torch.int8)
    return x


def _elem_type(dt: DataType) -> DataType:
    if isinstance(dt, ArrayType):
        return dt.element
    raise Unsupported(f"expected an array, got {dt}")


def _int_literal(e) -> Optional[int]:
    if isinstance(e, Literal) and isinstance(e.value, int) \
            and not isinstance(e.value, bool):
        return e.value
    return None


def _any_valid(mask: torch.Tensor) -> bool:
    """One host read: whether any row of ``mask`` holds."""
    return bool(mask.any().item())


def _string_literal(e) -> bool:
    return isinstance(e, Literal) and (e.value is None
                                       or isinstance(e.value, str))


def string_arg_reason(e: Expression, schema: Schema) -> Optional[str]:
    """Why a STRING argument has no device column, None when it has one:
    a string literal, a string column or struct field, a string chain
    over one (exprs/string_rect.py), or an expression giving a string
    column (``element_at`` of a list of strings, ``array_join``...)."""
    from .string_rect import chain_leaf
    if _string_literal(e) or chain_leaf(e, schema) is not None:
        return None
    if isinstance(e, ColumnRef):
        return None if e.data_type(schema) == STRING else \
            e.fully_device_supported(schema)
    return e.fully_device_supported(schema)


def _arg_reason(e: Expression, schema: Schema, what: str) -> Optional[str]:
    """Why an argument (a value, not a list) has no device form."""
    dt = e.data_type(schema)
    if dt == STRING:
        r = string_arg_reason(e, schema)
    elif dt.np_dtype is not None or dt == NULLTYPE:
        r = e.fully_device_supported(schema)
    elif isinstance(dt, StructType) and device_list_ok(ArrayType(dt)):
        r = e.fully_device_supported(schema)
    else:
        r = nested_reason(ArrayType(dt)) or f"a {dt.name} argument"
    return f"{what}: {r}" if r else None


def string_column(e: Expression, ctx):
    """A STRING expression's value as a flat device column of the batch's
    rows: a literal as a dictionary of its one value, else the column its
    value carries (``DVal.column``)."""
    from ..columnar import DictColumn
    from .compiler import dval_column
    p = ctx.padded_len
    if _string_literal(e):
        ok = e.value is not None
        return DictColumn(
            torch.zeros(p, dtype=torch.int32, device=ctx.device),
            torch.full((p,), ok, dtype=torch.bool, device=ctx.device),
            STRING, np.array([e.value] if ok else [], dtype=object))
    v = e.eval_device(ctx)
    if v is None:
        # a host string column: wider than rect.maxBytes, not
        # dictionary-shaped
        raise NotImplementedError(
            f"<{e.name_hint}>: host strings (past the byte rectangle, not "
            f"dictionary-shaped) inside nested values arrive with "
            f"{NESTED_REST}")
    if v.column is None:
        raise NotImplementedError(
            f"<{e.name_hint}>: a string with no device column arrives with "
            f"{STRINGS_REST}")
    return dval_column(v, v.validity, STRING)


def _arg_column(e: Expression, ctx, dtype: DataType):
    """An argument's value as a flat column (a string's or a struct's), or
    a tensor with its validity (a fixed-width value)."""
    from .compiler import dval_column
    if dtype == STRING:
        return string_column(e, ctx)
    v = e.eval_device(ctx)
    if isinstance(v.data, StructVal):
        return dval_column(v, v.validity, dtype)
    return v


def value_dval(value, valid: torch.Tensor, dtype: DataType) -> DVal:
    """An element taken out of a list (``slot_pick``): a tensor's DVal,
    or a flat column's (a string keeps its column)."""
    if isinstance(value, torch.Tensor):
        return DVal(value, valid, dtype)
    from .compiler import column_dval
    v = column_dval(null_rows(value, valid))
    return DVal(v.data, valid, dtype, v.column)


def _literal_eq(values: Slots, lit: str, use_kernel: bool) -> torch.Tensor:
    """bool[P, W]: the string slots equal to ``lit``: its code in the
    elements' dictionary, or ``rect_match``'s equals mode over the
    [P·W, B] byte rectangle (the hand-written kernel with
    ``use_kernel``)."""
    from ..columnar import ByteRectColumn, DictColumn
    from .rect_match import rect_match, rect_match_reference
    col = values.col
    if isinstance(col, DictColumn):
        d = col.dictionary
        i = int(np.searchsorted(d, lit)) if len(d) else 0
        if i < len(d) and d[i] == lit:
            return (col.data == i).reshape(values.shape)
        return torch.zeros(values.shape, dtype=torch.bool,
                           device=values.device)
    assert isinstance(col, ByteRectColumn)
    fn = rect_match if use_kernel else rect_match_reference
    return fn(col.data, col.lengths, lit.encode("utf-8"),
              "equals").reshape(values.shape)


def _needle_eq(ctx, lv: ListVal, value_expr):
    """(the value's validity, eq[P, W]): the live elements of ``lv`` equal
    to the value by Spark's ordering (a string literal by
    ``_literal_eq``, any other value keyed with the elements)."""
    if isinstance(lv.values, Slots) and _string_literal(value_expr):
        ok = value_expr.value is not None
        valid = torch.full((ctx.padded_len,), ok, dtype=torch.bool,
                           device=ctx.device)
        eq = _literal_eq(lv.values, value_expr.value, ctx.use_kernel) if ok \
            else torch.zeros(lv.values.shape, dtype=torch.bool,
                             device=ctx.device)
        return valid, eq & lv.elem_valid
    if isinstance(lv.values, Slots):
        col = _arg_column(value_expr, ctx, value_expr.data_type(ctx.schema))
        valid, needle = col.validity, col
    else:
        v = value_expr.eval_device(ctx)
        valid, needle = v.validity, v.data
    ka, kb = joint_keys([lv.values, needle])
    return valid, (ka == kb[:, None]) & lv.elem_valid


class _ListExpr(Expression):
    """An expression whose first child is a device list and whose other
    children are values: fixed-width ones, or strings (and structs)
    where the list's elements are."""

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        dt = self.children[0].data_type(schema)
        if not device_list_ok(dt):
            return (f"{type(self).__name__}: {dt.name} has no device "
                    f"layout; " + (nested_reason(dt)
                                   or f"it arrives with {NESTED_REST}"))
        for c in self.children[1:]:
            cdt = c.data_type(schema)
            if cdt == NULLTYPE or cdt == dt.element:
                continue
            if cdt.np_dtype is None or (self._needle and
                                        dt.element.np_dtype is None):
                return (f"{type(self).__name__}: a {cdt.name} argument "
                        f"against {dt.element.name} elements")
        return None

    #: its second child is a value sought among the elements, of their
    #: type (a number of another width is widened)
    _needle = False

    def fully_device_supported(self, schema: Schema) -> Optional[str]:
        r = self.device_unsupported_reason(schema) or \
            self.children[0].fully_device_supported(schema)
        if r:
            return r
        for c in self.children[1:]:
            r = _arg_reason(c, schema, type(self).__name__)
            if r:
                return r
        return None

    def _list(self, ctx) -> DVal:
        return self.children[0].eval_device(ctx)


class Size(_ListExpr):
    """size(array) or size(map): a NULL one's size is -1 (Spark's default
    with ANSI off)."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return INT32

    def device_unsupported_reason(self, schema):
        if device_map_ok(self.children[0].data_type(schema)):
            return None
        return super().device_unsupported_reason(schema)

    def eval_device(self, ctx):
        v = self._list(ctx)
        lv = v.data.keys if isinstance(v.data, MapVal) else v.data
        lens = lv.lengths.to(torch.int32)
        return DVal(torch.where(v.validity, lens, -1),
                    torch.ones_like(v.validity), INT32)


class ArrayContains(_ListExpr):
    _needle = True

    def __init__(self, array, value):
        self.children = [array, value]

    def data_type(self, schema):
        return BOOL

    def eval_device(self, ctx):
        arr = self._list(ctx)
        vvalid, eq = _needle_eq(ctx, arr.data, self.children[1])
        lv = arr.data
        found = eq.any(dim=1)
        has_null = torch.logical_and(in_list(lv), ~lv.elem_valid).any(dim=1)
        valid = arr.validity & vvalid & (found | ~has_null)
        return DVal(found, valid, BOOL)


class ArrayPosition(_ListExpr):
    """1-based position of the first match, 0 if absent."""

    _needle = True

    def __init__(self, array, value):
        self.children = [array, value]

    def data_type(self, schema):
        return INT64

    def eval_device(self, ctx):
        arr = self._list(ctx)
        vvalid, eq = _needle_eq(ctx, arr.data, self.children[1])
        first = eq.to(torch.int8).argmax(dim=1) + 1
        data = torch.where(eq.any(dim=1), first, 0)
        return DVal(data, arr.validity & vvalid, INT64)


def _element(lv: ListVal, idx: torch.Tensor):
    """(value[P] -- a tensor, or a flat column of strings or structs --,
    in range and valid[P]) at 0-based ``idx`` per row."""
    w = lv.values.shape[1]
    ok = (idx >= 0) & (idx < lv.lengths)
    j = idx.clamp(0, w - 1).to(torch.int64)
    rows = torch.arange(j.shape[0], device=j.device)
    return slot_pick(lv.values, rows, j), ok & lv.elem_valid[rows, j]


class _Extract(_ListExpr):
    def data_type(self, schema):
        return _elem_type(self.children[0].data_type(schema))

    def device_unsupported_reason(self, schema):
        r = super().device_unsupported_reason(schema)
        if r is None:
            idt = self.children[1].data_type(schema)
            if idt.np_dtype is None or idt.np_dtype.kind not in "iu":
                return f"{type(self).__name__}: the index must be integral"
        return r


class ElementAt(_Extract):
    """element_at(array, index): 1-based, negative from the end, NULL out
    of range; index 0 raises, as Spark's does. element_at(map, key): the
    key's value, NULL where it is absent (``GetMapValue``)."""

    def __init__(self, child, key):
        self.children = [child, key]

    def _on_map(self, schema) -> bool:
        return isinstance(self.children[0].data_type(schema), MapType)

    def data_type(self, schema):
        if self._on_map(schema):
            return self.children[0].data_type(schema).value
        return super().data_type(schema)

    def device_unsupported_reason(self, schema):
        if self._on_map(schema):
            return GetMapValue(*self.children).device_unsupported_reason(
                schema)
        if _int_literal(self.children[1]) == 0:
            raise ValueError("SQL array indices start at 1")
        return super().device_unsupported_reason(schema)

    def fully_device_supported(self, schema):
        if self._on_map(schema):
            return GetMapValue(*self.children).fully_device_supported(schema)
        return super().fully_device_supported(schema)

    def eval_device(self, ctx):
        if self._on_map(ctx.schema):
            return GetMapValue(*self.children).eval_device(ctx)
        arr = self._list(ctx)
        k = self.children[1].eval_device(ctx)
        both = arr.validity & k.validity
        if _int_literal(self.children[1]) is None and _any_valid(
                both & (k.data == 0) & ctx.row_mask()):
            raise ValueError("SQL array indices start at 1")
        kk = k.data.to(torch.int64)
        idx = torch.where(kk > 0, kk - 1, arr.data.lengths + kk)
        data, ok = _element(arr.data, idx)
        return value_dval(data, both & ok, self.data_type(ctx.schema))


class GetArrayItem(_Extract):
    """array[i]: 0-based, NULL out of range."""

    def __init__(self, array, ordinal):
        self.children = [array, ordinal]

    def eval_device(self, ctx):
        arr = self._list(ctx)
        k = self.children[1].eval_device(ctx)
        data, ok = _element(arr.data, k.data.to(torch.int64))
        return value_dval(data, arr.validity & k.validity & ok,
                          self.data_type(ctx.schema))


def _stable_sort_rows(keys):
    """The permutation [P, W] sorting each row by ``keys`` (first decides
    first), stably: one stable sort a key, last key first."""
    k0 = keys[0]
    perm = torch.arange(k0.shape[1], device=k0.device) \
        .expand(k0.shape).contiguous()
    for k in reversed(keys):
        order = torch.sort(k.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    return perm


class SortArray(_ListExpr):
    """sort_array(array, asc): NULLs first ascending, last descending;
    equal elements keep their order (Spark sorts stably by its ordering,
    NaN greatest, -0.0 equal to 0.0; strings by their bytes)."""

    def __init__(self, array, ascending=None):
        self.children = [array, ascending if ascending is not None
                         else Literal(True)]

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def device_unsupported_reason(self, schema):
        if not isinstance(self.children[1], Literal):
            return "SortArray: the ascending flag must be a literal"
        return super().device_unsupported_reason(schema)

    def key(self):
        return (f"SortArray({self.children[0].key()},"
                f"asc={self.children[1].value})")

    def eval_device(self, ctx):
        arr = self._list(ctx)
        lv = arr.data
        asc = bool(self.children[1].value)
        inside = in_list(lv)
        key = slot_key(lv.values)
        if not asc:
            key = torch.bitwise_not(key)
        # asc: NULLs, values, padding; desc: values, NULLs, padding
        null_rank, value_rank = (0, 1) if asc else (1, 0)
        rank = torch.where(inside, torch.where(lv.elem_valid, value_rank,
                                               null_rank), 2)
        key = torch.where(lv.elem_valid, key, torch.zeros_like(key))
        perm = _stable_sort_rows([rank.to(torch.int8), key])
        return DVal(ListVal(slot_take(lv.values, perm),
                            lv.elem_valid.gather(1, perm), lv.lengths),
                    arr.validity, self.data_type(ctx.schema))


class _ArrayExtreme(_ListExpr):
    """The least (or greatest) element by Spark's ordering, NULLs skipped;
    the first such element where several are equal (-0.0 and 0.0); NULL
    for a NULL, empty or all-NULL list."""

    _max = False

    def __init__(self, array):
        self.children = [array]

    def data_type(self, schema):
        return _elem_type(self.children[0].data_type(schema))

    def eval_device(self, ctx):
        arr = self._list(ctx)
        lv = arr.data
        key = slot_key(lv.values)
        info = torch.iinfo(key.dtype)
        fill = info.min if self._max else info.max
        masked = torch.where(lv.elem_valid, key, fill)
        best = masked.amax(dim=1) if self._max else masked.amin(dim=1)
        hit = lv.elem_valid & (masked == best[:, None])
        j = hit.to(torch.int8).argmax(dim=1)
        rows = torch.arange(j.shape[0], device=j.device)
        return value_dval(slot_pick(lv.values, rows, j),
                          arr.validity & lv.elem_valid.any(dim=1),
                          self.data_type(ctx.schema))


class ArrayMin(_ArrayExtreme):
    _max = False


class ArrayMax(_ArrayExtreme):
    _max = True


class Slice(_ListExpr):
    """slice(array, start, length): 1-based, a negative start counts from
    the end; start 0 or a negative length raises, as Spark's does (a
    literal's at planning, a column's at its batch)."""

    def __init__(self, array, start, length):
        self.children = [array, start, length]

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def device_unsupported_reason(self, schema):
        if _int_literal(self.children[1]) == 0:
            raise ValueError(_SLICE_START)
        ln = _int_literal(self.children[2])
        if ln is not None and ln < 0:
            raise ValueError(_SLICE_LENGTH)
        return super().device_unsupported_reason(schema)

    def eval_device(self, ctx):
        arr = self._list(ctx)
        sv = self.children[1].eval_device(ctx)
        lnv = self.children[2].eval_device(ctx)
        valid = arr.validity & sv.validity & lnv.validity
        s, ln = sv.data.to(torch.int64), lnv.data.to(torch.int64)
        live = valid & ctx.row_mask()
        if _int_literal(self.children[1]) is None and \
                _any_valid(live & (s == 0)):
            raise ValueError(_SLICE_START)
        if _int_literal(self.children[2]) is None and \
                _any_valid(live & (ln < 0)):
            raise ValueError(_SLICE_LENGTH)
        lv = arr.data
        w = lv.values.shape[1]
        lens = lv.lengths.to(torch.int64)
        start = torch.where(s > 0, s - 1, lens + s)
        neg = start < 0
        j = torch.arange(w, device=s.device)[None, :]
        src = start[:, None] + j
        take = (j < ln[:, None]) & (src < lens[:, None]) & ~neg[:, None]
        srcc = src.clamp(0, w - 1)
        out_len = torch.where(neg, 0, (lens - start).clamp(min=0)
                              .minimum(ln.clamp(min=0)))
        return DVal(ListVal(slot_take(lv.values, srcc),
                            lv.elem_valid.gather(1, srcc) & take,
                            out_len.to(torch.int32)),
                    valid, self.data_type(ctx.schema))


_SLICE_START = ("Unexpected value for start in function slice: SQL array "
                "indices start at 1")
_SLICE_LENGTH = ("Unexpected value for length in function slice: length "
                 "must be greater than or equal to 0")


class ArrayReverse(_ListExpr):
    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def eval_device(self, ctx):
        arr = self._list(ctx)
        lv = arr.data
        w = lv.values.shape[1]
        j = torch.arange(w, device=lv.lengths.device)[None, :]
        src = (lv.lengths[:, None].to(torch.int64) - 1 - j).clamp(0, w - 1)
        ok = in_list(lv)
        return DVal(ListVal(slot_take(lv.values, src),
                            lv.elem_valid.gather(1, src) & ok, lv.lengths),
                    arr.validity, self.data_type(ctx.schema))


def _common_type(schema, exprs) -> DataType:
    t = NULLTYPE
    for c in exprs:
        d = c.data_type(schema)
        if d != NULLTYPE:
            t = d if t == NULLTYPE else promote_types(t, d)
    return t


def _stacked(ctx, exprs, dt: DataType, w: int):
    """The values of ``exprs`` (one a slot) in a rectangle of ``w`` slots
    a row, padded with NULL slots: (values, validity [P, w])."""
    p = ctx.padded_len
    k = len(exprs)
    off = torch.zeros(p, dtype=torch.bool, device=ctx.device)
    if dt.np_dtype is None and dt != NULLTYPE:
        cols = [_arg_column(e, ctx, dt) for e in exprs]
        values = slot_pad(slot_hcat([Slots(c, 1) for c in cols]), w)
        ev = torch.stack([c.validity for c in cols] + [off] * (w - k), dim=1)
        return values, ev
    tdt = elem_torch_dtype(dt)
    vals = [e.eval_device(ctx) for e in exprs]
    zeros = torch.zeros(p, dtype=tdt, device=ctx.device)
    values = torch.stack([v.data.to(tdt).expand(p) for v in vals]
                         + [zeros] * (w - k), dim=1)
    ev = torch.stack([v.validity.expand(p) for v in vals] + [off] * (w - k),
                     dim=1)
    return values, ev


class CreateArray(Expression):
    """array(e1, ..., ek): never NULL itself; each element is its
    expression's value (strings and structs as their columns' slots).
    ``array()`` is an empty array of NULL-typed elements, as Spark's is."""

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self, schema):
        return ArrayType(_common_type(schema, self.children))

    def device_unsupported_reason(self, schema):
        if width_bucket(max(len(self.children), 1)) is None:
            return (f"array() of {len(self.children)} elements is wider "
                    f"than the device rectangle ({WIDTH_BUCKETS[-1]}); it "
                    f"arrives with {NESTED_REST}")
        dt = self.data_type(schema)
        if not device_list_ok(dt):
            return (f"array of {dt.element.name}: "
                    + (nested_reason(dt) or f"arrives with {NESTED_REST}"))
        return None

    def fully_device_supported(self, schema):
        r = self.device_unsupported_reason(schema)
        if r:
            return r
        for c in self.children:
            r = _arg_reason(c, schema, "CreateArray")
            if r:
                return r
        return None

    def eval_device(self, ctx):
        dt = self.data_type(ctx.schema)
        k = len(self.children)
        p = ctx.padded_len
        values, ev = _stacked(ctx, self.children, dt.element,
                              width_bucket(max(k, 1)))
        lengths = torch.full((p,), k, dtype=torch.int32, device=ctx.device)
        return DVal(ListVal(values, ev, lengths),
                    torch.ones(p, dtype=torch.bool, device=ctx.device), dt)


def sequence_counts(ctx, children):
    """(start, step, count, validity, illegal) of ``sequence(start, stop[,
    step])`` per row, int64: the default step is 1 up and -1 down; a row
    is NULL when an input is; ``illegal`` marks the live rows whose step
    cannot reach the stop (Spark raises for them)."""
    a = children[0].eval_device(ctx)
    b = children[1].eval_device(ctx)
    s0, s1 = a.data.to(torch.int64), b.data.to(torch.int64)
    valid = a.validity & b.validity
    if len(children) > 2:
        sv = children[2].eval_device(ctx)
        step = sv.data.to(torch.int64)
        valid = valid & sv.validity
    else:
        step = torch.where(s1 >= s0, 1, -1)
    bad = ((step == 0) & (s0 != s1)) | ((step > 0) & (s1 < s0)) \
        | ((step < 0) & (s1 > s0))
    live = valid & ctx.row_mask()
    safe = torch.where(step == 0, 1, step)
    count = torch.where(s0 == s1, 1, torch.div(s1 - s0, safe,
                                                 rounding_mode="floor") + 1)
    count = torch.where(live & ~bad, count, 0)
    return s0, step, count, valid, live & bad


def sequence_error(children) -> ValueError:
    return ValueError(f"Illegal sequence boundaries: "
                      f"{', '.join(c.name_hint for c in children)}")


class Sequence(Expression):
    """sequence(start, stop[, step]) over integers, default step +-1: a
    rectangle as wide as the widest row's bucket (one host read of the
    widest count and of whether a row's step cannot reach its stop).
    ``explode(sequence(...))`` does not build it: the Generate exec runs
    from the counts (exprs/generators.py)."""

    def __init__(self, start, stop, step=None):
        self.children = [start, stop] + ([step] if step is not None else [])

    def data_type(self, schema):
        return ArrayType(promote_types(self.children[0].data_type(schema),
                                       self.children[1].data_type(schema)))

    def device_unsupported_reason(self, schema):
        for c in self.children:
            dt = c.data_type(schema)
            if dt.np_dtype is None or dt.np_dtype.kind not in "iu":
                return (f"sequence over {dt.name} arrives with "
                        f"{NESTED_REST}")
        return None

    def eval_device(self, ctx):
        dt = self.data_type(ctx.schema)
        start, step, count, valid, bad = sequence_counts(ctx, self.children)
        widest, n_bad = torch.stack([count.max() if count.numel()
                                     else count.sum(),
                                     bad.sum()]).tolist()
        if n_bad:
            raise sequence_error(self.children)
        w = width_bucket(max(int(widest), 1))
        if w is None:
            raise NotImplementedError(
                f"a sequence of {widest} elements is wider than the device "
                f"rectangle ({WIDTH_BUCKETS[-1]}); it arrives with "
                f"{NESTED_REST}")
        j = torch.arange(w, device=ctx.device)[None, :]
        values = (start[:, None] + j * step[:, None]).to(elem_torch_dtype(
            dt.element))
        return DVal(ListVal(values, j < count[:, None],
                            count.to(torch.int32)), valid, dt)


# ---------------------------------------------------------------------------
# the array functions the reference runs on its host engine only
# ---------------------------------------------------------------------------

def _widest(count: torch.Tensor, live: torch.Tensor, what: str) -> int:
    """One host read: the bucket holding the longest live row's
    ``count``; past the widest, the refusal naming the queue."""
    longest = int(torch.where(live, count, 0).max().item()) \
        if count.numel() else 0
    w = width_bucket(max(longest, 1))
    if w is None:
        raise too_long(what, longest)
    return w


def compact_slots(values, ev: torch.Tensor, keep: torch.Tensor, w: int):
    """Each row's slots where ``keep`` holds, moved to its front in order,
    in a rectangle of ``w`` slots: (values, element validity, lengths)."""
    count = keep.sum(dim=1)
    perm = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    perm = perm[:, :w] if perm.shape[1] >= w else torch.nn.functional.pad(
        perm, (0, w - perm.shape[1]))
    inside = torch.arange(w, device=keep.device)[None, :] < count[:, None]
    return slot_take(values, perm), ev.gather(1, perm) & inside, \
        count.to(torch.int32)


def distinct_keep(key: torch.Tensor, inside: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """bool[P, W]: the first of each row's equal elements among its
    ``inside`` slots (``key`` as ``slot_key`` gives it), NULLs equal to
    each other."""
    null = (inside & ~valid).to(torch.int8)
    k = torch.where(inside & valid, key, torch.zeros_like(key))
    perm = _stable_sort_rows([(~inside).to(torch.int8), null, k])
    ks, ns, ins = k.gather(1, perm), null.gather(1, perm), \
        inside.gather(1, perm)
    first = ins.clone()
    first[:, 1:] &= ~((ks[:, 1:] == ks[:, :-1]) & (ns[:, 1:] == ns[:, :-1])
                      & ins[:, :-1])
    return torch.zeros_like(first).scatter_(1, perm, first)


def _rows_of(lists: List[DVal]):
    """The lists' validity (all valid) and their [P, Wi] slots side by
    side: (validity, values, element validity, inside, each one's width);
    element keys compare across the lists."""
    valid = lists[0].validity
    for v in lists[1:]:
        valid = valid & v.validity
    vals = [v.data.values for v in lists]
    if not isinstance(vals[0], Slots):
        common = vals[0].dtype
        for x in vals[1:]:
            common = torch.promote_types(common, x.dtype)
        vals = [x.to(common) for x in vals]
    hv = slot_hcat(vals)
    ev = torch.cat([v.data.elem_valid for v in lists], dim=1)
    inside = torch.cat([in_list(v.data) for v in lists], dim=1)
    return valid, hv, ev, inside, [x.shape[1] for x in vals]


class _ListsExpr(Expression):
    """A function of several lists of one element type."""

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def device_unsupported_reason(self, schema):
        types = [c.data_type(schema) for c in self.children]
        for dt in types:
            if not device_list_ok(dt):
                return (f"{type(self).__name__} over {dt.name}: "
                        + (nested_reason(dt)
                           or f"it arrives with {NESTED_REST}"))
        elems = {t.element for t in types}
        if len(elems) > 1 and not all(e.np_dtype is not None
                                      and e.np_dtype.kind in "iuf"
                                      for e in elems):
            return (f"{type(self).__name__}: lists of "
                    f"{', '.join(sorted(e.name for e in elems))} elements")
        return None

    def _result_type(self, schema) -> ArrayType:
        """The lists' element types widened to one."""
        et = _elem_type(self.children[0].data_type(schema))
        for c in self.children[1:]:
            et = promote_types(et, _elem_type(c.data_type(schema)))
        return ArrayType(et)


class ArrayJoin(Expression):
    """array_join(array<string>, delimiter[, null_replacement]): the
    elements joined by the delimiter, NULL elements skipped unless a
    replacement is given (then in their place). The delimiter and the
    replacement are literals. Over the elements' bytes on the device (a
    dictionary's decoded first): each element's place in the row from a
    scan of the lengths, one scatter a slot. A result past
    ``rect.maxBytes`` raises at its batch, naming the strings slice, as
    ``rect_transform`` does. Spark takes only ``array<string>``; the
    reference's ``str(v)`` of any element is not followed (ROADMAP.md
    Queue C): another element type needs a cast to string."""

    def __init__(self, array, delimiter, null_replacement=None):
        self.children = [array, delimiter] + (
            [null_replacement] if null_replacement is not None else [])

    def data_type(self, schema):
        return STRING

    def device_unsupported_reason(self, schema):
        dt = self.children[0].data_type(schema)
        if isinstance(dt, ArrayType) and not device_list_ok(dt):
            return f"ArrayJoin: {nested_reason(dt)}"
        if not isinstance(dt, ArrayType) or dt.element != STRING:
            return (f"ArrayJoin of {dt.name}: a cast of the elements to "
                    f"string arrives with {STRINGS_REST}")
        if not all(_string_literal(c) for c in self.children[1:]):
            return (f"ArrayJoin: a delimiter or replacement that is not a "
                    f"literal arrives with {STRINGS_REST}")
        return None

    def fully_device_supported(self, schema):
        return self.device_unsupported_reason(schema) or \
            self.children[0].fully_device_supported(schema)

    def eval_device(self, ctx):
        from ..columnar import ByteRectColumn
        from ..columnar.strrect import RECT_MAX_BYTES, rect_width_bucket
        from .compiler import column_dval
        arr = self.children[0].eval_device(ctx)
        lv = arr.data
        delim = self.children[1].value
        rep = self.children[2].value if len(self.children) > 2 else None
        p, w = lv.values.shape
        dev = ctx.device
        rect = _as_rect(lv.values.col)
        b = rect.width
        data = rect.data.reshape(p, w, b)
        blen = rect.lengths.reshape(p, w).to(torch.int64)
        inside = in_list(lv)
        ascii_only = rect.ascii_only
        if rep is not None:
            rb = rep.encode("utf-8")
            ascii_only = ascii_only and max(rb, default=0) < 0x80
            if len(rb) > b:
                data = torch.nn.functional.pad(data, (0, len(rb) - b))
                b = len(rb)
            fill = torch.zeros(b, dtype=torch.uint8, device=dev)
            fill[:len(rb)] = torch.tensor(list(rb), dtype=torch.uint8,
                                          device=dev)
            null = inside & ~lv.elem_valid
            data = torch.where(null[..., None], fill, data)
            blen = torch.where(null, len(rb), blen)
            incl = inside
        else:
            incl = inside & lv.elem_valid
        db = (delim or "").encode("utf-8")
        ascii_only = ascii_only and max(db, default=0) < 0x80
        L = len(db)
        plen = torch.where(incl, blen, 0)
        prior = torch.cumsum(incl.to(torch.int64), dim=1) - incl.to(
            torch.int64)
        start = torch.cumsum(plen, dim=1) - plen + L * prior
        total = plen.sum(dim=1) + L * (incl.sum(dim=1) - 1).clamp(min=0)
        valid = arr.validity & torch.full((p,), delim is not None,
                                          dtype=torch.bool, device=dev)
        live = valid & ctx.row_mask()
        longest = int(torch.where(live, total, 0).max().item()) if p else 0
        cap = RECT_MAX_BYTES.default
        wout = rect_width_bucket(longest, cap)
        if wout is None:
            raise NotImplementedError(
                f"array_join: a result of {longest} bytes is wider than "
                f"spark.rapids.tpu.sql.string.rect.maxBytes ({cap}); wider "
                f"strings arrive with {STRINGS_REST}")
        out = torch.zeros((p, wout + 1), dtype=torch.uint8, device=dev)
        jb = torch.arange(b, device=dev)[None, :]
        jd = torch.arange(L, device=dev)[None, :]
        dbytes = torch.tensor(list(db), dtype=torch.uint8,
                              device=dev).expand(p, L) if L else None
        for k in range(w):
            put = incl[:, k:k + 1] & (jb < plen[:, k:k + 1])
            out.scatter_(1, torch.where(put, start[:, k:k + 1] + jb, wout),
                         data[:, k])
            if L:
                dput = incl[:, k:k + 1] & (prior[:, k:k + 1] > 0)
                out.scatter_(1, torch.where(
                    dput, start[:, k:k + 1] - L + jd, wout), dbytes)
        lengths = torch.where(valid, total, 0).to(torch.int32)
        col = ByteRectColumn(
            torch.where(valid[:, None], out[:, :wout], 0), valid, lengths,
            ascii_only=ascii_only)
        v = column_dval(col)
        return DVal(v.data, valid, STRING, col)


def _as_rect(col):
    """A flat string column as a byte rectangle (a dictionary's entries
    decoded once and gathered by code)."""
    from ..columnar import DictColumn
    from ..columnar.batch import dict_to_rect
    if isinstance(col, DictColumn):
        return dict_to_rect(col, col.padded_len)
    return col


class ArrayRepeat(Expression):
    """array_repeat(element, count): ``count`` copies of the element (a
    NULL element gives NULL elements); NULL where the count is NULL,
    empty where it is not positive. One host read of the widest count,
    which past the rectangle's 256 raises, naming the queue."""

    def __init__(self, element, count):
        self.children = [element, count]

    def data_type(self, schema):
        return ArrayType(self.children[0].data_type(schema))

    def device_unsupported_reason(self, schema):
        cdt = self.children[1].data_type(schema)
        if cdt.np_dtype is None or cdt.np_dtype.kind not in "iu":
            return "ArrayRepeat: the count must be integral"
        dt = self.data_type(schema)
        if not device_list_ok(dt):
            return f"ArrayRepeat of {dt.element.name}: " + (
                nested_reason(dt) or f"arrives with {NESTED_REST}")
        return None

    def fully_device_supported(self, schema):
        return self.device_unsupported_reason(schema) or _arg_reason(
            self.children[0], schema, "ArrayRepeat") or \
            self.children[1].fully_device_supported(schema)

    def eval_device(self, ctx):
        dt = self.data_type(ctx.schema)
        c = self.children[1].eval_device(ctx)
        count = torch.where(c.validity, c.data.to(torch.int64).clamp(min=0),
                            0).expand(ctx.padded_len)
        w = _widest(count, ctx.row_mask(), "array_repeat")
        p = ctx.padded_len
        j = torch.arange(w, device=ctx.device)[None, :]
        inside = j < count[:, None]
        if dt.element.np_dtype is None and dt.element != NULLTYPE:
            col = _arg_column(self.children[0], ctx, dt.element)
            rows = torch.arange(p, device=ctx.device).repeat_interleave(w)
            values = Slots(take_rows(col, rows), w)
            ev = col.validity[:, None] & inside
        else:
            v = self.children[0].eval_device(ctx)
            values = v.data.to(elem_torch_dtype(dt.element)).expand(
                p)[:, None].expand(p, w).contiguous()
            ev = v.validity.expand(p)[:, None] & inside
        return DVal(ListVal(values, ev, count.to(torch.int32)),
                    c.validity.expand(p), dt)


class ArraysZip(Expression):
    """arrays_zip(a1, ..., ak): a list of structs, the i-th holding each
    list's i-th element, as long as the longest list, the shorter ones'
    fields NULL past their ends; NULL if any list is. Each field is its
    list's flat column (strings keep their layout), the struct elements
    never NULL."""

    def __init__(self, *arrays, names=None):
        self.children = list(arrays)
        self.names = list(names) if names else \
            [str(i) for i in range(len(arrays))]

    def data_type(self, schema):
        return ArrayType(StructType(
            StructField(n, _elem_type(c.data_type(schema)))
            for n, c in zip(self.names, self.children)))

    def device_unsupported_reason(self, schema):
        if not self.children:
            return f"an empty arrays_zip() arrives with {NESTED_REST}"
        dt = self.data_type(schema)
        if not device_list_ok(dt):
            return "ArraysZip: " + (nested_reason(dt)
                                    or f"arrives with {NESTED_REST}")
        return None

    def eval_device(self, ctx):
        from ..columnar import DeviceColumn
        dt = self.data_type(ctx.schema)
        lists = [c.eval_device(ctx) for c in self.children]
        valid = lists[0].validity
        for v in lists[1:]:
            valid = valid & v.validity
        w = max(v.data.values.shape[1] for v in lists)
        lengths = lists[0].data.lengths
        for v in lists[1:]:
            lengths = torch.maximum(lengths, v.data.lengths)
        fields = []
        for v, f in zip(lists, dt.element.fields):
            lv = v.data
            ev = torch.nn.functional.pad(lv.elem_valid,
                                         (0, w - lv.elem_valid.shape[1]))
            vals = slot_pad(lv.values, w)
            if isinstance(vals, Slots):
                fields.append(null_rows(vals.col, ev.reshape(-1)))
            else:
                fields.append(DeviceColumn(vals.reshape(-1), ev.reshape(-1),
                                           f.dtype))
        p = valid.shape[0]
        inside = torch.arange(w, device=ctx.device)[None, :] \
            < lengths[:, None]
        elems = StructColumn(fields, inside.reshape(-1), dt.element)
        return DVal(ListVal(Slots(elems, w), inside, lengths), valid, dt)


class Concat(_ListsExpr):
    """concat(a1, ..., ak) of arrays: each row's elements in order; NULL
    if any list is. One host read of the longest result."""

    def data_type(self, schema):
        return self._result_type(schema)

    def eval_device(self, ctx):
        lists = [c.eval_device(ctx) for c in self.children]
        valid, hv, ev, inside, _ = _rows_of(lists)
        w = _widest(inside.sum(dim=1), valid & ctx.row_mask(),
                    "concat")
        vals, ev, lens = compact_slots(hv, ev, inside, w)
        return DVal(ListVal(vals, ev, lens), valid,
                    self.data_type(ctx.schema))


class Flatten(Expression):
    """flatten(array<array<T>>): lists of lists have no device layout
    yet; refused at planning, naming the queue."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return _elem_type(self.children[0].data_type(schema))

    def device_unsupported_reason(self, schema):
        return (f"Flatten: a list of lists arrives with {NESTED_REST}")


class ArrayDistinct(_ListsExpr):
    """array_distinct(a): each row's elements with every repeat after the
    first dropped, a NULL kept once; equal by Spark's ordering (NaN equal
    to NaN, -0.0 to 0.0), where the reference compares with ``==``
    (ROADMAP.md Queue C)."""

    def eval_device(self, ctx):
        lst = self.children[0].eval_device(ctx)
        lv = lst.data
        inside = in_list(lv)
        keep = distinct_keep(slot_key(lv.values), inside, lv.elem_valid)
        vals, ev, lens = compact_slots(lv.values, lv.elem_valid, keep,
                                       lv.values.shape[1])
        return DVal(ListVal(vals, ev, lens), lst.validity,
                    self.data_type(ctx.schema))


def _in_other(key: torch.Tensor, valid: torch.Tensor, wa: int,
              inside: torch.Tensor) -> torch.Tensor:
    """bool[P, Wa]: each slot of the first list (its first ``wa`` of the
    side-by-side slots) equal to a slot of the second, NULL equal to
    NULL."""
    ka, kb = key[:, :wa], key[:, wa:]
    va, vb = valid[:, :wa], valid[:, wa:]
    ib = inside[:, wa:]
    same = ((ka[:, :, None] == kb[:, None, :]) & va[:, :, None]
            & vb[:, None, :]) | (~va[:, :, None] & ~vb[:, None, :])
    return (same & ib[:, None, :]).any(dim=2)


class _ArraySetOp(_ListsExpr):
    """array_union / array_intersect / array_except: NULL if either list
    is; each element once (a NULL too), in the order of its first
    occurrence; equal by Spark's ordering, NaN equal to NaN, where the
    reference compares with ``==`` (ROADMAP.md Queue C)."""

    def data_type(self, schema):
        return self._result_type(schema)

    def _keep(self, first, inside, in_b, wa):
        raise NotImplementedError

    def eval_device(self, ctx):
        lists = [c.eval_device(ctx) for c in self.children]
        valid, hv, ev, inside, widths = _rows_of(lists)
        wa = widths[0]
        key = slot_key(hv)
        keep = self._keep(key, ev, inside, wa)
        w = _widest(keep.sum(dim=1), valid & ctx.row_mask(),
                    type(self).__name__)
        vals, ev2, lens = compact_slots(hv, ev, keep, w)
        return DVal(ListVal(vals, ev2, lens), valid,
                    self.data_type(ctx.schema))


class ArrayUnion(_ArraySetOp):
    def _keep(self, key, ev, inside, wa):
        return distinct_keep(key, inside, ev)


class ArrayIntersect(_ArraySetOp):
    def _keep(self, key, ev, inside, wa):
        first = distinct_keep(key[:, :wa], inside[:, :wa], ev[:, :wa])
        keep = first & _in_other(key, ev, wa, inside)
        return torch.nn.functional.pad(keep, (0, key.shape[1] - wa))


class ArrayExcept(_ArraySetOp):
    def _keep(self, key, ev, inside, wa):
        first = distinct_keep(key[:, :wa], inside[:, :wa], ev[:, :wa])
        keep = first & ~_in_other(key, ev, wa, inside)
        return torch.nn.functional.pad(keep, (0, key.shape[1] - wa))


class ArrayRemove(_ListExpr):
    """array_remove(a, e): the elements not equal to ``e`` (NULL elements
    kept); NULL where ``e`` is NULL."""

    _needle = True

    def __init__(self, array, element):
        self.children = [array, element]

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def eval_device(self, ctx):
        arr = self._list(ctx)
        vvalid, eq = _needle_eq(ctx, arr.data, self.children[1])
        lv = arr.data
        keep = in_list(lv) & ~eq
        vals, ev, lens = compact_slots(lv.values, lv.elem_valid, keep,
                                       lv.values.shape[1])
        return DVal(ListVal(vals, ev, lens), arr.validity & vvalid,
                    self.data_type(ctx.schema))


class ArraysOverlap(_ListsExpr):
    """arrays_overlap(a, b): TRUE where a non-NULL element is in both;
    else NULL where both are non-empty and either holds a NULL; else
    FALSE. NULL if either list is."""

    def data_type(self, schema):
        return BOOL

    def eval_device(self, ctx):
        lists = [c.eval_device(ctx) for c in self.children]
        valid, hv, ev, inside, widths = _rows_of(lists)
        wa = widths[0]
        key = slot_key(hv)
        live = ev & inside
        ka, kb = key[:, :wa], key[:, wa:]
        hit = ((ka[:, :, None] == kb[:, None, :]) & live[:, :wa, None]
               & live[:, None, wa:]).any(dim=(1, 2))
        la, lb = lists[0].data.lengths, lists[1].data.lengths
        nulls = (inside & ~ev).any(dim=1)
        unknown = ~hit & (la > 0) & (lb > 0) & nulls
        return DVal(hit, valid & ~unknown, BOOL)


class StringToMap(Expression):
    """str_to_map(text[, pair_delim, key_value_delim]): ``text`` split on
    the pair delimiter (every part kept), each part split at its first
    key-value delimiter into a key and a value (NULL where the part has
    none). The delimiters are literals, as in ``split`` (Spark's are
    regexes; the two agree for literal ones). A key twice in a row raises
    (Spark's ``mapKeyDedupPolicy`` EXCEPTION), where the reference keeps
    the last value (ROADMAP.md Queue C)."""

    def __init__(self, text, pair_delim=None, kv_delim=None):
        self.children = [text, pair_delim if pair_delim is not None
                         else Literal(","),
                         kv_delim if kv_delim is not None else Literal(":")]

    def data_type(self, schema):
        return MapType(STRING, STRING)

    def device_unsupported_reason(self, schema):
        from .string_fns import literal_pattern
        for c in self.children[1:]:
            if not (isinstance(c, Literal) and isinstance(c.value, str)
                    and literal_pattern(c.value) is not None):
                return (f"StringToMap: a delimiter that is not a literal "
                        f"string arrives with {STRINGS_REST}")
        return None

    def fully_device_supported(self, schema):
        return self.device_unsupported_reason(schema) or \
            string_arg_reason(self.children[0], schema)

    def eval_device(self, ctx):
        from .string_fns import split_strings
        text = string_column(self.children[0], ctx)
        pairs = split_strings(text, self.children[1].value, -1,
                              "str_to_map")
        p, w = pairs.values.shape
        kv = split_strings(pairs.values.col, self.children[2].value, 2,
                           "str_to_map")
        rows = torch.arange(p * w, device=ctx.device)
        zero = torch.zeros_like(rows)
        keys = Slots(null_rows(slot_pick(kv.values, rows, zero),
                               pairs.elem_valid.reshape(-1)), w)
        has_value = pairs.elem_valid.reshape(-1) & (kv.lengths >= 2)
        vals = Slots(null_rows(slot_pick(kv.values, rows, zero + 1),
                               has_value), w)
        out = _map_val(keys, vals, has_value.reshape(p, w), pairs.lengths)
        check_map_keys(out.keys.elem_valid, out.keys.elem_valid, keys,
                       ctx.row_mask() & text.validity)
        return DVal(out, text.validity, self.data_type(ctx.schema))


# ---------------------------------------------------------------------------
# structs: named_struct / struct and get_field
# ---------------------------------------------------------------------------

def _column_reason(dt: DataType, what: str) -> Optional[str]:
    if device_column_ok(dt):
        return None
    return f"{what}: " + (nested_reason(dt) or
                          f"{dt.name} has no device column")


class CreateNamedStruct(Expression):
    """named_struct(name1, value1, ...): names are string literals; never
    NULL itself, each field its expression's value in its own layout (a
    string keeps its column's dictionary or byte rectangle, a literal is
    a dictionary of its value, a list its rectangle); ``struct()`` has no
    fields."""

    def __init__(self, *name_value_pairs):
        assert len(name_value_pairs) % 2 == 0, "named_struct takes pairs"
        self.names = [n.value if isinstance(n, Literal) else str(n)
                      for n in name_value_pairs[::2]]
        self.children = list(name_value_pairs[1::2])

    def data_type(self, schema):
        return StructType([StructField(n, c.data_type(schema))
                           for n, c in zip(self.names, self.children)])

    def device_unsupported_reason(self, schema):
        for n, c in zip(self.names, self.children):
            r = _column_reason(c.data_type(schema), f"struct field {n}")
            if r:
                return r
        return None

    def fully_device_supported(self, schema):
        r = self.device_unsupported_reason(schema)
        if r:
            return r
        for n, c in zip(self.names, self.children):
            r = string_arg_reason(c, schema) \
                if c.data_type(schema) == STRING \
                else c.fully_device_supported(schema)
            if r:
                return f"struct field {n}: {r}"
        return None

    def _field(self, ctx, c, dt):
        """The field's column: a string as its column (``string_column``),
        any other value as the column of its layout."""
        from .compiler import dval_column
        if dt == STRING:
            return string_column(c, ctx)
        v = c.eval_device(ctx)
        return dval_column(v, v.validity, dt)

    def eval_device(self, ctx):
        dt = self.data_type(ctx.schema)
        fields = [self._field(ctx, c, f.dtype)
                  for c, f in zip(self.children, dt.fields)]
        return DVal(StructVal(tuple(fields)),
                    torch.ones(ctx.padded_len, dtype=torch.bool,
                               device=ctx.device), dt)

    def key(self):
        kids = ",".join(f"{n}={c.key()}"
                        for n, c in zip(self.names, self.children))
        return f"CreateNamedStruct({kids})"


class GetStructField(Expression):
    """get_field(struct, name): the field, NULL where the struct is (as
    ``pc.struct_field`` carries the parent's NULLs); a string field's value
    carries its column, which a projection keeps."""

    def __init__(self, child, field_name: str):
        self.children = [child]
        self.field = field_name

    def data_type(self, schema):
        dt = self.children[0].data_type(schema)
        if not isinstance(dt, StructType):
            raise Unsupported(f"get_field expects a struct, got {dt}")
        return dt.fields[dt.index_of(self.field)].dtype

    def device_unsupported_reason(self, schema):
        dt = self.children[0].data_type(schema)
        if not device_struct_ok(dt):
            return _column_reason(dt, "GetStructField") or \
                f"GetStructField over {dt.name}"
        return None

    def eval_device(self, ctx):
        from .compiler import column_dval
        v = self.children[0].eval_device(ctx)
        return column_dval(null_rows(
            v.data.fields[v.dtype.index_of(self.field)], v.validity))

    def key(self):
        return f"GetStructField({self.children[0].key()},{self.field})"


# ---------------------------------------------------------------------------
# maps: two rectangles over one set of lengths (columnar/nested.py)
# ---------------------------------------------------------------------------

_DUPLICATE_KEY = ("Duplicate map key was found, please check the input "
                  "data. If you want to remove the duplicated keys, you can "
                  "set spark.sql.mapKeyDedupPolicy to LAST_WIN so that the "
                  "key inserted at last takes precedence.")
_NULL_KEY = "Cannot use null as map key"


def _map_reason(dt: DataType, what: str) -> Optional[str]:
    if device_map_ok(dt):
        return None
    if map_parts(dt) is not None:
        return f"{what}: {nested_reason(dt) or dt.name}"
    return f"{what}: expected a map, got {dt.name}"


def duplicate_keys(keys, inside: torch.Tensor) -> torch.Tensor:
    """bool[P]: the rows holding two equal keys among their ``inside``
    slots, keys equal by Spark's ordering (NaN equal to NaN, -0.0 to
    0.0; strings by their bytes)."""
    if keys.shape[1] < 2:
        return torch.zeros(keys.shape[0], dtype=torch.bool,
                           device=inside.device)
    k = torch.where(inside, slot_key(keys), 0)
    perm = _stable_sort_rows([(~inside).to(torch.int8), k])
    ks, ins = k.gather(1, perm), inside.gather(1, perm)
    return ((ks[:, 1:] == ks[:, :-1]) & ins[:, 1:] & ins[:, :-1]).any(dim=1)


def check_map_keys(key_valid: torch.Tensor, inside: torch.Tensor,
                   keys, live: torch.Tensor) -> None:
    """Raise as Spark does (``mapKeyDedupPolicy`` EXCEPTION, its
    default) where a live row holds a NULL key or a key twice: one host
    read."""
    null_key = (inside & ~key_valid).any(dim=1)
    dup = duplicate_keys(keys, inside & key_valid)
    n_null, n_dup = torch.stack([(null_key & live).any(),
                                 (dup & live).any()]).tolist()
    if n_null:
        raise ValueError(_NULL_KEY)
    if n_dup:
        raise ValueError(_DUPLICATE_KEY)


def _map_val(keys, values, value_valid, lengths) -> MapVal:
    """A MapVal of rectangles whose keys are valid up to each length."""
    w = keys.shape[1]
    inside = torch.arange(w, device=lengths.device)[None, :] \
        < lengths[:, None]
    return MapVal(ListVal(keys, inside, lengths),
                  ListVal(values, value_valid & inside, lengths))


class _MapExpr(Expression):
    """An expression whose first child is a device map."""

    def device_unsupported_reason(self, schema):
        r = _map_reason(self.children[0].data_type(schema),
                        type(self).__name__)
        if r:
            return r
        kt = map_parts(self.children[0].data_type(schema))[0]
        for c in self.children[1:]:
            cdt = c.data_type(schema)
            if cdt.np_dtype is None and cdt != NULLTYPE and cdt != kt:
                return f"{type(self).__name__}: argument type {cdt.name} " \
                       "is not a fixed-width type"
        return None

    def fully_device_supported(self, schema):
        r = self.device_unsupported_reason(schema) or \
            self.children[0].fully_device_supported(schema)
        if r:
            return r
        for c in self.children[1:]:
            r = _arg_reason(c, schema, type(self).__name__)
            if r:
                return r
        return None


class GetMapValue(_MapExpr):
    """map[key]: the key's value, NULL where the key is absent (Spark's
    default with ANSI off); a string key literal is looked up by its code
    or by ``rect_match``'s equals over the keys' byte rectangle."""

    def __init__(self, child, key):
        self.children = [child, key]

    def data_type(self, schema):
        return map_parts(self.children[0].data_type(schema))[1]

    def eval_device(self, ctx):
        m = self.children[0].eval_device(ctx)
        mv = m.data
        kvalid, eq = _needle_eq(ctx, mv.keys, self.children[1])
        j = eq.to(torch.int8).argmax(dim=1)
        rows = torch.arange(j.shape[0], device=j.device)
        ok = eq.any(dim=1) & mv.values.elem_valid[rows, j]
        return value_dval(slot_pick(mv.values.values, rows, j),
                          m.validity & kvalid & ok,
                          self.data_type(ctx.schema))


class MapKeys(_MapExpr):
    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return ArrayType(map_parts(self.children[0].data_type(schema))[0])

    def eval_device(self, ctx):
        m = self.children[0].eval_device(ctx)
        return DVal(m.data.keys, m.validity, self.data_type(ctx.schema))


class MapValues(_MapExpr):
    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return ArrayType(map_parts(self.children[0].data_type(schema))[1])

    def eval_device(self, ctx):
        m = self.children[0].eval_device(ctx)
        return DVal(m.data.values, m.validity, self.data_type(ctx.schema))


def _flat_field(lv: ListVal, dtype: DataType):
    """A rectangle's slots as a flat column (validity: the elements')."""
    from ..columnar import DeviceColumn
    ev = lv.elem_valid.reshape(-1)
    if isinstance(lv.values, Slots):
        return null_rows(lv.values.col, ev)
    return DeviceColumn(lv.values.reshape(-1), ev, dtype)


class MapEntries(_MapExpr):
    """map_entries(map): a list of ``struct<key, value>``, the struct
    elements' fields the map's two rectangles' slots."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return entries_type(*map_parts(self.children[0].data_type(schema)))

    def eval_device(self, ctx):
        m = self.children[0].eval_device(ctx)
        dt = self.data_type(ctx.schema)
        keys, vals = m.data
        st = dt.element
        inside = in_list(keys)
        elems = StructColumn([_flat_field(keys, st.fields[0].dtype),
                              _flat_field(vals, st.fields[1].dtype)],
                             inside.reshape(-1), st)
        return DVal(ListVal(Slots(elems, inside.shape[1]), inside,
                            keys.lengths), m.validity, dt)


def _map_types(schema, children):
    """The maps' key and value types widened to one (Spark's coercion)."""
    kvs = [map_parts(c.data_type(schema)) for c in children]
    if any(kv is None for kv in kvs):
        raise TypeError("map_concat takes maps")
    k, v = kvs[0]
    for k2, v2 in kvs[1:]:
        k, v = promote_types(k, k2), promote_types(v, v2)
    return k, v


class MapConcat(Expression):
    """map_concat(m1, ..., mk): NULL if any map is; a key in two maps
    raises (Spark's ``mapKeyDedupPolicy`` EXCEPTION, where the reference
    keeps the last value: ROADMAP.md Queue C). One host read of the
    widest row."""

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self, schema):
        return MapType(*_map_types(schema, self.children))

    def device_unsupported_reason(self, schema):
        if not self.children:
            return f"an empty map_concat() arrives with {NESTED_REST}"
        for c in self.children:
            r = _map_reason(c.data_type(schema), "MapConcat")
            if r:
                return r
        return None

    def eval_device(self, ctx):
        maps = [c.eval_device(ctx) for c in self.children]
        keys = [DVal(m.data.keys, m.validity, None) for m in maps]
        vals = [DVal(m.data.values, m.validity, None) for m in maps]
        valid, kh, _, inside, _ = _rows_of(keys)
        _, vh, vev, _, _ = _rows_of(vals)
        live = ctx.row_mask()
        w = _widest(inside.sum(dim=1), valid & live, "map_concat")
        k2, _, lens = compact_slots(kh, inside, inside, w)
        v2, vev2, _ = compact_slots(vh, vev, inside, w)
        out = _map_val(k2, v2, vev2, lens)
        check_map_keys(out.keys.elem_valid, out.keys.elem_valid,
                       out.keys.values, live & valid)
        return DVal(out, valid, self.data_type(ctx.schema))


class MapFromArrays(Expression):
    """map_from_arrays(keys, values): NULL where either array is; arrays
    of different lengths, a NULL key or a key twice raise (Spark's
    defaults; the reference keeps duplicate keys: ROADMAP.md Queue C)."""

    def __init__(self, keys, values):
        self.children = [keys, values]

    def data_type(self, schema):
        return MapType(_elem_type(self.children[0].data_type(schema)),
                       _elem_type(self.children[1].data_type(schema)))

    def device_unsupported_reason(self, schema):
        return _map_reason(self.data_type(schema), "MapFromArrays")

    def eval_device(self, ctx):
        a = self.children[0].eval_device(ctx)
        b = self.children[1].eval_device(ctx)
        valid = a.validity & b.validity
        live = ctx.row_mask() & valid
        ka, vb = a.data, b.data
        bad = (ka.lengths != vb.lengths) & live
        if bool(bad.any().item()):
            raise ValueError("The key array and value array of MapData "
                             "must have the same length.")
        w = max(ka.values.shape[1], vb.values.shape[1])
        keys = slot_pad(ka.values, w)
        kev = torch.nn.functional.pad(ka.elem_valid,
                                      (0, w - ka.values.shape[1]))
        pad = (0, w - vb.values.shape[1])
        lengths = torch.where(valid, ka.lengths, 0)
        out = _map_val(keys, slot_pad(vb.values, w),
                       torch.nn.functional.pad(vb.elem_valid, pad), lengths)
        check_map_keys(kev, out.keys.elem_valid, keys, live)
        return DVal(out, valid, self.data_type(ctx.schema))


class CreateMap(Expression):
    """map(k1, v1, ..., kn, vn): never NULL itself; a NULL key or a key
    twice raises (Spark's defaults; the reference keeps the last value of
    a repeated key: ROADMAP.md Queue C). ``map()`` is an empty map of
    NULL-typed keys and values."""

    def __init__(self, *children):
        assert len(children) % 2 == 0, "CreateMap needs key/value pairs"
        self.children = list(children)

    def _types(self, schema):
        return _common_type(schema, self.children[::2]), \
            _common_type(schema, self.children[1::2])

    def data_type(self, schema):
        return MapType(*self._types(schema))

    def device_unsupported_reason(self, schema):
        if width_bucket(max(len(self.children) // 2, 1)) is None:
            return (f"map() of {len(self.children) // 2} entries is wider "
                    f"than the device rectangle ({WIDTH_BUCKETS[-1]}); it "
                    f"arrives with {NESTED_REST}")
        return _map_reason(self.data_type(schema), "CreateMap")

    def fully_device_supported(self, schema):
        r = self.device_unsupported_reason(schema)
        if r:
            return r
        for c in self.children:
            r = _arg_reason(c, schema, "CreateMap")
            if r:
                return r
        return None

    def eval_device(self, ctx):
        kt, vt = self._types(ctx.schema)
        k = len(self.children) // 2
        w = width_bucket(max(k, 1))
        p = ctx.padded_len
        keys, kev = _stacked(ctx, self.children[::2], kt, w)
        vals, vev = _stacked(ctx, self.children[1::2],
                             vt if vt != NULLTYPE else INT32, w)
        lengths = torch.full((p,), k, dtype=torch.int32, device=ctx.device)
        out = _map_val(keys, vals, vev, lengths)
        check_map_keys(kev, out.keys.elem_valid, keys, ctx.row_mask())
        return DVal(out, torch.ones(p, dtype=torch.bool, device=ctx.device),
                    self.data_type(ctx.schema))
