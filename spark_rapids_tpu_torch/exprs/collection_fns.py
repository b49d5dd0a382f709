"""Collection expressions over device list rectangles (port of
``spark_rapids_tpu/exprs/collection_fns.py``, its device path).

A list value is a ``ListVal`` (values[P, W], elem_valid[P, W], lengths[P],
columnar/nested.py) and every function below is ops over axis 1, masked
past each row's length: ``size``, ``array_contains``, ``array_position``,
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

The other classes of the reference's file (maps, structs, and the array
functions it runs only on its host engine) are refused at planning
(``NESTED_REST``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..columnar.nested import WIDTH_BUCKETS, width_bucket
from ..types import (BOOL, INT32, INT64, NESTED_REST, NULLTYPE, STRING,
                     ArrayType, DataType, MapType, Schema, StructField,
                     StructType, device_list_ok, torch_dtype)
from .base import DVal, Expression, ListVal, Literal, Unsupported, \
    promote_types

__all__ = [
    "Size", "ArrayContains", "ArrayPosition", "ElementAt", "GetArrayItem",
    "SortArray", "ArrayMin", "ArrayMax", "Slice", "ArrayReverse",
    "CreateArray", "Sequence", "GetMapValue", "GetStructField",
    "ArrayJoin", "ArrayRepeat", "ArraysZip", "Concat", "Flatten",
    "ArrayDistinct", "ArrayUnion", "ArrayIntersect", "ArrayExcept",
    "ArrayRemove", "ArraysOverlap", "MapKeys", "MapValues", "MapEntries",
    "MapConcat", "MapFromArrays", "StringToMap", "CreateMap",
    "CreateNamedStruct", "in_list", "element_key", "sequence_counts",
]


def in_list(lv: ListVal) -> torch.Tensor:
    """bool[P, W]: the slots before each row's length."""
    w = lv.values.shape[1]
    return torch.arange(w, device=lv.values.device)[None, :] \
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


class _ListExpr(Expression):
    """An expression whose first child is a device list and whose other
    children are fixed-width values."""

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        dt = self.children[0].data_type(schema)
        if not device_list_ok(dt):
            return (f"{type(self).__name__}: {dt.name} has no device "
                    f"layout; it arrives with {NESTED_REST}")
        for c in self.children[1:]:
            cdt = c.data_type(schema)
            if cdt.np_dtype is None and cdt != NULLTYPE:
                return f"{type(self).__name__}: argument type {cdt.name} " \
                       "is not a fixed-width type"
        return None

    def _list(self, ctx) -> DVal:
        return self.children[0].eval_device(ctx)


class Size(_ListExpr):
    """size(array): a NULL list's size is -1 (Spark's default with ANSI
    off)."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return INT32

    def eval_device(self, ctx):
        v = self._list(ctx)
        lens = v.data.lengths.to(torch.int32)
        return DVal(torch.where(v.validity, lens, -1),
                    torch.ones_like(v.validity), INT32)


def _needle_eq(ctx, array_expr, value_expr):
    """(array DVal, value DVal, eq[P, W]): the live elements equal to the
    value by Spark's ordering."""
    arr = array_expr.eval_device(ctx)
    val = value_expr.eval_device(ctx)
    lv = arr.data
    common = torch.promote_types(lv.values.dtype, val.data.dtype)
    eq = element_key(lv.values.to(common)) \
        == element_key(val.data.to(common))[:, None]
    return arr, val, torch.logical_and(eq, lv.elem_valid)


class ArrayContains(_ListExpr):
    def __init__(self, array, value):
        self.children = [array, value]

    def data_type(self, schema):
        return BOOL

    def eval_device(self, ctx):
        arr, val, eq = _needle_eq(ctx, *self.children)
        lv = arr.data
        found = eq.any(dim=1)
        has_null = torch.logical_and(in_list(lv), ~lv.elem_valid).any(dim=1)
        valid = arr.validity & val.validity & (found | ~has_null)
        return DVal(found, valid, BOOL)


class ArrayPosition(_ListExpr):
    """1-based position of the first match, 0 if absent."""

    def __init__(self, array, value):
        self.children = [array, value]

    def data_type(self, schema):
        return INT64

    def eval_device(self, ctx):
        arr, val, eq = _needle_eq(ctx, *self.children)
        first = eq.to(torch.int8).argmax(dim=1) + 1
        data = torch.where(eq.any(dim=1), first, 0)
        return DVal(data, arr.validity & val.validity, INT64)


def _element(lv: ListVal, idx: torch.Tensor):
    """(value[P], in range and valid[P]) at 0-based ``idx`` per row."""
    w = lv.values.shape[1]
    ok = (idx >= 0) & (idx < lv.lengths)
    j = idx.clamp(0, w - 1).to(torch.int64)[:, None]
    data = lv.values.gather(1, j)[:, 0]
    return data, ok & lv.elem_valid.gather(1, j)[:, 0]


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
    of range; index 0 raises, as Spark's does."""

    def __init__(self, child, key):
        self.children = [child, key]

    def device_unsupported_reason(self, schema):
        if isinstance(self.children[0].data_type(schema), MapType):
            return f"element_at of a map arrives with {NESTED_REST}"
        if _int_literal(self.children[1]) == 0:
            raise ValueError("SQL array indices start at 1")
        return super().device_unsupported_reason(schema)

    def eval_device(self, ctx):
        arr = self._list(ctx)
        k = self.children[1].eval_device(ctx)
        both = arr.validity & k.validity
        if _int_literal(self.children[1]) is None and _any_valid(
                both & (k.data == 0) & ctx.row_mask()):
            raise ValueError("SQL array indices start at 1")
        kk = k.data.to(torch.int64)
        idx = torch.where(kk > 0, kk - 1, arr.data.lengths + kk)
        data, ok = _element(arr.data, idx)
        return DVal(data, both & ok, self.data_type(ctx.schema))


class GetArrayItem(_Extract):
    """array[i]: 0-based, NULL out of range."""

    def __init__(self, array, ordinal):
        self.children = [array, ordinal]

    def eval_device(self, ctx):
        arr = self._list(ctx)
        k = self.children[1].eval_device(ctx)
        data, ok = _element(arr.data, k.data.to(torch.int64))
        return DVal(data, arr.validity & k.validity & ok,
                    self.data_type(ctx.schema))


def _stable_sort_rows(keys, values: torch.Tensor):
    """The permutation [P, W] sorting each row by ``keys`` (first decides
    first), stably: one stable sort a key, last key first."""
    perm = torch.arange(values.shape[1], device=values.device) \
        .expand(values.shape).contiguous()
    for k in reversed(keys):
        order = torch.sort(k.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    return perm


class SortArray(_ListExpr):
    """sort_array(array, asc): NULLs first ascending, last descending;
    equal elements keep their order (Spark sorts stably by its ordering,
    NaN greatest, -0.0 equal to 0.0)."""

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
        key = element_key(lv.values)
        if not asc:
            key = torch.bitwise_not(key)
        # asc: NULLs, values, padding; desc: values, NULLs, padding
        null_rank, value_rank = (0, 1) if asc else (1, 0)
        rank = torch.where(inside, torch.where(lv.elem_valid, value_rank,
                                               null_rank), 2)
        key = torch.where(lv.elem_valid, key, torch.zeros_like(key))
        perm = _stable_sort_rows([rank.to(torch.int8), key], lv.values)
        return DVal(ListVal(lv.values.gather(1, perm),
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
        key = element_key(lv.values)
        info = torch.iinfo(key.dtype)
        fill = info.min if self._max else info.max
        masked = torch.where(lv.elem_valid, key, fill)
        best = masked.amax(dim=1) if self._max else masked.amin(dim=1)
        hit = lv.elem_valid & (masked == best[:, None])
        j = hit.to(torch.int8).argmax(dim=1, keepdim=True)
        data = lv.values.gather(1, j)[:, 0]
        return DVal(data, arr.validity & lv.elem_valid.any(dim=1),
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
        lens = lv.lengths.to(torch.int64)
        start = torch.where(s > 0, s - 1, lens + s)
        neg = start < 0
        j = torch.arange(lv.values.shape[1], device=s.device)[None, :]
        src = start[:, None] + j
        take = (j < ln[:, None]) & (src < lens[:, None]) & ~neg[:, None]
        srcc = src.clamp(0, lv.values.shape[1] - 1)
        out_len = torch.where(neg, 0, (lens - start).clamp(min=0)
                              .minimum(ln.clamp(min=0)))
        return DVal(ListVal(lv.values.gather(1, srcc),
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
        j = torch.arange(w, device=lv.values.device)[None, :]
        src = (lv.lengths[:, None].to(torch.int64) - 1 - j).clamp(0, w - 1)
        ok = in_list(lv)
        return DVal(ListVal(lv.values.gather(1, src),
                            lv.elem_valid.gather(1, src) & ok, lv.lengths),
                    arr.validity, self.data_type(ctx.schema))


class CreateArray(Expression):
    """array(e1, ..., ek): never NULL itself; each element is its
    expression's value."""

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self, schema):
        et = NULLTYPE
        for c in self.children:
            d = c.data_type(schema)
            if d != NULLTYPE:
                et = d if et == NULLTYPE else promote_types(et, d)
        return ArrayType(et)

    def device_unsupported_reason(self, schema):
        if not self.children:
            return f"an empty array() arrives with {NESTED_REST}"
        if width_bucket(len(self.children)) is None:
            return (f"array() of {len(self.children)} elements is wider "
                    f"than the device rectangle ({WIDTH_BUCKETS[-1]}); it "
                    f"arrives with {NESTED_REST}")
        if not device_list_ok(self.data_type(schema)):
            return (f"array of {self.data_type(schema).element.name} "
                    f"arrives with {NESTED_REST}")
        return None

    def eval_device(self, ctx):
        dt = self.data_type(ctx.schema)
        tdt = torch_dtype(dt.element)
        k = len(self.children)
        w = width_bucket(k)
        vals = [c.eval_device(ctx) for c in self.children]
        pad = w - k
        p = ctx.padded_len
        zeros = torch.zeros(p, dtype=tdt, device=ctx.device)
        off = torch.zeros(p, dtype=torch.bool, device=ctx.device)
        values = torch.stack([v.data.to(tdt) for v in vals] + [zeros] * pad,
                             dim=1)
        ev = torch.stack([v.validity for v in vals] + [off] * pad, dim=1)
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
        values = (start[:, None] + j * step[:, None]).to(torch_dtype(
            dt.element))
        return DVal(ListVal(values, j < count[:, None],
                            count.to(torch.int32)), valid, dt)


# ---------------------------------------------------------------------------
# refused at planning: maps, structs and the host-only array functions
# ---------------------------------------------------------------------------

class _Refused(Expression):
    """A nested-type function the port does not run: the reference runs
    it on its host engine only, or it takes a map or a struct."""

    def __init__(self, *children):
        self.children = [c for c in children if c is not None]

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def device_unsupported_reason(self, schema):
        return f"{type(self).__name__} arrives with {NESTED_REST}"


class GetMapValue(_Refused):
    def data_type(self, schema):
        return self.children[0].data_type(schema).value


class GetStructField(_Refused):
    def __init__(self, child, field_name: str):
        super().__init__(child)
        self.field = field_name

    def data_type(self, schema):
        dt = self.children[0].data_type(schema)
        return dt.fields[[f.name for f in dt.fields].index(self.field)].dtype


class ArrayJoin(_Refused):
    def data_type(self, schema):
        return STRING


class ArrayRepeat(_Refused):
    def data_type(self, schema):
        return ArrayType(self.children[0].data_type(schema))


class ArraysZip(_Refused):
    def data_type(self, schema):
        return ArrayType(StructType(
            StructField(str(i), _elem_type(c.data_type(schema)))
            for i, c in enumerate(self.children)))


class Concat(_Refused):
    pass


class Flatten(_Refused):
    def data_type(self, schema):
        return _elem_type(self.children[0].data_type(schema))


class ArrayDistinct(_Refused):
    pass


class ArrayUnion(_Refused):
    pass


class ArrayIntersect(_Refused):
    pass


class ArrayExcept(_Refused):
    pass


class ArrayRemove(_Refused):
    pass


class ArraysOverlap(_Refused):
    def data_type(self, schema):
        return BOOL


class MapKeys(_Refused):
    def data_type(self, schema):
        return ArrayType(self.children[0].data_type(schema).key)


class MapValues(_Refused):
    def data_type(self, schema):
        return ArrayType(self.children[0].data_type(schema).value)


class MapEntries(_Refused):
    def data_type(self, schema):
        dt = self.children[0].data_type(schema)
        return ArrayType(StructType([StructField("key", dt.key),
                                     StructField("value", dt.value)]))


class MapConcat(_Refused):
    pass


class MapFromArrays(_Refused):
    def data_type(self, schema):
        return MapType(_elem_type(self.children[0].data_type(schema)),
                       _elem_type(self.children[1].data_type(schema)))


class StringToMap(_Refused):
    def data_type(self, schema):
        return MapType(STRING, STRING)


class CreateMap(_Refused):
    def data_type(self, schema):
        return MapType(self.children[0].data_type(schema),
                       self.children[1].data_type(schema))


class CreateNamedStruct(_Refused):
    """named_struct(name1, value1, ...): names are string literals."""

    def data_type(self, schema):
        kids = self.children
        return StructType(StructField(str(n.value), v.data_type(schema))
                          for n, v in zip(kids[::2], kids[1::2]))
