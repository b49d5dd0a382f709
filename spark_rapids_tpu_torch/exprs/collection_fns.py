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

Structs (``named_struct``/``struct``, ``get_field``) are their fields'
device columns; maps (``map``, ``map_from_arrays``, ``map_concat``,
``map_keys``, ``map_values``, ``map_entries``, ``map[key]``,
``element_at`` and ``size`` of a map) are two rectangles over one set of
lengths, keys compared as the elements are. A map built here follows
Spark's ``mapKeyDedupPolicy`` EXCEPTION, its default: a key twice in a
row raises, as does a NULL key; the reference keeps the last value
(``map``, ``map_concat``) or both (``map_from_arrays``) (ROADMAP.md Queue
C). The array functions the reference runs only on its host engine and
``str_to_map`` (string keys) are refused at planning (``NESTED_REST``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..columnar.nested import WIDTH_BUCKETS, width_bucket
from ..types import (BOOL, INT32, INT64, NESTED_REST, NULLTYPE, STRING,
                     ArrayType, DataType, MapType, Schema, StructField,
                     StructType, device_column_ok, device_list_ok,
                     device_map_ok, device_struct_ok, entries_type,
                     map_parts, nested_reason, torch_dtype)
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


class StringToMap(_Refused):
    def data_type(self, schema):
        return MapType(STRING, STRING)




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
    string column keeps its dictionary or byte rectangle, a list its
    rectangle)."""

    def __init__(self, *name_value_pairs):
        assert len(name_value_pairs) % 2 == 0, "named_struct takes pairs"
        self.names = [n.value if isinstance(n, Literal) else str(n)
                      for n in name_value_pairs[::2]]
        self.children = list(name_value_pairs[1::2])

    def data_type(self, schema):
        return StructType([StructField(n, c.data_type(schema))
                           for n, c in zip(self.names, self.children)])

    def device_unsupported_reason(self, schema):
        if not self.children:
            return f"an empty struct arrives with {NESTED_REST}"
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
            if c.data_type(schema) == STRING and not isinstance(
                    c, (ColumnRef, GetStructField)):
                return (f"struct field {n}: a computed string in a struct "
                        f"arrives with {NESTED_REST}")
            if c.data_type(schema) != STRING or isinstance(
                    c, GetStructField):
                r = c.fully_device_supported(schema)
                if r:
                    return r
        return None

    def _field(self, ctx, c, dt):
        """The field's column: a string as the column it was read from
        (``DVal.column``), any other value as the column of its layout."""
        from .compiler import dval_column
        v = c.eval_device(ctx)
        if dt == STRING and v.column is None:
            raise NotImplementedError(
                f"struct field {c.name_hint}: a string that is not a device "
                f"string column; such a struct arrives with {NESTED_REST}")
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
        from ..columnar.nested import null_rows
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


def duplicate_keys(keys: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """bool[P]: the rows holding two equal keys among their ``inside``
    slots, keys equal by Spark's ordering (NaN equal to NaN, -0.0 to
    0.0)."""
    if keys.shape[1] < 2:
        return torch.zeros(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
    k = element_key(keys)
    k = torch.where(inside, k, torch.zeros_like(k))
    perm = _stable_sort_rows([(~inside).to(torch.int8), k], keys)
    ks, ins = k.gather(1, perm), inside.gather(1, perm)
    return ((ks[:, 1:] == ks[:, :-1]) & ins[:, 1:] & ins[:, :-1]).any(dim=1)


def check_map_keys(key_valid: torch.Tensor, inside: torch.Tensor,
                   keys: torch.Tensor, live: torch.Tensor) -> None:
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
    inside = torch.arange(w, device=keys.device)[None, :] \
        < lengths[:, None]
    return MapVal(ListVal(keys, inside, lengths),
                  ListVal(values, value_valid & inside, lengths))


def _lookup(mv: MapVal, key: torch.Tensor):
    """(value[P], found and valid[P]) of ``key`` in each row's map."""
    keys = mv.keys
    common = torch.promote_types(keys.values.dtype, key.dtype)
    eq = (element_key(keys.values.to(common))
          == element_key(key.to(common))[:, None]) & keys.elem_valid
    j = eq.to(torch.int8).argmax(dim=1, keepdim=True)
    data = mv.values.values.gather(1, j)[:, 0]
    ok = eq.any(dim=1) & mv.values.elem_valid.gather(1, j)[:, 0]
    return data, ok


class _MapExpr(Expression):
    """An expression whose first child is a device map."""

    def device_unsupported_reason(self, schema):
        r = _map_reason(self.children[0].data_type(schema),
                        type(self).__name__)
        if r:
            return r
        for c in self.children[1:]:
            cdt = c.data_type(schema)
            if cdt.np_dtype is None and cdt != NULLTYPE:
                return f"{type(self).__name__}: argument type {cdt.name} " \
                       "is not a fixed-width type"
        return None


class GetMapValue(_MapExpr):
    """map[key]: the key's value, NULL where the key is absent (Spark's
    default with ANSI off)."""

    def __init__(self, child, key):
        self.children = [child, key]

    def data_type(self, schema):
        return map_parts(self.children[0].data_type(schema))[1]

    def eval_device(self, ctx):
        m = self.children[0].eval_device(ctx)
        k = self.children[1].eval_device(ctx)
        data, ok = _lookup(m.data, k.data)
        return DVal(data, m.validity & k.validity & ok,
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


class MapEntries(_MapExpr):
    """map_entries(map): the same rectangles, typed as an array of
    ``struct<key, value>``."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return entries_type(*map_parts(self.children[0].data_type(schema)))

    def device_unsupported_reason(self, schema):
        if not isinstance(self.children[0].data_type(schema), MapType):
            return "MapEntries: expected a map"
        return super().device_unsupported_reason(schema)

    def eval_device(self, ctx):
        m = self.children[0].eval_device(ctx)
        return DVal(m.data, m.validity, self.data_type(ctx.schema))


class MapConcat(Expression):
    """map_concat(m1, ..., mk): NULL if any map is; a key in two maps
    raises (Spark's ``mapKeyDedupPolicy`` EXCEPTION, where the reference
    keeps the last value: ROADMAP.md Queue C). One host read of the
    widest row."""

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self, schema):
        """The maps' key and value types widened to one (Spark's
        coercion)."""
        kvs = [map_parts(c.data_type(schema)) for c in self.children]
        if any(kv is None for kv in kvs):
            raise TypeError("map_concat takes maps")
        k, v = kvs[0]
        for k2, v2 in kvs[1:]:
            k, v = promote_types(k, k2), promote_types(v, v2)
        return MapType(k, v)

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
        valid = maps[0].validity
        for m in maps[1:]:
            valid = valid & m.validity
        lens = [torch.where(valid, m.data.keys.lengths, 0).to(torch.int64)
                for m in maps]
        total = lens[0]
        for ln in lens[1:]:
            total = total + ln
        live = ctx.row_mask()
        widest = int(torch.where(live, total, 0).max().item()) \
            if total.numel() else 0
        w = width_bucket(max(widest, 1))
        if w is None:
            raise NotImplementedError(
                f"map_concat: a map of {widest} entries is wider than the "
                f"device rectangle ({WIDTH_BUCKETS[-1]}); it arrives with "
                f"{NESTED_REST}")
        p = valid.shape[0]
        dev = valid.device
        dt = self.data_type(ctx.schema)
        kt, vt = torch_dtype(dt.key), torch_dtype(dt.value)
        keys = torch.zeros((p, w + 1), dtype=kt, device=dev)
        vals = torch.zeros((p, w + 1), dtype=vt, device=dev)
        vv = torch.zeros((p, w + 1), dtype=torch.bool, device=dev)
        base = torch.zeros(p, dtype=torch.int64, device=dev)
        for m, ln in zip(maps, lens):
            mv = m.data
            mw = mv.keys.values.shape[1]
            j = torch.arange(mw, device=dev)[None, :]
            dest = torch.where(j < ln[:, None], base[:, None] + j, w)
            keys.scatter_(1, dest, mv.keys.values.to(kt))
            vals.scatter_(1, dest, mv.values.values.to(vt))
            vv.scatter_(1, dest, mv.values.elem_valid)
            base = base + ln
        out = _map_val(keys[:, :w], vals[:, :w], vv[:, :w],
                       total.to(torch.int32))
        check_map_keys(out.keys.elem_valid, out.keys.elem_valid,
                       out.keys.values, live & valid)
        return DVal(out, valid, dt)


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
        for c in self.children:
            dt = c.data_type(schema)
            if not device_list_ok(dt):
                return f"MapFromArrays over {dt.name} arrives with " \
                       f"{NESTED_REST}"
        return None

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
        pad = (0, w - ka.values.shape[1])
        keys = torch.nn.functional.pad(ka.values, pad)
        kev = torch.nn.functional.pad(ka.elem_valid, pad)
        pad = (0, w - vb.values.shape[1])
        lengths = torch.where(valid, ka.lengths, 0)
        out = _map_val(keys, torch.nn.functional.pad(vb.values, pad),
                       torch.nn.functional.pad(vb.elem_valid, pad), lengths)
        check_map_keys(kev, out.keys.elem_valid, keys, live)
        return DVal(out, valid, self.data_type(ctx.schema))


class CreateMap(Expression):
    """map(k1, v1, ..., kn, vn): never NULL itself; a NULL key or a key
    twice raises (Spark's defaults; the reference keeps the last value of
    a repeated key: ROADMAP.md Queue C)."""

    def __init__(self, *children):
        assert len(children) % 2 == 0, "CreateMap needs key/value pairs"
        self.children = list(children)

    def _types(self, schema):
        def common(exprs):
            t = NULLTYPE
            for c in exprs:
                d = c.data_type(schema)
                if d != NULLTYPE:
                    t = d if t == NULLTYPE else promote_types(t, d)
            return t
        return common(self.children[::2]), common(self.children[1::2])

    def data_type(self, schema):
        return MapType(*self._types(schema))

    def device_unsupported_reason(self, schema):
        if not self.children:
            return f"an empty map() arrives with {NESTED_REST}"
        if width_bucket(len(self.children) // 2) is None:
            return (f"map() of {len(self.children) // 2} entries is wider "
                    f"than the device rectangle ({WIDTH_BUCKETS[-1]}); it "
                    f"arrives with {NESTED_REST}")
        return _map_reason(self.data_type(schema), "CreateMap")

    def eval_device(self, ctx):
        kt, vt = self._types(ctx.schema)
        ks = [c.eval_device(ctx) for c in self.children[::2]]
        vs = [c.eval_device(ctx) for c in self.children[1::2]]
        k = len(ks)
        w = width_bucket(k)
        p = ctx.padded_len

        def rect(vals, dt, fill):
            tdt = torch_dtype(dt)
            cols = [v.data.to(tdt).expand(p) for v in vals]
            cols += [torch.zeros(p, dtype=tdt, device=ctx.device)] * (w - k)
            oks = [v.validity.expand(p) for v in vals]
            oks += [torch.full((p,), fill, device=ctx.device)] * (w - k)
            return torch.stack(cols, dim=1), torch.stack(oks, dim=1)
        keys, kev = rect(ks, kt, False)
        vals, vev = rect(vs, vt if vt != NULLTYPE else INT32, False)
        lengths = torch.full((p,), k, dtype=torch.int32, device=ctx.device)
        out = _map_val(keys, vals, vev, lengths)
        check_map_keys(kev, out.keys.elem_valid, keys, ctx.row_mask())
        return DVal(out, torch.ones(p, dtype=torch.bool, device=ctx.device),
                    self.data_type(ctx.schema))
