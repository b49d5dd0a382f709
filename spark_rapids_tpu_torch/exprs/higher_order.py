"""Higher-order functions over device list rectangles (port of
``spark_rapids_tpu/exprs/higher_order.py``): ``transform``, ``filter``,
``exists``, ``forall``, ``zip_with`` and ``aggregate``.

A lambda's body is evaluated once, vectorised, over the rectangle's P·W
slots flattened into element rows: each lambda variable is a column of
that scope (the element, its index; a string or struct element is its
flat column, so a string chain in the body runs over it by its layout,
``rect_match`` and ``rect_transform`` over a byte rectangle), and every
column the body reads from outside is repeated once a slot. Slots past a row's length are
evaluated too (no host read to compact them) and are masked out of the
result; the scope's ``live`` rows say which are real, for the functions
that raise on a value. A nested higher-order function binds its own
variables; an enclosing lambda's variable it reads is a column of the
enclosing scope like any other (``_outer_refs``).

``aggregate`` folds over the W positions in element order, one body
evaluation over the P rows a position, each row's accumulator left as
it is past its length: a row's fold adds its elements in the order the
reference's does. Its merge must give the zero's type, as Spark's
analyzer requires.

The map forms (``transform_keys``, ``transform_values``, ``map_filter``)
bind ``(k, v)`` to the map's two rectangles over the same P·W slots and
``live`` mask. ``transform_keys`` raises where a new key is NULL or
repeats in a row (Spark's ``mapKeyDedupPolicy`` EXCEPTION; the
reference does not check repeats: ROADMAP.md Queue C).
"""
from __future__ import annotations

import itertools
from typing import List, Optional

import torch

from ..types import (BOOL, INT32, NESTED_REST, STRING, ArrayType, DataType,
                     MapType, Schema, StructField, StructType,
                     device_list_ok, device_map_ok, nested_reason)
from ..columnar.nested import (Slots, slot_pad, slot_pick, slot_rows,
                               take_rows, with_validity)
from .base import (ColumnRef, DVal, EvalContext, Expression, ListVal, MapVal,
                   StrVal, StructVal)
from .collection_fns import (_elem_type, _map_val, check_map_keys,
                             compact_slots, in_list, value_dval)

__all__ = ["NamedLambdaVariable", "ArrayTransform", "ArrayFilter",
           "ArrayExists", "ArrayForAll", "ArrayAggregate", "ZipWith",
           "TransformKeys", "TransformValues", "MapFilter"]

_VARIABLE_IDS = itertools.count(1)


class NamedLambdaVariable(ColumnRef):
    """A lambda's variable: a column of its scope, by a name no column of
    a table has. Its type is set by the function that binds it."""

    def __init__(self, hint: str, dtype: Optional[DataType] = None):
        super().__init__(f"`lambda_{hint}_{next(_VARIABLE_IDS)}`")
        self._dtype = dtype

    def data_type(self, schema: Schema) -> DataType:
        assert self._dtype is not None, "unbound lambda variable"
        return self._dtype

    def device_unsupported_reason(self, schema):
        return None


def _repeat(v: DVal, w: int) -> DVal:
    """``v`` with each row repeated ``w`` times."""
    d = v.data
    idx = torch.arange(v.validity.shape[0], device=v.validity.device) \
        .repeat_interleave(w)

    def lst(lv):
        return ListVal(slot_rows(lv.values, idx), lv.elem_valid[idx],
                       lv.lengths[idx])
    if isinstance(d, StructVal):
        d = StructVal(tuple(take_rows(c, idx) for c in d.fields))
    elif isinstance(d, MapVal):
        d = MapVal(*(lst(lv) for lv in d))
    elif isinstance(d, ListVal):
        d = lst(d)
    elif isinstance(d, StrVal):
        d = StrVal(*(t[idx] for t in d))
    else:
        d = d[idx]
    col = None if v.column is None else take_rows(v.column, idx)
    return DVal(d, v.validity[idx], v.dtype, col)


def _slot_dval(values, valid: torch.Tensor, dtype: DataType) -> DVal:
    """A rectangle's slots flattened into element rows: a DVal of P·W
    rows (strings and structs as their flat column's, which they carry,
    its validity the elements': the bytes are not copied)."""
    if isinstance(values, Slots):
        from .compiler import column_dval
        v = column_dval(with_validity(values.col, valid))
        return DVal(v.data, valid, dtype, v.column)
    return DVal(values.reshape(-1), valid, dtype)


def _slot_result(res: DVal, dtype: DataType, p: int, w: int):
    """A lambda's result over P·W element rows as a [P, W] rectangle's
    values (``Slots`` for a string or a struct)."""
    if dtype == STRING or isinstance(dtype, StructType):
        from .compiler import dval_column
        return Slots(dval_column(res, res.validity, dtype), w)
    return res.data.reshape(p, w)


class _HigherOrder(Expression):
    """Binding, the scope of a lambda and its free columns."""

    args: List[NamedLambdaVariable]
    body: Expression

    def _bind_types(self, schema: Schema) -> None:
        raise NotImplementedError

    def _bodies(self) -> list:
        return [self.body]

    def _bound(self) -> set:
        """The variables bound here or in a nested higher-order function."""
        bound = {a.name for a in self.args}
        stack = list(self._bodies())
        while stack:
            e = stack.pop()
            if isinstance(e, _HigherOrder):
                bound.update(a.name for a in e.args)
                if isinstance(e, ArrayAggregate) and e.finish_args:
                    bound.update(a.name for a in e.finish_args)
            stack.extend(e.children)
        return bound

    def _outer_refs(self) -> List[str]:
        """The columns the lambda reads from outside (an enclosing lambda's
        variables among them), each once."""
        bound = self._bound()
        return list(dict.fromkeys(
            r for b in self._bodies() for r in b.references()
            if r not in bound))

    def references(self):
        bodies = [id(b) for b in self._bodies()]
        out = [r for c in self.children if id(c) not in bodies
               for r in c.references()]
        return out + self._outer_refs()

    def device_unsupported_reason(self, schema):
        self._bind_types(schema)
        for c in self.children[:self._n_lists]:
            dt = c.data_type(schema)
            if isinstance(dt, MapType) or not device_list_ok(dt):
                return (f"{type(self).__name__} over {dt.name}: "
                        + (nested_reason(dt)
                           or f"arrives with {NESTED_REST}"))
        return self._result_reason(schema)

    def fully_device_supported(self, schema):
        """The lists and the other arguments over ``schema``; the bodies
        over their scope, whose variables are columns: a string chain over
        a string variable runs (string_fns.py ``eval_device``)."""
        r = self.device_unsupported_reason(schema)
        if r:
            return r
        bodies = [id(b) for b in self._bodies()]
        scope = Schema(list(schema.fields) + [
            StructField(a.name, a._dtype) for a in self._all_args()])
        for c in self.children:
            r = c.fully_device_supported(scope if id(c) in bodies
                                         else schema)
            if r:
                return r
        return None

    def _all_args(self) -> list:
        return list(self.args) + list(getattr(self, "finish_args", None)
                                      or [])

    _n_lists = 1

    def _result_reason(self, schema) -> Optional[str]:
        dt = self.body.data_type(schema)
        if dt.np_dtype is None and dt != STRING:
            return (f"{type(self).__name__}: a lambda giving {dt.name} "
                    f"arrives with {NESTED_REST}")
        return None

    def _scope(self, ctx, bound, repeat: int, n: int,
               live: torch.Tensor) -> EvalContext:
        """The lambda's scope over ``n`` rows: the outer columns (each row
        repeated ``repeat`` times), then the (variable, DVal) pairs of
        ``bound``."""
        fields, cols = [], []
        for name in self._outer_refs():
            i = ctx.schema.index_of(name)
            v = ctx.columns[i]
            fields.append(ctx.schema.fields[i])
            cols.append(_repeat(v, repeat) if repeat > 1 else v)
        for var, v in bound:
            fields.append(StructField(var.name, var._dtype))
            cols.append(v)
        return EvalContext(Schema(fields), cols, n, n, ctx.device,
                           partition_id=ctx.partition_id, live=live,
                           use_kernel=ctx.use_kernel)

    def _elements(self, ctx, lv: ListVal, validity, with_index: bool):
        """The element scope of ``lv`` (P·W rows) and the slots' mask."""
        p, w = lv.values.shape
        inside = in_list(lv)
        live = (inside & (ctx.row_mask() & validity)[:, None]).reshape(-1)
        bound = [(self.args[0], _slot_dval(lv.values,
                                           lv.elem_valid.reshape(-1),
                                           self.args[0]._dtype))]
        if with_index and len(self.args) > 1:
            idx = torch.arange(w, dtype=torch.int32,
                               device=ctx.device).repeat(p)
            bound.append((self.args[1], DVal(idx, inside.reshape(-1),
                                             INT32)))
        return self._scope(ctx, bound, w, p * w, live), inside


class _OverElements(_HigherOrder):
    """transform / filter / exists / forall: (array, lambda body)."""

    def __init__(self, array, args, body):
        self.children = [array, body]
        self.args = args
        self.body = body

    def _bind_types(self, schema):
        self.args[0]._dtype = _elem_type(self.children[0].data_type(schema))
        if len(self.args) > 1:
            self.args[1]._dtype = INT32

    def _results(self, ctx):
        """(array DVal, the body's values and validity as [P, W]
        rectangles, slots mask)."""
        arr = self.children[0].eval_device(ctx)
        lv = arr.data
        scope, inside = self._elements(ctx, lv, arr.validity, True)
        res = self.body.eval_device(scope)
        p, w = lv.values.shape
        return arr, _slot_result(res, self.body.data_type(scope.schema), p,
                                 w), res.validity.reshape(p, w), inside


class ArrayTransform(_OverElements):
    """transform(array, x -> f) / transform(array, (x, i) -> f)."""

    def data_type(self, schema):
        self._bind_types(schema)
        return ArrayType(self.body.data_type(schema))

    def eval_device(self, ctx):
        arr, data, valid, inside = self._results(ctx)
        return DVal(ListVal(data, valid & inside, arr.data.lengths),
                    arr.validity, self.data_type(ctx.schema))


class ArrayFilter(_OverElements):
    """filter(array, x -> p) / filter(array, (x, i) -> p): the elements
    whose predicate is TRUE, in order."""

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def _result_reason(self, schema):
        if self.body.data_type(schema) != BOOL:
            return "ArrayFilter: the lambda must give a boolean"
        return None

    def eval_device(self, ctx):
        arr, data, valid, inside = self._results(ctx)
        lv = arr.data
        keep = data & valid & inside
        vals, ev, lens = compact_slots(lv.values, lv.elem_valid, keep,
                                       lv.values.shape[1])
        return DVal(ListVal(vals, ev, lens), arr.validity,
                    self.data_type(ctx.schema))


class _ArrayPredicate(_OverElements):
    """exists / forall, three-valued over the elements' results."""

    _decides = True              # the value that decides: TRUE for exists

    def data_type(self, schema):
        return BOOL

    def _result_reason(self, schema):
        if self.body.data_type(schema) != BOOL:
            return f"{type(self).__name__}: the lambda must give a boolean"
        return None

    def eval_device(self, ctx):
        arr, data, valid, inside = self._results(ctx)
        decided = ((data == self._decides) & valid & inside).any(dim=1)
        unknown = (~valid & inside).any(dim=1)
        out = decided if self._decides else ~decided
        return DVal(out, arr.validity & (decided | ~unknown), BOOL)


class ArrayExists(_ArrayPredicate):
    """TRUE if a result is TRUE; else NULL if one is NULL; else FALSE."""
    _decides = True


class ArrayForAll(_ArrayPredicate):
    """FALSE if a result is FALSE; else NULL if one is NULL; else TRUE."""
    _decides = False


class ZipWith(_HigherOrder):
    """zip_with(a, b, (x, y) -> f): the shorter list padded with NULLs."""

    _n_lists = 2

    def __init__(self, left, right, args, body):
        self.children = [left, right, body]
        self.args = args
        self.body = body

    def _bind_types(self, schema):
        self.args[0]._dtype = _elem_type(self.children[0].data_type(schema))
        self.args[1]._dtype = _elem_type(self.children[1].data_type(schema))

    def data_type(self, schema):
        self._bind_types(schema)
        return ArrayType(self.body.data_type(schema))

    def eval_device(self, ctx):
        a = self.children[0].eval_device(ctx)
        b = self.children[1].eval_device(ctx)
        w = max(a.data.values.shape[1], b.data.values.shape[1])

        def padded(lv):
            pad = (0, w - lv.values.shape[1])
            return (slot_pad(lv.values, w),
                    torch.nn.functional.pad(lv.elem_valid, pad))
        (av, ae), (bv, be) = padded(a.data), padded(b.data)
        validity = a.validity & b.validity
        lengths = torch.where(validity, torch.maximum(a.data.lengths,
                                                      b.data.lengths), 0)
        p = validity.shape[0]
        inside = torch.arange(w, device=ctx.device)[None, :] \
            < lengths[:, None]
        live = (inside & ctx.row_mask()[:, None]).reshape(-1)
        scope = self._scope(ctx, [
            (self.args[0], _slot_dval(av, ae.reshape(-1),
                                      self.args[0]._dtype)),
            (self.args[1], _slot_dval(bv, be.reshape(-1),
                                      self.args[1]._dtype))], w, p * w, live)
        res = self.body.eval_device(scope)
        return DVal(ListVal(_slot_result(res, self.body.data_type(
                                scope.schema), p, w),
                            res.validity.reshape(p, w) & inside,
                            lengths.to(torch.int32)),
                    validity, self.data_type(ctx.schema))


class ArrayAggregate(_HigherOrder):
    """aggregate(array, zero, (acc, x) -> merge[, acc -> finish])."""

    def __init__(self, array, zero, merge_args, merge_body,
                 finish_args=None, finish_body=None):
        self.children = [array, zero, merge_body] + (
            [finish_body] if finish_body is not None else [])
        self.args = merge_args
        self.body = merge_body
        self.finish_args = finish_args
        self.finish_body = finish_body

    def _bodies(self):
        return [self.body] + ([self.finish_body]
                              if self.finish_body is not None else [])

    def _bound(self):
        return super()._bound() | {a.name for a in self.finish_args or ()}

    def _bind_types(self, schema):
        self.args[0]._dtype = self.children[1].data_type(schema)
        self.args[1]._dtype = _elem_type(self.children[0].data_type(schema))
        if self.finish_args:
            self.finish_args[0]._dtype = self.args[0]._dtype

    def data_type(self, schema):
        self._bind_types(schema)
        if self.finish_body is not None:
            return self.finish_body.data_type(schema)
        return self.children[1].data_type(schema)

    def _result_reason(self, schema):
        zero = self.children[1].data_type(schema)
        merged = self.body.data_type(schema)
        if merged != zero:
            raise TypeError(
                f"aggregate: argument 3 requires {zero.name} type, however "
                f"'{self.body.name_hint}' is of {merged.name} type")
        dt = self.data_type(schema)
        if dt.np_dtype is None:
            return (f"ArrayAggregate: a result of {dt.name} arrives with "
                    f"{NESTED_REST}")
        return None

    def eval_device(self, ctx):
        arr = self.children[0].eval_device(ctx)
        lv = arr.data
        zero = self.children[1].eval_device(ctx)
        acc_t = self.args[0]._dtype
        acc = zero
        rows = ctx.row_mask() & arr.validity
        n = lv.values.shape[0]
        every = torch.arange(n, device=ctx.device)
        for j in range(lv.values.shape[1]):
            step = rows & (lv.lengths > j)
            x = value_dval(slot_pick(lv.values, every,
                                     torch.full_like(every, j)),
                           lv.elem_valid[:, j], self.args[1]._dtype)
            scope = self._scope(ctx, [(self.args[0], acc),
                                      (self.args[1], x)], 1, n, step)
            r = self.body.eval_device(scope)
            acc = DVal(torch.where(step, r.data.to(acc.data.dtype), acc.data),
                       torch.where(step, r.validity, acc.validity), acc_t)
        if self.finish_body is not None:
            acc = self.finish_body.eval_device(self._scope(
                ctx, [(self.finish_args[0], acc)], 1, n, rows))
        return DVal(acc.data, acc.validity & arr.validity,
                    self.data_type(ctx.schema))


class _MapHigherOrder(_HigherOrder):
    """A higher-order function over a map: ``(k, v)`` bound to the keys'
    and the values' slots (module doc)."""

    def __init__(self, m, args, body):
        self.children = [m, body]
        self.args = args
        self.body = body

    def _bind_types(self, schema):
        dt = self.children[0].data_type(schema)
        if isinstance(dt, MapType):
            self.args[0]._dtype = dt.key
            self.args[1]._dtype = dt.value

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def device_unsupported_reason(self, schema):
        self._bind_types(schema)
        dt = self.children[0].data_type(schema)
        if not isinstance(dt, MapType) or not device_map_ok(dt):
            return (f"{type(self).__name__} over {dt.name}: "
                    + (nested_reason(dt) or "expected a map"))
        return self._result_reason(schema)

    def _results(self, ctx):
        """(map DVal, the body's data and validity as [P, W] tensors, the
        slots inside each row)."""
        m = self.children[0].eval_device(ctx)
        keys, vals = m.data
        p, w = keys.values.shape
        inside = in_list(keys)
        live = (inside & (ctx.row_mask() & m.validity)[:, None]).reshape(-1)
        scope = self._scope(ctx, [
            (self.args[0], _slot_dval(keys.values,
                                      keys.elem_valid.reshape(-1),
                                      self.args[0]._dtype)),
            (self.args[1], _slot_dval(vals.values,
                                      vals.elem_valid.reshape(-1),
                                      self.args[1]._dtype))], w, p * w, live)
        res = self.body.eval_device(scope)
        return m, _slot_result(res, self.body.data_type(scope.schema), p,
                               w), res.validity.reshape(p, w), inside, \
            live.reshape(p, w)


class TransformKeys(_MapHigherOrder):
    """transform_keys(map, (k, v) -> f): a NULL new key or a repeated one
    raises (module doc)."""

    def data_type(self, schema):
        self._bind_types(schema)
        return MapType(self.body.data_type(schema),
                       self.children[0].data_type(schema).value)

    def eval_device(self, ctx):
        m, data, valid, inside, live = self._results(ctx)
        check_map_keys(valid, inside, data, live.any(dim=1))
        vals = m.data.values
        return DVal(_map_val(data, vals.values, vals.elem_valid,
                             m.data.keys.lengths),
                    m.validity, self.data_type(ctx.schema))


class TransformValues(_MapHigherOrder):
    """transform_values(map, (k, v) -> f)."""

    def data_type(self, schema):
        self._bind_types(schema)
        return MapType(self.children[0].data_type(schema).key,
                       self.body.data_type(schema))

    def eval_device(self, ctx):
        m, data, valid, inside, _ = self._results(ctx)
        keys = m.data.keys
        return DVal(_map_val(keys.values, data, valid & inside,
                             keys.lengths),
                    m.validity, self.data_type(ctx.schema))


class MapFilter(_MapHigherOrder):
    """map_filter(map, (k, v) -> p): the entries whose predicate is TRUE,
    in order."""

    def _result_reason(self, schema):
        if self.body.data_type(schema) != BOOL:
            return "MapFilter: the lambda must give a boolean"
        return None

    def eval_device(self, ctx):
        m, data, valid, inside, _ = self._results(ctx)
        keys, vals = m.data
        keep = data & valid & inside
        w = keys.values.shape[1]
        k2, _, lens = compact_slots(keys.values, keep, keep, w)
        v2, vev, _ = compact_slots(vals.values, vals.elem_valid, keep, w)
        return DVal(_map_val(k2, v2, vev, lens), m.validity,
                    self.data_type(ctx.schema))
