"""Generators: explode / posexplode (with ``outer``) and stack (port of
``spark_rapids_tpu/exprs/generators.py``).

A generator runs under a Generate exec (exec/generate.py), never in a
projection. Here it runs on the device: ``counts`` gives each input row's
number of output rows, and ``outputs`` the generated columns for the
output rows, each row given by its input row (``rep``) and its place
among that row's outputs (``pos``):

  * ``explode(list)``: a row's elements, flattened out of the rectangle
    by their slots (``outer``: one all-NULL row for a NULL or empty list);
    strings and structs come out as their flat column's rows (a struct
    column for a list of structs);
  * ``explode(map)``: a row's entries as ``key, value`` columns, out of
    the map's two rectangles by the same slots (``posexplode``: ``pos,
    key, value``);
  * ``explode(sequence(a, b[, step]))``: the values ``a + pos * step``
    straight from each row's count, with no rectangle and no width cap;
    INTERSECT ALL / EXCEPT ALL replicate rows by it;
  * ``stack(n, e1, ..., ek)``: n rows of ceil(k / n) columns a row, the
    values taken from the expressions evaluated once over the batch.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..types import (INT32, NESTED_REST, NULLTYPE, ArrayType, DataType,
                     MapType, Schema, StructField, device_list_ok,
                     device_map_ok, nested_reason)
from ..columnar.nested import slot_pick
from .base import DVal, Expression, MapVal, Unsupported
from .collection_fns import Sequence, sequence_counts, sequence_error

__all__ = ["Generator", "Explode", "PosExplode", "Stack"]


class Generator(Expression):
    """An expression giving 0..n output rows an input row; planned as a
    Generate node (Spark's ExtractGenerator), not projected."""

    #: one all-NULL output row for a NULL or empty input (``*_outer``)
    outer: bool = False

    def generator_output(self, schema: Schema) -> List[StructField]:
        raise NotImplementedError

    def data_type(self, schema: Schema) -> DataType:
        return self.generator_output(schema)[0].dtype

    def counts(self, ctx):
        """(int64 counts[P], 0 on padding rows; int64 count of rows that
        raise, a tensor; state for ``outputs``)."""
        raise NotImplementedError

    def outputs(self, state, rep: torch.Tensor,
                pos: torch.Tensor) -> List[DVal]:
        raise NotImplementedError

    def error(self) -> Exception:
        raise NotImplementedError


class Explode(Generator):
    """explode(array) -> ``col`` (ref ``Explode``)."""

    def __init__(self, child: Expression, outer: bool = False):
        self.children = [child]
        self.outer = outer

    def _sequence(self) -> Optional[Sequence]:
        c = self.children[0]
        return c if isinstance(c, Sequence) else None

    def generator_output(self, schema: Schema) -> List[StructField]:
        dt = self.children[0].data_type(schema)
        if isinstance(dt, MapType):
            return [StructField("key", dt.key, True),
                    StructField("value", dt.value, True)]
        if not isinstance(dt, ArrayType):
            raise Unsupported(f"explode requires an array or a map, got {dt}")
        return [StructField("col", dt.element, True)]

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        dt = self.children[0].data_type(schema)
        if isinstance(dt, MapType) and device_map_ok(dt):
            return None
        if isinstance(dt, MapType) or not device_list_ok(dt):
            return (f"{type(self).__name__} of {dt.name}: "
                    + (nested_reason(dt) or f"arrives with {NESTED_REST}"))
        return None

    def fully_device_supported(self, schema: Schema) -> Optional[str]:
        seq = self._sequence()
        if seq is None:
            return super().fully_device_supported(schema)
        # the sequence is never built: its arguments are what run
        r = self.device_unsupported_reason(schema) or \
            seq.device_unsupported_reason(schema)
        if r:
            return r
        for c in seq.children:
            r = c.fully_device_supported(schema)
            if r:
                return r
        return None

    def counts(self, ctx):
        seq = self._sequence()
        live = ctx.row_mask()
        if seq is not None:
            start, step, count, valid, bad = sequence_counts(ctx,
                                                             seq.children)
            state = ("seq", start, step, count)
            n_bad = bad.sum()
        else:
            v = self.children[0].eval_device(ctx)
            lv = v.data.keys if isinstance(v.data, MapVal) else v.data
            count = torch.where(v.validity & live, lv.lengths, 0) \
                .to(torch.int64)
            state = ("list", v.data, count)
            n_bad = torch.zeros((), dtype=torch.int64, device=count.device)
        if self.outer:
            count = torch.where(live & (count == 0), 1, count)
        return count, n_bad, state

    def error(self) -> Exception:
        return sequence_error(self._sequence().children)

    def _element(self, state, rep, pos):
        """(the output rows' values: the element, or a map's key and
        value; which rows hold one)."""
        if state[0] == "seq":
            _, start, step, count = state
            inside = pos < count[rep]
            return [DVal(start[rep] + pos * step[rep], inside, None)], \
                inside
        _, val, count = state
        inside = pos < count[rep]
        lvs = val if isinstance(val, MapVal) else [val]
        j = pos.clamp(0, lvs[0].values.shape[1] - 1)
        return [DVal(slot_pick(lv.values, rep, j),
                     lv.elem_valid[rep, j] & inside, None)
                for lv in lvs], inside

    def outputs(self, state, rep, pos) -> List[DVal]:
        return self._element(state, rep, pos)[0]

    def key(self):
        return f"Explode({self.children[0].key()},outer={self.outer})"

    @property
    def name_hint(self):
        return "col"


class PosExplode(Explode):
    """posexplode: a 0-based ``pos`` column before ``col``."""

    def generator_output(self, schema: Schema) -> List[StructField]:
        return [StructField("pos", INT32, True)] \
            + super().generator_output(schema)

    def outputs(self, state, rep, pos) -> List[DVal]:
        vals, inside = self._element(state, rep, pos)
        return [DVal(pos.to(torch.int32), inside, INT32)] + vals

    def key(self):
        return f"PosExplode({self.children[0].key()},outer={self.outer})"


class Stack(Generator):
    """stack(n, e1, ..., ek): n rows of ceil(k / n) columns an input row,
    the missing values of the last row NULL; a column's values must share
    the type of its first (NULL literals aside), as Spark requires."""

    def __init__(self, n: int, *exprs: Expression):
        if int(n) <= 0:
            raise Unsupported("stack: n must be a positive literal")
        if not exprs:
            raise Unsupported("stack requires at least one value expression")
        self.n = int(n)
        self.children = list(exprs)

    @property
    def width(self) -> int:
        return -(-len(self.children) // self.n)

    def _column(self, c: int) -> list:
        return [self.children[r * self.width + c] for r in range(self.n)
                if r * self.width + c < len(self.children)]

    def generator_output(self, schema: Schema) -> List[StructField]:
        return [StructField(f"col{c}", self.children[c].data_type(schema),
                            True) for c in range(self.width)]

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        for c, f in enumerate(self.generator_output(schema)):
            if f.dtype.np_dtype is None:
                return (f"stack of {f.dtype.name} values arrives with "
                        f"{NESTED_REST}")
            for e in self._column(c):
                dt = e.data_type(schema)
                if dt != f.dtype and dt != NULLTYPE:
                    raise TypeError(
                        f"stack: the values of column {c} must share one "
                        f"type, not {f.dtype.name} and {dt.name}")
        return None

    def counts(self, ctx):
        count = torch.where(ctx.row_mask(), self.n, 0).to(torch.int64)
        vals = [e.eval_device(ctx) for e in self.children]
        return count, torch.zeros((), dtype=torch.int64,
                                  device=count.device), vals

    def outputs(self, vals, rep, pos) -> List[DVal]:
        out = []
        w, p = self.width, vals[0].validity.shape[0]
        for c in range(w):
            tdt = vals[c].data.dtype
            data = torch.zeros((p, self.n), dtype=tdt, device=rep.device)
            valid = torch.zeros((p, self.n), dtype=torch.bool,
                                device=rep.device)
            for r in range(self.n):
                k = r * w + c
                if k < len(vals):
                    data[:, r] = vals[k].data.to(tdt)
                    valid[:, r] = vals[k].validity
            out.append(DVal(data[rep, pos], valid[rep, pos], None))
        return out

    def key(self):
        return f"Stack({self.n},{','.join(c.key() for c in self.children)})"
