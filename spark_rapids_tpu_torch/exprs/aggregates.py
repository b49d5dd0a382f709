"""Aggregate functions (port of ``spark_rapids_tpu/exprs/aggregates.py``:
Sum, Count, CountStar, Average, Min, Max, First, Last, the moment
aggregates VariancePop, VarianceSamp, StddevPop and StddevSamp, and
CollectList, CollectSet, MinBy, MaxBy, Percentile and
ApproximatePercentile, keyless and keyed).

Each aggregate declares
  update   : per-row values  -> partials     (per batch)
  merge    : partials        -> partials     (across batches)
  finalize : partials        -> result
with Spark's null semantics: sum/avg ignore nulls and are null over no
rows; count is never null.

Every update here reduces to ``_seg_sum``: per group, the sum of a
column over its valid live rows and the count of those rows. So each
aggregate names those columns (``sum_inputs``) and builds its partials
from their (sum, count) pairs (``from_sums``). ``update`` reduces them
over a segment context (columnar/segmented.py); the dense groupby path
reduces every aggregate's columns in one kernel launch and hands each
aggregate its pairs (exec/aggregate.py).

The moment aggregates are sums too, of their values less a shift ``c``
per group (``shifted_inputs``): per group the count and the sums of
``x - c`` and of its square. On the sort and keyless routes ``c`` is the
group's first finite value (``first_finite``); on the dense route it is
the group's mean from a first kernel launch (``group_shift``), and a
second launch sums the shifted values (exec/aggregate.py). No scatter
runs. A partial is (count, shifted sum, shifted sum of squares, shift);
the merge moves each of a group's partials to one shift near their mean
(``s + n*d``, ``q + d*(2*s + n*d)``, ``d`` a difference of two nearby
doubles, so exact) before it adds them. The finalize takes
``m2 = q - s*s/n``, which does not cancel as the reference's
``s2 - n*mean^2`` does for a group far from zero (``var_pop`` of 1e9+1,
1e9+2, 1e9+3 is 2/3, as in Spark, whatever the other groups hold). The
sample forms are NULL for n <= 1; m2 is clamped at 0 before ``sqrt``.

Min, Max, First and Last are no sums (``dense_ok`` False): an aggregate
holding one takes the sort path. Min and Max follow Spark's float order
(NaN greatest, -0.0 equal to 0.0, both come out canonical). First and
Last pick the value of the first or last row in input order, over the
valid rows with ``ignore_nulls`` (the reference's only form and the
default here) or over every row without it; their partial keeps the
row's position in the input, so partials merge in any order.

CollectList and CollectSet build a list rectangle a group
(``segment_lists``; a string's or a struct's values as ``Slots`` of
their column's rows) and concatenate a group's lists when they merge;
MinBy and MaxBy keep the extreme ordering, its value and its row's
position; Percentile's partial is the count of values, and the exec
orders the values themselves (exec/aggregate.py). The reference runs
these on its host engine only (``_HostOnlyAgg``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.segmented import seg_max, seg_min, select_by_rank
from ..types import (ArrayType, DataType, DecimalType, FLOAT64, INT64,
                     NESTED_REST, STRING, Schema, adjust_precision_scale,
                     numeric)
from .base import ColumnRef, DVal, Expression, ListVal, Literal, StructVal
from .decimal_arith import DEC_LIMB

__all__ = ["AggregateExpression", "Sum", "Count", "CountStar", "Average",
           "Min", "Max", "First", "Last", "VariancePop", "VarianceSamp",
           "StddevPop", "StddevSamp", "CollectList", "CollectSet", "MinBy",
           "MaxBy", "Percentile", "ApproximatePercentile", "segment_lists",
           "distinct_elements"]

#: a column to reduce: (data or None, validity or None). No data: only
#: the count is needed. No validity: every live row counts.
SumInput = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _seg_sum(data, valid, seg):
    """(sum of the valid live values, count of them) per segment of
    ``seg``; the sum is None when ``data`` is."""
    if valid is None:
        valid = seg.live
    s = None if data is None else seg.sum(data, valid)
    return s, seg.count(valid)


class AggregateExpression:
    """Not an Expression: it appears only in Aggregate nodes."""

    #: its update is sums and counts (``sum_inputs``/``from_sums``), so the
    #: dense groupby kernel can compute it
    dense_ok = True
    #: the DISTINCT modifier (``agg(DISTINCT e)``): the planner rewrites
    #: it away (plan/rewrites.py) before any exec sees it
    distinct: bool = False
    #: its update reads a string input's values (its column), not only
    #: their validity
    reads_strings: bool = False

    def __init__(self, child: Optional[Expression],
                 name: Optional[str] = None):
        self.child = child
        self._name = name

    def as_distinct(self) -> "AggregateExpression":
        self.distinct = True
        return self

    @property
    def name_hint(self) -> str:
        if self._name:
            return self._name
        cn = self.child.name_hint if self.child is not None else "*"
        d = "DISTINCT " if self.distinct else ""
        return f"{type(self).__name__.lower()}({d}{cn})"

    def with_name(self, name: str) -> "AggregateExpression":
        self._name = name
        return self

    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        if self.child is None:
            return None
        r = self.child.fully_device_supported(schema)
        if r:
            return r
        dt = self.child.data_type(schema)
        if not dt.device_backed:
            return f"{self.name_hint}: input type {dt.name} is host-only"
        return None

    def input_exprs(self) -> List[Expression]:
        return [self.child] if self.child is not None else []

    def partial_types(self, schema: Schema) -> List[DataType]:
        raise NotImplementedError

    def sum_inputs(self, vals: List[DVal]) -> List[SumInput]:
        """The columns whose per-group (sum, count) the update needs."""
        raise NotImplementedError

    def shifted_inputs(self, vals: List[DVal]) -> List[SumInput]:
        """The columns whose per-group sums of ``x - c`` and of its
        square, ``c`` a shift per group, the update needs too; the moment
        aggregates'."""
        return []

    def from_sums(self, sums: list, shifted: Sequence = ()) -> list:
        """(sum, count) per column of ``sum_inputs``, and (shift, sum of
        ``x - shift``, sum of its square) per column of
        ``shifted_inputs`` -> list of (data, validity) partials."""
        raise NotImplementedError

    def update(self, vals: List[DVal], seg):
        """per-row DVals -> list of (data, validity) partials over the
        segments of ``seg`` (its live rows)."""
        sums = [_seg_sum(d, v, seg) for d, v in self.sum_inputs(vals)]
        shifted = []
        for d, v in self.shifted_inputs(vals):
            c = first_finite(d, v, seg)
            x, x2 = less_shift(d, c, seg.seg_ids)
            shifted.append((c, _seg_sum(x, v, seg)[0],
                            _seg_sum(x2, v, seg)[0]))
        return self.from_sums(sums, shifted)

    def merge(self, partials: List[DVal], seg):
        raise NotImplementedError

    def finalize(self, partials: List[DVal]) -> DVal:
        raise NotImplementedError

    def key(self) -> str:
        c = self.child.key() if self.child is not None else "*"
        d = "DISTINCT " if self.distinct else ""
        return f"{type(self).__name__}({d}{c})"


#: a decimal's value as a batch's sums take it: two int64 limbs, ``x mod
#: 10^9`` in [0, 10^9) and ``floor(x / 10^9)``, below 9.3e9 in magnitude.
#: Each limb's sum fits int64 over the widest batch the port makes (q9's
#: keyless batch of 28.8 M rows: 28.8e6 * 9.3e9 < 2^63), so the dense
#: kernel adds them exactly as int64 columns
IN_LIMB = 10 ** 9
#: a decimal SUM's partials are three normalized limbs in base DEC_LIMB
#: (l0, l1 in [0, 10^12), l2 signed), the reference's (aggregates.py:172);
#: they merge as int64 sums and normalize


def decimal_limbs(v: DVal) -> List[SumInput]:
    """A decimal value's two summed limbs (``IN_LIMB``)."""
    hi = torch.div(v.data, IN_LIMB, rounding_mode="floor")
    return [(v.data - hi * IN_LIMB, v.validity), (hi, v.validity)]


def dec_normalize(l0, l1, l2):
    """Limb sums carried back into canonical form (l0, l1 in [0, 10^12),
    the sign carried by l2), as the reference's ``_dec_normalize``."""
    c = torch.div(l0, DEC_LIMB, rounding_mode="floor")
    l0, l1 = l0 - c * DEC_LIMB, l1 + c
    c = torch.div(l1, DEC_LIMB, rounding_mode="floor")
    return l0, l1 - c * DEC_LIMB, l2 + c


def limbs_of_sums(s0: torch.Tensor, s1: torch.Tensor):
    """The total ``s1 * 10^9 + s0`` of the summed limbs as the three
    partial limbs: ``s1 = 1000 a + b`` gives ``a * 10^12 + (b * 10^9 +
    s0)``, each part within int64."""
    a = torch.div(s1, 1000, rounding_mode="floor")
    return dec_normalize((s1 - a * 1000) * IN_LIMB + s0, a,
                         torch.zeros_like(a))


def _merge_limbs(partials, seg):
    sums = [_seg_sum(p.data, p.validity, seg)[0] for p in partials[:3]]
    return dec_normalize(*sums)


def _limb_total(l0, l1, l2, precision: int):
    """(the int64 total of three partial limbs, whether it fits int64 and
    ``precision`` digits): exact bounds, no float."""
    # a total within int64 has l2 of -1 or 0
    small = torch.abs(l2) <= 1
    hi = torch.where(small, l2, 0) * DEC_LIMB + l1
    top = 9223372
    fits = small & ((hi.abs() < top) | ((hi == top) & (l0 <= 36854775807))
                    | (hi == -top)
                    | ((hi == -top - 1) & (l0 >= 963145224192)))
    total = torch.where(fits, hi, 0) * DEC_LIMB + torch.where(fits, l0, 0)
    if precision < 19:
        fits = fits & (total.abs() < 10 ** precision)
    return torch.where(fits, total, 0), fits


def _sum_type(dt: DecimalType) -> DecimalType:
    """Spark's SUM of a decimal: decimal(min(p + 10, 38), s)."""
    return DecimalType(min(dt.precision + 10, 38), dt.scale)


class Sum(AggregateExpression):
    """sum(x); a decimal's is exact (module doc of ``IN_LIMB``), its total
    NULL where it passes int64 or its result precision, as the
    reference's (aggregates.py:191)."""

    def data_type(self, schema):
        dt = self.child.data_type(schema)
        if dt.name in ("tinyint", "smallint", "int", "bigint"):
            return INT64
        if isinstance(dt, DecimalType):
            return _sum_type(dt)
        return FLOAT64 if dt.name in ("float", "double") else dt

    def partial_types(self, schema):
        dt = self.child.data_type(schema)
        if isinstance(dt, DecimalType):
            # the top limb carries the input's type, which finalize reads
            return [INT64, INT64, dt]
        return [self.data_type(schema)]

    def sum_inputs(self, vals):
        v = vals[0]
        if isinstance(v.dtype, DecimalType):
            return decimal_limbs(v)
        acc = torch.int64 if not v.data.is_floating_point() \
            else torch.float64
        return [(v.data.to(acc), v.validity)]

    def from_sums(self, sums, shifted=()):
        if len(sums) == 2:
            (s0, cnt), (s1, _) = sums
            ok = cnt > 0
            return [(x, ok) for x in limbs_of_sums(s0, s1)]
        s, cnt = sums[0]
        return [(s, cnt > 0)]

    def merge(self, partials, seg):
        if len(partials) == 3:
            _, cnt = _seg_sum(None, partials[0].validity, seg)
            ok = cnt > 0
            return [(x, ok) for x in _merge_limbs(partials, seg)]
        p = partials[0]
        s, cnt = _seg_sum(p.data, p.validity, seg)
        return [(s, cnt > 0)]

    def finalize(self, partials):
        if len(partials) == 3:
            out = _sum_type(partials[2].dtype)
            total, fits = _limb_total(*(p.data for p in partials),
                                      out.precision)
            return DVal(total, partials[0].validity & fits, out)
        return partials[0]


class Count(AggregateExpression):
    def data_type(self, schema):
        return INT64

    def device_unsupported_reason(self, schema):
        # count(<string column>) reads only the validity, which every
        # string layout holds on the device (a string field of a struct
        # too)
        if self.child is not None \
                and self.child.data_type(schema) == STRING and (
                isinstance(self.child, ColumnRef)
                or self.child.fully_device_supported(schema) is None):
            return None
        return super().device_unsupported_reason(schema)

    def partial_types(self, schema):
        return [INT64]

    def sum_inputs(self, vals):
        return [(None, vals[0].validity)]

    def from_sums(self, sums, shifted=()):
        cnt = sums[0][1]
        return [(cnt, torch.ones_like(cnt, dtype=torch.bool))]

    def merge(self, partials, seg):
        p = partials[0]
        s, _ = _seg_sum(p.data, p.validity, seg)
        return [(s, torch.ones_like(s, dtype=torch.bool))]

    def finalize(self, partials):
        p = partials[0]
        return DVal(torch.where(p.validity, p.data, torch.zeros_like(p.data)),
                    torch.ones_like(p.validity), INT64)


class CountStar(Count):
    def __init__(self, name: Optional[str] = None):
        super().__init__(None, name)

    @property
    def name_hint(self):
        return self._name or "count(1)"

    def input_exprs(self):
        return [Literal(1)]

    def sum_inputs(self, vals):
        return [(None, None)]


def average_type(dt: DecimalType) -> DecimalType:
    """Spark's AVG of a decimal: decimal(min(p + 4, 38), min(s + 4, 38))."""
    return DecimalType(min(dt.precision + 4, 38), min(dt.scale + 4, 38))


def average_division(dt: DecimalType) -> DecimalType:
    """The type of Spark's Divide inside AVG of a decimal: the SUM's type
    over the count as decimal(20,0), with precision loss allowed."""
    st = _sum_type(dt)
    scale = max(6, st.scale + 20 + 1)
    return adjust_precision_scale(st.precision - st.scale + scale, scale)


class Average(AggregateExpression):
    """avg(x): a double, or for a decimal Spark's decimal average, its
    exact total over the count (``decimal_arith``'s ``avg``)."""

    def data_type(self, schema):
        dt = self.child.data_type(schema)
        if isinstance(dt, DecimalType):
            return average_type(dt)
        return FLOAT64

    def partial_types(self, schema):
        dt = self.child.data_type(schema)
        if isinstance(dt, DecimalType):
            return [INT64, INT64, dt, INT64]     # limbs (Sum's), count
        return [FLOAT64, INT64]      # sum, count

    def sum_inputs(self, vals):
        v = vals[0]
        if isinstance(v.dtype, DecimalType):
            return decimal_limbs(v)
        return [(v.data.to(torch.float64), v.validity)]

    def from_sums(self, sums, shifted=()):
        ones = torch.ones_like(sums[0][1], dtype=torch.bool)
        if len(sums) == 2:
            (s0, cnt), (s1, _) = sums
            return [(x, cnt > 0) for x in limbs_of_sums(s0, s1)] \
                + [(cnt, ones)]
        s, cnt = sums[0]
        return [(s, cnt > 0), (cnt, ones)]

    def merge(self, partials, seg):
        c, _ = _seg_sum(partials[-1].data, partials[-1].validity, seg)
        ones = torch.ones_like(c, dtype=torch.bool)
        if len(partials) == 4:
            return [(x, c > 0) for x in _merge_limbs(partials, seg)] \
                + [(c, ones)]
        s, _ = _seg_sum(partials[0].data, partials[0].validity, seg)
        return [(s, c > 0), (c, ones)]

    def finalize(self, partials):
        if len(partials) == 4:
            from . import decimal_arith as DA
            dt = partials[2].dtype
            div, out = average_division(dt), average_type(dt)
            c = partials[3].data
            data, ok = DA.avg(partials[0].data, partials[1].data,
                              partials[2].data, c,
                              partials[0].validity & (c > 0),
                              e=div.scale - dt.scale, t=38 - div.scale,
                              m=div.scale - out.scale, p=out.precision)
            return DVal(data, ok, out)
        s, c = partials[0], partials[1]
        ok = torch.logical_and(s.validity, c.data > 0)
        denom = torch.where(c.data > 0, c.data, torch.ones_like(c.data))
        return DVal(s.data / denom.to(torch.float64), ok, FLOAT64)


class Min(AggregateExpression):
    dense_ok = False
    _reduce = staticmethod(seg_min)

    def data_type(self, schema):
        return self.child.data_type(schema)

    def partial_types(self, schema):
        return [self.data_type(schema)]

    def _extreme(self, v: DVal, seg):
        return [(self._reduce(v.data, v.validity, seg),
                 seg.count(v.validity) > 0)]

    def update(self, vals, seg):
        return self._extreme(vals[0], seg)

    def merge(self, partials, seg):
        return self._extreme(partials[0], seg)

    def finalize(self, partials):
        return partials[0]


class Max(Min):
    _reduce = staticmethod(seg_max)


def _take(data: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    if not data.shape[0]:
        return torch.zeros(rows.shape, dtype=data.dtype, device=data.device)
    return data[rows]


class First(AggregateExpression):
    """first(x, ignoreNulls): partials (value, position in the input)."""

    dense_ok = False
    mode = "min"

    def __init__(self, child, ignore_nulls: bool = True,
                 name: Optional[str] = None):
        super().__init__(child, name)
        self.ignore_nulls = ignore_nulls

    def data_type(self, schema):
        return self.child.data_type(schema)

    def partial_types(self, schema):
        return [self.data_type(schema), INT64]

    def _select(self, data, valid, rank, ok, seg):
        rows, has = select_by_rank(rank, ok, seg, self.mode)
        return [(_take(data, rows), torch.logical_and(_take(valid, rows),
                                                      has)),
                (_take(rank, rows), has)]

    def update(self, vals, seg):
        v = vals[0]
        ok = v.validity if self.ignore_nulls \
            else torch.ones_like(v.validity)
        return self._select(v.data, v.validity, seg.orig_index, ok, seg)

    def merge(self, partials, seg):
        val, pos = partials
        return self._select(val.data, val.validity, pos.data, pos.validity,
                            seg)

    def finalize(self, partials):
        return partials[0]

    def key(self):
        return f"{super().key()}[ignoreNulls={self.ignore_nulls}]"


class Last(First):
    mode = "max"


def group_shift(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The mean ``s / n`` per group, 0 where there are no rows or it is
    not finite."""
    mean = s / torch.clamp(n, min=1).to(torch.float64)
    return torch.where(torch.isfinite(mean), mean, torch.zeros_like(mean))


def first_finite(data: torch.Tensor, valid: torch.Tensor, seg):
    """Per segment of ``seg``, ``data`` at its first live row where it is
    valid and finite, 0 where there is none."""
    rows, has = seg.first(torch.logical_and(valid, torch.isfinite(data)))
    return torch.where(has, _take(data, rows), torch.zeros_like(
        rows, dtype=data.dtype))


def less_shift(data: torch.Tensor, shift: torch.Tensor, ids: torch.Tensor):
    """(``data`` less its group's ``shift``, its square) per row (``ids``:
    each row's group; a row outside every group takes the last)."""
    G = shift.shape[0]
    d = data - shift[ids.clamp(0, G - 1)] if G else data
    return d, d * d


def _per_row(per_group: torch.Tensor, seg) -> torch.Tensor:
    """A per-segment value at every row of ``seg``."""
    G = per_group.shape[0]
    if not G:
        return torch.zeros(seg.live.shape, dtype=per_group.dtype,
                           device=per_group.device)
    return per_group[seg.seg_ids.clamp(0, G - 1)]


class _MomentAgg(AggregateExpression):
    """variance/stddev: partials (count, shifted sum, shifted sum of
    squares, shift) per group (module doc)."""

    def data_type(self, schema):
        return FLOAT64

    def device_unsupported_reason(self, schema):
        r = numeric.reason_not_supported(self.child.data_type(schema))
        if r:
            return f"{self.name_hint}: input {r}"
        return super().device_unsupported_reason(schema)

    def partial_types(self, schema):
        return [INT64, FLOAT64, FLOAT64, FLOAT64]

    def sum_inputs(self, vals):
        return [(None, vals[0].validity)]

    def shifted_inputs(self, vals):
        v = vals[0]
        return [(v.data.to(torch.float64), v.validity)]

    def from_sums(self, sums, shifted=()):
        (_, n), = sums
        c, s, q = shifted[0]
        ones = torch.ones_like(n, dtype=torch.bool)
        return [(n, ones), (s, ones), (q, ones), (c, ones)]

    def merge(self, partials, seg):
        """Each of a group's partials moved to one shift, the group's
        mean (rounded), then added."""
        n, s, q, c = (p.data for p in partials)
        valid = partials[0].validity
        has = n > 0
        nf = n.to(torch.float64)
        zero = torch.zeros((), dtype=torch.float64, device=nf.device)
        N, _ = _seg_sum(n, valid, seg)
        T, _ = _seg_sum(torch.where(has, nf * c + s, zero), valid, seg)
        target = group_shift(T, N)
        d = c - _per_row(target, seg)
        s2 = torch.where(has, s + nf * d, zero)
        q2 = torch.where(has, q + d * (2.0 * s + nf * d), zero)
        out = [N, _seg_sum(s2, valid, seg)[0], _seg_sum(q2, valid, seg)[0],
               target]
        return [(x, torch.ones_like(x, dtype=torch.bool)) for x in out]

    def _variance(self, partials, ddof: int) -> DVal:
        n = partials[0].data.to(torch.float64)
        s, q = partials[1].data, partials[2].data
        m2 = q - s * s / torch.where(n > 0, n, torch.ones_like(n))
        ok = n > ddof
        out = m2 / torch.where(ok, n - ddof, torch.ones_like(n))
        return DVal(torch.clamp(out, min=0.0), ok, FLOAT64)


class VariancePop(_MomentAgg):
    def finalize(self, partials):
        return self._variance(partials, 0)


class VarianceSamp(_MomentAgg):
    def finalize(self, partials):
        # n <= 1 is NULL (Spark 3.1+, SPARK-33726)
        return self._variance(partials, 1)


class StddevPop(_MomentAgg):
    def finalize(self, partials):
        v = self._variance(partials, 0)
        return DVal(torch.sqrt(v.data), v.validity, FLOAT64)


class StddevSamp(_MomentAgg):
    def finalize(self, partials):
        v = self._variance(partials, 1)
        return DVal(torch.sqrt(v.data), v.validity, FLOAT64)


# ---------------------------------------------------------------------------
# collect_list / collect_set, min_by / max_by, percentile
# ---------------------------------------------------------------------------

def _nested_agg_reason(agg, e: Expression, schema: Schema, what: str,
                       structs: bool = False) -> Optional[str]:
    """Why a collected (or min_by/max_by) value has no device form: it
    must be fixed-width or a string (or, with ``structs``, a struct of
    such fields); lists arrive with the queue."""
    from ..types import NESTED_REST, StructType, device_list_ok
    from .collection_fns import string_arg_reason
    dt = e.data_type(schema)
    if dt == STRING:
        r = string_arg_reason(e, schema)
        return f"{agg.name_hint}: {r}" if r else None
    if dt.np_dtype is None and not (
            structs and isinstance(dt, StructType)
            and device_list_ok(ArrayType(dt))):
        return (f"{agg.name_hint}: {what} of {dt.name} arrives with "
                f"{NESTED_REST}")
    return e.fully_device_supported(schema)


def _slots_of(v: DVal):
    """A collected value's rows as a [N, 1] rectangle: a tensor, or the
    ``Slots`` of its column (a string's, a struct's)."""
    from ..columnar.nested import Slots
    if v.column is not None or isinstance(v.data, StructVal):
        from .compiler import dval_column
        col = v.column if v.column is not None else \
            dval_column(v, v.validity, v.dtype)
        return Slots(col, 1)
    return v.data[:, None]


def segment_lists(values, lens: torch.Tensor,
                  ids: torch.Tensor, G: int, what: str) -> ListVal:
    """Per segment, the first ``lens[r]`` slots of every row ``r`` of
    ``values`` ([N, Wi]: a tensor, or ``Slots`` of strings or structs)
    whose segment ``ids[r]`` it is, in row order, as a list rectangle
    [G, W]. A segment's rows are contiguous and the segments in order
    (rows sorted by group, or one segment); a row that adds nothing has
    ``lens`` 0. One host read: the longest list, which past the
    rectangle's widest bucket raises (the lists are never truncated)."""
    from ..columnar.nested import (WIDTH_BUCKETS, Slots, null_rows,
                                   take_rows, width_bucket, zero_rows)
    from ..types import NESTED_REST
    dev = lens.device
    lens = lens.to(torch.int64)
    ids = torch.where(lens > 0, ids, G).to(torch.int64)
    total = torch.zeros(G + 1, dtype=torch.int64, device=dev) \
        .scatter_add_(0, ids, lens)[:G]
    longest = int(total.max().item()) if G else 0
    w = width_bucket(max(longest, 1))
    if w is None:
        raise NotImplementedError(
            f"{what}: a group of {longest} values is longer than the device "
            f"list rectangle ({WIDTH_BUCKETS[-1]}); such groups arrive with "
            f"{NESTED_REST}")
    before = torch.cumsum(total, 0) - total
    first = torch.cumsum(lens, 0) - lens \
        - torch.cat([before, before.new_zeros(1)])[ids]
    wi = values.shape[1]
    j = torch.arange(wi, device=dev)[None, :]
    col = torch.where(j < lens[:, None], first[:, None] + j, w)
    row = ids[:, None].expand(-1, wi)
    flat = (row * (w + 1) + col).reshape(-1)
    shape = (G + 1, w + 1)
    if isinstance(values, Slots):
        src = torch.full(((G + 1) * (w + 1),), -1, dtype=torch.int64,
                         device=dev)
        src[flat] = torch.arange(flat.shape[0], device=dev)
        src = src.reshape(shape)[:G, :w].reshape(-1)
        ok = src >= 0
        got = take_rows(values.col, src.clamp(min=0)) if flat.shape[0] \
            else zero_rows(values.col, G * w)
        return ListVal(Slots(null_rows(got, ok), w), ok.reshape(G, w),
                       total.to(torch.int32))
    out = torch.zeros((G + 1) * (w + 1), dtype=values.dtype, device=dev)
    ev = torch.zeros((G + 1) * (w + 1), dtype=torch.bool, device=dev)
    out[flat] = values.reshape(-1)
    ev[flat] = (j < lens[:, None]).reshape(-1)
    return ListVal(out.reshape(shape)[:G, :w], ev.reshape(shape)[:G, :w],
                   total.to(torch.int32))


def distinct_elements(lv: ListVal) -> ListVal:
    """Each row's elements with every repeat after the first dropped,
    the first occurrences in their order; equal as Spark's ordering has
    it (NaN equal to NaN, -0.0 to 0.0; strings by their bytes)."""
    from ..columnar.nested import slot_key
    from .collection_fns import compact_slots, distinct_keep, in_list
    inside = in_list(lv) & lv.elem_valid
    keep = distinct_keep(slot_key(lv.values), inside, inside)
    return ListVal(*compact_slots(lv.values, lv.elem_valid, keep,
                                  lv.values.shape[1]))


class CollectList(AggregateExpression):
    """collect_list(e): a group's non-NULL values in arrival order, an
    empty list where it has none. The partial is a list a group (a list
    rectangle, ``segment_lists``: a string's or a struct's as ``Slots``,
    their columns' rows gathered); the merge concatenates a group's
    partials in order (dictionaries merged, byte rectangles widened, as
    their batches concatenate). A group past the rectangle's 256 values
    raises at its batch, naming the queue: a list is never cut short."""

    dense_ok = False
    reads_strings = True
    _distinct = False

    def data_type(self, schema: Schema) -> DataType:
        return ArrayType(self.child.data_type(schema))

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        dt = self.child.data_type(schema)
        if isinstance(dt, DecimalType):
            return (f"{self.name_hint}: a list of {dt.name} arrives with "
                    f"{NESTED_REST}")
        return _nested_agg_reason(self, self.child, schema, "a list",
                                  structs=not self._distinct)

    def partial_types(self, schema):
        return [self.data_type(schema)]

    def _lists(self, values, lens, seg):
        lv = segment_lists(values, lens, seg.seg_ids, seg.num_segments,
                           self.name_hint)
        if self._distinct:
            lv = distinct_elements(lv)
        return [(lv, torch.ones(seg.num_segments, dtype=torch.bool,
                                device=lv.lengths.device))]

    def update(self, vals, seg):
        v = vals[0]
        ok = v.validity & seg.live
        return self._lists(_slots_of(v), ok.to(torch.int64), seg)

    def merge(self, partials, seg):
        p = partials[0]
        ok = p.validity & seg.live
        lv = p.data
        return self._lists(lv.values, torch.where(ok, lv.lengths, 0), seg)

    def finalize(self, partials):
        return partials[0]


class CollectSet(CollectList):
    """collect_set(e): a group's distinct non-NULL values (the first of
    each, in arrival order; Spark leaves the order unspecified), equal as
    Spark's ordering has it: NaN equal to NaN, -0.0 to 0.0. Each partial
    is de-duplicated after its update and after every merge."""

    _distinct = True


def _order_key(v: DVal) -> torch.Tensor:
    """An ordering's key, Spark's order: a number's, a string's rank among
    the batch's values (``flat_key``)."""
    from .collection_fns import element_key
    if v.column is not None:
        from ..columnar.nested import flat_key
        return flat_key(v.column)
    return element_key(v.data)


def _take_value(v: DVal, rows: torch.Tensor):
    """``v``'s rows ``rows``: a tensor, or a string's column."""
    if v.column is None:
        return _take(v.data, rows)
    from ..columnar.nested import take_rows, zero_rows
    if not v.column.padded_len:
        return zero_rows(v.column, rows.shape[0])
    return take_rows(v.column, rows)


class MinBy(AggregateExpression):
    """min_by(value, ordering): the value of the row whose ordering is
    least by Spark's ordering (NaN greatest, -0.0 equal to 0.0; strings
    by their bytes), NULL orderings skipped; the first such row in
    arrival order where several tie; NULL where the value there is NULL
    or no ordering is valid. The partials are (value, ordering, the
    row's position in the input); a string's partial is its column's
    rows."""

    dense_ok = False
    reads_strings = True
    mode = "min"

    def __init__(self, child, ordering, name: Optional[str] = None):
        super().__init__(child, name)
        self.ordering = ordering

    def data_type(self, schema):
        return self.child.data_type(schema)

    def device_unsupported_reason(self, schema):
        for e, what in ((self.child, "a value"),
                        (self.ordering, "an ordering")):
            r = _nested_agg_reason(self, e, schema, what)
            if r:
                return r
        return None

    def input_exprs(self):
        return [self.child, self.ordering]

    def partial_types(self, schema):
        return [self.data_type(schema), self.ordering.data_type(schema),
                INT64]

    def _pick(self, value: DVal, order: DVal, rank, ok, seg):
        key = _order_key(order)
        how = "amin" if self.mode == "min" else "amax"
        from ..columnar.segmented import _extreme
        G = seg.num_segments
        best = _extreme(key, ok, seg, how)
        ids = seg.seg_ids
        hit = ok & seg.live & (key == best[ids.clamp(0, max(G - 1, 0))]) \
            if G else ok
        rows, has = select_by_rank(rank, hit, seg, "min")
        return [(_take_value(value, rows), _take(value.validity, rows) & has),
                (_take_value(order, rows), has), (_take(rank, rows), has)]

    def update(self, vals, seg):
        value, order = vals
        return self._pick(value, order, seg.orig_index, order.validity, seg)

    def merge(self, partials, seg):
        value, order, rank = partials
        return self._pick(value, order, rank.data, order.validity, seg)

    def finalize(self, partials):
        return partials[0]

    def key(self):
        return (f"{type(self).__name__}({self.child.key()},"
                f"{self.ordering.key()})")


class MaxBy(MinBy):
    """max_by(value, ordering): as ``min_by``, the greatest ordering."""

    mode = "max"


class Percentile(Count):
    """percentile(e, p): the exact percentile of a group's non-NULL
    values, interpolated as Spark's is: with n values in order and
    ``pos = p * (n - 1)``, ``(hi - pos) * v[lo] + (pos - lo) * v[hi]``
    for ``lo``/``hi`` the floor and ceiling of ``pos``; NaN sorts
    greatest and is a value (the reference drops NaN and interpolates
    through ``np.percentile``: ROADMAP.md Queue C). The partial is the
    count of values; the values themselves are ordered by the port's
    sort, however many batches a group spans (exec/aggregate.py), and
    ``finalize_picked`` takes the two picked."""

    #: the exec orders this aggregate's values and hands
    #: ``finalize_picked`` the ones at its ranks
    order_statistic = True

    def __init__(self, child, percentage: float,
                 name: Optional[str] = None):
        super().__init__(child, name)
        self.percentage = float(percentage)
        if not 0.0 <= self.percentage <= 1.0:
            raise ValueError(f"percentile: the percentage {percentage} "
                             "must lie in [0, 1]")

    def data_type(self, schema):
        return FLOAT64

    def device_unsupported_reason(self, schema):
        r = numeric.reason_not_supported(self.child.data_type(schema))
        if r:
            return f"{self.name_hint}: input {r}"
        return super().device_unsupported_reason(schema)

    def ranks(self, counts: torch.Tensor):
        """(lo, hi, pos) per group of ``counts`` values: the ranks to pick
        and the interpolation point."""
        n = counts.to(torch.int64)
        pos = self.percentage * (n - 1).clamp(min=0).to(torch.float64)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.ceil(pos).to(torch.int64)
        return lo, hi, pos

    def finalize_picked(self, counts: torch.Tensor, lo_v: torch.Tensor,
                        hi_v: torch.Tensor) -> DVal:
        """The result from each group's count and its values at ``lo`` and
        ``hi`` (``ranks``)."""
        lo, hi, pos = self.ranks(counts)
        a, b = lo_v.to(torch.float64), hi_v.to(torch.float64)
        mixed = (hi.to(torch.float64) - pos) * a \
            + (pos - lo.to(torch.float64)) * b
        return DVal(torch.where(lo == hi, a, mixed), counts > 0, FLOAT64)

    def key(self):
        return f"{type(self).__name__}({self.child.key()},{self.percentage})"


class ApproximatePercentile(Percentile):
    """approx_percentile(e, p): computed exactly, as the reference's is
    (Spark's t-digest answer is within its accuracy of this one). It takes
    no accuracy: a path that would read one does not exist."""
