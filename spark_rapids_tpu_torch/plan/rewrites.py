"""Logical plan rewrites applied before planning (port of
``spark_rapids_tpu/plan/rewrites.py``).

* A union of keyless aggregates over one shared relation, each over its
  own filter (the TPC-DS q28 shape), becomes ONE aggregate keyed by a
  branch id (``_rewrite_union_agg``): the id is a CASE WHEN over the
  branch filters when they are provably disjoint (one row a row), else an
  ``Expand`` (one copy a matching branch); ``BranchAlign`` puts the rows
  back in branch order, with the empty aggregate's values for a branch
  without rows. The id's cardinality is proven, so the aggregate may
  group it by direct addressing (``int_key_cards``).
* ``agg(DISTINCT e)``: with ``spark.rapids.tpu.sql.hashDistinct.enabled``
  (the default) and fixed-width types, ``count/sum/avg(DISTINCT e) GROUP
  BY g`` becomes ``count/sum/avg(CASE WHEN __hd_flag THEN e END)`` over a
  ``DistinctFlag`` that marks the first (g, e) occurrences
  (``_rewrite_distinct_hash``, exec/distinct_flag.py). Otherwise the
  two-level form (``_rewrite_distinct``): an inner aggregate deduplicates
  (g, e) with the other aggregates' partials, an outer one finishes them.
  The rewrites apply when every distinct aggregate shares one child and
  every aggregate decomposes; a distinct aggregate they leave is refused
  at planning.

``plan_query`` runs ``rewrite_plan`` before column pruning: the union
rewrite keys on the identity of the shared relation, which pruning's
per-branch copies would break.
"""
from __future__ import annotations

import copy
from typing import Optional

from ..config import register
from ..exprs import aggregates as AG
from ..exprs.arithmetic import Divide
from ..exprs.base import Alias, ColumnRef, Literal
from ..exprs.cast import Cast
from ..exprs.comparison import (GreaterThan, GreaterThanOrEqual, IsNotNull,
                                LessThan, LessThanOrEqual)
from ..exprs.conditional import CaseWhen, Coalesce
from ..exprs.logical import And
from ..types import FLOAT64, INT64
from . import logical as L

__all__ = ["rewrite_plan", "HASH_DISTINCT_ENABLED"]

HASH_DISTINCT_ENABLED = register(
    "spark.rapids.tpu.sql.hashDistinct.enabled", True,
    "Rewrite count/sum/avg(DISTINCT e) over fixed-width types into a "
    "single-level aggregate guarded by a first-occurrence flag from a "
    "device hash table (exec/distinct_flag.py) instead of the two-level "
    "expansion (ref: cudf's hash-based distinct aggregation).")

_DECOMPOSABLE = (AG.Sum, AG.Count, AG.CountStar, AG.Min, AG.Max, AG.Average)
_DISTINCT_OK = (AG.Count, AG.Sum, AG.Average)
#: fixed-width types whose bit patterns the distinct-flag table stores
#: exactly (strings stay on the two-level path)
_HASHABLE_TYPE_NAMES = frozenset(
    ["boolean", "tinyint", "smallint", "int", "bigint", "float",
     "double", "date", "timestamp"])


def _agg_refs(a, out: set) -> None:
    for e in a.input_exprs():
        out.update(e.references())


def rewrite_plan(plan: L.LogicalPlan,
                 hash_distinct: bool = True) -> L.LogicalPlan:
    """``plan`` with the rewrites of the module doc applied bottom-up;
    ``hash_distinct`` prefers the distinct-flag form."""
    if isinstance(plan, L.Union):
        new = _rewrite_union_agg(plan)
        if new is not None:
            # the single pass holds a (possibly distinct) grouped
            # aggregate that still needs the distinct rewrite
            return rewrite_plan(new, hash_distinct)
    kids = [rewrite_plan(c, hash_distinct) for c in plan.children]
    if any(n is not o for n, o in zip(kids, plan.children)):
        plan = copy.copy(plan)
        plan.children = kids
    if isinstance(plan, L.Aggregate) and any(a.distinct for a in plan.aggs):
        new = _rewrite_distinct_hash(plan) if hash_distinct else None
        if new is None:
            new = _rewrite_distinct(plan)
        if new is not None:
            plan = new
    return plan


# ---------------------------------------------------------------------------
# a union of keyless aggregates over one relation in one pass
# ---------------------------------------------------------------------------

def _flatten_union(plan: L.Union, out: list) -> None:
    for c in plan.children:
        if isinstance(c, L.Union):
            _flatten_union(c, out)
        else:
            out.append(c)


def _conjuncts(e, out: list) -> None:
    if isinstance(e, And):
        for c in e.children:
            _conjuncts(c, out)
    else:
        out.append(e)


def _branch_interval(cond):
    """(column, lo, hi) when the condition's top-level conjuncts pin one
    column into an interval; None otherwise (ref ``_branch_interval``: a
    strict lower bound counts as closed, which is conservative for the
    disjointness test)."""
    cs: list = []
    _conjuncts(cond, cs)
    lo = hi = col = None
    for c in cs:
        kids = getattr(c, "children", ())
        if len(kids) != 2:
            continue
        left, right = kids
        if not (isinstance(left, ColumnRef) and isinstance(right, Literal)):
            continue
        if isinstance(c, (GreaterThanOrEqual, GreaterThan)):
            if col is None or col == left.name:
                col = left.name
                lo = right.value if lo is None else max(lo, right.value)
        elif isinstance(c, (LessThanOrEqual, LessThan)):
            if col is None or col == left.name:
                col = left.name
                hi = right.value if hi is None else min(hi, right.value)
    if col is None or lo is None or hi is None:
        return None
    return col, lo, hi


def _branches_disjoint(conds) -> bool:
    ivs = [_branch_interval(c) for c in conds]
    if any(iv is None for iv in ivs):
        return False
    if any(iv[0] != ivs[0][0] for iv in ivs):
        return False
    spans = sorted((iv[1], iv[2]) for iv in ivs)
    return all(spans[i][1] < spans[i + 1][0] for i in range(len(spans) - 1))


def _same_aggs(a0, aggs) -> bool:
    """The two aggregate lists are alike: type, DISTINCT, name and child."""
    if len(aggs) != len(a0):
        return False
    for x, y in zip(a0, aggs):
        if type(x) is not type(y) or x.distinct != y.distinct \
                or x.name_hint != y.name_hint:
            return False
        if (x.child is None) != (y.child is None):
            return False
        if x.child is not None and x.child.key() != y.child.key():
            return False
    return True


def _rewrite_union_agg(union: L.Union) -> Optional[L.LogicalPlan]:
    branches: list = []
    _flatten_union(union, branches)
    if len(branches) < 2:
        return None
    conds, shared = [], None
    for b in branches:
        if not (isinstance(b, L.Aggregate) and not b.groupings
                and isinstance(b.children[0], L.Filter)):
            return None
        f = b.children[0]
        if shared is None:
            shared = f.children[0]
        elif f.children[0] is not shared:
            return None          # the branches must read ONE relation
        conds.append(f.condition)
    a0 = branches[0].aggs
    if not all(_same_aggs(a0, b.aggs) for b in branches[1:]):
        return None
    for a in a0:
        if type(a) not in (_DISTINCT_OK if a.distinct else _DECOMPOSABLE):
            return None
    if len({a.child.key() for a in a0 if a.distinct}) > 1:
        return None
    k = len(branches)
    bid = "__ua_bid"
    needed: set = set()
    for a in a0:
        _agg_refs(a, needed)
    names = shared.schema().names()
    keep = [n for n in names if n in needed] or names[:1]
    refs = [ColumnRef(n) for n in keep]
    if _branches_disjoint(conds):
        tag = CaseWhen([(c, Literal(i, INT64)) for i, c in enumerate(conds)])
        tagged = L.Project(refs + [Alias(tag, bid)], shared)
    else:
        projections = [refs + [Alias(CaseWhen([(c, Literal(i, INT64))]),
                                     bid)] for i, c in enumerate(conds)]
        tagged = L.Expand(projections, keep + [bid], shared)
    filtered = L.Filter(IsNotNull(ColumnRef(bid)), tagged)
    agg = L.Aggregate([ColumnRef(bid)], [copy.copy(a) for a in a0],
                      filtered, int_key_cards=[k])
    fill_zero = [isinstance(a, AG.Count) for a in a0]
    return L.BranchAlign(k, fill_zero, agg)


# ---------------------------------------------------------------------------
# agg(DISTINCT e)
# ---------------------------------------------------------------------------

def _rewrite_distinct_hash(agg: L.Aggregate) -> Optional[L.LogicalPlan]:
    """The distinct-flag form (module doc): at most one grouping key and
    one distinct child, both of a fixed-width type."""
    cs = agg.children[0].schema()
    if len({a.child.key() for a in agg.aggs if a.distinct}) != 1 \
            or len(agg.groupings) > 1:
        return None
    if any(a.distinct and type(a) not in _DISTINCT_OK for a in agg.aggs):
        return None
    d_expr = next(a.child for a in agg.aggs if a.distinct)
    try:
        if any(e.data_type(cs).name not in _HASHABLE_TYPE_NAMES
               for e in [d_expr] + agg.groupings):
            return None
    except (KeyError, TypeError):
        return None
    flag = "__hd_flag"
    new_aggs = [type(a)(CaseWhen([(ColumnRef(flag), a.child)]))
                .with_name(a.name_hint) if a.distinct else a
                for a in agg.aggs]
    flagged = L.DistinctFlag(list(agg.groupings), d_expr, flag,
                             agg.children[0])
    return L.Aggregate(agg.groupings, new_aggs, flagged,
                       many_groups_hint=agg.many_groups_hint,
                       int_key_cards=agg.int_key_cards)


def _rewrite_distinct(agg: L.Aggregate) -> Optional[L.LogicalPlan]:
    """The two-level form (module doc)."""
    if len({a.child.key() for a in agg.aggs if a.distinct}) != 1:
        return None
    for a in agg.aggs:
        if type(a) not in (_DISTINCT_OK if a.distinct else _DECOMPOSABLE):
            return None
    d_expr = next(a.child for a in agg.aggs if a.distinct)
    dname = "__da_d"
    inner_aggs, outer_aggs = [], []
    projections = [ColumnRef(g.name_hint) for g in agg.groupings]
    for i, a in enumerate(agg.aggs):
        out, t = a.name_hint, f"__da_t{i}"
        if a.distinct:
            # the inner aggregate deduplicates (g, e); the plain
            # aggregate over e finishes it
            outer_aggs.append(type(a)(ColumnRef(dname)).with_name(t))
            projections.append(Alias(ColumnRef(t), out))
        elif isinstance(a, AG.Average):
            ps, pc = f"__da_p{i}_s", f"__da_p{i}_c"
            inner_aggs.append(AG.Sum(Cast(a.child, FLOAT64)).with_name(ps))
            inner_aggs.append(AG.Count(a.child).with_name(pc))
            ts, tc = f"__da_t{i}_s", f"__da_t{i}_c"
            outer_aggs.append(AG.Sum(ColumnRef(ps)).with_name(ts))
            outer_aggs.append(AG.Sum(ColumnRef(pc)).with_name(tc))
            projections.append(Alias(
                Divide(ColumnRef(ts), Cast(ColumnRef(tc), FLOAT64)), out))
        elif isinstance(a, AG.Count):
            p = f"__da_p{i}"
            inner = AG.CountStar() if isinstance(a, AG.CountStar) \
                else AG.Count(a.child)
            inner_aggs.append(inner.with_name(p))
            outer_aggs.append(AG.Sum(ColumnRef(p)).with_name(t))
            projections.append(Alias(
                Coalesce(ColumnRef(t), Literal(0, INT64)), out))
        else:                  # Sum / Min / Max merge with themselves
            p = f"__da_p{i}"
            inner_aggs.append(type(a)(a.child).with_name(p))
            outer_aggs.append(type(a)(ColumnRef(p)).with_name(t))
            projections.append(Alias(ColumnRef(t), out))
    inner = L.Aggregate(list(agg.groupings) + [Alias(d_expr, dname)],
                        inner_aggs, agg.children[0], many_groups_hint=True,
                        int_key_cards=agg.int_key_cards + [None])
    outer = L.Aggregate([ColumnRef(g.name_hint) for g in agg.groupings],
                        outer_aggs, inner, int_key_cards=agg.int_key_cards)
    return L.Project(projections, outer)
