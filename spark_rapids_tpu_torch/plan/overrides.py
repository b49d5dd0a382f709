"""Logical plan -> tagged meta -> physical exec (port of
``spark_rapids_tpu/plan/overrides.py``).

``plan_query`` rewrites (plan/rewrites.py: the union of aggregates in one
pass, DISTINCT aggregates), prunes columns, tags and converts, with no
cost optimizer (the reference with
``spark.rapids.tpu.sql.optimizer.enabled=false``). A keyless aggregate
over an in-memory scan widens the scan's batches up to the whole
partition while one batch fits half the memory manager's budget
(``AggregateMeta._widen_scan_batches``). A join broadcasts the side its
hint names, or else the smaller side whose plan-time size estimate is
within ``spark.rapids.tpu.sql.autoBroadcastJoinThreshold`` (estimates only:
measured sizes wait for the adaptivity slice). An aggregate, keyless or
keyed, folds the device filters and projections below it into its update
(``_fold_stages``), as the reference's does, except a stage (or the
aggregate's own inputs) holding ``rand`` or a row id above a folded
filter: those number the rows they see, so they stay below with the
filter compacting before them. Elsewhere than in a projection, a filter
or an aggregate, such an expression is refused at planning. String group
and sort keys plan onto the device:
the execs take them as dictionary columns and refuse other forms when
the batch arrives. A window prunes its child to the columns its
expressions and its parent read; where the reference tags a window for
its host engine (list payloads or keys), the port raises at planning.
List, map and struct columns ride through projections, filters, joins,
sorts and generators as payloads; a list, map or struct as a group,
sort, join or window key is refused at planning (``NESTED_REST``).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Type

from ..config import TpuConf
from ..exec import aggregate as A
from ..exec import basic as B
from ..exec import sort as S
from ..exec.base import TpuExec
from ..exprs.base import Alias, ColumnRef, Expression
from ..types import (NESTED_REST, STRING, ArrayType, MapType, Schema,
                     StructType, device_column_ok, nested_reason)
from . import logical as L
from .meta import PlanMeta

__all__ = ["plan_query", "wrap_plan", "prune_columns",
           "estimated_size_bytes"]

_RULES: Dict[Type, Type[PlanMeta]] = {}


def rule(plan_cls):
    def deco(meta_cls):
        _RULES[plan_cls] = meta_cls
        return meta_cls
    return deco


class _FallbackMeta(PlanMeta):
    def tag_self(self):
        self.will_not_work_on_tpu(
            f"no device rule for {type(self.plan).__name__}")


def wrap_plan(plan: L.LogicalPlan, conf: TpuConf,
              budget: Optional[int] = None) -> PlanMeta:
    m = _RULES.get(type(plan), _FallbackMeta)(plan, conf)
    m.budget = budget
    m.child_metas = [wrap_plan(c, conf, budget) for c in plan.children]
    return m


def plan_query(plan: L.LogicalPlan, conf: TpuConf,
               budget: Optional[int] = None) -> TpuExec:
    """rewrite -> prune columns -> tag -> convert. The rewrites run before
    pruning: the union rewrite keys on the identity of the shared
    relation, which pruning's per-branch copies would break. ``budget``:
    the device bytes of the memory manager the query will run under
    (the session's; by default the conf's manager on the card, or on
    the CPU where there is none)."""
    from .rewrites import HASH_DISTINCT_ENABLED, rewrite_plan
    if conf.sql_enabled:
        plan = rewrite_plan(plan, bool(conf.get(HASH_DISTINCT_ENABLED)))
    meta = wrap_plan(prune_columns(plan), conf, budget)
    meta.tag()
    return meta.convert()


def _expr_refs(e: Expression, out: set) -> None:
    out.update(e.references())


def prune_columns(plan: L.LogicalPlan,
                  required: Optional[set] = None) -> L.LogicalPlan:
    """Narrow every scan to the columns the plan above it reads;
    ``required`` = names needed from this node's output, None = all."""
    if isinstance(plan, (L.LogicalScan, L.ParquetScan)):
        names = plan.schema().names()
        if required is None or set(names) <= required:
            return plan
        keep = [n for n in names if n in required] or names[:1]
        node = copy.copy(plan)
        node.columns = keep
        return node
    if isinstance(plan, L.Project):
        exprs = plan.exprs
        if required is not None:
            exprs = [e for e in exprs if e.name_hint in required] \
                or exprs[:1]
        child_req: set = set()
        for e in exprs:
            _expr_refs(e, child_req)
        child = prune_columns(plan.children[0], child_req)
        if exprs is not plan.exprs or child is not plan.children[0]:
            return L.Project(exprs, child)
        return plan
    if isinstance(plan, L.Filter):
        child_req = None if required is None else set(required)
        if child_req is not None:
            _expr_refs(plan.condition, child_req)
        return _rebuilt(plan, prune_columns(plan.children[0], child_req))
    if isinstance(plan, L.Aggregate):
        child_req = set()
        for g in plan.groupings:
            _expr_refs(g, child_req)
        for a in plan.aggs:
            for e in a.input_exprs():
                _expr_refs(e, child_req)
        return _rebuilt(plan, prune_columns(plan.children[0], child_req))
    if isinstance(plan, L.Sort):
        child_req = None if required is None else set(required)
        if child_req is not None:
            for o in plan.orders:
                _expr_refs(o.expr, child_req)
        return _rebuilt(plan, prune_columns(plan.children[0], child_req))
    if isinstance(plan, L.Join):
        lnames = set(plan.children[0].schema().names())
        rnames = set(plan.children[1].schema().names())
        lreq = rreq = None
        if required is not None:
            refs: set = set()
            for k in plan.left_keys + plan.right_keys:
                _expr_refs(k, refs)
            if plan.condition is not None:
                _expr_refs(plan.condition, refs)
            lreq = (set(required) | refs) & lnames
            rreq = (set(required) | refs) & rnames
        return _rebuilt(plan, prune_columns(plan.children[0], lreq),
                        prune_columns(plan.children[1], rreq))
    if isinstance(plan, (L.GlobalLimit, L.Sample)):
        return _rebuilt(plan, prune_columns(plan.children[0], required))
    if isinstance(plan, L.Union):
        # the children's columns pair by position and share the names
        return _rebuilt(plan, *[prune_columns(c, required)
                                for c in plan.children])
    if isinstance(plan, L.Expand):
        # every projection keeps every column: the rows pair by position
        child_req = set()
        for p in plan.projections:
            for e in p:
                _expr_refs(e, child_req)
        return _rebuilt(plan, prune_columns(plan.children[0], child_req))
    if isinstance(plan, L.DistinctFlag):
        child_req = None if required is None \
            else set(required) - {plan.flag_name}
        if child_req is not None:
            for e in plan.key_exprs + [plan.value_expr]:
                _expr_refs(e, child_req)
        return _rebuilt(plan, prune_columns(plan.children[0], child_req))
    if isinstance(plan, L.BranchAlign):
        return _rebuilt(plan, prune_columns(plan.children[0], None))
    if isinstance(plan, L.Window):
        return _prune_window(plan, required)
    if isinstance(plan, L.Generate):
        # the generator runs whatever reads its columns: it sets the rows
        keep = [c for c in plan.required_cols
                if required is None or c in required]
        child_req = set(keep)
        _expr_refs(plan.generator, child_req)
        child = prune_columns(plan.children[0], child_req)
        if keep == plan.required_cols and child is plan.children[0]:
            return plan
        return L.Generate(plan.generator, keep, child, plan.output_names)
    return plan


def _prune_window(plan: L.Window, required: Optional[set]) -> L.LogicalPlan:
    """A window keeps the child's columns in front of its own, so its
    child is pruned to what the parent reads of them and what the window
    expressions read; window columns nobody reads are dropped (the
    reference keeps every column below a window)."""
    exprs = plan.window_exprs
    if required is not None:
        exprs = [w for w in exprs if w[2] in required]
    child_req = None
    if required is not None:
        child_req = set(required) - {w[2] for w in plan.window_exprs}
        for fn, spec, _ in exprs:
            for e in [getattr(fn, "child", None)] + list(spec.partition_by) \
                    + [o.expr for o in spec.order_by]:
                if e is not None:
                    _expr_refs(e, child_req)
    child = prune_columns(plan.children[0], child_req)
    if not exprs:
        return child
    if exprs == plan.window_exprs and child is plan.children[0]:
        return plan
    return L.Window(exprs, child)


def _rebuilt(node, *kids):
    if all(k is o for k, o in zip(kids, node.children)):
        return node
    node = copy.copy(node)
    node.children = list(kids)
    return node


def estimated_size_bytes(plan: L.LogicalPlan) -> Optional[int]:
    """Plan-time size estimate (ref ``plan/rewrites.py``): known for
    in-memory and file scans, passed up through filters, projections and
    sorts (a filter keeps its child's estimate, as Spark does without
    column statistics), None elsewhere."""
    own = getattr(plan, "estimated_size_bytes", None)
    if own is not None:
        return own()
    if isinstance(plan, L.ParquetScan):
        import os
        try:
            return sum(os.path.getsize(p) for p in plan.paths)
        except OSError:
            return None
    if isinstance(plan, (L.Filter, L.Sort, L.Project, L.GlobalLimit,
                         L.Sample)):
        return estimated_size_bytes(plan.children[0])
    return None


@rule(L.LogicalScan)
class ScanMeta(PlanMeta):
    def convert_to_tpu(self, children):
        return B.InMemoryScanExec(self.plan.tables, self.plan._schema,
                                  batch_rows=self.conf.batch_size_rows,
                                  columns=self.plan.columns)


@rule(L.RangeRel)
class RangeMeta(PlanMeta):
    def convert_to_tpu(self, children):
        p = self.plan
        return B.TpuRangeExec(p.start, p.end, p.step, p.name,
                              batch_rows=self.conf.batch_size_rows)


@rule(L.Sample)
class SampleMeta(PlanMeta):
    def convert_to_tpu(self, children):
        return B.TpuSampleExec(self.plan.fraction, self.plan.seed,
                               children[0])


def _numbers_rows(exprs) -> Optional[Expression]:
    """The first of ``exprs`` holding ``rand`` or a row id (an
    expression that numbers the rows it sees), else None."""
    from ..exprs.nondeterministic import TaskContextExpression
    for e in exprs:
        stack = [e]
        while stack:
            x = stack.pop()
            if isinstance(x, TaskContextExpression):
                return e
            stack.extend(x.children)
    return None


def _row_numbering_reason(exprs, where: str) -> Optional[str]:
    e = _numbers_rows(exprs)
    if e is None:
        return None
    return (f"<{e.name_hint}> in {where}: rand and the row ids run in a "
            "projection, a filter or an aggregate here; project the value "
            f"into a column below (elsewhere they arrive with {NESTED_REST})")


@rule(L.ParquetScan)
class ParquetScanMeta(PlanMeta):
    def tag_self(self):
        from ..io.parquet import unsupported_columns
        for r in unsupported_columns(self.plan.schema()):
            self.will_not_work_on_tpu(r)

    def convert_to_tpu(self, children):
        from ..io.parquet import ParquetScanExec
        return ParquetScanExec(self.plan.paths, self.plan._schema,
                               self.plan.columns, self.conf)


def _computed_string(e, schema: Schema) -> bool:
    """``e`` is a string chain over one STRING column (``upper(trim(s))``)
    or another device expression giving a string (a string field of a
    struct, ``element_at`` of a list or map of strings, ``array_join``),
    and not a column itself: a projection computes it below an aggregate
    or a sort that keys on it, so that its batches' dictionaries are
    unified as a column's are."""
    from ..exprs.string_rect import chain_leaf
    return e.data_type(schema) == STRING and not isinstance(e, ColumnRef) \
        and (chain_leaf(e, schema) is not None
             or e.fully_device_supported(schema) is None)


@rule(L.Project)
class ProjectMeta(PlanMeta):
    def tag_self(self):
        from ..exprs.string_rect import chain_leaf
        schema = self.plan.children[0].schema()
        for e in self.plan.exprs:
            inner = e.children[0] if isinstance(e, Alias) else e
            # a string chain over one STRING column runs over its byte
            # rectangle or once per dictionary entry (exec/basic.py)
            if isinstance(inner, ColumnRef) \
                    or e.fully_device_supported(schema) is None \
                    or chain_leaf(inner, schema) is not None:
                continue
            self.will_not_work_on_tpu(
                f"<{e.name_hint}>: {e.fully_device_supported(schema)}")

    def convert_to_tpu(self, children):
        return B.TpuProjectExec(self.plan.exprs, children[0])


@rule(L.Filter)
class FilterMeta(PlanMeta):
    def tag_self(self):
        schema = self.plan.children[0].schema()
        r = self.plan.condition.fully_device_supported(schema)
        if r:
            # literal-match predicates over STRING columns run on the
            # device over the dictionary or the byte rectangle
            # (exprs/compiler.py DictFilterEvaluator)
            from ..exprs.compiler import build_dict_filter
            if build_dict_filter(self.plan.condition, schema) is not None:
                return
            self.will_not_work_on_tpu(
                f"filter condition <{self.plan.condition.name_hint}>: {r}")

    def convert_to_tpu(self, children):
        self._push_down_predicate(children[0])
        return B.TpuFilterExec(self.plan.condition, children[0])

    def _push_down_predicate(self, child_exec):
        """Predicate pushdown into a file scan for row-group skipping
        (ref ``plan/overrides.py:_push_down_predicate``): through
        projections that pass the referenced columns on unchanged. The
        filter itself still runs; pruning is conservative."""
        from ..io.file_scan import FileScanBase
        cond = self.plan.condition
        if _numbers_rows([cond]) is not None:
            return
        refs = set(cond.references())
        node = child_exec
        while isinstance(node, B.TpuProjectExec):
            same_name = {n for i, n in node.passthrough.items()
                         if node.exprs[i].name_hint == n}
            if not refs <= same_name:
                return
            node = node.children[0]
        if isinstance(node, FileScanBase) and node.predicate is None \
                and refs <= set(node.output_schema().names()):
            node.set_predicate(cond)


def _list_key_reason(e: Expression, schema) -> Optional[str]:
    dt = e.data_type(schema)
    if isinstance(dt, (ArrayType, MapType, StructType)):
        kind = {ArrayType: "list", MapType: "map",
                StructType: "struct"}[type(dt)]
        return f"a {kind} as a key arrives with {NESTED_REST}"
    return None


def _key_reason(e: Expression, schema) -> Optional[str]:
    """Why a group or sort key cannot run on the device; a string key
    passes (the exec takes it as a dictionary column)."""
    r = _list_key_reason(e, schema)
    if r:
        return r
    r = e.fully_device_supported(schema)
    return None if r is None or e.data_type(schema) == STRING else r


@rule(L.Aggregate)
class AggregateMeta(PlanMeta):
    def tag_self(self):
        schema = self.plan.children[0].schema()
        for g in self.plan.groupings:
            r = _key_reason(g, schema)
            if r:
                self.will_not_work_on_tpu(f"grouping <{g.name_hint}>: {r}")
        for a in self.plan.aggs:
            r = a.device_unsupported_reason(schema)
            if r:
                self.will_not_work_on_tpu(f"aggregate <{a.name_hint}>: {r}")
            if a.distinct:
                # the rewrites left it: several distinct children, or an
                # aggregate that does not decompose
                self.will_not_work_on_tpu(
                    f"aggregate <{a.name_hint}>: this DISTINCT form has no "
                    "device rewrite")

    def convert_to_tpu(self, children):
        groupings, child = self._string_key_project(self.plan.groupings,
                                                    children[0])
        own = list(groupings) + [e for a in self.plan.aggs
                                 for e in a.input_exprs()]
        child, stages, eval_schema = self._fold_stages(
            child, _numbers_rows(own) is not None)
        if not groupings:
            self._widen_scan_batches(child)
        return A.TpuHashAggregateExec(groupings, self.plan.aggs,
                                      child, pre_stages=stages,
                                      eval_schema=eval_schema,
                                      int_key_cards=self._key_cards())

    def _key_cards(self) -> list:
        """The plan's proven key cardinalities, and for a key that is the
        ``pos`` of a posexplode over a list column of an in-memory scan,
        the scan's longest list: its values lie in [0, that length), so
        the dense route can address it directly."""
        cards = list(self.plan.int_key_cards)
        for i, g in enumerate(self.plan.groupings):
            inner = g.children[0] if isinstance(g, Alias) else g
            if cards[i] is None and isinstance(inner, ColumnRef):
                cards[i] = _position_card(self.plan.children[0], inner.name)
        return cards

    @staticmethod
    def _string_key_project(groupings, child: TpuExec):
        """A computed STRING grouping (a chain over one string column:
        ``GROUP BY upper(trim(s))``) becomes a column of a projection
        below the aggregate, which groups on that column by its string
        key modes (exec/aggregate.py); the reference encodes such a key
        on the host. Returns (groupings, child)."""
        schema = child.output_schema()
        extra, out = [], []
        for k, g in enumerate(groupings):
            inner = g.children[0] if isinstance(g, Alias) else g
            if not _computed_string(inner, schema):
                out.append(g)
                continue
            name = f"__string_key{k}"
            extra.append(Alias(inner, name))
            out.append(Alias(ColumnRef(name), g.name_hint))
        if not extra:
            return groupings, child
        return out, B.TpuProjectExec(
            [ColumnRef(n) for n in schema.names()] + extra, child)

    def _widen_scan_batches(self, node) -> None:
        """A keyless aggregate has no group count to keep small, and pays
        per batch: feed it the widest batches the memory runtime allows
        (ref ``_widen_scan_batches``). Through filters, projections and
        a distinct flag down to an in-memory scan."""
        from ..config import AGG_WIDE_BATCH_ROWS
        from ..exec.distinct_flag import HashDistinctFlagExec
        wide = int(self.conf.get(AGG_WIDE_BATCH_ROWS))
        while isinstance(node, (B.TpuFilterExec, B.TpuProjectExec,
                                HashDistinctFlagExec)):
            node = node.children[0]
        if not isinstance(node, B.InMemoryScanExec):
            return
        if wide <= 0:
            total = max((t.num_rows for t in node.tables), default=0)
            wide = min(total, self._wide_batch_row_cap(node))
        node.batch_rows = max(node.batch_rows, wide, 1)

    def _wide_batch_row_cap(self, scan) -> int:
        """Rows of one batch of ``scan`` that fit half the memory
        manager's budget (ref ``_wide_batch_row_cap``): a row's bytes are
        the larger of the schema's estimate (fixed-width lanes, 16 bytes
        for a string, and a validity byte each) and the tables' own bytes
        a row."""
        from ..mem.manager import MemoryManager
        row_bytes = sum((f.dtype.np_dtype.itemsize
                         if f.dtype.np_dtype is not None else 16) + 1
                        for f in scan.output_schema().fields)
        total_rows = sum(t.num_rows for t in scan.tables)
        if total_rows:
            names = scan.output_schema().names()
            data_bytes = sum(t.select(names).nbytes for t in scan.tables)
            row_bytes = max(row_bytes, -(-data_bytes // total_rows))
        budget = self.budget
        if budget is None:
            import torch
            budget = MemoryManager.get(
                self.conf, "cuda" if torch.cuda.is_available()
                else "cpu").budget
        return max(1, (budget // 2) // max(1, row_bytes))

    @staticmethod
    def _fold_stages(child: TpuExec, own_numbers_rows: bool = False):
        """Fold the chain of device-only filters and projections below
        the aggregate into its update: (new child, stages bottom-up,
        eval schema), or (child, None, None) when nothing folds. A stage
        that numbers its rows (``rand``, a row id) folds only with no
        filter folded below it, and the aggregate's own expressions
        (``own_numbers_rows``) only with no filter folded at all: a
        folded filter masks rows without compacting them."""
        eval_schema = child.output_schema()
        stages, nodes, node = [], [child], child
        while True:
            if (isinstance(node, B.TpuFilterExec)
                    and node.condition.fully_device_supported(
                        node.children[0].output_schema()) is None):
                stages.append(("filter", node.condition))
            elif isinstance(node, B.TpuProjectExec) and not node.chains \
                    and not any(_computed_string(
                        e.children[0] if isinstance(e, Alias) else e,
                        node.children[0].output_schema())
                        for e in node.exprs):
                # a string chain, or a string field of a struct, stays its
                # own exec: its result's layout (dictionary or rectangle)
                # is known only per batch
                stages.append(("project", node.exprs, node.output_schema()))
            else:
                break
            node = node.children[0]
            nodes.append(node)

        def numbers_rows(st):
            return _numbers_rows([st[1]] if st[0] == "filter"
                                 else st[1]) is not None

        def foldable(m):
            top = stages[:m]                # top-down
            filters = [st[0] == "filter" for st in top]
            if own_numbers_rows and any(filters):
                return False
            return not any(numbers_rows(st) and any(filters[i + 1:])
                           for i, st in enumerate(top))
        m = len(stages)
        while m and not foldable(m):
            m -= 1
        if not m:
            return child, None, None
        return nodes[m], stages[:m][::-1], eval_schema


def _source_column(plan: L.LogicalPlan, name: str):
    """(plan, name) of the column ``name`` of ``plan`` followed down
    through filters and pass-through projections."""
    while True:
        if isinstance(plan, L.Filter):
            plan = plan.children[0]
        elif isinstance(plan, L.Project):
            e = next((x for x in plan.exprs if x.name_hint == name), None)
            inner = e.children[0] if isinstance(e, Alias) else e
            if not isinstance(inner, ColumnRef):
                return plan, name
            plan, name = plan.children[0], inner.name
        else:
            return plan, name


def _position_card(plan: L.LogicalPlan, name: str) -> Optional[int]:
    """The longest list or map an exploded position ``name`` of ``plan``
    can come from, when it is a posexplode's ``pos`` over a list or map
    column of an in-memory scan (each host list or map keeps its longest
    row), else None: one computed in the query takes the sort route."""
    from ..columnar.nested import HostList, HostMap
    from ..exprs.generators import PosExplode
    plan, name = _source_column(plan, name)
    if not isinstance(plan, L.Generate) or not isinstance(
            plan.generator, PosExplode):
        return None
    names = plan.output_names or ["pos"]
    src = plan.generator.children[0]
    if name != names[0] or not isinstance(src, ColumnRef):
        return None
    scan, col = _source_column(plan.children[0], src.name)
    if not isinstance(scan, L.LogicalScan):
        return None
    lists = [t.columns[col][0] for t in scan.tables]
    if not all(isinstance(hl, (HostList, HostMap)) for hl in lists):
        return None
    return max([hl.longest for hl in lists] + [1])


@rule(L.Sort)
class SortMeta(PlanMeta):
    def tag_self(self):
        schema = self.plan.children[0].schema()
        for o in self.plan.orders:
            r = _key_reason(o.expr, schema)
            if r:
                self.will_not_work_on_tpu(
                    f"sort key <{o.expr.name_hint}>: {r}")
        for f in schema.fields:
            if not device_column_ok(f.dtype):
                self.will_not_work_on_tpu(
                    f"column {f.name}: {f.dtype.name} payload: "
                    + (nested_reason(f.dtype) or "host-only"))
        r = _row_numbering_reason([o.expr for o in self.plan.orders],
                                  "a sort key")
        if r:
            self.will_not_work_on_tpu(r)

    def convert_to_tpu(self, children):
        """A sort key that is a string chain over one column (``ORDER BY
        upper(name)`` below the projection that names it) is computed by
        a projection below the sort, and dropped by one above it."""
        child = children[0]
        schema = child.output_schema()
        orders, extra = [], []
        for k, o in enumerate(self.plan.orders):
            if _computed_string(o.expr, schema):
                name = f"__sort_key{k}"
                extra.append(Alias(o.expr, name))
                o = L.SortOrder(ColumnRef(name), o.ascending, o.nulls_first)
            orders.append(o)
        g = self.plan.global_sort
        if not extra:
            return S.TpuSortExec(self.plan.orders, child, g)
        keep = [ColumnRef(n) for n in schema.names()]
        return B.TpuProjectExec(keep, S.TpuSortExec(
            orders, B.TpuProjectExec(keep + extra, child), g))


@rule(L.Window)
class WindowMeta(PlanMeta):
    """(ref ``WindowMeta``, ``plan/overrides.py:823``.) Where the
    reference tags a window for its host window exec (a list payload or
    list key) and a frame or function the port's window exec does not
    take, the port raises at planning, naming the slice."""

    def tag_self(self):
        from ..exec.window import frame_reason
        schema = self.plan.children[0].schema()
        for f in schema.fields:
            if not f.dtype.device_backed and f.dtype != STRING:
                self.will_not_work_on_tpu(
                    f"column {f.name}: {f.dtype.name} payload in a window "
                    "arrives with a later windows slice (ROADMAP.md Queue "
                    "A: windows, the rest)")
        for fn, spec, name in self.plan.window_exprs:
            for pk in spec.partition_by:
                r = _key_reason(pk, schema)
                if r:
                    self.will_not_work_on_tpu(
                        f"window partition key <{pk.name_hint}>: {r}")
            for o in spec.order_by:
                r = _key_reason(o.expr, schema)
                if r:
                    self.will_not_work_on_tpu(
                        f"window order key <{o.expr.name_hint}>: {r}")
            r = fn.device_unsupported_reason(schema) or \
                frame_reason(fn, spec, schema) or _row_numbering_reason(
                    list(spec.partition_by) + [o.expr for o in spec.order_by]
                    + [e for e in [getattr(fn, "child", None)]
                       if e is not None], "a window")
            if r:
                self.will_not_work_on_tpu(f"window <{name}>: {r}")

    def convert_to_tpu(self, children):
        from ..exec.window import TpuWindowExec
        return TpuWindowExec(self.plan.window_exprs, children[0])


@rule(L.Generate)
class GenerateMeta(PlanMeta):
    """(ref ``GenerateMeta``.) The generator runs on the device; a map to
    explode, or a generator over a value without a device layout, is
    refused naming the slice that brings it."""

    def tag_self(self):
        schema = self.plan.children[0].schema()
        gen = self.plan.generator
        r = gen.fully_device_supported(schema) or \
            _row_numbering_reason([gen], "a generator")
        if r:
            self.will_not_work_on_tpu(f"generator <{gen.key()}>: {r}")

    def convert_to_tpu(self, children):
        from ..exec.generate import TpuGenerateExec
        p = self.plan
        return TpuGenerateExec(p.generator, p.required_cols, children[0],
                               p.output_names)


@rule(L.GlobalLimit)
class LimitMeta(PlanMeta):
    def convert_to_tpu(self, children):
        return B.LimitExec(self.plan.n, children[0])


@rule(L.LocalLimit)
class LocalLimitMeta(LimitMeta):
    pass


@rule(L.Union)
class UnionMeta(PlanMeta):
    def convert_to_tpu(self, children):
        return B.UnionExec(children)


@rule(L.Expand)
class ExpandMeta(PlanMeta):
    def tag_self(self):
        schema = self.plan.children[0].schema()
        for p in self.plan.projections:
            for e in p:
                r = e.fully_device_supported(schema) or \
                    _row_numbering_reason([e], "an expand")
                if r:
                    self.will_not_work_on_tpu(f"expand <{e.name_hint}>: {r}")

    def convert_to_tpu(self, children):
        return B.TpuExpandExec(self.plan.projections, self.plan.names,
                               children[0])


@rule(L.DistinctFlag)
class DistinctFlagMeta(PlanMeta):
    def tag_self(self):
        schema = self.plan.children[0].schema()
        for e in self.plan.key_exprs + [self.plan.value_expr]:
            r = e.fully_device_supported(schema) or \
                _row_numbering_reason([e], "a distinct flag")
            if r:
                self.will_not_work_on_tpu(
                    f"distinct-flag <{e.name_hint}>: {r}")

    def convert_to_tpu(self, children):
        from ..exec.distinct_flag import HashDistinctFlagExec
        p = self.plan
        return HashDistinctFlagExec(p.key_exprs, p.value_expr, p.flag_name,
                                    children[0])


@rule(L.BranchAlign)
class BranchAlignMeta(PlanMeta):
    def convert_to_tpu(self, children):
        return B.BranchAlignExec(self.plan.n, self.plan.fill_zero,
                                 children[0])


def _join_key_reason(e: Expression, schema) -> Optional[str]:
    """Why a join key cannot run on the device; a string column passes
    (the join takes it as a dictionary column), and so does the value key
    of INTERSECT and EXCEPT over one: the column with NULL filled by a
    string literal (exec/joins.py)."""
    from ..exec.joins import string_key_column_name
    if e.data_type(schema) == STRING and \
            string_key_column_name(e) is not None:
        return None
    return _list_key_reason(e, schema) or e.fully_device_supported(schema)


@rule(L.Join)
class JoinMeta(PlanMeta):
    def tag_self(self):
        ls = self.plan.children[0].schema()
        rs = self.plan.children[1].schema()
        for side, keys, schema in (("left", self.plan.left_keys, ls),
                                   ("right", self.plan.right_keys, rs)):
            for k in keys:
                r = _join_key_reason(k, schema)
                if r:
                    self.will_not_work_on_tpu(
                        f"{side} key <{k.name_hint}>: {r}")
        r = _row_numbering_reason(
            self.plan.left_keys + self.plan.right_keys
            + ([self.plan.condition] if self.plan.condition is not None
               else []), "a join")
        if r:
            self.will_not_work_on_tpu(r)
        if self.plan.condition is not None:
            joined = Schema(list(ls.fields) + list(rs.fields))
            r = self.plan.condition.fully_device_supported(joined)
            if r:
                self.will_not_work_on_tpu(
                    f"join condition <{self.plan.condition.name_hint}>: {r}")

    def _auto_broadcast(self) -> Optional[str]:
        """The side to broadcast when the user gave no hint: the smaller
        of the sides the join type lets stream whose estimate is within
        the threshold (ref ``_auto_broadcast``, estimates only)."""
        from ..config import AUTO_BROADCAST_THRESHOLD
        p = self.plan
        thr = int(self.conf.get(AUTO_BROADCAST_THRESHOLD))
        if thr <= 0:
            return None
        cand = []
        if p.join_type in ("inner", "left", "leftsemi", "leftanti"):
            cand.append((estimated_size_bytes(p.children[1]), "right"))
        if p.join_type in ("inner", "right"):
            cand.append((estimated_size_bytes(p.children[0]), "left"))
        cand = [(sz, side) for sz, side in cand
                if sz is not None and sz <= thr]
        return min(cand)[1] if cand else None

    def convert_to_tpu(self, children):
        from ..exec.joins import (TpuBroadcastHashJoinExec, TpuHashJoinExec,
                                  TpuNestedLoopJoinExec)
        from ..shuffle.broadcast import BroadcastExchangeExec
        p = self.plan
        if p.join_type == "cross" or not p.left_keys:
            return TpuNestedLoopJoinExec(children[0], children[1],
                                         p.join_type, p.condition)
        side = p.broadcast if p.broadcast is not None \
            else self._auto_broadcast()
        if side == "right":
            return TpuBroadcastHashJoinExec(
                children[0], BroadcastExchangeExec(children[1]), p.join_type,
                p.left_keys, p.right_keys, p.condition, build_side="right")
        if side == "left":
            return TpuBroadcastHashJoinExec(
                BroadcastExchangeExec(children[0]), children[1], p.join_type,
                p.left_keys, p.right_keys, p.condition, build_side="left")
        return TpuHashJoinExec(children[0], children[1], p.join_type,
                               p.left_keys, p.right_keys, p.condition)
