"""Logical plan -> tagged meta -> physical exec (port of
``spark_rapids_tpu/plan/overrides.py``).

``plan_query`` prunes columns, tags and converts, with no cost optimizer
(the reference with ``spark.rapids.tpu.sql.optimizer.enabled=false``) and
no plan rewrites. An aggregate, keyless or keyed, folds the device
filters and projections below it into its update (``_fold_stages``), as
the reference's does. String group and sort keys plan onto the device:
the execs take them as dictionary columns and refuse other forms when
the batch arrives.
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
from ..types import STRING
from . import logical as L
from .meta import PlanMeta

__all__ = ["plan_query", "wrap_plan", "prune_columns"]

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


def wrap_plan(plan: L.LogicalPlan, conf: TpuConf) -> PlanMeta:
    m = _RULES.get(type(plan), _FallbackMeta)(plan, conf)
    m.child_metas = [wrap_plan(c, conf) for c in plan.children]
    return m


def plan_query(plan: L.LogicalPlan, conf: TpuConf) -> TpuExec:
    """prune columns -> tag -> convert."""
    meta = wrap_plan(prune_columns(plan), conf)
    meta.tag()
    return meta.convert()


def _expr_refs(e: Expression, out: set) -> None:
    out.update(e.references())


def prune_columns(plan: L.LogicalPlan,
                  required: Optional[set] = None) -> L.LogicalPlan:
    """Narrow every scan to the columns the plan above it reads;
    ``required`` = names needed from this node's output, None = all."""
    if isinstance(plan, L.LogicalScan):
        names = plan.schema().names()
        if required is None or set(names) <= required:
            return plan
        keep = [n for n in names if n in required] or names[:1]
        return L.LogicalScan(plan.tables, plan._schema, columns=keep)
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
    return plan


def _rebuilt(node, child):
    if child is node.children[0]:
        return node
    node = copy.copy(node)
    node.children = [child]
    return node


@rule(L.LogicalScan)
class ScanMeta(PlanMeta):
    def convert_to_tpu(self, children):
        return B.InMemoryScanExec(self.plan.tables, self.plan._schema,
                                  batch_rows=self.conf.batch_size_rows,
                                  columns=self.plan.columns)


@rule(L.Project)
class ProjectMeta(PlanMeta):
    def tag_self(self):
        from ..exprs.string_rect import rect_chain_leaf
        schema = self.plan.children[0].schema()
        for e in self.plan.exprs:
            inner = e.children[0] if isinstance(e, Alias) else e
            if isinstance(inner, ColumnRef) \
                    or e.fully_device_supported(schema) is None \
                    or rect_chain_leaf(inner, schema) is not None:
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
        return B.TpuFilterExec(self.plan.condition, children[0])


def _key_reason(e: Expression, schema) -> Optional[str]:
    """Why a group or sort key cannot run on the device; a string key
    passes (the exec takes it as a dictionary column)."""
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

    def convert_to_tpu(self, children):
        child, stages, eval_schema = self._fold_stages(children[0])
        return A.TpuHashAggregateExec(self.plan.groupings, self.plan.aggs,
                                      child, pre_stages=stages,
                                      eval_schema=eval_schema)

    @staticmethod
    def _fold_stages(child: TpuExec):
        """Fold the chain of device-only filters and projections below
        the aggregate into its update: (new child, stages bottom-up,
        eval schema), or (child, None, None) when nothing folds."""
        eval_schema = child.output_schema()
        stages, node = [], child
        while True:
            if (isinstance(node, B.TpuFilterExec)
                    and node.condition.fully_device_supported(
                        node.children[0].output_schema()) is None):
                stages.append(("filter", node.condition))
                node = node.children[0]
            elif isinstance(node, B.TpuProjectExec) and not node.rect_chain:
                stages.append(("project", node.exprs, node.output_schema()))
                node = node.children[0]
            else:
                break
        if not stages:
            return child, None, None
        stages.reverse()
        return node, stages, eval_schema


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
            if not f.dtype.device_backed and f.dtype != STRING:
                self.will_not_work_on_tpu(
                    f"column {f.name}: {f.dtype.name} payload is host-only")

    def convert_to_tpu(self, children):
        return S.TpuSortExec(self.plan.orders, children[0])
