"""Logical plan nodes (port of ``spark_rapids_tpu/plan/logical.py``: scan,
project, filter, aggregate, sort)."""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..exprs.base import Expression
from ..types import Schema, StructField

__all__ = ["LogicalPlan", "LogicalScan", "Project", "Filter", "Aggregate",
           "SortOrder", "Sort"]


class LogicalPlan:
    children: List["LogicalPlan"] = []

    def schema(self) -> Schema:
        raise NotImplementedError

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe() + "\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def describe(self) -> str:
        return type(self).__name__


class LogicalScan(LogicalPlan):
    """In-memory source: host tables, one per partition. ``columns`` (set
    by pruning) narrows the scan without replacing the tables."""

    def __init__(self, tables, schema: Schema,
                 columns: Optional[List[str]] = None):
        self.tables = list(tables)
        self._schema = schema
        self.columns = columns
        self.children = []

    def schema(self) -> Schema:
        if self.columns is None:
            return self._schema
        return Schema([self._schema[c] for c in self.columns])

    def describe(self):
        return f"LogicalScan[{len(self.tables)} partitions]({self.schema()})"


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.exprs = list(exprs)
        self.children = [child]

    def schema(self) -> Schema:
        cs = self.children[0].schema()
        return Schema([StructField(e.name_hint, e.data_type(cs), True)
                       for e in self.exprs])

    def describe(self):
        return "Project[" + ", ".join(e.name_hint for e in self.exprs) + "]"


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition
        self.children = [child]

    def schema(self) -> Schema:
        return self.children[0].schema()

    def describe(self):
        return f"Filter[{self.condition.name_hint}]"


class Aggregate(LogicalPlan):
    """groupings: expressions; aggs: AggregateExpressions with names."""

    def __init__(self, groupings, aggs, child: LogicalPlan):
        self.groupings = list(groupings)
        self.aggs = list(aggs)
        self.children = [child]

    def schema(self) -> Schema:
        cs = self.children[0].schema()
        fields = [StructField(e.name_hint, e.data_type(cs), True)
                  for e in self.groupings]
        fields += [StructField(a.name_hint, a.data_type(cs), True)
                   for a in self.aggs]
        return Schema(fields)

    def describe(self):
        g = ", ".join(e.name_hint for e in self.groupings)
        a = ", ".join(a.name_hint for a in self.aggs)
        return f"Aggregate[keys=[{g}], aggs=[{a}]]"


class SortOrder:
    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.expr = expr
        self.ascending = ascending
        # Spark default: nulls first for asc, nulls last for desc
        self.nulls_first = nulls_first if nulls_first is not None \
            else ascending

    def __repr__(self):
        d = "ASC" if self.ascending else "DESC"
        n = "NULLS FIRST" if self.nulls_first else "NULLS LAST"
        return f"{self.expr.name_hint} {d} {n}"


class Sort(LogicalPlan):
    """A global sort."""

    def __init__(self, orders: Sequence[SortOrder], child: LogicalPlan):
        self.orders = list(orders)
        self.children = [child]

    def schema(self) -> Schema:
        return self.children[0].schema()

    def describe(self):
        return f"Sort[{', '.join(map(repr, self.orders))}]"
