"""Logical plan nodes (port of ``spark_rapids_tpu/plan/logical.py``: scan,
range, project, filter, sample, aggregate, sort, limit, join, union,
window, generate, and the nodes the plan rewrites make: expand, branch
alignment and the distinct flag)."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..exprs.base import Expression
from ..types import BOOL, INT64, Schema, StructField

__all__ = ["LogicalPlan", "LogicalScan", "ParquetScan", "RangeRel",
           "Project", "Filter", "Sample", "Aggregate", "SortOrder", "Sort",
           "GlobalLimit", "LocalLimit", "Join", "Union", "WindowSpec",
           "Window", "Expand", "BranchAlign", "DistinctFlag", "Generate"]


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

    def estimated_size_bytes(self) -> int:
        return sum(t.nbytes for t in self.tables)

    def describe(self):
        return f"LogicalScan[{len(self.tables)} partitions]({self.schema()})"


class ParquetScan(LogicalPlan):
    """Parquet file source (ref GpuParquetScan.scala): the files, the
    first file's schema, and ``columns`` (set by pruning)."""

    def __init__(self, paths: Sequence[str], schema: Schema,
                 columns: Optional[List[str]] = None):
        self.paths = list(paths)
        self._schema = schema
        self.columns = columns
        self.children = []

    def schema(self) -> Schema:
        if self.columns is None:
            return self._schema
        return Schema([self._schema[c] for c in self.columns])

    def describe(self):
        return f"ParquetScan[{len(self.paths)} files]({self.schema()})"


class RangeRel(LogicalPlan):
    """``range(start, end, step)``: one non-null bigint column (ref
    ``RangeRel``)."""

    def __init__(self, start: int, end: int, step: int = 1,
                 name: str = "id"):
        self.start, self.end, self.step = start, end, step
        self.name = name
        self.children = []

    def schema(self) -> Schema:
        return Schema([StructField(self.name, INT64, False)])

    def describe(self):
        return f"Range[{self.start},{self.end},{self.step}]"


class Sample(LogicalPlan):
    """A Bernoulli sample of the child's rows (ref ``Sample``)."""

    def __init__(self, fraction: float, seed: int, child: LogicalPlan):
        self.fraction = fraction
        self.seed = seed
        self.children = [child]

    def schema(self) -> Schema:
        return self.children[0].schema()

    def describe(self):
        return f"Sample[{self.fraction}, seed={self.seed}]"


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

    def __init__(self, groupings, aggs, child: LogicalPlan,
                 many_groups_hint: bool = False, int_key_cards=None):
        self.groupings = list(groupings)
        self.aggs = list(aggs)
        #: the planner knows the aggregate has many groups (the inner dedup
        #: of a two-level DISTINCT); carried for the optimistic-groups
        #: path, which the port does not have yet
        self.many_groups_hint = many_groups_hint
        #: per grouping, a PROVEN cardinality k (the key's values lie in
        #: [0, k)) or None; set only by rewrites that make the key (the
        #: union-of-aggregates branch id), so the exec may group it by
        #: direct addressing
        self.int_key_cards = (list(int_key_cards)
                              if int_key_cards is not None
                              else [None] * len(self.groupings))
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
    """A global sort, or with ``global_sort`` False each batch sorted
    alone (``sort_within_partitions``)."""

    def __init__(self, orders: Sequence[SortOrder], child: LogicalPlan,
                 global_sort: bool = True):
        self.orders = list(orders)
        self.global_sort = global_sort
        self.children = [child]

    def schema(self) -> Schema:
        return self.children[0].schema()

    def describe(self):
        g = "" if self.global_sort else ", local"
        return f"Sort[{', '.join(map(repr, self.orders))}{g}]"


class GlobalLimit(LogicalPlan):
    """The first ``n`` rows of the child (ref ``GlobalLimit``)."""

    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.children = [child]

    def schema(self) -> Schema:
        return self.children[0].schema()

    def describe(self):
        return f"GlobalLimit[{self.n}]"


class LocalLimit(GlobalLimit):
    def describe(self):
        return f"LocalLimit[{self.n}]"


class Join(LogicalPlan):
    JOIN_TYPES = ("inner", "left", "right", "full", "leftsemi", "leftanti",
                  "cross", "existence")
    _ALIASES = {"leftouter": "left", "rightouter": "right",
                "fullouter": "full", "outer": "full", "semi": "leftsemi",
                "anti": "leftanti"}

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 join_type: str, left_keys: Sequence[Expression] = (),
                 right_keys: Sequence[Expression] = (),
                 condition: Optional[Expression] = None,
                 broadcast: Optional[str] = None):
        jt = join_type.lower().replace("_", "")
        jt = self._ALIASES.get(jt, jt)
        if jt not in self.JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        if broadcast not in (None, "left", "right"):
            raise ValueError(f"broadcast is left, right or None, not "
                             f"{broadcast!r}")
        if len(left_keys) != len(right_keys):
            raise ValueError("a join needs as many left keys as right keys")
        self.join_type = jt
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self.broadcast = broadcast
        self.children = [left, right]

    def schema(self) -> Schema:
        l, r = self.children[0].schema(), self.children[1].schema()
        if self.join_type in ("leftsemi", "leftanti"):
            return l
        if self.join_type == "existence":
            return Schema(list(l.fields) +
                          [StructField("exists", BOOL, nullable=False)])
        return Schema(list(l.fields) + list(r.fields))

    def describe(self):
        k = ", ".join(f"{a.name_hint}={b.name_hint}"
                      for a, b in zip(self.left_keys, self.right_keys))
        return f"Join[{self.join_type}, keys=({k})]"


class Union(LogicalPlan):
    """UNION ALL: the children's rows in order; columns pair by position."""

    def __init__(self, children: Sequence[LogicalPlan]):
        self.children = list(children)

    def schema(self) -> Schema:
        return self.children[0].schema()

    def describe(self):
        return f"Union[{len(self.children)}]"


class WindowSpec:
    """PARTITION BY, ORDER BY and the frame of a window: ``frame`` is
    None (Spark's default) or (kind, lower, upper), kind "rows" or
    "range", a bound None for unbounded and an int offset otherwise."""

    def __init__(self, partition_by: Sequence[Expression] = (),
                 order_by: Sequence[SortOrder] = (),
                 frame: Optional[Tuple] = None):
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.frame = frame

    def key(self) -> str:
        """Equal for specs that order rows the same way (the frame
        aside): window expressions with one key share one sort."""
        ps = ",".join(e.key() for e in self.partition_by)
        os = ",".join(f"{o.expr.key()}|{o.ascending}|{o.nulls_first}"
                      for o in self.order_by)
        return f"[{ps}][{os}]"


class Window(LogicalPlan):
    """Appends one column per window expression (ref
    window/GpuWindowExec.scala:146). ``window_exprs``: (window function or
    AggregateExpression, WindowSpec, output name)."""

    def __init__(self, window_exprs, child: LogicalPlan):
        self.window_exprs = list(window_exprs)
        self.children = [child]

    def schema(self) -> Schema:
        cs = self.children[0].schema()
        fields = list(cs.fields)
        for e, spec, name in self.window_exprs:
            fields.append(StructField(name, e.data_type(cs), True))
        return Schema(fields)

    def describe(self):
        return "Window[" + ", ".join(n for _, _, n in self.window_exprs) \
            + "]"


class Expand(LogicalPlan):
    """Each input row emits one row per projection list (ref
    GpuExpandExec)."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: LogicalPlan):
        self.projections = [list(p) for p in projections]
        self.names = list(names)
        self.children = [child]

    def schema(self) -> Schema:
        cs = self.children[0].schema()
        return Schema([StructField(n, e.data_type(cs), True)
                       for n, e in zip(self.names, self.projections[0])])

    def describe(self):
        return f"Expand[{len(self.projections)} x ({', '.join(self.names)})]"


class BranchAlign(LogicalPlan):
    """The union-of-aggregates result: the child is an aggregate keyed by
    a branch id (its first column); the output has exactly ``n`` rows in
    branch order, a branch without rows filled with the empty aggregate's
    values (a count 0, anything else NULL), and drops the id."""

    def __init__(self, n: int, fill_zero: Sequence[bool],
                 child: LogicalPlan):
        self.n = n
        self.fill_zero = list(fill_zero)
        self.children = [child]

    def schema(self) -> Schema:
        return Schema(list(self.children[0].schema().fields)[1:])

    def describe(self):
        return f"BranchAlign[n={self.n}]"


class DistinctFlag(LogicalPlan):
    """Appends a bool column, true on the stream-global first occurrence
    of each (key_exprs, value_expr) combination and false elsewhere (a
    NULL value never flags). Made by the hash-distinct rewrite
    (plan/rewrites.py); run by exec/distinct_flag.py."""

    def __init__(self, key_exprs: Sequence[Expression],
                 value_expr: Expression, flag_name: str,
                 child: LogicalPlan):
        self.key_exprs = list(key_exprs)
        self.value_expr = value_expr
        self.flag_name = flag_name
        self.children = [child]

    def schema(self) -> Schema:
        return Schema(list(self.children[0].schema().fields)
                      + [StructField(self.flag_name, BOOL, False)])

    def describe(self):
        k = ", ".join(e.name_hint for e in self.key_exprs)
        return (f"DistinctFlag[keys=[{k}], value="
                f"{self.value_expr.name_hint}]")


class Generate(LogicalPlan):
    """A generator's rows (explode, posexplode, stack; ref ``Generate``):
    the child's ``required_cols`` repeated for each row the generator
    gives its input row, then the generator's columns (named
    ``output_names`` when given)."""

    def __init__(self, generator, required_cols: Sequence[str],
                 child: LogicalPlan,
                 output_names: Optional[Sequence[str]] = None):
        self.generator = generator
        self.required_cols = list(required_cols)
        self.output_names = list(output_names) if output_names else None
        self.children = [child]

    def schema(self) -> Schema:
        cs = self.children[0].schema()
        gen = self.generator.generator_output(cs)
        if self.output_names:
            gen = [StructField(n, f.dtype, f.nullable)
                   for n, f in zip(self.output_names, gen)]
        return Schema([cs[c] for c in self.required_cols] + gen)

    def describe(self):
        return (f"Generate[{self.generator.key()}, "
                f"required={self.required_cols}]")
